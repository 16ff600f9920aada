"""The port's utilities (`utils/{logging,memory,perf,tracking}.py`) on the
cases of the JAX package's `tests/test_api_utils.py`, and its host packer
(`csrc/pack_ext.cpp` through `csrc/__init__.py`) byte for byte against the
JAX package's and against the port's PyTorch packers.

The OOM probe: a probe fails on `torch.cuda.OutOfMemoryError` (the
allocator's cache emptied after it), where JAX's reads "RESOURCE_EXHAUSTED"
in the message of any exception; every other error propagates, JAX's
RuntimeError-with-message included. The boundary cases are JAX's."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_model_optimizer_tpu import csrc as jcsrc
from tensorrt_model_optimizer_tpu.ops import numerics as jnum
from tensorrt_model_optimizer_tpu.utils import memory as jmemory
from tensorrt_model_optimizer_tpu.utils import tracking as jtracking
from tensorrt_model_optimizer_tpu_torch import csrc as tcsrc
from tensorrt_model_optimizer_tpu_torch.ops import numerics as tnum
from tensorrt_model_optimizer_tpu_torch.utils import logging as tlogging
from tensorrt_model_optimizer_tpu_torch.utils import memory, perf, tracking


def test_timer_and_tree_bytes():
    t = perf.Timer()
    with t.time("fwd"):
        torch.ones(4) @ torch.ones(4)
    with t.time("fwd", block_on=torch.ones(1)):
        pass
    assert "fwd" in t.report() and t.counts["fwd"] == 2
    tree = {"a": torch.zeros(3, 4), "b": [torch.zeros(2, dtype=torch.bfloat16), None], "c": 7}
    assert perf.tree_bytes(tree) == 3 * 4 * 4 + 2 * 2
    assert perf.device_memory_stats() == {"bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None}
    assert memory.device_memory_stats() == {} and memory.memory_summary() == ""
    with memory.MemoryMonitor() as mon:
        pass
    assert mon.peak_bytes is None and mon.delta_bytes is None


def _run(mod, root):
    art = root / "thing.json"
    art.write_text("{}")
    with mod.RunLogger(str(root / "runs"), name="t") as run:
        run.log_params({"lr": 1e-3, "api_key": "hunter2", "uri": "https://user:pw@host/x", "shape": (2, 3)})
        run.log_metric("ppl", 3.5, step=1)
        run.log_metric("ppl", 3.1, step=2)
        run.log_artifact(str(art))
        return run.dir


def test_run_logger_writes_jax_files(tmp_path):
    """The same files as JAX's RunLogger, the same meta and metrics (but for
    times), secrets redacted."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tdir, jdir = _run(tracking, tmp_path / "t"), _run(jtracking, tmp_path / "j")
    files = lambda d: sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)
    assert files(tdir) == files(jdir) == ["artifacts/thing.json", "meta.json", "metrics.jsonl"]
    tm, jm = (json.load(open(os.path.join(d, "meta.json"))) for d in (tdir, jdir))
    for m in (tm, jm):
        for k in ("start_time", "end_time", "cwd"):
            m.pop(k)
    assert tm == jm and tm["status"] == "finished" and tm["params"]["api_key"] == "***"
    assert "pw@" not in tm["params"]["uri"]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "time"} for r in rows]
    assert strip(tracking.read_metrics(tdir)) == strip(jtracking.read_metrics(jdir))
    assert [m["value"] for m in tracking.read_metrics(tdir)] == [3.5, 3.1]


def test_run_logger_failure_status(tmp_path):
    with pytest.raises(ValueError):
        with tracking.RunLogger(str(tmp_path), name="f") as run:
            rdir = run.dir
            raise ValueError("boom")
    assert json.load(open(os.path.join(rdir, "meta.json")))["status"] == "failed"


def test_print_rank_0(capsys, monkeypatch):
    tlogging.print_rank_0("hello")
    tlogging.atomic_print("a", 1)
    assert capsys.readouterr().out == "hello\na 1\n"
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    tlogging.print_rank_0("quiet")
    assert capsys.readouterr().out == "" and tlogging.rank() == 1


class TestFindMaxBatchSize:
    @staticmethod
    def _probe(capacity, calls, error=None):
        def try_fn(b):
            calls.append(b)
            if b > capacity:
                raise (error or torch.cuda.OutOfMemoryError("CUDA out of memory"))
        return try_fn

    @staticmethod
    def _jax_probe(capacity):
        def try_fn(b):
            if b > capacity:
                raise RuntimeError("RESOURCE_EXHAUSTED: out of memory probing")
        return try_fn

    @pytest.mark.parametrize("cap", [1, 2, 3, 5, 8, 13, 64, 100])
    def test_finds_exact_boundary(self, cap):
        calls = []
        got = memory.find_max_batch_size(self._probe(cap, calls), start=1, ceiling=128)
        assert got == cap == jmemory.find_max_batch_size(self._jax_probe(cap), start=1, ceiling=128)

    def test_ceiling_respected(self):
        assert memory.find_max_batch_size(self._probe(10**9, []), start=2, ceiling=16) == 16

    def test_optimistic_start_backs_off(self):
        assert memory.find_max_batch_size(self._probe(3, []), start=32, ceiling=64) == 3

    def test_nothing_fits_raises(self):
        with pytest.raises(MemoryError):
            memory.find_max_batch_size(self._probe(0, []), start=4)

    def test_non_oom_errors_propagate(self):
        with pytest.raises(ValueError):
            memory.find_max_batch_size(self._probe(1, [], ValueError("shape mismatch")), start=2)
        # JAX's OOM signal is a message, the port's the exception type
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            memory.find_max_batch_size(self._jax_probe(1), start=2)

    def test_empties_the_cache_after_an_oom(self, monkeypatch):
        emptied = []
        monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
        memory.find_max_batch_size(self._probe(5, []), start=1, ceiling=64)
        assert len(emptied) == 2  # 8 and 6 fail on the way to 5


# ---- the host packer ---------------------------------------------------------


def test_pack_ext_builds_into_the_build_tree():
    so = tcsrc.build()
    assert os.path.dirname(so) == tcsrc.BUILD_DIR and os.path.exists(so)
    assert os.path.dirname(tcsrc.SOURCE) != os.path.dirname(jcsrc.__file__)


def test_int4_pack_equals_jax_and_torch():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 256)).astype(np.float32)
    block = 64
    bam = np.abs(w).reshape(16, -1, block).max(-1)
    scale = np.where(bam == 0, 1.0, bam / 7.0).astype(np.float32)
    packed = tcsrc.int4_round_and_pack(w, scale, block)
    np.testing.assert_array_equal(packed, jcsrc.int4_round_and_pack(w, scale, block))
    q = np.clip(np.round(w / np.repeat(scale, block, axis=1)), -8, 7).astype(np.int8)
    np.testing.assert_array_equal(packed, tnum.pack_int4(torch.from_numpy(q)).numpy())
    np.testing.assert_array_equal(tcsrc.int4_unpack(packed), q)
    np.testing.assert_array_equal(tcsrc.int4_unpack(packed), jcsrc.int4_unpack(packed))


def test_nvfp4_pack_equals_jax_and_torch():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 64)).astype(np.float32)
    g_amax = float(np.abs(w).max())
    gs = g_amax / (6.0 * 448.0)
    packed, scales = tcsrc.nvfp4_quantize_and_pack(w, gs, 16)
    jpacked, jscales = jcsrc.nvfp4_quantize_and_pack(w, gs, 16)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(scales, jscales)
    tp, ts, tgs = tnum.real_quant_nvfp4(torch.from_numpy(w), 16, torch.tensor(g_amax))
    np.testing.assert_array_equal(packed, tp.numpy())
    np.testing.assert_allclose(scales, ts.float().numpy(), rtol=1e-6)


def test_nf4_equals_jax():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 128)).astype(np.float32)
    packed, am = tcsrc.nf4_quantize_and_pack(w, block=64)
    jpacked, jam = jcsrc.nf4_quantize_and_pack(w, block=64)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(am, jam)
    deq = tcsrc.nf4_dequantize(packed, am, block=64)
    np.testing.assert_array_equal(deq, jcsrc.nf4_dequantize(packed, am, block=64))
    ref = np.asarray(jnum.fake_quant_nf4(jnp.asarray(w), 64)).reshape(-1)
    np.testing.assert_allclose(deq, ref, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="blocks"):
        tcsrc.nf4_quantize_and_pack(w[:, :10], block=64)


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++")
    monkeypatch.setattr(tcsrc, "SOURCE", str(bad))
    monkeypatch.setattr(tcsrc, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="pack_ext build failed"):
        tcsrc.build()
