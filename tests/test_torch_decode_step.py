"""The fused decode step of the port's engine against the JAX engine:
`Engine.decode_step(tok, cache, unroll)` (JAX `serve/engine.py`
`decode_step`), `paged_decode_step(unroll)`, `generate_host`, and the
dense cache's `pos` as a device int32 tensor, on a tiny f32 Llama wide
enough for JAX's Pallas layouts (K >= 128). The kernel engine runs its plain
versions on the CPU and JAX its Pallas kernels in interpret mode; the einsum
engine runs against JAX's XLA backend. Weights cross through `convert.py`.

Tolerances: tokens equal exactly; caches hold at most 1e-3 of their stored
bytes apart (f32 sums taken in another order can move an int8 code or an
E2M1 code by one step), pos equal; the kv-decode plain version within 1e-5
of the Pallas kernel's scale.

The CUDA-marked tests hold the graphed step (one replay a call) against the
eager loop on the card bit for bit, and the wrappers' launch counters
against the captured launches.
"""

import dataclasses
import gc
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, llama_params_np, rel_err, tree_map  # noqa: F401  (cuda_device: a fixture)
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.ops.pallas import kv_attention as jkva
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.ops.cuda import kv_attention as tkva
from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm as tqmm
from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm_wo as tqmm_wo
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve import step_graph
from tensorrt_model_optimizer_tpu_torch.serve.paged_cache import PagedKV

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)
PROMPT = (2, 8)
MAX_SEQ = 32

# engine -> (JAX EngineConfig fields, the port's EngineConfig fields)
CASES = {
    "kernel_int8": (dict(backend="pallas", kv_dtype=jnp.int8, kv_attention_kernel=True),
                    dict(kv_dtype=torch.int8, kv_attention_kernel=True)),
    "kernel_nvfp4": (dict(backend="pallas", kv_dtype="nvfp4", kv_attention_kernel=True),
                     dict(kv_dtype="nvfp4", kv_attention_kernel=True)),
    "einsum_int8": (dict(backend="xla", kv_dtype=jnp.int8), dict(kv_dtype=torch.int8)),
    "einsum_nvfp4": (dict(backend="xla", kv_dtype="nvfp4"), dict(kv_dtype="nvfp4")),
}


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    jcm = jcompress.compress(jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"))
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=PROMPT).astype(np.int32)
    return jcm, convert.compressed_from_jax(jcm), prompt


def _pair(setup, case, **extra):
    jcm, cm, _ = setup
    jf, tf = CASES[case]
    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=MAX_SEQ, **jf, **extra))
    te = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=MAX_SEQ, **tf, **extra), device="cpu")
    return je, te


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8) if t.element_size() == 1 else t.float()


def _held_cache(got: dict, want: dict):
    assert set(got) == set(want)
    assert got["pos"].dtype == torch.int32 and got["pos"].shape == () and int(got["pos"]) == int(want["pos"])
    for name in sorted(set(got) - {"pos"}):
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert (_bytes(a) != _bytes(b)).float().mean() <= 1e-3, name


@pytest.mark.parametrize("unroll", [1, 3, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_step_matches_jax(setup, case, unroll):
    """Two calls of `decode_step(tok, cache, unroll)` after the prefill give
    JAX's tokens, and the same cache, pos included."""
    *_, prompt = setup
    je, te = _pair(setup, case)
    jl, jc = je.prefill(jnp.asarray(prompt), je.init_cache(PROMPT[0]))
    tc = te.init_cache(PROMPT[0])
    assert tc["pos"].dtype == torch.int32 and tc["pos"].shape == () and int(tc["pos"]) == 0
    tl = te.prefill(torch.from_numpy(prompt), tc)
    jt = jnp.argmax(jl, axis=-1).astype(jnp.int32)[:, None]
    tt = torch.argmax(tl, dim=-1).to(torch.int32)[:, None]
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    for _ in range(2):
        jt, jc = je.decode_step(jt, jc, unroll=unroll)
        tt, tc2 = te.decode_step(tt, tc, unroll=unroll)
        assert tc2 is tc and tt.shape == (PROMPT[0], 1) and tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _held_cache(tc, convert.cache_from_jax(jc))
    assert int(tc["pos"]) == PROMPT[1] + 2 * unroll


def test_decode_step_refuses_a_full_cache(setup):
    *_, prompt = setup
    _, te = _pair(setup, "kernel_int8")
    cache = te.init_cache(PROMPT[0])
    te.prefill(torch.from_numpy(prompt), cache)
    tok = torch.zeros((PROMPT[0], 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        te.decode_step(tok, cache, unroll=MAX_SEQ - PROMPT[1] + 1)
    assert int(cache["pos"]) == PROMPT[1]  # refused before any step


def _record(eng, cache):
    st = eng._caches[id(cache["pos"])]
    return st.pos, st.version


@pytest.mark.parametrize("case", ["kernel_int8", "einsum_nvfp4"])
def test_host_keeps_pos_without_reading_the_card(setup, case):
    """Every public call leaves the host's record of pos equal to the
    tensor's, at the tensor's version, so the next room check reads no
    device value; a write the engine did not make (a fill, a direct
    `_model_step`) moves the version, and the check reads pos again."""
    *_, prompt = setup
    _, te = _pair(setup, case)
    cache = te.init_cache(PROMPT[0])
    assert _record(te, cache) == (0, cache["pos"]._version)
    tok = torch.argmax(te.prefill(torch.from_numpy(prompt), cache), dim=-1).to(torch.int32)[:, None]
    assert _record(te, cache) == (PROMPT[1], cache["pos"]._version)
    tok, _ = te.decode_step(tok, cache, unroll=3)
    te.decode(tok, cache, 2)
    assert _record(te, cache) == (PROMPT[1] + 5, cache["pos"]._version) and int(cache["pos"]) == PROMPT[1] + 5
    cache["pos"].fill_(4)
    assert te._room(cache, 1) == 4 and _record(te, cache) == (4, cache["pos"]._version)
    te._model_step(tok, cache)
    assert te._room(cache, 1) == 5


def test_cache_state_goes_with_the_cache(setup):
    """What the engine keeps about a cache (its pos record, its graphs) is
    dropped when the cache is, dense or paged."""
    *_, prompt = setup
    _, te = _pair(setup, "kernel_int8")
    cache = te.init_cache(PROMPT[0])
    te.prefill(torch.from_numpy(prompt), cache)
    paged = te.init_paged_cache(n_pages=8, page_size=8, max_slots=2, max_pages_per_seq=4)
    te._state(paged.seq_lens)
    assert len(te._caches) == 2
    del cache
    gc.collect()
    assert list(te._caches) == [id(paged.seq_lens)]
    del paged
    gc.collect()
    assert not te._caches


@pytest.mark.parametrize("case", ["kernel_int8", "einsum_nvfp4"])
def test_generate_host_matches_jax(setup, case):
    *_, prompt = setup
    je, te = _pair(setup, case)
    want = np.asarray(je.generate_host(jnp.asarray(prompt), 7))
    got = te.generate_host(torch.from_numpy(prompt), 7)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(te.generate(torch.from_numpy(prompt), 7).numpy(), want)


def test_paged_decode_step_unroll4_matches_jax(setup):
    """Two slots prefilled into their pages, then `paged_decode_step(unroll=4,
    return_all=True)` twice: JAX's tokens, pool and lengths."""
    je, te = _pair(setup, "kernel_int8", paged_attention_kernel=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=(1, n)).astype(np.int32) for n in (9, 5)]
    geom = dict(n_pages=16, page_size=8, max_slots=2, max_pages_per_seq=4)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jc = je.init_paged_cache(**geom)
    jc = jc.__class__(**{**jc.__dict__, "block_table": jnp.asarray(table)})
    tc = te.init_paged_cache(**geom)
    tc.block_table.copy_(torch.from_numpy(table))
    jfirst, tfirst = [], []
    for slot, p in enumerate(prompts):
        jl, jc = je.prefill_into_slot(jc, slot, jnp.asarray(p))
        jfirst.append(int(jnp.argmax(jl[0])))
        tfirst.append(int(te.prefill_into_slot(tc, slot, torch.from_numpy(p))[0].argmax()))
    assert tfirst == jfirst
    jt = jnp.asarray(np.asarray(jfirst, np.int32)[:, None])
    tt = torch.tensor(tfirst, dtype=torch.int32)[:, None]
    act = np.asarray([True, True])
    for _ in range(2):
        jblk, jc = je.paged_decode_step(jt, jc, jnp.asarray(act), unroll=4, return_all=True)
        tblk = te.paged_decode_step(tt, tc, torch.from_numpy(act), unroll=4, return_all=True)
        np.testing.assert_array_equal(tblk.numpy(), np.asarray(jblk))
        jt, tt = jblk[:, -1:], tblk[:, -1:]
    want = convert.paged_from_jax(jc)
    assert tc.seq_lens.tolist() == want.seq_lens.tolist() == [17, 13]
    for name in ("k_pages", "v_pages"):
        assert (_bytes(getattr(tc, name)) != _bytes(getattr(want, name))).float().mean() <= 1e-3


# ---- kv decode with pos as a device tensor ----

B, N_KV, REP, HD, S = 2, 2, 4, 128, 64


def _kv_inputs(fmt, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, N_KV * REP, HD)) / math.sqrt(HD)).astype(np.float32)
    if fmt == "int8":
        kc, vc = (rng.integers(-128, 128, size=(B, N_KV, S, HD)).astype(np.int8) for _ in range(2))
        q = q / 40.0
    else:
        dt = ml_dtypes.bfloat16 if fmt == "bf16" else ml_dtypes.float8_e4m3fn
        kc, vc = ((rng.standard_normal((B, N_KV, S, HD)) * 2).astype(dt) for _ in range(2))
    kn, vn = (rng.standard_normal((B, N_KV, 1, HD)).astype(np.float32) for _ in range(2))
    return q, kc, vc, kn, vn


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("pos", [0, 1, 15, 16, 17, S - 1])
def test_kv_plain_with_tensor_pos_matches_pallas(fmt, pos):
    q, kc, vc, kn, vn = _kv_inputs(fmt, seed=300 + pos)
    ref = np.asarray(jkva.kv_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pos, jnp.int32), fmt, interpret=True))
    t = [convert.tensor_from_array(a) for a in (q, kc, vc, kn, vn)]
    pos_t = torch.tensor(pos, dtype=torch.int32)
    out = tkva.kv_decode_attention_plain(*t, pos_t, fmt)
    assert rel_err(out.numpy(), ref) < 1e-5
    assert torch.equal(tkva.kv_decode_attention(*t, pos_t, fmt), out)  # the wrapper on a CPU tensor
    assert int(pos_t) == pos


def test_kv_pos_must_be_one_int32():
    t = [convert.tensor_from_array(a) for a in _kv_inputs("int8", seed=1)]
    with pytest.raises(TypeError):
        tkva.kv_decode_attention(*t, torch.tensor(3, dtype=torch.int64), "int8")
    with pytest.raises(ValueError):
        tkva.kv_decode_attention(*t, S + 1, "int8")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
def test_kv_kernel_with_device_pos_at_split_edges(cuda_device, fmt):
    """The kernel reads pos from device memory and sizes its grid from S (600
    rows: 3 splits of 256): each side of the splits' edges against the
    plain version, and one grid at every pos."""
    rng = np.random.default_rng(11)
    S_ = 600
    q = torch.from_numpy((rng.standard_normal((B, N_KV * REP, HD)) / math.sqrt(HD)).astype(np.float32))
    x = rng.standard_normal((2, B, N_KV, S_, HD)).astype(np.float32)
    if fmt == "int8":
        kc, vc = (torch.from_numpy(np.clip(np.round(a * 40), -128, 127).astype(np.int8)) for a in x)
        q = q / 40.0
    else:
        kc, vc = (torch.from_numpy(a * 2).to(torch.bfloat16 if fmt == "bf16" else torch.float8_e4m3fn) for a in x)
    kn, vn = (torch.from_numpy(rng.standard_normal((B, N_KV, 1, HD)).astype(np.float32)) for _ in range(2))
    q, kc, vc, kn, vn = (t.to(cuda_device) for t in (q, kc, vc, kn, vn))
    assert tkva.n_splits(S_) == 3
    pos = torch.zeros((), dtype=torch.int32, device=cuda_device)
    for p in (0, 1, 255, 256, 257, 511, 512, 513, S_ - 1, S_):
        pos.fill_(p)
        out = tkva.kv_decode_attention(q, kc, vc, kn, vn, pos, fmt)
        ref = tkva.kv_decode_attention_plain(q, kc, vc, kn, vn, pos, fmt)
        assert rel_err(out.cpu().numpy(), ref.cpu().numpy()) < 1e-5, p


# ---- launch counters across replays (the bookkeeping, on the CPU) ----

def test_add_counts_moves_every_wrapper_counter():
    before = step_graph.counters()
    delta = {k: 2 for k in before}
    step_graph.add_counts(delta)
    after = step_graph.counters()
    step_graph.add_counts({k: -2 for k in before})
    assert all(after[k] == before[k] + 2 for k in before)
    assert step_graph.counters() == before
    names = {(m.__name__.rsplit(".", 1)[-1], a) for m, a, _ in before}
    assert {("qmm", "launches"), ("qmm_wo", "launches"), ("kv_attention", "launches"),
            ("flash_gqa", "launches"), ("paged_attention", "launches"),
            ("paged_attention", "prefill_route_launches"), ("sparse_attention", "route_launches")} <= names


# ---- on the card: the graphed step against the eager loop ----

def _eager_steps(eng, tok, cache, n):
    toks = []
    for _ in range(n):
        tok = eng._greedy_steps(tok, cache, 1)
        toks.append(tok)
    return torch.cat(toks, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES) + ["kernel_bf16", "kernel_fp8", "einsum_fp8"])
def test_graphed_decode_step_equals_eager(cuda_device, setup, case):
    """decode_step(unroll=1) and (unroll=4) over 8 steps give the eager
    loop's tokens and cache bit for bit, a second cache on the same engine
    gets its own graph, and the wrappers' launch counters grow by the
    captured launches on each replay."""
    _, cm, prompt = setup
    kv = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
    fields = dict(CASES[case][1]) if case in CASES else dict(
        kv_dtype=kv[case.split("_")[1]], kv_attention_kernel=case.startswith("kernel"))
    eng = tengine.Engine(_to(cm, cuda_device), tengine.EngineConfig(max_seq_len=MAX_SEQ, **fields), device=cuda_device)
    p = torch.from_numpy(prompt).to(cuda_device)
    caches = [eng.init_cache(PROMPT[0]) for _ in range(3)]
    firsts = [torch.argmax(eng.prefill(p, c), dim=-1).to(torch.int32)[:, None] for c in caches]
    want = _eager_steps(eng, firsts[0], caches[0], 8)
    for unroll, cache, tok in ((1, caches[1], firsts[1]), (4, caches[2], firsts[2])):
        got = []
        for call in range(8 // unroll):
            before = step_graph.counters()
            tok, _ = eng.decode_step(tok, cache, unroll=unroll)
            torch.cuda.synchronize()
            after = step_graph.counters()
            grown = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            graphs = _graphs_of(eng)
            key = [k for k in graphs if k[-1] == unroll and k[0] == "dense"]
            assert len(key) == 1
            captured = {k: n for k, n in graphs[key[0]].launches.items() if n}
            assert grown == captured, (call, grown, captured)
            got.append(tok if unroll == 1 else None)
        if unroll == 1:
            assert torch.equal(torch.cat(got, dim=1), want)
        else:
            assert torch.equal(tok, want[:, -1:])
        for name in caches[0]:
            assert torch.equal(_bytes(cache[name]), _bytes(caches[0][name])), (unroll, name)
    assert len([k for k in _graphs_of(eng) if k[0] == "dense"]) == 2  # one graph per (cache, unroll)
    eng.release_graphs()
    assert not _graphs_of(eng)
    eng.decode_step(tok, cache, unroll=unroll)
    assert len(_graphs_of(eng)) == 1
    del cache, caches, _
    gc.collect()
    assert not _graphs_of(eng) and not eng._caches  # a cache's graphs go with it


@pytest.mark.cuda
def test_graph_keeps_its_split_k_workspace(cuda_device):
    """A graph captured at N = 16 keeps the split-K workspace it captured
    when a capture at N = 8 (more splits) on the same stream swaps a larger
    one in: a buffer of the old one's size made afterwards on that stream
    lies elsewhere, the replay leaves it as it was, and the replay equals
    the eager product bit for bit."""
    O, K = 4096, 14336  # Llama-3-8B's down_proj
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert tqmm.decode_splits(O, K, 8, sms) > tqmm.decode_splits(O, K, 16, sms) > 1
    g = torch.Generator(device=cuda_device).manual_seed(0)
    packed = torch.randint(0, 256, (O, K // 2), dtype=torch.uint8, device=cuda_device, generator=g)
    scales = torch.rand((K // 128, O), generator=g, device=cuda_device) * 1e-2
    xs = {n: torch.randn((n, K), generator=g, device=cuda_device).to(torch.bfloat16) for n in (16, 8)}

    def fn(x):
        return tqmm_wo.int4_wo_matmul(x, packed, scales)

    stream = torch.cuda.Stream(device=cuda_device)
    key = (tqmm._index(cuda_device), stream.cuda_stream)
    g16 = step_graph.StepGraph(fn, (xs[16],), stream)
    old_ptr, old_numel = tqmm._workspace[key][0].data_ptr(), tqmm._workspace[key][0].numel()
    g8 = step_graph.StepGraph(fn, (xs[8],), stream)
    assert tqmm._workspace[key][0].data_ptr() != old_ptr  # the larger workspace swapped in
    with torch.cuda.stream(stream):
        victim = torch.full((old_numel,), 7.0, device=cuda_device)
    torch.cuda.current_stream().wait_stream(stream)
    assert victim.data_ptr() != old_ptr
    got = g16(xs[16])
    torch.cuda.synchronize()
    assert bool((victim == 7.0).all())
    assert torch.equal(got, fn(xs[16])) and torch.equal(got, g16.first)
    assert torch.equal(g8(xs[8]), fn(xs[8]))


def _graphs_of(eng):
    """Every captured graph of the engine, over all its caches."""
    return {k: g for st in eng._caches.values() for k, g in st.graphs.items()}


def _to(cm, device):
    """A compressed model's tensors moved to `device`, bf16 (what the
    weight-only kernels take) where they are not packed arrays."""
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if type(x).__name__ == "QuantizerState":
            return type(x)(amax=move(x.amax), pre_quant_scale=move(x.pre_quant_scale), bias=move(x.bias))
        if isinstance(x, tuple):
            return tuple(move(v) for v in x)
        return x
    params = move(cm.params)
    params = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v) for k, v in params.items()}
    params["layers"] = {k: (v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v)
                        for k, v in params["layers"].items()}
    return dataclasses.replace(cm, params=params, qstate=move(cm.qstate),
                               model_cfg=dataclasses.replace(cm.model_cfg, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_graphed_paged_decode_step_equals_eager(cuda_device, setup):
    """`paged_decode_step(unroll=4)` as one replay a call gives the eager
    steps' tokens; the tables are updated in place between calls."""
    _, cm, _ = setup
    eng = tengine.Engine(_to(cm, cuda_device), tengine.EngineConfig(
        max_seq_len=MAX_SEQ, kv_dtype=torch.int8, kv_attention_kernel=True, paged_attention_kernel=True),
        device=cuda_device)
    geom = dict(n_pages=16, page_size=8, max_slots=2, max_pages_per_seq=4)
    rng = np.random.default_rng(7)
    prompts = [torch.from_numpy(rng.integers(0, 256, size=(1, n)).astype(np.int32)) for n in (9, 5)]
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    runs = []
    for graphed in (False, True):
        c = eng.init_paged_cache(**geom)
        c.block_table.copy_(table)
        first = [int(eng.prefill_into_slot(c, s, p)[0].argmax()) for s, p in enumerate(prompts)]
        tok = torch.tensor(first, dtype=torch.int32, device=cuda_device)[:, None]
        act = torch.ones(2, dtype=torch.bool, device=cuda_device)
        blocks = []
        for _ in range(2):
            if graphed:
                blk = eng.paged_decode_step(tok, c, act, unroll=4, return_all=True)
            else:
                blk = eng._paged_greedy_steps(tok, c, act, 4, True)
            blocks.append(blk)
            tok = blk[:, -1:]
        runs.append((torch.cat(blocks, dim=1), c))
    (want, cw), (got, cg) = runs
    assert torch.equal(got, want)
    assert isinstance(cg, PagedKV) and torch.equal(cg.seq_lens, cw.seq_lens)
    assert torch.equal(cg.k_pages.view(torch.uint8), cw.k_pages.view(torch.uint8))
