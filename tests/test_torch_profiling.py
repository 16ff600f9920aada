"""`serve/profiling.py` of the port against the JAX package's: the same keys
from `get_latency` and `profile_matmuls`, on a tiny Llama on the CPU
(timings differ by nature; only their form and the shapes are compared)."""

import jax.numpy as jnp
import pytest
import torch

from _torch_parity import llama_params_np, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu.serve import profiling as jprofiling
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine
from tensorrt_model_optimizer_tpu_torch.serve import profiling as tprofiling

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)


@pytest.fixture(scope="module")
def engines():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    jcm = jcompress.compress(jptq.quantize(jcfg, tree_map(jnp.asarray, llama_params_np(jcfg, seed=0)),
                                           "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"))
    je = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=64, backend="xla", kv_dtype=jnp.int8))
    te = tengine.Engine(convert.compressed_from_jax(jcm), tengine.EngineConfig(max_seq_len=64, kv_dtype=torch.int8),
                        device="cpu")
    return je, te


def test_get_latency_keys_match_jax(engines):
    je, te = engines
    want = jprofiling.get_latency(je, batch=2, prefill=16, steps=2)
    got = tprofiling.get_latency(te, batch=2, prefill=16, steps=2)
    assert set(got) == set(want) == {"step_ms", "tok_s", "batch"}
    assert got["batch"] == want["batch"] == 2 and got["step_ms"] > 0 and got["tok_s"] > 0


def test_profile_matmuls_keys_match_jax(engines):
    je, te = engines
    want = jprofiling.profile_matmuls(je, batch=2, iters=1)
    got = tprofiling.profile_matmuls(te, batch=2, iters=1)
    assert list(got) == list(want)
    for name in want:
        assert set(got[name]) == set(want[name]) == {"kind", "shape", "us", "us_per_model"}
        assert got[name]["shape"] == list(want[name]["shape"])
        assert got[name]["us"] > 0 and got[name]["us_per_model"] == pytest.approx(2 * got[name]["us"], rel=1e-2)
