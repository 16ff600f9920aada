"""The port's W4A8 + int8-KV + kernel-attention engine against the JAX
engine (Pallas kernels in interpret mode) on a tiny Llama wide enough that
every projection takes JAX's w48 layout (K >= 128)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.serve import engine as tengine

DIMS = dict(hidden_size=128, intermediate_size=256, num_attention_heads=4, num_key_value_heads=2)
PRESET = "INT4_BLOCKWISE_WEIGHT_ONLY_CFG"


@pytest.fixture(scope="module")
def setup():
    jcfg = jllama.LlamaConfig.tiny(**DIMS)
    pnp = llama_params_np(jcfg, seed=0)
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, 8)).astype(np.int32)
    jcm = jcompress.compress(jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), PRESET))
    jeng = jengine.Engine(jcm, jengine.EngineConfig(
        max_seq_len=32, backend="pallas", kv_dtype=jnp.int8, int4_layout="a8",
        kv_attention_kernel=True))
    assert set(jeng.cm.kinds.values()) == {"int4w48"}
    cache = jeng.init_cache(2)
    jlogits, _ = jeng.prefill(jnp.asarray(prompt), cache)
    jtoks = np.asarray(jeng.generate(jnp.asarray(prompt), 8))
    return jcfg, pnp, prompt, jcm, np.asarray(jlogits), jtoks


def _port_engine(cm):
    return tengine.Engine(cm, tengine.EngineConfig(
        max_seq_len=32, kv_dtype=torch.int8, int4_layout="a8", kv_attention_kernel=True),
        device="cpu")


def _check(eng, prompt, jlogits, jtoks):
    cache = eng.init_cache(2)
    logits = eng.prefill(torch.from_numpy(prompt), cache)
    # f32 model; the W4A8 block sums and attention reduce in another order
    assert rel_err(logits.numpy(), jlogits) < 1e-3
    toks = eng.generate(torch.from_numpy(prompt), 8).numpy()
    np.testing.assert_array_equal(toks, jtoks)


def test_port_pipeline_matches_jax_engine(setup):
    jcfg, pnp, prompt, _, jlogits, jtoks = setup
    tcfg = tllama.LlamaConfig.tiny(**DIMS)
    params = tree_map(torch.from_numpy, pnp)
    cm = tcompress.compress(tptq.quantize(tcfg, params, PRESET, device="cpu"))
    assert set(cm.kinds.values()) == {"int4"}
    _check(_port_engine(cm), prompt, jlogits, jtoks)


def test_compressed_from_jax_matches_jax_engine(setup):
    _, _, prompt, jcm, jlogits, jtoks = setup
    cm = convert.compressed_from_jax(jcm)
    _check(_port_engine(cm), prompt, jlogits, jtoks)


def test_engine_refuses_unported_paths(setup):
    _, _, _, jcm, _, _ = setup
    cm = convert.compressed_from_jax(jcm)
    for bad in (dict(int4_layout="bd2", kv_attention_kernel=True),
                dict(int4_layout="a8", kv_attention_kernel=False),
                dict(int4_layout="a8", kv_attention_kernel=True, kv_dtype="nvfp4")):
        with pytest.raises(NotImplementedError):
            tengine.Engine(cm, tengine.EngineConfig(**bad), device="cpu")


def test_prefill_needs_empty_cache(setup):
    _, _, prompt, jcm, _, _ = setup
    eng = _port_engine(convert.compressed_from_jax(jcm))
    cache = eng.init_cache(2)
    eng.prefill(torch.from_numpy(prompt), cache)
    with pytest.raises(ValueError):
        eng.prefill(torch.from_numpy(prompt), cache)


@pytest.mark.parametrize("plain", [(), ("flash",), tengine.PLAIN_ALL])
def test_plain_ops_picks_each_kernel(plain):
    """`plain_ops` swaps exactly the named kernels for their plain versions."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention, qmm

    kernels = (qmm.w4a8_matmul, kv_attention.kv_decode_attention, flash_gqa.flash_attention_gqa)
    plains = (qmm.w4a8_matmul_plain, kv_attention.kv_decode_attention_plain,
              flash_gqa.flash_attention_gqa_plain)
    want = tuple(p if name in plain else k for name, k, p in zip(tengine.PLAIN_ALL, kernels, plains))
    assert tengine._ops(plain) == want


def test_plain_ops_rejects_unknown_names():
    with pytest.raises(ValueError):
        tengine._ops(("gemm",))


def test_sampling_support():
    """Greedy is argmax; sampled tokens stay inside the top-k set and the
    top-p nucleus (the draws come from a torch.Generator, so they are held
    by support, not token for token, against JAX's `sample` rule)."""
    from tensorrt_model_optimizer_tpu_torch.serve.sampling import SamplingConfig, sample

    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32) * 3)
    np.testing.assert_array_equal(sample(logits, SamplingConfig()).numpy(), logits.argmax(-1).numpy())
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([sample(logits, SamplingConfig(temperature=0.7, top_k=5), g) for _ in range(200)])
    topk = torch.topk(logits, 5, dim=-1).indices
    assert all(set(draws[:, b].tolist()) <= set(topk[b].tolist()) for b in range(4))
    draws = torch.stack([sample(logits, SamplingConfig(temperature=1.0, top_p=0.5), g) for _ in range(200)])
    p = torch.softmax(logits, dim=-1)
    for b in range(4):
        order = torch.argsort(p[b], descending=True)
        keep = int((torch.cumsum(p[b][order], 0) < 0.5).sum()) + 1
        assert set(draws[:, b].tolist()) <= set(order[:keep].tolist())
        assert len(set(draws[:, b].tolist())) > 1 or keep == 1
