"""The port's int8-KV + kernel-attention engine against the JAX engine
(Pallas kernels in interpret mode) on a tiny Llama wide enough that every
projection takes JAX's w48 / bd2 layouts (K >= 128): W4A8, and the
weight-only formats under the default layout names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import compress as jcompress
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu.serve import engine as jengine
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import compress as tcompress
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
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
    _, pnp, _, jcm, _, _ = setup
    cm = convert.compressed_from_jax(jcm)
    for bad in (dict(int4_layout="xla", kv_attention_kernel=True),
                dict(int4_layout="a8", kv_attention_kernel=True, attn_sparsity=1e-3),
                dict(int4_layout="xla", kv_attention_kernel=False, paged_attention_kernel=True)):
        with pytest.raises(NotImplementedError):
            tengine.Engine(cm, tengine.EngineConfig(**bad), device="cpu")
    for bad in (dict(int4_layout="bd4"), dict(int4_layout="a8", kv_dtype="nf4")):
        with pytest.raises(ValueError):
            tengine.Engine(cm, tengine.EngineConfig(kv_attention_kernel=True, **bad), device="cpu")
    tcfg = tllama.LlamaConfig.tiny(**DIMS)
    params = tree_map(torch.from_numpy, pnp)
    kernel_path = tengine.EngineConfig(kv_attention_kernel=True)
    nv = tcompress.compress(tptq.quantize(tcfg, params, "NVFP4_WEIGHT_ONLY_CFG", device="cpu"))
    with pytest.raises(NotImplementedError, match="W8A8"):
        tengine.Engine(nv, tengine.EngineConfig(nvfp4_layout="i8", kv_attention_kernel=True), device="cpu")
    # INT8_DEFAULT_CFG is W8A8 (int8 x int8 products), served since the
    # calibration-algorithms slice (test_torch_calib_serve.py holds it to JAX)
    calib = [torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(2, 16)))]
    w8a8 = tcompress.compress(tptq.quantize(tcfg, params, "INT8_DEFAULT_CFG", calib, device="cpu"))
    assert set(tengine.Engine(w8a8, kernel_path, device="cpu").cm.kinds.values()) == {"int8"}


INT8_WEIGHT_ONLY = {"*input_quantizer": {"enable": False}}
FORMATS = {  # label -> (preset or weight-only INT8 rules, calibrate, JAX serving kind, port kind)
    "int4_bd2": ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", False, "int4b2", "int4wo"),
    "nvfp4_word2": ("NVFP4_DEFAULT_CFG", True, "nvfp4w2", "nvfp4wo"),
    "mxfp4": ("MXFP4_DEFAULT_CFG", True, "mxfp4w2", "mxfp4wo"),
    "fp8": ("FP8_DEFAULT_CFG", True, "fp8", "fp8"),
    "int8_weight_only": (None, False, "int8", "int8"),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_weight_only_formats_match_jax_engine(setup, fmt):
    """`EngineConfig()`'s default layouts (int4 "bd2", nvfp4 "word2"): greedy
    tokens equal to the JAX engine's, from the port's own PTQ and compress
    and from the JAX model carried across. The presets with input quantizers
    (NVFP4, MXFP4: dynamic blocks under a calibrated global amax; FP8: static
    per tensor) are calibrated on the same batch and fake-quantize the
    activations before the GEMM in both engines."""
    jcfg, pnp, prompt, _, _, _ = setup
    preset, need_calib, jkind, tkind = FORMATS[fmt]
    jq = preset or jconfig.INT8_DEFAULT_CFG.with_rules(INT8_WEIGHT_ONLY)
    tq = preset or tconfig.INT8_DEFAULT_CFG.with_rules(INT8_WEIGHT_ONLY)
    calib = np.random.default_rng(2).integers(0, jcfg.vocab_size, size=(2, 16)).astype(np.int32)
    jm = jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), jq, [jnp.asarray(calib)] if need_calib else None)
    jcm = jcompress.compress(jm)
    jeng = jengine.Engine(jcm, jengine.EngineConfig(max_seq_len=32, backend="pallas", kv_dtype=jnp.int8,
                                                    kv_attention_kernel=True))
    assert set(jeng.cm.kinds.values()) == {jkind}
    jlogits, _ = jeng.prefill(jnp.asarray(prompt), jeng.init_cache(2))
    jtoks = np.asarray(jeng.generate(jnp.asarray(prompt), 8))

    tm = tptq.quantize(tllama.LlamaConfig.tiny(**DIMS), tree_map(torch.from_numpy, pnp), tq,
                       [torch.from_numpy(calib)] if need_calib else None, device="cpu")
    if need_calib:  # the calibrated activation amax, from the port's own calibration forward
        np.testing.assert_allclose(tm.qstate["mlp.down_proj"]["input"].amax.numpy(),
                                   np.asarray(jm.qstate["mlp.down_proj"]["input"].amax), rtol=1e-5)
    for cm in (tcompress.compress(tm), convert.compressed_from_jax(jcm)):
        eng = tengine.Engine(cm, tengine.EngineConfig(max_seq_len=32, kv_dtype=torch.int8,
                                                      kv_attention_kernel=True), device="cpu")
        assert set(eng.cm.kinds.values()) == {tkind}
        _check(eng, prompt, np.asarray(jlogits), jtoks)


def test_prefill_needs_empty_cache(setup):
    _, _, prompt, jcm, _, _ = setup
    eng = _port_engine(convert.compressed_from_jax(jcm))
    cache = eng.init_cache(2)
    eng.prefill(torch.from_numpy(prompt), cache)
    with pytest.raises(ValueError):
        eng.prefill(torch.from_numpy(prompt), cache)


@pytest.mark.parametrize("plain", [(), ("flash",), ("int4_wo", "byte_wo"), tengine.PLAIN_ALL])
def test_plain_ops_picks_each_kernel(plain):
    """`plain_ops` swaps exactly the named kernels for their plain versions."""
    from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa, kv_attention, paged_attention, qmm, qmm_wo

    from tensorrt_model_optimizer_tpu_torch.ops.cuda import sparse_attention

    assert tengine.PLAIN_ALL == ("w4a8", "kv_attention", "flash", "int4_wo", "fp4_wo", "byte_wo",
                                 "paged_decode", "paged_prefill", "skip_softmax")
    kernels = (qmm.w4a8_matmul, kv_attention.kv_decode_attention, flash_gqa.flash_attention_gqa,
               qmm_wo.int4_wo_matmul, qmm_wo.fp4_wo_matmul, qmm_wo.byte_wo_matmul,
               paged_attention.paged_attention_decode, paged_attention.paged_attention_prefill,
               sparse_attention.skip_softmax_flash)
    plains = (qmm.w4a8_matmul_plain, kv_attention.kv_decode_attention_plain,
              flash_gqa.flash_attention_gqa_plain, qmm_wo.int4_wo_matmul_plain,
              qmm_wo.fp4_wo_matmul_plain, qmm_wo.byte_wo_matmul_plain,
              paged_attention.paged_attention_decode_plain, paged_attention.paged_attention_prefill_plain,
              sparse_attention.skip_softmax_flash_plain)
    want = {name: (p if name in plain else k) for name, k, p in zip(tengine.PLAIN_ALL, kernels, plains)}
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
