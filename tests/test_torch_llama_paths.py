"""Llama's remaining paths in the port against the JAX package's, on tiny f32
models made from seeded numpy weights: Qwen2's attention biases, Qwen3's
per-head q/k norms, DBRX's qkv clamp and LayerNorm blocks, yarn RoPE
scaling, the cached forward (prefill then single-token steps, logits and
the cache), `forward_unrolled` (a layout per layer, with and without a
cache) and `attn_impl="flash"` (the port's plain flash version on the CPU,
JAX's grouped reference there). Tolerances: logits within 1e-5 of their
scale (f32 matmuls summed in another order; 1e-4 under a fake-quantized
INT4 layout, whose rounding ties the sums can move); rope frequencies
within 1e-6; caches within 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, rel_err, tree_map
from tensorrt_model_optimizer_tpu.models import hf_loader as jload
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.models import hf_loader as tload
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq

VARIANTS = {
    "qwen2_bias": dict(attention_bias=True),
    "qwen3_qk_norm": dict(qk_norm=True),
    "dbrx_clip_layernorm": dict(clip_qkv=0.5, norm_type="layernorm"),
    "yarn": dict(rope_scaling=jllama.RopeScaling(rope_type="yarn", factor=4.0, original_max_position_embeddings=32)),
    "flash": dict(attn_impl="flash"),
}


def _params(jcfg, seed: int) -> dict:
    """llama_params_np plus the variant's leaves (random biases and norms)."""
    p = llama_params_np(jcfg, seed)
    rng = np.random.default_rng(seed + 100)
    L = jcfg.num_hidden_layers
    if jcfg.attention_bias:
        for name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
            p["layers"][name + "__bias"] = (0.1 * rng.standard_normal((L, p["layers"][name].shape[1]))).astype(np.float32)
    if jcfg.qk_norm:
        for name in ("self_attn.q_norm", "self_attn.k_norm"):
            p["layers"][name] = (1 + 0.2 * rng.standard_normal((L, jcfg.hd))).astype(np.float32)
    return p


def _models(variant: str):
    jcfg = jllama.LlamaConfig.tiny(**VARIANTS[variant])
    pnp = _params(jcfg, seed=3)
    return jcfg, tree_map(jnp.asarray, pnp), convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(1).integers(0, 256, size=(2, 12)).astype(np.int32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant, tokens):
    jcfg, jp, tcfg, tp = _models(variant)
    assert tcfg.attn_impl == jcfg.attn_impl and tcfg.clip_qkv == jcfg.clip_qkv
    jl = np.asarray(jllama.forward(jcfg, jp, jnp.asarray(tokens))[0])
    tl = tllama.forward(tcfg, tp, torch.from_numpy(tokens))[0].numpy()
    assert rel_err(tl, jl) < 1e-5


@pytest.mark.parametrize("variant", ["qwen2_bias", "qwen3_qk_norm", "dbrx_clip_layernorm"])
def test_calibrated_fake_quant_matches_jax(variant, tokens):
    """INT4 block weights under max calibration in each package: weight
    amax equal, fake-quant logits within 1e-4."""
    jcfg, jp, tcfg, tp = _models(variant)
    jm = jptq.quantize(jcfg, jp, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", [jnp.asarray(tokens)])
    tm = tptq.quantize(tcfg, tp, "INT4_BLOCKWISE_WEIGHT_ONLY_CFG", [torch.from_numpy(tokens)], device="cpu")
    for name in tllama.PROJ_NAMES:
        np.testing.assert_array_equal(tm.qstate[name]["weight"].amax.numpy(), np.asarray(jm.qstate[name]["weight"].amax))
    jl = np.asarray(jm.forward(jnp.asarray(tokens))[0])
    assert rel_err(tm.forward(torch.from_numpy(tokens))[0].numpy(), jl) < 1e-4


def test_yarn_rope_freqs_match_jax():
    for rs in (jllama.RopeScaling(rope_type="yarn", factor=8.0, original_max_position_embeddings=4096),
               jllama.RopeScaling(rope_type="yarn", factor=40.0, beta_fast=32, beta_slow=1, truncate=False,
                                  attention_factor=1.3, original_max_position_embeddings=4096)):
        trs = convert.llama_cfg_from_jax(jllama.LlamaConfig.tiny(rope_scaling=rs)).rope_scaling
        for hd in (64, 128):
            jf, ja = jllama.rope_freqs(hd, 1e6, rs)
            tf, ta = tllama.rope_freqs(hd, 1e6, trs)
            assert rel_err(tf.numpy(), np.asarray(jf)) < 1e-6 and ta == pytest.approx(ja, rel=1e-12)


@pytest.mark.parametrize("variant", ["qwen3_qk_norm", "flash"])
def test_cached_forward_matches_jax(variant, tokens):
    """Prefill 10 tokens into a 16-row cache, then 2 single-token steps:
    logits at every step and the final cache. The flash config keeps the
    einsum under a cache, as JAX's does."""
    jcfg, jp, tcfg, tp = _models(variant)
    jc, tc = jllama.init_cache(jcfg, 2, 16), tllama.init_cache(tcfg, 2, 16, device="cpu")
    jfwd = jax.jit(lambda p, t, c: jllama.forward(jcfg, p, t, cache=c))
    for lo, hi in ((0, 10), (10, 11), (11, 12)):
        jl, _, jc = jfwd(jp, jnp.asarray(tokens[:, lo:hi]), jc)
        tl, _, tc = tllama.forward(tcfg, tp, torch.from_numpy(tokens[:, lo:hi]), cache=tc)
        assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-5
    assert int(tc["pos"]) == int(jc["pos"]) == 12
    for k in ("k", "v"):
        assert rel_err(tc[k].numpy(), np.asarray(jc[k])) < 1e-5
    # the cached logits are the uncached forward's
    full = tllama.forward(tcfg, tp, torch.from_numpy(tokens))[0][:, -1]
    assert rel_err(tl[:, -1].numpy(), full.numpy()) < 1e-5


def test_forward_unrolled_matches_jax(tokens):
    """A layout per layer (INT4 weights on layer 0, NVFP4 on layer 1, each
    calibrated on the weights alone), with and without a cache."""
    jcfg, jp, tcfg, tp = _models("qwen3_qk_norm")
    jms = [jptq.quantize(jcfg, jp, p) for p in ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "NVFP4_WEIGHT_ONLY_CFG")]
    tms = [convert.quantized_from_jax(m) for m in jms]
    jlay, tlay = [m.layout for m in jms], [m.layout for m in tms]
    jqs = [jllama.slice_layer({k: v for k, v in m.qstate.items() if not k.startswith("lm_head")}, i)
           for i, m in enumerate(jms)]
    tqs = [tllama.slice_state({k: v for k, v in m.qstate.items() if not k.startswith("lm_head")}, i)
           for i, m in enumerate(tms)]
    # jitted: JAX's unrolled forward op by op takes ~12 s here, compiled ~1 s
    jl, _ = jax.jit(lambda p, t, q: jllama.forward_unrolled(jcfg, p, t, jlay, q))(jp, jnp.asarray(tokens), jqs)
    tl, _ = tllama.forward_unrolled(tcfg, tp, torch.from_numpy(tokens), tlay, tqs)
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-4
    jc, tc = jllama.init_cache(jcfg, 2, 16), tllama.init_cache(tcfg, 2, 16, device="cpu")
    jl, _, jc = jax.jit(lambda p, t, q, c: jllama.forward_unrolled(jcfg, p, t, jlay, q, cache=c))(
        jp, jnp.asarray(tokens[:, :6]), jqs, jc)
    tl, _, tc = tllama.forward_unrolled(tcfg, tp, torch.from_numpy(tokens[:, :6]), tlay, tqs, cache=tc)
    assert rel_err(tl.numpy(), np.asarray(jl)) < 1e-4 and int(tc["pos"]) == 6
    assert rel_err(tc["k"].numpy(), np.asarray(jc["k"])) < 1e-4


def test_variant_leaves_and_configs_cross_over(tmp_path):
    """init_params makes the variants' leaves as JAX's does (zero biases,
    unit norms); the HF config flags and a yarn rope_scaling read as JAX's
    reader reads them; a checkpoint with biases and q/k norms saved by the
    port is byte-equal to JAX's, and its q/k norms load back through both
    loaders (its config says qwen3, so neither reads the biases back)."""
    tcfg = convert.llama_cfg_from_jax(jllama.LlamaConfig.tiny(attention_bias=True, qk_norm=True))
    tp = tllama.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert float(tp["layers"]["self_attn.k_proj__bias"].abs().max()) == 0.0
    assert float(tp["layers"]["self_attn.q_norm"].min()) == 1.0 and tp["layers"]["self_attn.q_norm"].shape == (2, 16)
    for d in ({"model_type": "qwen2"}, {"model_type": "qwen3"}, {"model_type": "llama", "attention_bias": True},
              {"model_type": "llama", "rope_scaling": {"rope_type": "yarn", "factor": 4.0, "beta_fast": 16,
                                                       "original_max_position_embeddings": 2048}},
              {"model_type": "llama", "rope_scaling": {"type": "yarn", "factor": 40, "mscale": 1.0,
                                                       "mscale_all_dim": 0.8}}):
        d = {"vocab_size": 256, "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
             "num_attention_heads": 4, "max_position_embeddings": 4096, **d}
        jc, tc = jload.config_from_hf(d), tload.config_from_hf(d)
        for f in dataclasses.fields(tllama.LlamaConfig):
            if f.name not in ("dtype", "rope_scaling"):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        if jc.rope_scaling is not None:
            assert dataclasses.asdict(tc.rope_scaling) == dataclasses.asdict(jc.rope_scaling)
    jcfg = jllama.LlamaConfig.tiny(attention_bias=True, qk_norm=True)
    pnp = _params(jcfg, seed=5)
    jload.save_hf_checkpoint(jcfg, tree_map(jnp.asarray, pnp), str(tmp_path / "jax"))
    tload.save_hf_checkpoint(convert.llama_cfg_from_jax(jcfg), tree_map(torch.from_numpy, pnp), str(tmp_path / "port"))
    for f in ("config.json", "model.safetensors"):
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    jc2, jp2 = jload.load_hf_checkpoint(str(tmp_path / "port"), dtype=jnp.float32)
    tc2, tp2 = tload.load_hf_checkpoint(str(tmp_path / "port"), dtype=torch.float32, device="cpu")
    assert tc2.qk_norm and tc2.attention_bias == jc2.attention_bias
    assert set(tp2["layers"]) == set(jp2["layers"])
    for name in ("self_attn.q_norm", "self_attn.k_norm"):
        np.testing.assert_array_equal(tp2["layers"][name].numpy(), np.asarray(jp2["layers"][name]))
