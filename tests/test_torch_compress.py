"""Packing and calibration parity: `compress_weight("int4")` bytes and
scales are bit-exact with JAX, the port's own W4A8 layout decompresses to
JAX's `decompress_weight("int4w48")` values, and PTQ amaxes are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import llama_params_np, tree_map
from tensorrt_model_optimizer_tpu.models import llama as jllama
from tensorrt_model_optimizer_tpu.ops.pallas import qmm as jqmm
from tensorrt_model_optimizer_tpu.quant import compress as jc
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import ptq as jptq
from tensorrt_model_optimizer_tpu_torch.models import llama as tllama
from tensorrt_model_optimizer_tpu_torch.quant import compress as tc
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.quant import ptq as tptq
from tensorrt_model_optimizer_tpu_torch.quant import quantizer as tq


def _w(o, k, seed=0):
    return (np.random.default_rng(seed).standard_normal((o, k)) * 0.05).astype(np.float32)


def _bits(a):
    """Array or tensor -> numpy, fp8 as its uint8 bit pattern."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


def _jcfg(name):
    return jconfig.PRESETS[name].resolve("model.layers.0.mlp.up_proj.weight_quantizer")


def _tcfg(name):
    return tconfig.PRESETS[name].resolve("model.layers.0.mlp.up_proj.weight_quantizer")


@pytest.mark.parametrize("preset,kind", [("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "int4"),
                                         ("INT8_DEFAULT_CFG", "int8"), ("FP8_DEFAULT_CFG", "fp8")])
@pytest.mark.parametrize("o,k", [(64, 256), (96, 704)])
def test_compress_weight_bit_exact(preset, kind, o, k):
    w = _w(o, k)
    jk, ja = jc.compress_weight(jnp.asarray(w), _jcfg(preset), None)
    tk, ta = tc.compress_weight(torch.from_numpy(w), _tcfg(preset), None)
    assert jk == tk == kind
    assert set(ja) == set(ta)
    for name in ja:
        np.testing.assert_array_equal(_bits(ta[name]), _bits(ja[name]))
    np.testing.assert_array_equal(
        tc.decompress_weight(kind, ta, torch.float32).numpy(),
        np.asarray(jc.decompress_weight(kind, ja, jnp.float32)))


@pytest.mark.parametrize("o,k", [(256, 2048), (64, 128), (128, 384)])
def test_a8_layout_matches_jax_w48_by_value(o, k):
    w = _w(o, k, seed=1)
    _, ja = jc.compress_weight(jnp.asarray(w), _jcfg("INT4_BLOCKWISE_WEIGHT_ONLY_CFG"), None)
    assert jqmm.w48_supported(o, 128)
    pw, sc = jqmm.int4_w48_pack(ja["packed"], ja["scale_lo"], ja["scale_hi"])
    jw = np.asarray(jc.decompress_weight("int4w48", {"packed": pw, "scales": sc}, jnp.float32))
    ta = tc.int4_a8_pack(*(torch.from_numpy(np.array(ja[n])) for n in ("packed", "scale_lo", "scale_hi")))
    assert ta["packed"].shape == (o, k // 2) and ta["scales"].shape == (k // 128, o)
    np.testing.assert_array_equal(tc.decompress_weight("int4a8", ta, torch.float32).numpy(), jw)


def test_a8_layout_ragged_k_pads_with_zero_codes():
    w = _w(64, 704, seed=2)  # 5.5 blocks: JAX's w48 cannot take it, the port pads
    _, ta = tc.compress_weight(torch.from_numpy(w), _tcfg("INT4_BLOCKWISE_WEIGHT_ONLY_CFG"), None)
    a8 = tc.int4_a8_pack(ta["packed"], ta["scale_lo"], ta["scale_hi"])
    assert a8["packed"].shape == (64, 384) and a8["in_features"] == 704
    assert not tc.int4_a8_codes(a8["packed"])[:, 704:].any()
    # equal to the plane decompress up to the bf16 rounding of the scales
    ref = tc.decompress_weight("int4", ta, torch.float32)
    rel = (tc.decompress_weight("int4a8", a8, torch.float32) - ref).abs().max() / ref.abs().max()
    assert rel < 1e-2  # bf16 scale rounding only


@pytest.mark.parametrize("preset", ["INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "INT8_DEFAULT_CFG"])
def test_ptq_weights_only_amax_equal(preset):
    jcfg = jllama.LlamaConfig.tiny(hidden_size=128, intermediate_size=256)
    tcfg = tllama.LlamaConfig.tiny(hidden_size=128, intermediate_size=256)
    pnp = llama_params_np(jcfg, seed=4)
    jm = jptq.quantize(jcfg, tree_map(jnp.asarray, pnp), preset)
    tm = tptq.quantize(tcfg, tree_map(torch.from_numpy, pnp), preset, device="cpu")
    for name in tllama.PROJ_NAMES:
        np.testing.assert_array_equal(tm.qstate[name]["weight"].amax.numpy(),
                                      np.asarray(jm.qstate[name]["weight"].amax))


def test_unported_presets_raise():
    with pytest.raises(NotImplementedError, match="NVFP4"):
        tconfig.get_preset("NVFP4_DEFAULT_CFG")
    with pytest.raises(NotImplementedError, match="calibration-algorithms"):
        tconfig.INT4_AWQ_CFG  # noqa: B018
    with pytest.raises(NotImplementedError):
        tptq.quantize(tllama.LlamaConfig.tiny(), {}, tconfig.INT4_BLOCKWISE_WEIGHT_ONLY_CFG.replace(
            algorithm="mse"), device="cpu")
    assert set(tconfig.PRESETS) | set(tconfig.UNPORTED_PRESETS) == set(jconfig.PRESETS) | {"W4A16_NVFP4_CFG"}
    assert tq.DISABLED == tconfig.PRESETS["INT8_DEFAULT_CFG"].resolve("lm_head.weight_quantizer")
