"""Packing and calibration parity: `compress_weight` bytes and scales are
bit-exact with JAX for every canonical pack, each of the port's own serving
layouts decompresses exactly to JAX's `decompress_weight` of the serving
kind that the same layout name gives there, and PTQ amaxes are equal."""

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
                                         ("INT8_DEFAULT_CFG", "int8"), ("FP8_DEFAULT_CFG", "fp8"),
                                         ("NVFP4_DEFAULT_CFG", "nvfp4"), ("MXFP4_DEFAULT_CFG", "mxfp4")])
@pytest.mark.parametrize("o,k", [(64, 256), (96, 704)])
def test_compress_weight_bit_exact(preset, kind, o, k):
    w = _w(o, k)
    w[3] = 0.0  # a zero row: zero block amax (the scale guards)
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


def _jax_serving(jk, ja, layout):
    """What the JAX engine serves for a canonical pack under a layout name
    (`serve/engine.py` Engine.__init__): blockdot keeps the planes, perm
    K-permutes them, the other names go through `word_convert_site`; MXFP4
    has no blockdot or perm kernel and takes the word layout there."""
    if jk == "mxfp4" and layout in ("blockdot", "perm"):
        layout = "word"
    if layout == "blockdot":
        return jk, ja
    if layout == "perm":
        arr = dict(ja)
        arr["packed"] = jqmm.permute_k(ja["packed"], -1, jqmm.nvfp4_perm_tile(ja["packed"].shape[-1]))
        for n in ("scale_lo", "scale_hi"):
            arr[n] = ja[n].astype(jnp.float32).astype(jnp.bfloat16)
        return "nvfp4p", arr
    return jc.word_convert_site(jk, ja, layout)


@pytest.mark.parametrize("preset,layouts,o,k", [
    ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", tc.INT4_LAYOUTS, 256, 2048),
    ("INT4_BLOCKWISE_WEIGHT_ONLY_CFG", tc.INT4_LAYOUTS, 64, 64),  # one short block: JAX falls back to word2
    ("NVFP4_DEFAULT_CFG", tc.FP4_LAYOUTS, 64, 256),
    ("NVFP4_DEFAULT_CFG", tc.FP4_LAYOUTS, 96, 704),  # 704 = 44 blocks of 16: the port pads rows to 768
    ("MXFP4_DEFAULT_CFG", tc.FP4_LAYOUTS, 64, 256),
    ("MXFP4_DEFAULT_CFG", tc.FP4_LAYOUTS, 96, 704),
])
def test_serving_layouts_match_jax_by_value(preset, layouts, o, k):
    """Every accepted layout name maps to the one port layout of its format,
    whose decompress equals JAX's for the kind that name gives there: the
    bf16 rounding of the int4 block scales (bd2, word, word2, a8: yes;
    blockdot: no) and the clamp of the MXFP4 exponents follow the name."""
    w = _w(o, k, seed=3)
    jk, ja = jc.compress_weight(jnp.asarray(w), _jcfg(preset), None)
    tk, ta = tc.compress_weight(torch.from_numpy(w), _tcfg(preset), None)
    port_kind = {"int4": "int4wo", "nvfp4": "nvfp4wo", "mxfp4": "mxfp4wo"}[tk]
    for layout in layouts:
        jk2, ja2 = _jax_serving(jk, ja, layout)
        tk2, ta2 = tc.word_convert_site(tk, ta, layout)
        assert tk2 == ("int4a8" if layout == "a8" else port_kind)
        np.testing.assert_array_equal(tc.decompress_weight(tk2, ta2, torch.float32).numpy(),
                                      np.asarray(jc.decompress_weight(jk2, ja2, jnp.float32)),
                                      err_msg=f"{layout}: JAX kind {jk2}")


def test_int4_wo_ragged_k_pads_with_zero_codes():
    """K = 704 (5.5 blocks): JAX's word / word2 / bd2 packs cannot take it
    (they reshape K into K // nblk = 117-wide blocks and raise) and its plane
    kernel mis-scales it, so the port is held against its own plane
    decompress, which equals JAX's."""
    w = _w(64, 704, seed=2)
    cfg = _tcfg("INT4_BLOCKWISE_WEIGHT_ONLY_CFG")
    _, ta = tc.compress_weight(torch.from_numpy(w), cfg, None)
    ref = tc.decompress_weight("int4", ta, torch.float32)
    kind, wo = tc.word_convert_site("int4", ta, "blockdot")
    assert kind == "int4wo" and wo["packed"].shape == (64, 384) and wo["scales"].shape == (6, 64)
    assert torch.equal(tc.decompress_weight(kind, wo, torch.float32), ref)
    kind, wo = tc.word_convert_site("int4", ta, "bd2")
    rel = (tc.decompress_weight(kind, wo, torch.float32) - ref).abs().max() / ref.abs().max()
    assert 0 < rel < 2.0 ** -8  # bf16 rounding of the scales only
    with pytest.raises(TypeError):  # the JAX pack at this shape
        _, ja = jc.compress_weight(jnp.asarray(w), _jcfg("INT4_BLOCKWISE_WEIGHT_ONLY_CFG"), None)
        jc.word_convert_site("int4", ja, "bd2")


def test_convert_refuses_unported_layouts():
    w = _w(64, 256)
    _, i4 = tc.compress_weight(torch.from_numpy(w), _tcfg("INT4_BLOCKWISE_WEIGHT_ONLY_CFG"), None)
    _, f4 = tc.compress_weight(torch.from_numpy(w), _tcfg("NVFP4_DEFAULT_CFG"), None)
    with pytest.raises(NotImplementedError, match="xla"):
        tc.word_convert_site("int4", i4, "xla")
    with pytest.raises(NotImplementedError, match="i8"):
        tc.word_convert_site("nvfp4", f4, "i8")
    with pytest.raises(ValueError):
        tc.word_convert_site("int4", i4, "bd4")
    with pytest.raises(ValueError):
        tc.word_convert_site("nvfp4", f4, "a8")


@pytest.mark.parametrize("preset", ["INT4_BLOCKWISE_WEIGHT_ONLY_CFG", "INT8_DEFAULT_CFG",
                                    "NVFP4_WEIGHT_ONLY_CFG", "MXFP4_WEIGHT_ONLY_CFG"])
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
    with pytest.raises(NotImplementedError, match="remaining-formats"):
        tconfig.get_preset("NF4_WEIGHT_ONLY_CFG")
    assert tconfig.get_preset("NVFP4_KV_CFG") is tconfig.NVFP4_KV_CFG  # ported with the NVFP4 KV cache
    with pytest.raises(NotImplementedError, match="remaining-formats"):
        tconfig.MXFP6_DEFAULT_CFG  # noqa: B018
    assert tconfig.get_preset("INT4_AWQ_CFG") is tconfig.INT4_AWQ_CFG  # ported with the calibration algorithms
    with pytest.raises(ValueError, match="requires calib_batches"):
        tptq.quantize(tllama.LlamaConfig.tiny(), {}, tconfig.INT4_BLOCKWISE_WEIGHT_ONLY_CFG.replace(
            algorithm="gptq"), device="cpu")
    assert set(tconfig.PRESETS) | set(tconfig.UNPORTED_PRESETS) == set(jconfig.PRESETS) | {"W4A16_NVFP4_CFG"}
    assert tq.DISABLED == tconfig.PRESETS["INT8_DEFAULT_CFG"].resolve("lm_head.weight_quantizer")
