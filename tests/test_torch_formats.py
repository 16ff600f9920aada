"""The last formats of the port against the JAX package: MXINT, NF4, MXFP6
and MXFP8 fake quant and `compress` bit for bit, and the configs' JSON form
(`config_to_dict`) equal to JAX's text for all 25 presets.

NF4_WEIGHT_ONLY_CFG is pinned to what JAX computes: its weight site is a
static int4 grid under the calibrated 64-wide block amax (the integer
`scale_bits` and its scale blocks are carried but never applied), and
`compress` packs it as INT4 at 64-blocks; `numerics.fake_quant_nf4`'s
codebook is called by no quantizer."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_model_optimizer_tpu.ops import numerics as jnum
from tensorrt_model_optimizer_tpu.ops.formats import BlockSpec as JBlock
from tensorrt_model_optimizer_tpu.quant import compress as jc
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import quantizer as jq
from tensorrt_model_optimizer_tpu_torch.ops.formats import BlockSpec as TBlock
from tensorrt_model_optimizer_tpu_torch.quant import compress as tc
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.quant import quantizer as tq

W_SITE = "model.layers.0.mlp.up_proj.weight_quantizer"
A_SITE = "model.layers.0.mlp.up_proj.input_quantizer"


def _x(shape, seed=0, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    x.flat[:6] = [0.0, -0.0, 1e-30, 3.0e4, -7.5, 2.0 ** -120]  # zeros, a subnormal-range value, large ones
    return x


def _bits(a):
    a = np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)
    return a.view(np.uint32)


def _fq_equal(jcfg, tcfg, x):
    jst = jq.collect(jnp.asarray(x), jcfg, jq.init_state(jcfg, x.shape))
    tst = tq.collect(torch.from_numpy(x), tcfg, tq.init_state(tcfg, x.shape))
    if jst.amax is not None:
        np.testing.assert_array_equal(_bits(tst.amax), _bits(jst.amax))
    np.testing.assert_array_equal(_bits(tq.quantize(torch.from_numpy(x), tcfg, tst)),
                                  _bits(jq.quantize(jnp.asarray(x), jcfg, jst)))
    return jst, tst


@pytest.mark.parametrize("bits", [8, 4, 6])
@pytest.mark.parametrize("bsz", [32, 16])
def test_mxint_fake_quant_bit_equal(bits, bsz):
    """MXINT: an int grid under an E8M0 (power-of-two) block scale."""
    jcfg = jq.QuantizerConfig(num_bits=bits, block=JBlock(sizes=((-1, bsz),), scale_bits=(8, 0), dynamic=True))
    tcfg = tq.QuantizerConfig(num_bits=bits, block=TBlock(sizes=((-1, bsz),), scale_bits=(8, 0), dynamic=True))
    for shape in ((3, 5, 128), (64, 96)):
        _fq_equal(jcfg, tcfg, _x(shape, seed=bits + bsz))


@pytest.mark.parametrize("preset", ["MXFP6_DEFAULT_CFG", "MXFP8_DEFAULT_CFG", "NF4_WEIGHT_ONLY_CFG"])
def test_new_presets_fake_quant_bit_equal(preset):
    for site, shape in ((W_SITE, (96, 256)), (A_SITE, (2, 7, 256))):
        jcfg, tcfg = jconfig.PRESETS[preset].resolve(site), tconfig.PRESETS[preset].resolve(site)
        if jcfg.enable:
            _fq_equal(jcfg, tcfg, _x(shape, seed=len(shape)))


def test_nf4_is_int4_at_64_blocks_as_jax_computes_it():
    w = _x((64, 256), seed=4)
    jcfg = jconfig.PRESETS["NF4_WEIGHT_ONLY_CFG"].resolve(W_SITE)
    jst, tst = _fq_equal(jcfg, tconfig.PRESETS["NF4_WEIGHT_ONLY_CFG"].resolve(W_SITE), w)
    assert tuple(tst.amax.shape) == (64, 4)  # one amax per 64-wide block
    jax_q = np.asarray(jq.quantize(jnp.asarray(w), jcfg, jst))
    int4_64 = np.asarray(jnum.fake_quant_int(jnp.asarray(w), jnum.expand_block_scale(jst.amax, w.shape, ((-1, 64),)), 4))
    np.testing.assert_array_equal(jax_q, int4_64)
    assert not np.array_equal(jax_q, np.asarray(jnum.fake_quant_nf4(jnp.asarray(w), 64)))


@pytest.mark.parametrize("preset", ["NF4_WEIGHT_ONLY_CFG", "MXFP6_DEFAULT_CFG", "MXFP8_DEFAULT_CFG"])
def test_compress_bit_equal(preset):
    """NF4 reaches JAX's INT4 branch at 64-blocks; MXFP6 / MXFP8 store
    their fake-quantized weights in bf16."""
    w = _x((96, 320), seed=9, scale=0.05)
    jcfg, tcfg = jconfig.PRESETS[preset].resolve(W_SITE), tconfig.PRESETS[preset].resolve(W_SITE)
    jst = jq.collect(jnp.asarray(w), jcfg, jq.init_state(jcfg, w.shape))
    tst = tq.collect(torch.from_numpy(w), tcfg, tq.init_state(tcfg, w.shape))
    jk, ja = jc.compress_weight(jnp.asarray(w), jcfg, jst)
    tk, ta = tc.compress_weight(torch.from_numpy(w), tcfg, tst)
    assert tk == jk == ("int4" if preset.startswith("NF4") else "bf16")
    assert set(ta) == set(ja)
    for k in ja:
        a, b = np.asarray(ja[k]), ta[k]
        if b.dtype == torch.bfloat16:
            np.testing.assert_array_equal(b.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    if preset.startswith("NF4"):
        assert ta["scale_lo"].shape == (48, 5)  # 64-wide blocks over K = 320


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_config_json_equals_jax(name):
    jtext = json.dumps(jconfig.config_to_dict(jconfig.PRESETS[name]))
    ttext = json.dumps(tconfig.config_to_dict(tconfig.PRESETS[name]))
    assert ttext == jtext
    back = tconfig.config_from_dict(json.loads(ttext))
    assert back == tconfig.PRESETS[name]
    for site, cfg in tconfig.PRESETS[name].rules:
        assert tconfig.quantizer_cfg_from_dict(tconfig.quantizer_cfg_to_dict(cfg)) == cfg


def test_every_jax_preset_is_served():
    assert list(tconfig.PRESETS) == list(jconfig.PRESETS) and len(tconfig.PRESETS) == 25
    assert tconfig.UNPORTED_PRESETS == {}
    for name in jconfig.PRESETS:
        assert tconfig.get_preset(name) is tconfig.PRESETS[name]
    assert tconfig.W4A16_NVFP4_CFG is tconfig.NVFP4_WEIGHT_ONLY_CFG  # an alias, as in JAX
