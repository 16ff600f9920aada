"""The port's quantization numerics (int, fp8, the arithmetic mini-float
rounding, NVFP4 and the MX formats) are bit-exact with JAX's
(`ops/numerics.py`), on the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread cap)
from tensorrt_model_optimizer_tpu.ops import numerics as jn
from tensorrt_model_optimizer_tpu_torch.ops import numerics as tn


def _x(shape, seed=0, scale=3.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    x.flat[:4] = [0.0, 0.5, -2.5, 1e-30]  # ties and tiny values
    return x


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("num_bits,unsigned,narrow", [(8, False, False), (4, False, False),
                                                      (8, False, True), (8, True, False)])
def test_int_fake_and_real_quant(num_bits, unsigned, narrow):
    x = _x((16, 96))
    if unsigned:
        x = np.abs(x)
    amax = np.abs(x).max(axis=-1, keepdims=True)
    amax[3] = 0.0  # zero-amax guard
    args = (num_bits, unsigned, narrow)
    _eq(tn.int_scale_from_amax(torch.from_numpy(amax), *args),
        jn.int_scale_from_amax(jnp.asarray(amax), *args))
    _eq(tn.fake_quant_int(torch.from_numpy(x), torch.from_numpy(amax), *args),
        jn.fake_quant_int(jnp.asarray(x), jnp.asarray(amax), *args))
    tq, ts = tn.real_quant_int(torch.from_numpy(x), torch.from_numpy(amax), *args)
    jq, js = jn.real_quant_int(jnp.asarray(x), jnp.asarray(amax), *args)
    _eq(tq, jq)
    _eq(ts, js)


def test_cast_e4m3_and_fp8_fake_quant():
    x = _x((32, 64), scale=200.0)
    x.flat[4:8] = [1000.0, -1000.0, 448.0, 0.001953125]  # saturation and subnormals
    _eq(tn.cast_e4m3(torch.from_numpy(x)), jn.cast_e4m3(jnp.asarray(x)))
    _eq(tn.cast_e5m2(torch.from_numpy(x)), jn.cast_e5m2(jnp.asarray(x)))
    amax = np.float32(np.abs(x).max() * 0.5)
    _eq(tn.fake_quant_fp(torch.from_numpy(x), torch.tensor(amax), 4, 3),
        jn.fake_quant_fp(jnp.asarray(x), jnp.asarray(amax), 4, 3))


@pytest.mark.parametrize("shape,sizes", [((8, 256), ((-1, 128),)), ((6, 704), ((-1, 128),)),
                                         ((256, 384), ((-2, 128), (-1, 128))), ((4, 64), ((-1, 128),))])
def test_block_amax_and_expand(shape, sizes):
    x = _x(shape)
    ta = tn.block_amax_compact(torch.from_numpy(x), sizes)
    ja = jn.block_amax_compact(jnp.asarray(x), sizes)
    _eq(ta, ja)
    _eq(tn.expand_block_scale(ta, shape, sizes), jn.expand_block_scale(ja, shape, sizes))
    _eq(tn.block_reduce_amax(torch.from_numpy(x), sizes), jn.block_reduce_amax(jnp.asarray(x), sizes))


def test_int4_pack_unpack():
    q = np.random.default_rng(3).integers(-8, 8, size=(12, 64)).astype(np.int8)
    tp = tn.pack_int4(torch.from_numpy(q))
    _eq(tp, jn.pack_int4(jnp.asarray(q)))
    _eq(tn.unpack_int4(tp), jn.unpack_int4(jnp.asarray(np.asarray(tp.numpy()))))
    np.testing.assert_array_equal(tn.unpack_int4(tp).numpy(), q)


# E2M1's values, every rounding boundary (ties go to the even mantissa), both
# signs, zeros, a subnormal, and values beyond the largest magnitude
_E2M1_POINTS = [0.0, -0.0, 0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
                -0.25, -0.75, -2.5, -5.0, -6.0, 0.2500001, 0.7499999, 7.0, 100.0, -1e4, 1e-30, 1e-40]


def _x4(shape=(16, 96), seed=0, scale=3.0):
    x = _x(shape, seed, scale)
    x.flat[4:4 + len(_E2M1_POINTS)] = _E2M1_POINTS
    return x


def test_fp4_round_and_codes_all_16():
    x = _x4()
    _eq(tn.fp4_round(torch.from_numpy(x)), jn.fp4_round(jnp.asarray(x)))
    q = np.array(jn.fp4_round(jnp.asarray(x)))
    tcodes = tn.fp4_to_codes(torch.from_numpy(q))
    _eq(tcodes, jn.fp4_to_codes(jnp.asarray(q)))
    assert set(tcodes.flatten().tolist()) == set(range(16)) - {8}  # -0.0 rounds to code 0's +0
    # off-grid inputs take the nearest magnitude, the lower index on a tie
    _eq(tn.fp4_to_codes(torch.from_numpy(x)), jn.fp4_to_codes(jnp.asarray(x)))
    codes = np.arange(16, dtype=np.uint8)
    _eq(tn.codes_to_fp4(torch.from_numpy(codes)), jn.codes_to_fp4(jnp.asarray(codes)))
    _eq(tn.pack_nibbles(torch.from_numpy(codes)), jn.pack_nibbles(jnp.asarray(codes)))


@pytest.mark.parametrize("ebits,mbits", [(2, 1), (3, 2), (2, 3), (4, 3), (5, 2)])
@pytest.mark.parametrize("scale", [1.0, 2.0 ** -10, 2.0 ** 9])
def test_fp_round_normals_subnormals_saturation(ebits, mbits, scale):
    x = _x4() * np.float32(scale)
    _eq(tn.fp_round(torch.from_numpy(x), ebits, mbits), jn.fp_round(jnp.asarray(x), ebits, mbits))
    _eq(tn.fp_round(torch.from_numpy(x), ebits, mbits, saturate=False),
        jn.fp_round(jnp.asarray(x), ebits, mbits, saturate=False))
    _eq(tn.fp_cast(torch.from_numpy(x), ebits, mbits), jn.fp_cast(jnp.asarray(x), ebits, mbits))


@pytest.mark.parametrize("elem_emax", [2, 4, 8, 0])
def test_e8m0_scale_zero_denormal_and_huge_amax(elem_emax):
    amax = np.abs(_x((8, 32)))
    # zero and subnormal amax give 1 (XLA flushes subnormals); the largest
    # floats clamp at 2^127. An amax so small that the SCALE would be
    # subnormal is left out: XLA flushes that scale to 0 (ROADMAP queue 3).
    amax.flat[:8] = [0.0, 1e-45, 1e-39, 3e38, 1.0, 2.0 ** -100, 0.99999994, 2.0 ** 100]
    _eq(tn.e8m0_scale(torch.from_numpy(amax), elem_emax), jn.e8m0_scale(jnp.asarray(amax), elem_emax))
    assert tn.fp_emax(2, 1) == jn.fp_emax(2, 1) == 2


@pytest.mark.parametrize("global_amax", [None, 20.0, 0.0])
def test_nvfp4_scales_and_fake_quant(global_amax):
    x = _x4((12, 80))  # 80 = 5 blocks of 16
    x[5] = 0.0  # a zero block: its scale rounds to 0 and becomes 1
    tg = None if global_amax is None else torch.tensor(global_amax)
    jg = None if global_amax is None else jnp.float32(global_amax)
    _eq(tn.fake_quant_nvfp4(torch.from_numpy(x), 16, tg), jn.fake_quant_nvfp4(jnp.asarray(x), 16, jg))
    ga = np.float32(np.abs(x).max() if global_amax is None else global_amax)
    _eq(tn.nvfp4_global_scale(torch.tensor(ga)), jn.nvfp4_global_scale(jnp.asarray(ga)))
    bam = np.abs(x).reshape(12, 5, 16).max(-1)
    gs = np.array(jn.nvfp4_global_scale(jnp.asarray(ga)))
    _eq(tn.nvfp4_block_scale(torch.from_numpy(bam), torch.from_numpy(gs)),
        jn.nvfp4_block_scale(jnp.asarray(bam), jnp.asarray(gs)))


@pytest.mark.parametrize("ebits,mbits", [(2, 1), (3, 2), (2, 3), (4, 3)])
@pytest.mark.parametrize("scale,shape", [(3.0, (8, 96)), (1e-30, (8, 96)), (3.0, (6, 80))])
def test_fake_quant_mx(ebits, mbits, scale, shape):
    x = _x4(shape, scale=scale)  # (6, 80): a ragged last block of 32
    _eq(tn.fake_quant_mx(torch.from_numpy(x), ebits, mbits), jn.fake_quant_mx(jnp.asarray(x), ebits, mbits))
    _eq(tn.fake_quant_mx(torch.from_numpy(x), ebits, mbits, 16, 0),
        jn.fake_quant_mx(jnp.asarray(x), ebits, mbits, 16, 0))


@pytest.mark.parametrize("preset", ["NVFP4_DEFAULT_CFG", "MXFP4_DEFAULT_CFG"])
def test_quantizer_block_float_dispatch(preset):
    """`quantize` and max `collect` through the NVFP4 / MX branches."""
    from tensorrt_model_optimizer_tpu.quant import config as jconfig
    from tensorrt_model_optimizer_tpu.quant import quantizer as jq
    from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
    from tensorrt_model_optimizer_tpu_torch.quant import quantizer as tq

    site = "model.layers.0.mlp.up_proj.input_quantizer"
    jcfg, tcfg = jconfig.PRESETS[preset].resolve(site), tconfig.PRESETS[preset].resolve(site)
    assert tq.amax_shape(tcfg, (4, 96)) == jq.amax_shape(jcfg, (4, 96)) == ()
    x, x2 = _x4((4, 96)), _x4((4, 96), seed=1, scale=5.0)
    js = jq.collect(jnp.asarray(x2), jcfg, jq.collect(jnp.asarray(x), jcfg, jq.init_state(jcfg, (1, 96))))
    ts = tq.collect(torch.from_numpy(x2), tcfg,
                    tq.collect(torch.from_numpy(x), tcfg, tq.init_state(tcfg, (1, 96), "cpu")))
    _eq(ts.amax, js.amax)
    _eq(tq.quantize(torch.from_numpy(x), tcfg, ts), jq.quantize(jnp.asarray(x), jcfg, js))
    xb = torch.from_numpy(x).to(torch.bfloat16)  # the engine quantizes bf16 activations
    out = tq.quantize(xb, tcfg, ts)
    assert out.dtype == torch.bfloat16
    _eq(out.float(), jq.quantize(jnp.asarray(x).astype(jnp.bfloat16), jcfg, js).astype(jnp.float32))
