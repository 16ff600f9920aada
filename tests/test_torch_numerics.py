"""The port's int and fp8 quantization numerics are bit-exact with JAX's
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
