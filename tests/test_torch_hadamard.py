"""The port's Hadamard rotation (`ops/hadamard.py`, the quantizer's
`rotate` option) against the JAX package's: `fwht` and `blocked_fwht`
within 1e-6 of the input's scale (f32 butterflies in the same order), the
rotated quantizer's collect and fake quant within the same, and the product
identity (xH)(WH)^T = xW^T that makes rotating the weight's input dim too
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_model_optimizer_tpu.ops import hadamard as jh
from tensorrt_model_optimizer_tpu.quant import config as jconfig
from tensorrt_model_optimizer_tpu.quant import quantizer as jq
from tensorrt_model_optimizer_tpu_torch.ops import hadamard as th
from tensorrt_model_optimizer_tpu_torch.quant import config as tconfig
from tensorrt_model_optimizer_tpu_torch.quant import quantizer as tq


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(a, b, tol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("shape,axis", [((4, 64), -1), ((3, 128, 5), 1), ((2, 1024), -1), ((1,), 0)])
def test_fwht_matches_jax(shape, axis):
    x = _x(shape)
    _close(th.fwht(torch.from_numpy(x), axis).numpy(), jh.fwht(jnp.asarray(x), axis))


@pytest.mark.parametrize("n", [704, 96, 14336, 256, 6])
def test_blocked_fwht_matches_jax(n):
    x = _x((3, n), seed=n)
    _close(th.blocked_fwht(torch.from_numpy(x)).numpy(), jh.blocked_fwht(jnp.asarray(x)))
    assert th.largest_pow2_divisor(n) == jh.largest_pow2_divisor(n)


def test_fwht_refuses_a_dim_that_is_not_a_power_of_two():
    with pytest.raises(ValueError):
        th.fwht(torch.zeros(3, 6))


def test_rotation_is_orthonormal_and_keeps_the_product():
    x, w = torch.from_numpy(_x((5, 256))).double(), torch.from_numpy(_x((32, 256), 1)).double()
    assert torch.allclose(th.fwht(th.fwht(x)), x, atol=1e-12)
    assert torch.allclose(th.blocked_fwht(x) @ th.blocked_fwht(w).t(), x @ w.t(), atol=1e-10)


@pytest.mark.parametrize("unit", ["INT8_PER_TENSOR", "INT4_PER_BLOCK_128", "FP8_PER_TENSOR", "NVFP4_BLOCK16",
                                  "INT8_PER_TOKEN_DYNAMIC"])
def test_rotated_quantizer_matches_jax(unit):
    """Collect then quantize through a rotated site, the activation's [B, T,
    K] and the weight's [O, K] (its input dim rotated): the amax and the
    fake-quant values within 1e-6 of their scale."""
    jcfg = getattr(jconfig, unit).replace(rotate=True)
    tcfg = getattr(tconfig, unit).replace(rotate=True)
    for shape in ((2, 8, 256), (64, 256)):
        x = _x(shape, seed=len(shape))
        jst = jq.collect(jnp.asarray(x), jcfg, jq.init_state(jcfg, x.shape))
        tst = tq.collect(torch.from_numpy(x), tcfg, tq.init_state(tcfg, x.shape))
        if jst.amax is not None:
            _close(tst.amax.numpy(), jst.amax)
        _close(tq.quantize(torch.from_numpy(x), tcfg, tst).numpy(), jq.quantize(jnp.asarray(x), jcfg, jst))
