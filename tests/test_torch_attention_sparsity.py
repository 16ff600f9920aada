"""The port's `sparsity/attention_sparsity.py` (plain PyTorch) against the JAX
package's: the skip-softmax block mask, attention and its sparsity, the
threshold calibration, and VSA with its 3-D tile permutation. Inputs come
from a numpy seed and go to both sides; f32 throughout, so the tolerance is
1e-5 (sums taken in another order) and masks, sparsities and thresholds are
held equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_model_optimizer_tpu.sparsity import attention_sparsity as jas
from tensorrt_model_optimizer_tpu_torch.sparsity import attention_sparsity as tas


def _qkv(seed, B=2, T=32, n=2, d=16, spike=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, n, d)).astype(np.float32) for _ in range(3))
    if spike:  # a few keys dominate, so blocks do get skipped
        q[..., 0] = 4.0
        k[:, :8, :, 0] = 4.0
    return q, k, v


@pytest.mark.parametrize("threshold", [1e-6, 1e-2, 0.5])
@pytest.mark.parametrize("blocks", [(8, 8), (16, 8), (32, 32)])
def test_block_skip_mask(threshold, blocks):
    s = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(np.float32) * 3
    want = np.asarray(jas.block_skip_mask(jnp.asarray(s), threshold, *blocks))
    got = tas.block_skip_mask(torch.from_numpy(s), threshold, *blocks)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("threshold", [1e-6, 1e-2, 0.3])
def test_skip_softmax_attention(threshold, causal):
    q, k, v = _qkv(1, spike=True)
    jo, jsp = jas.skip_softmax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), threshold, causal, 8, 8)
    to, tsp = tas.skip_softmax_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), threshold,
                                         causal, 8, 8)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    assert float(tsp) == float(jsp)


def test_sparsity_grows_with_threshold():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, spike=True))
    sp = [float(tas.skip_softmax_attention(q, k, v, th, True, 8, 8)[1]) for th in (1e-9, 1e-3, 0.3)]
    assert sp[0] <= sp[1] <= sp[2] and sp[2] > 0


@pytest.mark.parametrize("target", [0.1, 0.3, 0.6])
def test_calibrate_threshold(target):
    q, k, v = _qkv(3, spike=True)
    want = jas.calibrate_threshold(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), target)
    got = tas.calibrate_threshold(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), target)
    assert got == want


@pytest.mark.parametrize("shape,block", [((4, 4, 4), (2, 2, 2)), ((2, 6, 4), (1, 3, 2)), ((3, 2, 2), (3, 1, 2))])
def test_tile_3d_indices(shape, block):
    np.testing.assert_array_equal(tas.tile_3d_indices(shape, block).numpy(),
                                  np.asarray(jas.tile_3d_indices(shape, block)))


@pytest.mark.parametrize("block_size,top_k,gate", [(8, 0.5, 0.5), (16, 0.25, 1.0), (12, 0.75, 0.0)])
def test_vsa_attention(block_size, top_k, gate):
    q, k, v = _qkv(4, T=48)
    jo, jkeep = jas.vsa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_size, top_k, gate)
    to, tkeep = tas.vsa_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), block_size,
                                  top_k, gate)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
