"""The port's causal GQA flash attention (plain version here; the CUDA
kernel on a card) against JAX's `flash_attention_gqa` Pallas kernel in
interpret mode, for rep in {1, 4} and a T (72) that is not a multiple of
the port kernel's 64-row tile. f32, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.ops.pallas import flash_gqa as jflash
from tensorrt_model_optimizer_tpu_torch.ops.cuda import flash_gqa as tflash

B, HKV, T, D = 2, 2, 72, 64


def _inputs(rep, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, HKV * rep, T, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, T, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, T, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("rep", [1, 4])
def test_plain_matches_pallas(rep):
    q, k, v = _inputs(rep, seed=rep)
    ref = np.asarray(jflash.flash_attention_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                causal=True, block_q=32, block_k=32, interpret=True))
    out = tflash.flash_attention_gqa(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_causal_rows_ignore_later_keys():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, seed=3))
    base = tflash.flash_attention_gqa(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] = 9.0
    v2[:, :, 40:] = -9.0
    out = tflash.flash_attention_gqa(q, k2, v2)
    assert torch.equal(out[:, :, :40], base[:, :, :40])


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True], ids=["contiguous", "transposed_view"])
@pytest.mark.parametrize("t", [T, 1, 63, 130, 1000])
@pytest.mark.parametrize("rep,d", [(1, 64), (4, 128), (2, 32)])
def test_kernel_matches_plain(cuda_device, rep, d, t, view):
    """The tensor-core kernel against its plain version on the card, causal
    and not, at ragged T (none a multiple of the 128-row q tile but 1000's
    k tiles) and with q as the engine passes it (`view`: a [B, T, H, d]
    tensor seen as [B, H, T, d], read in place; the output keeps q's
    layout). Held per element to 2^-8 |ref| + 1e-3 rms(ref) of the plain
    version's f32 result (the output's bf16 rounding and f32 sums in
    another order), and to the bf16 plain version within 2e-2."""
    rng = np.random.default_rng(rep + t)
    shape_q = (B, t, HKV * rep, d) if view else (B, HKV * rep, t, d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device, torch.bfloat16)
               for s in (shape_q, (B, HKV, t, d), (B, HKV, t, d)))
    if view:
        q = q.transpose(1, 2)
    for causal in (True, False):
        n0 = tflash.launches
        out = tflash.flash_attention_gqa(q, k, v, causal)
        torch.cuda.synchronize()
        assert tflash.launches == n0 + 1 and out.stride() == q.stride()
        ref = tflash.flash_attention_gqa_plain(q, k, v, causal)
        # bf16 output: one bf16 ulp of |out| <= ~4
        assert (out.float() - ref.float()).abs().max().item() < 2e-2
        ref32 = tflash.flash_attention_gqa_plain(q.float(), k.float(), v.float(), causal)
        assert bool(((out.float() - ref32).abs() <= 2.0 ** -8 * ref32.abs()
                     + 1e-3 * ref32.square().mean().sqrt()).all())
