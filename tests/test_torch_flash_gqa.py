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
@pytest.mark.parametrize("rep,d", [(1, 64), (4, 128), (2, 32)])
def test_kernel_matches_plain(cuda_device, rep, d):
    rng = np.random.default_rng(rep)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda_device, torch.bfloat16)
               for s in ((B, HKV * rep, T, d), (B, HKV, T, d), (B, HKV, T, d)))
    out = tflash.flash_attention_gqa(q, k, v)
    torch.cuda.synchronize()
    ref = tflash.flash_attention_gqa_plain(q, k, v)
    # bf16 output: one bf16 ulp of |out| <= ~4
    assert (out.float() - ref.float()).abs().max().item() < 2e-2
