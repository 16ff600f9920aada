"""The port's W4A8 GEMM (plain version here; the CUDA kernel on a card)
against JAX's `qmm_int4_w48` Pallas kernel in interpret mode, on the same
packed weights: the decode shape (N = 8) and the row-tiled prefill shape
(N = 1024, the kernel's gn > 1 path). Relative error <= 1e-3: both sum the
exact int32 block products in f32, in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, rel_err  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.ops.pallas import qmm as jqmm
from tensorrt_model_optimizer_tpu_torch.ops.cuda import qmm as tqmm
from tensorrt_model_optimizer_tpu_torch.quant.config import INT4_PER_BLOCK_128
from tensorrt_model_optimizer_tpu_torch.quant import compress as tc

O, K = 256, 2048


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    x8 = rng.integers(-127, 128, size=(n, K)).astype(np.int8)
    packed = rng.integers(0, 256, size=(O // 2, K), dtype=np.uint8)
    s_lo = rng.uniform(0.5, 2.0, size=(O // 2, K // 128)).astype(np.float32)
    s_hi = rng.uniform(0.5, 2.0, size=(O // 2, K // 128)).astype(np.float32)
    return x8, packed, s_lo, s_hi


@pytest.mark.parametrize("n", [8, 1024])
def test_plain_w4a8_matches_pallas_w48(n):
    x8, packed, s_lo, s_hi = _inputs(n, seed=n)
    pw, sc = jqmm.int4_w48_pack(jnp.asarray(packed), jnp.asarray(s_lo), jnp.asarray(s_hi))
    ref = np.asarray(jqmm.qmm_int4_w48(jnp.asarray(x8), pw, sc))
    a8 = tc.int4_a8_pack(torch.from_numpy(packed), torch.from_numpy(s_lo), torch.from_numpy(s_hi))
    out = tqmm.w4a8_matmul(torch.from_numpy(x8), a8["packed"], a8["scales"])
    assert out.dtype == torch.float32 and out.shape == (n, O)
    assert rel_err(out.numpy(), ref) < 1e-3


def test_plain_w4a8_ragged_k_equals_padded_dense():
    """K = 704 (5.5 blocks): the padded tail adds nothing; equal to an f64
    dense product with the bf16-rounded scales, to f32 rounding."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.standard_normal((96, 704)) * 0.05).astype(np.float32))
    _, arr = tc.compress_weight(w, INT4_PER_BLOCK_128, None)
    a8 = tc.int4_a8_pack(arr["packed"], arr["scale_lo"], arr["scale_hi"])
    x8 = torch.from_numpy(rng.integers(-127, 128, size=(5, 704)).astype(np.int8))
    out = tqmm.w4a8_matmul(x8, a8["packed"], a8["scales"])
    wd = tc.decompress_weight("int4a8", a8, torch.float32).double()
    ref = x8.double() @ wd.t()
    assert rel_err(out.numpy(), ref.numpy()) < 1e-6


def test_wrapper_rejects_bad_shapes():
    x8, packed, s_lo, s_hi = _inputs(8, seed=0)
    a8 = tc.int4_a8_pack(torch.from_numpy(packed), torch.from_numpy(s_lo), torch.from_numpy(s_hi))
    with pytest.raises(ValueError):
        tqmm.w4a8_matmul(torch.zeros((8, K + 128), dtype=torch.int8), a8["packed"], a8["scales"])
    with pytest.raises(TypeError):
        tqmm.w4a8_matmul(torch.zeros((8, K)), a8["packed"], a8["scales"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 1024])
def test_kernel_bit_exact_with_plain(cuda_device, n):
    x8, packed, s_lo, s_hi = _inputs(n, seed=n)
    a8 = tc.int4_a8_pack(torch.from_numpy(packed), torch.from_numpy(s_lo), torch.from_numpy(s_hi))
    args = (torch.from_numpy(x8).to(cuda_device), a8["packed"].to(cuda_device), a8["scales"].to(cuda_device))
    out = tqmm.w4a8_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, tqmm.w4a8_matmul_plain(*args))
