"""The port's KV decode attention (plain version here; the CUDA kernel on a
card) against JAX's `kv_decode_attention` Pallas kernel in interpret mode,
for the bf16, int8 and fp8 stored forms (NVFP4: test_torch_nvfp4_kv.py), including pos = 0 (only the
current token). f32 throughout; the tolerance is 1e-5 of the output's
scale, f32 rounding of sums taken in another order."""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, rel_err  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.ops.pallas import kv_attention as jkva
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.ops.cuda import kv_attention as tkva

B, N_KV, REP, HD, S = 2, 2, 4, 128, 64


def _inputs(fmt, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, N_KV * REP, HD)) / math.sqrt(HD)).astype(np.float32)
    if fmt == "int8":
        kc = rng.integers(-128, 128, size=(B, N_KV, S, HD)).astype(np.int8)
        vc = rng.integers(-128, 128, size=(B, N_KV, S, HD)).astype(np.int8)
        q = q / 40.0
    else:
        dt = ml_dtypes.bfloat16 if fmt == "bf16" else ml_dtypes.float8_e4m3fn
        kc = (rng.standard_normal((B, N_KV, S, HD)) * 2).astype(dt)
        vc = (rng.standard_normal((B, N_KV, S, HD)) * 2).astype(dt)
    kn = np.asarray(rng.standard_normal((B, N_KV, 1, HD)), np.float32)
    vn = np.asarray(rng.standard_normal((B, N_KV, 1, HD)), np.float32)
    return q, kc, vc, kn, vn


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("pos", [0, 37, S - 1])
def test_plain_matches_pallas(fmt, pos):
    q, kc, vc, kn, vn = _inputs(fmt, seed=pos)
    ref = np.asarray(jkva.kv_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(pos, jnp.int32), fmt, interpret=True))
    t = [convert.tensor_from_array(a) for a in (q, kc, vc, kn, vn)]
    out = tkva.kv_decode_attention(*t, pos, fmt)
    assert out.shape == (B, N_KV * REP, HD) and out.dtype == torch.float32
    assert rel_err(out.numpy(), ref) < 1e-5


def test_rows_at_and_above_pos_are_not_read():
    q, kc, vc, kn, vn = _inputs("int8", seed=1)
    t = [convert.tensor_from_array(a) for a in (q, kc, vc, kn, vn)]
    base = tkva.kv_decode_attention(*t, 20, "int8")
    t[1][:, :, 20:] = 127
    t[2][:, :, 20:] = -128
    assert torch.equal(base, tkva.kv_decode_attention(*t, 20, "int8"))


def test_unported_format_raises():
    q, kc, vc, kn, vn = _inputs("int8", seed=1)
    t = [convert.tensor_from_array(a) for a in (q, kc, vc, kn, vn)]
    with pytest.raises(NotImplementedError):
        tkva.kv_decode_attention(*t, 3, "nf4")
    with pytest.raises(ValueError):  # nvfp4 rows are hd/2 bytes with block-scale arrays
        tkva.kv_decode_attention(*t, 3, "nvfp4")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
def test_kernel_matches_plain(cuda_device, fmt):
    q, kc, vc, kn, vn = _inputs(fmt, seed=7)
    t = [convert.tensor_from_array(a, cuda_device) for a in (q, kc, vc, kn, vn)]
    out = tkva.kv_decode_attention(*t, 37, fmt)
    torch.cuda.synchronize()
    assert rel_err(out.cpu().numpy(), tkva.kv_decode_attention_plain(*t, 37, fmt).cpu().numpy()) < 1e-5
