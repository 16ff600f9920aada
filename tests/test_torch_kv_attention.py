"""The port's KV decode attention (plain version here; the CUDA kernel on a
card) against JAX's `kv_decode_attention` Pallas kernel in interpret mode,
for the bf16, int8 and fp8 stored forms (NVFP4: test_torch_nvfp4_kv.py), including pos = 0 (only the
current token). f32 throughout; the tolerance is 1e-5 of the output's
scale, f32 rounding of sums taken in another order.

The kernel splits the rows < pos over blocks and merges them
(`csrc/kv_decode_attention.cu`); `_split_merge` repeats that in plain
PyTorch and is held against the plain version at pos 0, 1, a split boundary
+- 1 and S - 1."""

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


def _split_merge(q, k_cache, v_cache, k_new, v_new, pos, fmt, split_rows, k_scales=None, v_scales=None):
    """The kernel's algorithm: the grid's splits of `split_rows` rows cover
    the cache's S rows (the grid is sized from S, never from pos); each
    split keeps, over its rows < pos, its max m, denominator l = sum exp(s -
    m) and accumulator sum exp(s - m) v (a split wholly past pos, or empty:
    -1e30, 0, 0); the merge rescales them to the largest of
    the maxima and the current token's score, folds the token in and
    divides by max(L, 1e-30)."""
    B, HR, hd = q.shape
    n_kv = k_cache.shape[1]
    q3 = q.float().reshape(B, n_kv, HR // n_kv, hd)
    parts = []
    for r0 in range(0, tkva.n_splits(k_cache.shape[2], split_rows) * split_rows, split_rows):
        r1 = min(r0 + split_rows, pos)
        if r1 <= r0:
            parts.append((torch.full(q3.shape[:3], -1e30), torch.zeros(q3.shape[:3]), torch.zeros(q3.shape)))
            continue
        sl = slice(r0, r1)
        k = tkva.decode_rows(k_cache[:, :, sl], None if k_scales is None else k_scales[:, :, sl], fmt)
        v = tkva.decode_rows(v_cache[:, :, sl], None if v_scales is None else v_scales[:, :, sl], fmt)
        s = torch.einsum("bgrd,bgsd->bgrs", q3, k)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(dim=-1), torch.einsum("bgrs,bgsd->bgrd", p, v)))
    s_new = torch.einsum("bgrd,bgd->bgr", q3, k_new.float().reshape(B, n_kv, hd))
    M = torch.stack([m for m, _, _ in parts] + [s_new]).amax(dim=0)
    p_new = torch.exp(s_new - M)
    L = p_new.clone()
    A = p_new[..., None] * v_new.float().reshape(B, n_kv, 1, hd)
    for m, l, acc in parts:
        c = torch.exp(m - M)
        L = L + l * c
        A = A + acc * c[..., None]
    return (A / L.clamp_min(1e-30)[..., None]).reshape(B, HR, hd)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("pos", [0, 1, 15, 16, 17, S - 1])
def test_split_merge_matches_plain(fmt, pos):
    """Splits of 16 rows here (the kernel's are `SPLIT_ROWS`), so that S = 64
    holds four: pos 15, 16, 17 sit at the first boundary."""
    q, kc, vc, kn, vn = _inputs(fmt, seed=100 + pos)
    t = [convert.tensor_from_array(a) for a in (q, kc, vc, kn, vn)]
    assert tkva.n_splits(S, 16) == S // 16 and tkva.n_splits(0, 16) == 1
    out = _split_merge(*t, pos, fmt, 16)
    assert rel_err(out.numpy(), tkva.kv_decode_attention_plain(*t, pos, fmt).numpy()) < 1e-6


def _nvfp4_inputs(seed, S_):
    """NVFP4 caches: random planes and E4M3 scale bytes 2^-3 .. 2^2 (the
    codes reach 24), q scaled so that the scores are a few units."""
    g = torch.Generator().manual_seed(seed)
    planes = lambda: torch.randint(0, 256, (B, N_KV, S_, HD // 2), generator=g, dtype=torch.int32).to(torch.uint8)  # noqa: E731
    scales = lambda: (torch.randint(0, 48, (B, N_KV, S_, HD // 16), generator=g, dtype=torch.int32) + 0x20).to(torch.uint8)  # noqa: E731
    q = torch.randn((B, N_KV * REP, HD), generator=g) / (4 * math.sqrt(HD))
    return q, planes(), planes(), torch.randn((B, N_KV, 1, HD), generator=g), \
        torch.randn((B, N_KV, 1, HD), generator=g), scales(), scales()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8", "nvfp4"])
def test_kernel_at_split_edges(cuda_device, fmt):
    """A cache of 600 rows: pos 0, 1, and each side of the 256-row splits'
    boundaries; the kernel (one launch per call) against the plain version."""
    S_ = 600
    assert tkva.SPLIT_ROWS == 256
    if fmt == "nvfp4":
        q, kc, vc, kn, vn, ks, vs = (x.to(cuda_device) for x in _nvfp4_inputs(3, S_))
    else:
        rng = np.random.default_rng(3)
        q = torch.from_numpy((rng.standard_normal((B, N_KV * REP, HD)) / math.sqrt(HD)).astype(np.float32))
        x = rng.standard_normal((2, B, N_KV, S_, HD)).astype(np.float32)
        if fmt == "int8":
            kc, vc = (torch.from_numpy(np.clip(np.round(a * 40), -128, 127).astype(np.int8)) for a in x)
            q = q / 40.0
        else:
            dt = torch.bfloat16 if fmt == "bf16" else torch.float8_e4m3fn
            kc, vc = (torch.from_numpy(a * 2).to(dt) for a in x)
        kn, vn = (torch.from_numpy(rng.standard_normal((B, N_KV, 1, HD)).astype(np.float32)) for _ in range(2))
        q, kc, vc, kn, vn = (t.to(cuda_device) for t in (q, kc, vc, kn, vn))
        ks = vs = None
    for pos in (0, 1, 255, 256, 257, 511, 512, 513, S_ - 1, S_):
        n0 = tkva.launches
        out = tkva.kv_decode_attention(q, kc, vc, kn, vn, pos, fmt, ks, vs)
        torch.cuda.synchronize()
        assert tkva.launches == n0 + 1
        ref = tkva.kv_decode_attention_plain(q, kc, vc, kn, vn, pos, fmt, ks, vs)
        assert rel_err(out.cpu().numpy(), ref.cpu().numpy()) < 1e-5, pos
