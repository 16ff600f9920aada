"""The tensor-core route of the port's paged prefill (`csrc/paged_attention_prefill.cu`,
`paged_attention_prefill_tc`), on the CPU where it cannot run: its premises
and its algorithm.

- Every stored form dequantizes exactly into bf16, the tiles' type: all 256
  int8 codes, every finite e4m3 byte, all 16 E2M1 codes under the 127 finite
  E4M3 scale bytes. So q . k on bf16 tiles differs from the plain f32
  product only in summation order.
- `_tc_walk` repeats the kernel's walk in plain PyTorch: 64-row q tiles that
  pack GQA (row m is token m / rep, head m % rep), 64-key K / V tiles over
  the context (each row's page from the block table, -1 read as page 0, rows
  past the context never dereferenced) and then over the chunk under the
  causal mask key <= m / rep, the online softmax in raw-score units (exp2,
  1/sqrt(hd) log2(e) in f32, -1e30 and 1e-30), P split exactly into three
  bf16 terms. It is held to 1e-6 of the output's scale against
  `paged_attention_prefill_plain` and against JAX's Pallas kernel in
  interpret mode on the same inputs (f32 sums in another order; the
  output's bf16 rounding, which the kernel adds, is not emulated).
- `prefill_route` sends bf16 q to the tensor cores and f32 q to the CUDA
  cores.

On a card (`cuda` marker) the kernel itself is held against the plain
version's f32 result per element: 2^-8 |ref| (the output's bf16 rounding)
+ 1e-3 rms(ref) (f32 sums in another order), at head_dim 32 / 64 / 128,
rep 1 / 2 / 4 / 8, pages of 8 and 16, T 1 / 5 / 64, ragged contexts with a
0, every stored form; and at pages of 12 and 128, which do not divide its
64-key tiles (each row's page is looked up on its own).
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import cuda_device, rel_err  # noqa: F401  (fixture)
from tensorrt_model_optimizer_tpu.ops import numerics as jnum
from tensorrt_model_optimizer_tpu.ops.pallas import paged_attention as jpa
from tensorrt_model_optimizer_tpu_torch import convert
from tensorrt_model_optimizer_tpu_torch.ops.cuda import paged_attention as tpa
from tensorrt_model_optimizer_tpu_torch.ops.cuda.kv_attention import decode_rows

FORMATS = ("bf16", "int8", "fp8", "nvfp4")
TILE = tpa.TC_TILE


def _exact_in_bf16(x: torch.Tensor) -> bool:
    return bool(torch.equal(x.to(torch.bfloat16).float(), x))


def test_int8_and_e4m3_codes_are_exact_in_bf16():
    codes = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    assert _exact_in_bf16(decode_rows(codes, None, "int8"))
    e4m3 = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(torch.float8_e4m3fn).float()
    finite = torch.isfinite(e4m3)
    assert int(finite.sum()) == 254  # 0x7f and 0xff are NaN
    assert _exact_in_bf16(e4m3[finite])


def test_nvfp4_codes_times_scales_are_exact_in_bf16():
    planes = torch.tensor([c | (c + 8) << 4 for c in range(8)], dtype=torch.uint8).repeat(127, 1)  # 16 codes a row
    sbytes = torch.arange(127, dtype=torch.int32).to(torch.uint8)[:, None]
    vals = decode_rows(planes, sbytes, "nvfp4")
    assert vals.shape == (127, 16) and int((vals != 0).sum()) == 126 * 14  # byte 0x00 scales by 0
    assert _exact_in_bf16(vals)


def _split3(p: torch.Tensor):
    """p (f32) -> bf16-valued hi, mid, lo with hi + mid + lo == p: the top 8
    significant bits, cut by a mask, then the next 8, then the rest."""
    def cut(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)

    hi = cut(p)
    r = p - hi
    mid = cut(r)
    return hi, mid, r - mid


def _stored_np(rng, shape, fmt):
    x = rng.standard_normal(shape).astype(np.float32)
    if fmt == "int8":
        return np.clip(np.round(x * 40), -128, 127).astype(np.int8), None
    if fmt == "nvfp4":
        planes, sbits, _ = jnum.real_quant_nvfp4_planes(jnp.asarray(x), 16, jnp.asarray(4.0, jnp.float32))
        return np.asarray(planes), np.asarray(sbits)
    return (x * 2).astype(ml_dtypes.bfloat16 if fmt == "bf16" else ml_dtypes.float8_e4m3fn), None


def _case(fmt, T, ctx, rep, page, hd=32, n_kv=2, seed=0):
    """Seeded inputs of both packages: q rounded to bf16 (the route's q) and
    kept as f32, a shuffled pool of pages for 160 rows a sequence, -1 table
    entries past each sequence's live pages."""
    rng = np.random.default_rng(seed)
    max_pages = 160 // page
    n_pages = 2 * max_pages + 1
    k, ks = _stored_np(rng, (n_pages, n_kv, page, hd), fmt)
    v, vs = _stored_np(rng, (n_pages, n_kv, page, hd), fmt)
    perm = rng.permutation(np.arange(1, n_pages))[:2 * max_pages].astype(np.int32).reshape(2, max_pages)
    live = np.arange(max_pages)[None] * page < np.asarray(ctx)[:, None]
    table = np.where(live, perm, -1).astype(np.int32)
    # q carries k's global scale, as the engine folds it: 1/127 of an amax of
    # ~4 for int8 codes, ~4/2688 for NVFP4 codes (E2M1 x E4M3 up to 2688); the
    # scores are then a few units in every format
    div = {"int8": 40.0, "nvfp4": 700.0}.get(fmt, 1.0)
    q = (rng.standard_normal((2, T, n_kv * rep, hd)) / div).astype(ml_dtypes.bfloat16).astype(np.float32)
    ck, cks = _stored_np(rng, (2, T, n_kv, hd), fmt)
    cv, cvs = _stored_np(rng, (2, T, n_kv, hd), fmt)
    kwargs = {} if ks is None else {"k_scale_pages": ks, "v_scale_pages": vs,
                                    "chunk_k_scales": cks, "chunk_v_scales": cvs}
    return (q, k, v, table, np.asarray(ctx, np.int32), ck, cv), kwargs


def _tc_walk(q, k_pages, v_pages, block_table, ctx_lens, chunk_k, chunk_v, fmt="raw", k_scale_pages=None,
             v_scale_pages=None, chunk_k_scales=None, chunk_v_scales=None, read=None):
    """The tensor-core kernel's walk, block by block, in f32 (out before its
    bf16 rounding). `read` collects the (sequence, table column) entries it
    dereferences."""
    B, T, nH, hd = q.shape
    _, n_kv, page, _ = k_pages.shape
    rep, max_pages = nH // n_kv, block_table.shape[1]
    c = np.float32(np.float32(1.0 / math.sqrt(hd)) * np.float32(math.log2(math.e)))
    out = torch.zeros((B, T, nH, hd))
    r = torch.arange(TILE)

    def bf16_tile(rows):  # stored rows -> the tile's bf16 values, exactly
        x = decode_rows(*rows, fmt)
        assert _exact_in_bf16(x)
        return x

    for b in range(B):
        ctx = min(int(ctx_lens[b]), max_pages * page)
        for g in range(n_kv):
            for M0 in range(0, T * rep, TILE):
                M = M0 + r
                t, h = M // rep, M % rep
                ok = t < T
                Q = torch.zeros((TILE, hd))
                Q[ok] = q[b, t[ok], g * rep + h[ok]].float()
                t_hi = (min(M0 + TILE, T * rep) - 1) // rep
                n_ctx = -(-ctx // TILE)
                m = torch.full((TILE,), -1e30)
                l = torch.zeros(TILE)
                o = torch.zeros((TILE, hd))
                for jt in range(n_ctx + t_hi // TILE + 1):
                    K, V = torch.zeros((TILE, hd)), torch.zeros((TILE, hd))
                    if jt < n_ctx:
                        col = jt * TILE + r
                        live = col < ctx
                        cols = (col[live] // page).tolist()
                        if read is not None:
                            read.update((b, j) for j in cols)
                        pid = block_table[b, cols].clamp_min(0).long()
                        off = col[live] % page
                        sc = (lambda s: None if s is None else s[pid, g, off])
                        K[live] = bf16_tile((k_pages[pid, g, off], sc(k_scale_pages)))
                        V[live] = bf16_tile((v_pages[pid, g, off], sc(v_scale_pages)))
                        masked = ~live[None, :].expand(TILE, TILE)
                    else:
                        col = (jt - n_ctx) * TILE + r
                        live = col < T
                        sc = (lambda s: None if s is None else s[b, col[live], g])
                        K[live] = bf16_tile((chunk_k[b, col[live], g], sc(chunk_k_scales)))
                        V[live] = bf16_tile((chunk_v[b, col[live], g], sc(chunk_v_scales)))
                        masked = (col[None, :] >= T) | (col[None, :] > t[:, None])
                    s = torch.where(masked, torch.full((), -1e30), Q @ K.T)  # raw scores
                    m_new = torch.maximum(m, s.amax(dim=1))
                    corr = torch.exp2((m - m_new) * c)
                    p = torch.exp2(s * c - (m_new * c)[:, None])
                    p = torch.where(p < 2.0 ** -126, torch.zeros(()), p)  # ex2.approx.ftz
                    assert not bool(p[masked].any())  # every row has a live key in every tile it visits
                    hi, mid, lo = _split3(p)
                    assert torch.equal(hi + mid + lo, p)
                    # below 2^-110, lo's last bits lie under bf16's smallest subnormal 2^-133
                    # (an error < 2^-133, where every row's l >= 1)
                    big = p >= 2.0 ** -110
                    assert all(_exact_in_bf16(x[big]) for x in (hi, mid, lo))
                    l = l * corr + p.sum(dim=1)
                    o = o * corr[:, None] + hi @ V + mid @ V + lo @ V
                    m = m_new
                res = o / l.clamp_min(1e-30)[:, None]
                out[b, t[ok], g * rep + h[ok]] = res[ok]
    return out


GEOMETRIES = {  # T, ctx, rep, page
    "T5_page8_ctx_37_0": (5, [37, 0], 2, 8),
    "T20_page16_rep4_two_context_tiles": (20, [100, 64], 4, 16),
    "T70_rep1_two_chunk_tiles": (70, [9, 130], 1, 8),
    "T5_page12_pages_across_tiles": (5, [100, 0], 2, 12),
    "T9_page128_one_page_two_tiles": (9, [128, 70], 4, 128),
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_tc_walk_matches_plain_and_pallas(fmt, geom):
    T, ctx, rep, page = GEOMETRIES[geom]
    args, kwargs = _case(fmt, T, ctx, rep, page, seed=T + rep)
    kind = "nvfp4" if fmt == "nvfp4" else "raw"
    t = [convert.tensor_from_array(a) for a in args]
    tkw = {k: convert.tensor_from_array(v) for k, v in kwargs.items()}
    t[0] = t[0].to(torch.bfloat16)
    read = set()
    walk = _tc_walk(*t, fmt=kind, read=read, **tkw)
    plain = tpa.paged_attention_prefill_plain(*t, fmt=kind, out_dtype=torch.float32, **tkw)
    ref = np.asarray(jpa.paged_attention_prefill(*[jnp.asarray(a) for a in args], fmt=kind, interpret=True,
                                                 **{k: jnp.asarray(v) for k, v in kwargs.items()}))
    assert walk.shape == plain.shape == ref.shape == (2, T, 2 * rep, 32)
    assert rel_err(walk.numpy(), plain.numpy()) < 1e-6
    assert rel_err(walk.numpy(), ref) < 1e-6
    live_cols = {(b, j) for b in range(2) for j in range(-(-ctx[b] // page))}
    assert read == live_cols  # every live page, and no table entry past the context


def test_prefill_route_picks_tensor_cores_for_bf16():
    assert tpa.prefill_route(torch.bfloat16, 128, 4) == "tensor_core"
    assert all(tpa.prefill_route(torch.bfloat16, hd, rep) == "tensor_core" for hd in (32, 64) for rep in (1, 2, 8))
    assert tpa.prefill_route(torch.float32, 128, 4) == "cuda_core"
    assert tpa.prefill_route(torch.float16, 128, 4) == "cuda_core"
    assert tpa.prefill_route(torch.bfloat16, 16, 4) == "cuda_core"


def _held(out, ref32):
    """Worst |out - ref| / (2^-8 |ref| + 1e-3 rms(ref)) over the elements."""
    diff = (out.float() - ref32).abs()
    return float((diff / (2.0 ** -8 * ref32.abs() + 1e-3 * ref32.square().mean().sqrt())).max())


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("rep", [1, 2, 4, 8])
def test_tc_kernel_matches_plain(cuda_device, fmt, page, hd, rep):
    kind = "nvfp4" if fmt == "nvfp4" else "raw"
    for T, ctx in ((1, [0, 77]), (5, [37, 0]), (64, [150, 64])):
        args, kwargs = _case(fmt, T, ctx, rep, page, hd=hd, seed=hd + rep + T)
        t = [convert.tensor_from_array(a, cuda_device) for a in args]
        kw = {k: convert.tensor_from_array(v, cuda_device) for k, v in kwargs.items()}
        t[0] = t[0].to(torch.bfloat16)
        assert tpa.prefill_route(t[0].dtype, hd, rep) == "tensor_core"
        n0 = dict(tpa.prefill_route_launches)
        out = tpa.paged_attention_prefill(*t, fmt=kind, **kw)
        torch.cuda.synchronize()
        assert tpa.prefill_route_launches == {"tensor_core": n0["tensor_core"] + 1, "cuda_core": n0["cuda_core"]}
        assert out.dtype == torch.bfloat16 and out.shape == t[0].shape
        ref32 = tpa.paged_attention_prefill_plain(*t, fmt=kind, out_dtype=torch.float32, **kw)
        worst = _held(out, ref32)
        assert worst <= 1.0, (T, ctx, worst)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("page", [12, 128])
@pytest.mark.parametrize("hd,rep", [(32, 2), (128, 4)])
def test_tc_kernel_takes_pages_that_do_not_divide_its_tiles(cuda_device, fmt, page, hd, rep):
    kind = "nvfp4" if fmt == "nvfp4" else "raw"
    for T, ctx in ((5, [100, 0]), (64, [128, 70])):
        args, kwargs = _case(fmt, T, ctx, rep, page, hd=hd, seed=page + hd + T)
        t = [convert.tensor_from_array(a, cuda_device) for a in args]
        kw = {k: convert.tensor_from_array(v, cuda_device) for k, v in kwargs.items()}
        t[0] = t[0].to(torch.bfloat16)
        n0 = dict(tpa.prefill_route_launches)
        out = tpa.paged_attention_prefill(*t, fmt=kind, **kw)
        torch.cuda.synchronize()
        assert tpa.prefill_route_launches == {"tensor_core": n0["tensor_core"] + 1, "cuda_core": n0["cuda_core"]}
        ref32 = tpa.paged_attention_prefill_plain(*t, fmt=kind, out_dtype=torch.float32, **kw)
        worst = _held(out, ref32)
        assert worst <= 1.0, (T, ctx, worst)
