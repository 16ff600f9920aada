"""The port's paged-attention functions (plain versions here; the CUDA
kernels on a card) against JAX's `paged_attention_decode` and
`paged_attention_prefill` Pallas kernels in interpret mode, for bf16, int8,
fp8 and NVFP4 pages. Inputs come from a numpy seed and go to both sides.

f32 queries: the tolerance is 1e-5 of the output's scale, f32 rounding of
sums taken in another order; on the card, NVFP4 pages add a limit from the
scores' f32 rounding (`_f32_score_limit`: their scores reach ~1e3 here).
bf16 queries: both sides compute in f32 and round the result to bf16 once,
so they may land one bf16 ulp apart (2^-7 of a value, since the ulp is
relative to the next lower power of two)."""

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
PAGE, N_PAGES, MAX_P = 16, 12, 4
TABLE = np.asarray([[3, 5, 7, 9], [2, 4, 6, 8]], np.int32)


def _stored(rng, shape, fmt):
    """Random rows in stored form: (rows, block-scale bytes or None)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if fmt == "int8":
        return np.clip(np.round(x * 40), -128, 127).astype(np.int8), None
    if fmt == "nvfp4":
        planes, sbits, _ = jnum.real_quant_nvfp4_planes(jnp.asarray(x), 16, jnp.asarray(4.0, jnp.float32))
        return np.asarray(planes), np.asarray(sbits)
    return (x * 2).astype(ml_dtypes.bfloat16 if fmt == "bf16" else ml_dtypes.float8_e4m3fn), None


def _pool(fmt, seed, n_kv, hd, page=PAGE):
    rng = np.random.default_rng(seed)
    k, ks = _stored(rng, (N_PAGES, n_kv, page, hd), fmt)
    v, vs = _stored(rng, (N_PAGES, n_kv, page, hd), fmt)
    return rng, k, v, ks, vs


def _both(fn_j, fn_t, args, kwargs, fmt):
    """The JAX function and the port's on the same numpy inputs."""
    jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
    tkw = {k: convert.tensor_from_array(v) for k, v in kwargs.items()}
    kind = "nvfp4" if fmt == "nvfp4" else "raw"
    ref = fn_j(*[jnp.asarray(a) for a in args], fmt=kind, interpret=True, **jkw)
    out = fn_t(*[convert.tensor_from_array(a) for a in args], fmt=kind, **tkw)
    return out, np.asarray(ref)


def _decode_case(fmt, lens, n_kv=2, rep=4, hd=32, seed=0, qdtype=np.float32):
    rng, k, v, ks, vs = _pool(fmt, seed, n_kv, hd)
    q = (rng.standard_normal((2, n_kv * rep, hd)) / (40.0 if fmt == "int8" else 1.0)).astype(qdtype)
    kwargs = {} if ks is None else {"k_scale_pages": ks, "v_scale_pages": vs}
    return (q, k, v, TABLE, np.asarray(lens, np.int32)), kwargs


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("lens", [[33, 7], [16, 64], [0, 1]], ids=str)
def test_decode_plain_matches_pallas(fmt, lens):
    args, kwargs = _decode_case(fmt, lens)
    out, ref = _both(jpa.paged_attention_decode, tpa.paged_attention_decode, args, kwargs, fmt)
    assert out.shape == (2, 8, 32) and out.dtype == torch.float32
    assert rel_err(out.numpy(), ref) < 1e-5
    if lens[0] == 0:  # no live row: exactly 0, as the reference gives
        assert not out[0].any() and not ref[0].any()


@pytest.mark.parametrize("fmt", ["int8", "nvfp4"])
def test_decode_without_gqa_sharing(fmt):
    args, kwargs = _decode_case(fmt, [40, 9], n_kv=4, rep=1, hd=64, seed=3)
    out, ref = _both(jpa.paged_attention_decode, tpa.paged_attention_decode, args, kwargs, fmt)
    assert rel_err(out.numpy(), ref) < 1e-5


def test_decode_bf16_queries_round_once():
    args, kwargs = _decode_case("bf16", [33, 7], qdtype=ml_dtypes.bfloat16)
    out, ref = _both(jpa.paged_attention_decode, tpa.paged_attention_decode, args, kwargs, "bf16")
    assert out.dtype == torch.bfloat16 and ref.dtype == ml_dtypes.bfloat16
    ref = ref.astype(np.float32)
    assert np.all(np.abs(out.float().numpy() - ref) <= 2.0 ** -7 * np.abs(ref) + 1e-30)


def _prefill_case(fmt, T, ctx, n_kv=2, rep=2, hd=32, seed=1):
    rng, k, v, ks, vs = _pool(fmt, seed, n_kv, hd, page=8)
    q = (rng.standard_normal((2, T, n_kv * rep, hd)) / (40.0 if fmt == "int8" else 1.0)).astype(np.float32)
    ck, cks = _stored(rng, (2, T, n_kv, hd), fmt)
    cv, cvs = _stored(rng, (2, T, n_kv, hd), fmt)
    kwargs = {} if ks is None else {"k_scale_pages": ks, "v_scale_pages": vs,
                                    "chunk_k_scales": cks, "chunk_v_scales": cvs}
    return (q, k, v, TABLE, np.asarray(ctx, np.int32), ck, cv), kwargs


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("T,ctx", [(4, [0, 0]), (5, [13, 5]), (8, [32, 1])], ids=str)
def test_prefill_plain_matches_pallas(fmt, T, ctx):
    args, kwargs = _prefill_case(fmt, T, ctx)
    out, ref = _both(jpa.paged_attention_prefill, tpa.paged_attention_prefill, args, kwargs, fmt)
    assert out.shape == (2, T, 4, 32) and out.dtype == torch.float32
    assert rel_err(out.numpy(), ref) < 1e-5


def test_rows_past_the_lengths_are_not_read():
    """Table entries past the live pages, and rows past the length inside
    the last live page, do not reach the result; the chunk's rows come from
    the chunk arguments, not from the pages."""
    args, _ = _decode_case("int8", [19, 7])
    t = [convert.tensor_from_array(a) for a in args]
    base = tpa.paged_attention_decode(*t)
    t[3][0, 2:] = -1   # sequence 0 lives in pages 3 and 5
    t[3][1, 1:] = 11
    t[1][5, :, 3:] = 127  # page 5 holds rows 16..18 of sequence 0
    t[2][7] = -128
    assert torch.equal(base, tpa.paged_attention_decode(*t))
    args, _ = _prefill_case("int8", 4, [9, 0])
    t = [convert.tensor_from_array(a) for a in args]
    base = tpa.paged_attention_prefill(*t)
    t[1][5, :, 1:] = 127  # past row 9 of sequence 0 (pages of 8 rows)
    t[2][2] = -128        # sequence 1 has no context
    assert torch.equal(base, tpa.paged_attention_prefill(*t))


def test_wrappers_reject_what_they_do_not_take():
    args, _ = _decode_case("int8", [19, 7])
    t = [convert.tensor_from_array(a) for a in args]
    with pytest.raises(ValueError):
        tpa.paged_attention_decode(*t, fmt="fp4")
    with pytest.raises(ValueError):  # nvfp4 pages are hd/2 bytes wide and come with scale pools
        tpa.paged_attention_decode(*t, fmt="nvfp4")
    with pytest.raises(ValueError):
        tpa.paged_attention_decode(t[0][:, :7], *t[1:])
    args, _ = _prefill_case("int8", 4, [9, 0])
    t = [convert.tensor_from_array(a) for a in args]
    with pytest.raises(ValueError):
        tpa.paged_attention_prefill(*t[:5], t[5][:, :3], t[6])


def _to(dev, args, kwargs):
    return [convert.tensor_from_array(a, dev) for a in args], {k: convert.tensor_from_array(v, dev)
                                                               for k, v in kwargs.items()}


# NVFP4 rows decode to E2M1 codes times E4M3 block scales (up to 6 x 448),
# and `_stored` quantizes N(0, 1) rows under a global amax of 4, so decoded
# k / v reach ~2e3 and the scores q.k / sqrt(hd) reach ~1e3 here, where the
# other formats' scores are a few units. The kernels decode exactly as the
# plain versions do (chip_smoke.py holds all 16 codes x 127 scale bytes
# bit-equal through the three KV kernels); they sum q.k over a warp's
# shuffle tree, where the plain version takes an einsum, and multiply by
# 1/sqrt(hd) where it divides. Two f32 evaluations of a score s_j then
# differ by up to ds_j = 2 (hd + 1) 2^-24 sum_d |q_d k_jd| / sqrt(hd): the
# sums' length and magnitude. exp turns that into the same relative change
# of p_j, so an output moves by up to max_j ds_j sum_j p_j |v_jd - out_d|
# (first order): the limit below, beside the 1e-5 of the output's scale the
# other formats are held to (f32 rounding of the p.v sums). On this data
# the plain f32 version itself lies up to 1.8e-5 of the scale from an f64
# evaluation of the same decoded rows.
def _f32_score_limit(q, k, v, live):
    """Per output element, the limit above. q [B, G, R, hd], k / v [B, G, S,
    hd] (decoded), live [B, 1, R, S]; evaluated in f64."""
    hd = q.shape[-1]
    q, k, v = q.double(), k.double(), v.double()
    s = torch.where(live, q @ k.transpose(-1, -2) / np.sqrt(hd), torch.full((), -1e30, dtype=torch.float64))
    p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), torch.zeros((), dtype=torch.float64))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = p @ v
    s_abs = torch.where(live, q.abs() @ k.abs().transpose(-1, -2), torch.zeros((), dtype=torch.float64))
    ds = 2 * (hd + 1) * 2.0 ** -24 * s_abs.amax(-1, keepdim=True) / np.sqrt(hd)
    return ds * torch.einsum("bgrs,bgrsd->bgrd", p, (v[:, :, None] - out[:, :, :, None]).abs())


def _within_f32_score_limit(out, ref, limit):
    out, ref = out.double().cpu(), ref.double().cpu()
    assert bool(((out - ref).abs() <= 1e-5 * ref.abs().max() + limit.cpu()).all())


def _nvfp4_decode_limit(q, k_pages, v_pages, block_table, seq_lens, k_scale_pages, v_scale_pages):
    B, nH, hd = q.shape
    bt = block_table.clamp_min(0).long()
    k, v = tpa._gather(k_pages, k_scale_pages, bt, "nvfp4"), tpa._gather(v_pages, v_scale_pages, bt, "nvfp4")
    live = (torch.arange(k.shape[2], device=q.device)[None] < seq_lens[:, None])[:, None, None, :]
    return _f32_score_limit(q.reshape(B, k.shape[1], -1, hd), k, v, live).reshape(B, nH, hd)


def _nvfp4_prefill_limit(q, k_pages, v_pages, block_table, ctx_lens, chunk_k, chunk_v, k_scale_pages,
                         v_scale_pages, chunk_k_scales, chunk_v_scales):
    B, T, nH, hd = q.shape
    bt = block_table.clamp_min(0).long()
    k = torch.cat([tpa._gather(k_pages, k_scale_pages, bt, "nvfp4"),
                   decode_rows(chunk_k, chunk_k_scales, "nvfp4").transpose(1, 2)], dim=2)
    v = torch.cat([tpa._gather(v_pages, v_scale_pages, bt, "nvfp4"),
                   decode_rows(chunk_v, chunk_v_scales, "nvfp4").transpose(1, 2)], dim=2)
    n_kv, S = k.shape[1], k.shape[2] - T
    rep = nH // n_kv
    t = torch.arange(T, device=q.device)
    live = torch.cat([(torch.arange(S, device=q.device)[None] < ctx_lens[:, None])[:, None, :].expand(B, T, S),
                      (t[None, :] <= t[:, None])[None].expand(B, T, T)], dim=-1)
    live = live[:, None].expand(B, rep, T, S + T).reshape(B, 1, rep * T, S + T)
    q5 = q.reshape(B, T, n_kv, rep, hd).permute(0, 2, 3, 1, 4).reshape(B, n_kv, rep * T, hd)
    lim = _f32_score_limit(q5, k, v, live).reshape(B, n_kv, rep, T, hd)
    return lim.permute(0, 3, 1, 2, 4).reshape(B, T, nH, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("hd,rep", [(32, 4), (64, 2), (128, 4), (128, 1)])
def test_decode_kernel_matches_plain(cuda_device, fmt, hd, rep):
    for lens in ([33, 7], [64, 0], [1, 17]):
        args, kwargs = _decode_case(fmt, lens, n_kv=2, rep=rep, hd=hd, seed=hd + rep)
        t, kw = _to(cuda_device, args, kwargs)
        kind = "nvfp4" if fmt == "nvfp4" else "raw"
        out = tpa.paged_attention_decode(*t, fmt=kind, **kw)
        torch.cuda.synchronize()
        ref = tpa.paged_attention_decode_plain(*t, fmt=kind, **kw)
        if fmt == "nvfp4":
            _within_f32_score_limit(out, ref, _nvfp4_decode_limit(*t, **kw))
        else:
            assert rel_err(out.cpu().numpy(), ref.cpu().numpy()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("hd,rep", [(32, 2), (64, 4), (128, 4)])
def test_prefill_kernel_matches_plain(cuda_device, fmt, hd, rep):
    """f32 q: the CUDA-core route (the tensor-core route's cases are in
    test_torch_paged_prefill_tc.py)."""
    for T, ctx in ((4, [0, 0]), (5, [13, 5]), (19, [32, 1])):
        args, kwargs = _prefill_case(fmt, T, ctx, n_kv=2, rep=rep, hd=hd, seed=hd + T)
        t, kw = _to(cuda_device, args, kwargs)
        kind = "nvfp4" if fmt == "nvfp4" else "raw"
        n0 = dict(tpa.prefill_route_launches)
        out = tpa.paged_attention_prefill(*t, fmt=kind, **kw)
        torch.cuda.synchronize()
        assert tpa.prefill_route_launches == {"tensor_core": n0["tensor_core"], "cuda_core": n0["cuda_core"] + 1}
        ref = tpa.paged_attention_prefill_plain(*t, fmt=kind, **kw)
        if fmt == "nvfp4":
            _within_f32_score_limit(out, ref, _nvfp4_prefill_limit(*t, **kw))
        else:
            assert rel_err(out.cpu().numpy(), ref.cpu().numpy()) < 1e-5


@pytest.mark.cuda
def test_kernels_raise_on_cuda_tensors_they_do_not_take(cuda_device):
    args, kwargs = _decode_case("int8", [19, 7])
    t, _ = _to(cuda_device, args, kwargs)
    with pytest.raises(TypeError):  # f32 pages have no kernel: no quiet fall back to the plain version
        tpa.paged_attention_decode(t[0], t[1].float(), t[2].float(), t[3], t[4])


# ---- the decode kernel's split over each sequence's rows (flash-decoding) ----


def _split_merge(q, k_pages, v_pages, block_table, seq_lens, fmt, split_rows, k_scale_pages=None,
                 v_scale_pages=None):
    """The kernel's algorithm in plain PyTorch: `tpa.n_splits` splits of
    `split_rows` rows from the table's width; split sp of a sequence takes
    rows [sp * split_rows, min((sp + 1) * split_rows, len)), each row from
    page table[s // page] (-1 as page 0), and keeps its max m, denominator l
    = sum exp(s - m) and accumulator sum exp(s - m) v (a split past the
    length: -1e30, 0, 0); the merge rescales the splits to their largest
    max and divides by max(L, 1e-30). f32, scores q.k / sqrt(hd)."""
    B, nH, hd = q.shape
    n_pages, n_kv, page, _ = k_pages.shape
    rep = nH // n_kv
    max_pages = block_table.shape[1]
    q4 = q.float().reshape(B, n_kv, rep, hd)
    out = torch.zeros((B, n_kv, rep, hd))
    for b in range(B):
        n = min(int(seq_lens[b]), max_pages * page)
        parts = []
        for sp in range(tpa.n_splits(max_pages, page, split_rows)):
            rows = torch.arange(sp * split_rows, max(sp * split_rows, min((sp + 1) * split_rows, n)))
            if len(rows) == 0:
                parts.append((torch.full((n_kv, rep), -1e30), torch.zeros((n_kv, rep)), torch.zeros((n_kv, rep, hd))))
                continue
            pid = block_table[b, rows // page].clamp_min(0).long()
            at = rows % page

            def stored(pages, scales):
                rr = pages[pid, :, at]  # [rows, n_kv, C]
                return decode_rows(rr, None if scales is None else scales[pid, :, at], fmt).transpose(0, 1)

            k, v = stored(k_pages, k_scale_pages), stored(v_pages, v_scale_pages)  # [n_kv, rows, hd]
            s = torch.einsum("grd,gsd->grs", q4[b], k) / np.sqrt(hd)
            m = s.amax(dim=-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(dim=-1), torch.einsum("grs,gsd->grd", p, v)))
        M = torch.stack([torch.full((n_kv, rep), -1e30)] + [m for m, _, _ in parts]).amax(dim=0)
        L, A = torch.zeros((n_kv, rep)), torch.zeros((n_kv, rep, hd))
        for m, l, acc in parts:
            c = torch.exp(m - M)
            L = L + l * c
            A = A + acc * c[..., None]
        out[b] = A / L.clamp_min(1e-30)[..., None]
    return out.reshape(B, nH, hd)


SPLIT_LENS = {"last_row": [0, 1, 15, 16, 17, 48], "wide_table": [0, 1, 15, 16, 17, 20]}


def _split_case(fmt, page, lens, seed):
    """Six sequences over a shuffled pool; the table spans 48 rows (6 pages
    of 8 or 4 of 12), so 16-row splits make three of them: "last_row" fills
    the table, "wide_table" leaves its last split empty for every sequence."""
    n_kv, rep, hd, B = 2, 2, 32, len(lens)
    max_pages = 48 // page
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * max_pages
    k, ks = _stored(rng, (n_pages, n_kv, page, hd), fmt)
    v, vs = _stored(rng, (n_pages, n_kv, page, hd), fmt)
    perm = (rng.permutation(n_pages - 1) + 1).reshape(B, max_pages)
    live = np.arange(max_pages)[None] * page < np.asarray(lens)[:, None]
    table = np.where(live, perm, -1).astype(np.int32)
    q = (rng.standard_normal((B, n_kv * rep, hd)) / (40.0 if fmt == "int8" else 1.0)).astype(np.float32)
    kwargs = {} if ks is None else {"k_scale_pages": ks, "v_scale_pages": vs}
    return (q, k, v, table, np.asarray(lens, np.int32)), kwargs


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("page", [8, 12])
@pytest.mark.parametrize("lens", list(SPLIT_LENS), ids=str)
def test_split_merge_matches_plain_and_pallas(fmt, page, lens):
    """16-row splits here (the kernel's are SPLIT_ROWS): lengths 0, 1, each
    side of the first boundary, and either the table's last row or a table
    wider than the longest sequence needs."""
    args, kwargs = _split_case(fmt, page, SPLIT_LENS[lens], seed=page + len(lens))
    assert tpa.n_splits(args[3].shape[1], page, 16) == 3
    out, ref = _both(jpa.paged_attention_decode, tpa.paged_attention_decode, args, kwargs, fmt)
    t = [convert.tensor_from_array(a) for a in args]
    kw = {key: convert.tensor_from_array(val) for key, val in kwargs.items()}
    split = _split_merge(*t, "nvfp4" if fmt == "nvfp4" else "raw", 16, **kw)
    assert rel_err(split.numpy(), out.numpy()) < 1e-5
    assert rel_err(split.numpy(), ref) < 1e-5
    assert not split[0].any()  # length 0: exactly 0


def test_split_count_comes_from_the_table_width():
    """The decode kernel's grid: ceil(max_pages * page / SPLIT_ROWS) splits,
    at least one; the lengths are not an argument, so the host never reads
    them back from the card. The kernels phase's 130-page table of 16 rows
    makes 9 splits, the full serve run's 69-page table 5."""
    import inspect

    assert tpa.SPLIT_ROWS == 256
    assert list(inspect.signature(tpa.n_splits).parameters) == ["max_pages", "page", "split_rows"]
    assert tpa.n_splits(130, 16) == 9 and tpa.n_splits(69, 16) == 5
    assert tpa.n_splits(16, 16) == 1 and tpa.n_splits(17, 16) == 2 and tpa.n_splits(1, 1) == 1
    for max_pages, page in ((1, 8), (7, 12), (32, 8), (43, 12), (3, 128)):
        n = tpa.n_splits(max_pages, page)
        assert (n - 1) * 256 < max_pages * page <= n * 256


EDGE_LENS = [0, 1, 255, 256, 257, 511, 512, 513, 600]  # each side of the kernel's 256-row split edges


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("page", [12, 16, 128])
def test_decode_kernel_at_split_edges(cuda_device, fmt, page):
    """The split kernel and its merge (one call each: `launches` + 1) with
    lengths on each side of the 256-row split edges, bf16 and f32 q, against
    the plain version's f32 result. f32 q: 1e-5 of the output's scale;
    bf16 q: the output rounds once to bf16, 2^-8 |ref| more. NVFP4 adds
    the f32 score limit above."""
    B, n_kv, rep, hd = len(EDGE_LENS), 2, 4, 64
    max_pages = -(-max(EDGE_LENS) // page) + 1
    rng = np.random.default_rng(page)
    n_pages = 1 + B * max_pages
    k, ks = _stored(rng, (n_pages, n_kv, page, hd), fmt)
    v, vs = _stored(rng, (n_pages, n_kv, page, hd), fmt)
    perm = (rng.permutation(n_pages - 1) + 1).reshape(B, max_pages)
    live = np.arange(max_pages)[None] * page < np.asarray(EDGE_LENS)[:, None]
    table = np.where(live, perm, -1).astype(np.int32)
    q = (rng.standard_normal((B, n_kv * rep, hd)) / (40.0 if fmt == "int8" else 1.0)).astype(np.float32)
    kwargs = {} if ks is None else {"k_scale_pages": ks, "v_scale_pages": vs}
    t, kw = _to(cuda_device, (q, k, v, table, np.asarray(EDGE_LENS, np.int32)), kwargs)
    kind = "nvfp4" if fmt == "nvfp4" else "raw"
    for qdt in (torch.float32, torch.bfloat16):
        args = [t[0].to(qdt), *t[1:]]
        n0 = tpa.launches["paged_attention_decode"]
        out = tpa.paged_attention_decode(*args, fmt=kind, **kw)
        torch.cuda.synchronize()
        assert tpa.launches["paged_attention_decode"] == n0 + 1 and out.dtype == qdt
        ref = tpa.paged_attention_decode_plain(*args, fmt=kind, out_dtype=torch.float32, **kw)
        assert not out[0].any()  # length 0
        if fmt == "nvfp4":
            limit = _nvfp4_decode_limit(*args, **kw) + (2.0 ** -8 * ref.abs() if qdt == torch.bfloat16 else 0)
            _within_f32_score_limit(out, ref, limit)
        elif qdt == torch.float32:
            assert rel_err(out.cpu().numpy(), ref.cpu().numpy()) < 1e-5
        else:
            err = (out.float() - ref).abs()
            assert bool((err <= 2.0 ** -8 * ref.abs() + 1e-5 * ref.abs().max()).all())
