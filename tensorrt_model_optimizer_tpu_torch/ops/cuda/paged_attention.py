"""GQA attention over a paged KV pool behind a block table (port of
`ops/pallas/paged_attention.py`): `paged_attention_decode`, one query token
per sequence, and `paged_attention_prefill`, a chunk of T tokens per
sequence over the paged context plus, causally, the chunk's own k/v.

Kernels: `csrc/paged_attention_decode.cu` and `csrc/paged_attention_prefill.cu`.
The decode splits each sequence's rows over blocks of SPLIT_ROWS (flash-
decoding, as the dense KV decode does) and merges them in a second kernel,
which writes q's dtype; `n_splits` sizes its grid from the block table's
width. The prefill has two routes that `prefill_route` picks from q's
dtype, head_dim and rep alone: the tensor cores for bf16 q (the engine's
activations: bf16 out), the CUDA cores for f32 q (f32 out), which bf16
would round. On a CUDA tensor a wrapper launches its kernel or raises; only
CPU tensors take the plain PyTorch versions.

Pages are `[n_pages, n_kv, page, C]`, kv-head-major, in stored form: `fmt
"raw"` is bf16 values, int8 codes or fp8 e4m3 values (C = hd; the plain
versions also take f32 pages), `fmt "nvfp4"` plane-packed E2M1 bytes (C =
hd/2) with parallel pools `[n_pages, n_kv, page, hd/16]` of E4M3 block-scale
bytes (the dense kernel cache's layout, `kv_attention.py`). The per-layer
global scales stay with the caller: k's folds into q, v's into the result.
`block_table [B, max_pages]` holds page ids, -1 (unused) reading as page 0;
entries past a sequence's live pages are never dereferenced by the kernels.
Scores are divided by sqrt(hd) inside. The softmax keeps the reference's
constants (masked scores -1e30, denominator clamped at 1e-30): a sequence
with no live row gives exactly 0.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .kv_attention import FORMATS, SPLIT_ROWS, decode_rows

# kernel wrapper calls that launched since the last reset (chip_smoke reads
# them; a decode call launches the split and the merge kernel); the
# prefill's also per route
launches = {"paged_attention_decode": 0, "paged_attention_prefill": 0}
prefill_route_launches = {"tensor_core": 0, "cuda_core": 0}
TC_TILE = 64  # keys of the tensor-core route's K / V tiles (any page size: each row's page is looked up)


def prefill_route(dtype: torch.dtype, hd: int, rep: int) -> str:
    """The prefill kernel a CUDA tensor goes to: "tensor_core" for bf16 q,
    head_dim 32, 64 or 128 and rep 1, 2, 4 or 8, else "cuda_core"."""
    if dtype == torch.bfloat16 and hd in (32, 64, 128) and rep in (1, 2, 4, 8):
        return "tensor_core"
    return "cuda_core"


def _gather(pages, scale_pages, bt, fmt) -> torch.Tensor:
    """Every table column's page, decoded: [B, n_kv, max_pages*page, hd] f32."""
    rows = decode_rows(pages[bt], None if scale_pages is None else scale_pages[bt], fmt)
    B, P, n_kv, page, hd = rows.shape
    return rows.permute(0, 2, 1, 3, 4).reshape(B, n_kv, P * page, hd)


def _softmax_pv(s, live, v, eq):
    """Masked softmax of scores `s` (mask `live` broadcast over them) times
    `v`, with the reference's constants."""
    s = torch.where(live, s, torch.full_like(s, -1e30))
    p = torch.where(live, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum(eq, p / denom, v)


def paged_attention_decode_plain(q, k_pages, v_pages, block_table, seq_lens, fmt: str = "raw",
                                 k_scale_pages=None, v_scale_pages=None, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: gathers every table column, masks by length."""
    B, n_heads, hd = q.shape
    n_kv = k_pages.shape[1]
    bt = block_table.clamp_min(0).long()
    k = _gather(k_pages, k_scale_pages, bt, fmt)
    v = _gather(v_pages, v_scale_pages, bt, fmt)
    q4 = q.float().reshape(B, n_kv, n_heads // n_kv, hd)
    s = torch.einsum("bgrd,bgsd->bgrs", q4, k) / math.sqrt(hd)
    live = (torch.arange(k.shape[2], device=q.device)[None] < seq_lens[:, None])[:, None, None, :]
    out = _softmax_pv(s, live, v, "bgrs,bgsd->bgrd").reshape(B, n_heads, hd)
    return out.to(out_dtype or q.dtype)


def paged_attention_prefill_plain(q, k_pages, v_pages, block_table, ctx_lens, chunk_k, chunk_v,
                                  fmt: str = "raw", k_scale_pages=None, v_scale_pages=None,
                                  chunk_k_scales=None, chunk_v_scales=None, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version: context columns masked by `ctx_lens`, then the
    chunk's own columns under the causal mask col <= row."""
    B, T, n_heads, hd = q.shape
    n_kv = k_pages.shape[1]
    bt = block_table.clamp_min(0).long()
    k = torch.cat([_gather(k_pages, k_scale_pages, bt, fmt),
                   decode_rows(chunk_k, chunk_k_scales, fmt).transpose(1, 2)], dim=2)
    v = torch.cat([_gather(v_pages, v_scale_pages, bt, fmt),
                   decode_rows(chunk_v, chunk_v_scales, fmt).transpose(1, 2)], dim=2)
    S = k.shape[2] - T
    q5 = q.float().reshape(B, T, n_kv, n_heads // n_kv, hd)
    s = torch.einsum("btgrd,bgsd->bgrts", q5, k) / math.sqrt(hd)
    t = torch.arange(T, device=q.device)
    live = torch.cat([(torch.arange(S, device=q.device)[None] < ctx_lens[:, None])[:, None, :].expand(B, T, S),
                      (t[None, :] <= t[:, None])[None].expand(B, T, T)], dim=-1)[:, None, None]
    out = _softmax_pv(s, live, v, "bgrts,bgsd->btgrd").reshape(B, T, n_heads, hd)
    return out.to(out_dtype or q.dtype)


def _check_pages(what, q_heads, hd, k_pages, v_pages, block_table, lens, fmt, k_scale_pages, v_scale_pages):
    if fmt not in ("raw", "nvfp4"):
        raise ValueError(f"{what}: fmt {fmt!r} is neither 'raw' nor 'nvfp4'")
    n_pages, n_kv, page, C = k_pages.shape
    B = block_table.shape[0]
    if (C != (hd // 2 if fmt == "nvfp4" else hd) or q_heads % n_kv or v_pages.shape != k_pages.shape
            or lens.shape != (B,)):
        raise ValueError(f"{what}: {q_heads} heads of {hd}, pages {tuple(k_pages.shape)}, "
                         f"table {tuple(block_table.shape)}, lens {tuple(lens.shape)}, fmt {fmt}")
    if fmt == "nvfp4":
        want = (n_pages, n_kv, page, hd // 16)
        if k_scale_pages is None or v_scale_pages is None or k_scale_pages.shape != want \
                or v_scale_pages.shape != want:
            raise ValueError(f"{what}: nvfp4 needs k_scale_pages / v_scale_pages {want}")


def _kernel_args(what, q, k_pages, v_pages, block_table, lens, fmt, scale_tensors, chunk=()):
    """The kernel's format code and rep; raises on what the kernels do not
    take. Every tensor must be contiguous with 16-byte aligned storage, so a
    page row (C bytes or more) starts on the boundary of a lane's widest load."""
    hd = q.shape[-1]
    rep = q.shape[-2] // k_pages.shape[1]
    raw = {dt: name for name, (_, dt) in FORMATS.items() if name != "nvfp4"}
    stored = "nvfp4" if fmt == "nvfp4" else raw.get(k_pages.dtype)
    if stored is None or v_pages.dtype != k_pages.dtype or k_pages.dtype != FORMATS[stored][1]:
        raise TypeError(f"{what}: fmt {fmt} pages of {k_pages.dtype}: the kernel takes bf16, int8 and "
                        "fp8 e4m3 pages as 'raw' and uint8 planes as 'nvfp4'")
    if hd not in (32, 64, 128) or rep not in (1, 2, 4, 8):
        raise ValueError(f"{what} kernel: head_dim {hd} / rep {rep} unsupported")
    if block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{what}: block_table and lengths are int32")
    for t in (k_pages, v_pages, block_table, lens, *scale_tensors, *chunk):
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: every tensor lies on {q.device}, contiguous and 16-byte aligned")
    if any(t.dtype != torch.uint8 for t in scale_tensors):
        raise TypeError(f"{what}: nvfp4 scales are uint8 bytes")
    return FORMATS[stored][0], rep


def n_splits(max_pages: int, page: int, split_rows: int = SPLIT_ROWS) -> int:
    """Splits of the decode kernel's grid: enough `split_rows`-row splits to
    cover the block table's width, max_pages * page rows. Derived from the
    table's shape alone, never from the lengths, so the host reads nothing
    back from the card (a graph-captured step can replay it); splits past a
    sequence's length write an empty state."""
    return max(1, -(-max_pages * page // split_rows))


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, seq_lens: torch.Tensor, fmt: str = "raw",
                           k_scale_pages=None, v_scale_pages=None) -> torch.Tensor:
    """q [B, n_heads, hd]; pages [n_pages, n_kv, page, C]; block_table [B,
    max_pages] int32; seq_lens [B] int32, the current token included (its
    k/v are already in its page). Returns [B, n_heads, hd] in q's dtype."""
    B, n_heads, hd = q.shape
    _check_pages("paged_attention_decode", n_heads, hd, k_pages, v_pages, block_table, seq_lens, fmt,
                 k_scale_pages, v_scale_pages)
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pages, v_pages, block_table, seq_lens, fmt,
                                            k_scale_pages, v_scale_pages)
    scales = (k_scale_pages, v_scale_pages) if fmt == "nvfp4" else ()
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged_attention_decode: the kernel takes bf16 or f32 q, got {q.dtype}")
    q = q.contiguous()
    code, rep = _kernel_args("paged_attention_decode", q, k_pages, v_pages, block_table, seq_lens, fmt, scales)
    n_pages, n_kv, page, _ = k_pages.shape
    if n_pages * n_kv * page >= 2 ** 32:
        raise ValueError("paged_attention_decode: the kernel indexes pool rows with 32 bits")
    max_pages = block_table.shape[1]
    n_split = n_splits(max_pages, page)
    part_ml = torch.empty((B, n_kv, n_split, rep, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, n_kv, n_split, rep, hd), dtype=torch.float32, device=q.device)
    out = torch.empty((B, n_heads, hd), dtype=q.dtype, device=q.device)
    ksp, vsp = (_build.ptr(t) for t in scales) if scales else (None, None)
    fn = _build.function("paged_attention_decode", "paged_attention_decode",
                         [_build.c_int] * 3 + [_build.c_void_p] * 10 + [_build.c_int] * 6 + [_build.c_void_p])
    _build.check(fn(code, hd, rep, _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages), ksp, vsp,
                    _build.ptr(block_table), _build.ptr(seq_lens), _build.ptr(part_ml), _build.ptr(part_acc),
                    _build.ptr(out), int(q.dtype == torch.bfloat16), B, n_kv, page, max_pages, n_split,
                    _build.stream()), "paged_attention_decode")
    launches["paged_attention_decode"] += 1
    return out


def paged_attention_prefill(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                            block_table: torch.Tensor, ctx_lens: torch.Tensor, chunk_k: torch.Tensor,
                            chunk_v: torch.Tensor, fmt: str = "raw", k_scale_pages=None,
                            v_scale_pages=None, chunk_k_scales=None, chunk_v_scales=None) -> torch.Tensor:
    """q [B, T, n_heads, hd]; pages and block_table as in decode; ctx_lens
    [B] int32, each sequence's length before the chunk; chunk_k / chunk_v
    [B, T, n_kv, C], the chunk's k/v in stored form (nvfp4: with
    chunk_k_scales / chunk_v_scales [B, T, n_kv, hd/16]). Returns
    [B, T, n_heads, hd] in q's dtype."""
    B, T, n_heads, hd = q.shape
    what = "paged_attention_prefill"
    _check_pages(what, n_heads, hd, k_pages, v_pages, block_table, ctx_lens, fmt, k_scale_pages, v_scale_pages)
    _, n_kv, page, C = k_pages.shape
    if chunk_k.shape != (B, T, n_kv, C) or chunk_v.shape != chunk_k.shape or chunk_k.dtype != k_pages.dtype \
            or chunk_v.dtype != v_pages.dtype:
        raise ValueError(f"{what}: chunk k/v {tuple(chunk_k.shape)} {chunk_k.dtype}, pages "
                         f"{tuple(k_pages.shape)} {k_pages.dtype}")
    if fmt == "nvfp4" and (chunk_k_scales is None or chunk_v_scales is None
                           or chunk_k_scales.shape != (B, T, n_kv, hd // 16)
                           or chunk_v_scales.shape != chunk_k_scales.shape):
        raise ValueError(f"{what}: nvfp4 needs chunk_k_scales / chunk_v_scales [B, T, n_kv, hd/16]")
    if q.device.type == "cpu":
        return paged_attention_prefill_plain(q, k_pages, v_pages, block_table, ctx_lens, chunk_k, chunk_v,
                                             fmt, k_scale_pages, v_scale_pages, chunk_k_scales, chunk_v_scales)
    chunk_k, chunk_v = chunk_k.contiguous(), chunk_v.contiguous()
    scales = ()
    if fmt == "nvfp4":
        scales = (k_scale_pages, v_scale_pages, chunk_k_scales.contiguous(), chunk_v_scales.contiguous())
    code, rep = _kernel_args(what, q, k_pages, v_pages, block_table, ctx_lens, fmt, scales, (chunk_k, chunk_v))
    which = prefill_route(q.dtype, hd, rep)
    if which == "tensor_core":
        qk = q.contiguous()
        if qk.data_ptr() % 16:
            raise ValueError(f"{what}: q's storage must be 16-byte aligned")
        out = torch.empty((B, T, n_heads, hd), dtype=torch.bfloat16, device=q.device)
        entry = "paged_attention_prefill_tc"
    else:
        qk = q.float().contiguous()
        out = torch.empty((B, T, n_heads, hd), dtype=torch.float32, device=q.device)
        entry = "paged_attention_prefill"
    ksp, vsp, cks, cvs = (_build.ptr(t) for t in scales) if scales else (None,) * 4
    fn = _build.function("paged_attention_prefill", entry,
                         [_build.c_int] * 3 + [_build.c_void_p] * 12 + [_build.c_int] * 5 + [_build.c_void_p])
    _build.check(fn(code, hd, rep, _build.ptr(qk), _build.ptr(k_pages), _build.ptr(v_pages), ksp, vsp,
                    _build.ptr(block_table), _build.ptr(ctx_lens), _build.ptr(chunk_k), _build.ptr(chunk_v),
                    cks, cvs, _build.ptr(out), B, T, n_kv, page, block_table.shape[1], _build.stream()),
                 f"{what} ({which} route)")
    launches["paged_attention_prefill"] += 1
    prefill_route_launches[which] += 1
    return out.to(q.dtype)
