"""Skip-softmax sparse flash attention (port of
`ops/pallas/sparse_attention.py` `skip_softmax_flash`).

Kernel: `csrc/skip_softmax_flash.cu`, two routes that `route` picks from
dtype, head_dim and tile sizes alone: the tensor cores for bf16, head_dim
32/64/128 and tiles of 64 or 128 rows (the 8B sparse prefill); the CUDA
cores for the rest (f32, head_dim 16, the halving rule's odd tiles; tiles up
to 128 x 128). On a CUDA tensor the wrapper launches the chosen route's
kernel or raises; only CPU tensors take the plain PyTorch version.

A [bq x bk] score tile whose max sits more than log(threshold) below the
running max of the tiles already kept for its q tile carries less than
`threshold` relative probability mass and is skipped: no exp, no P.V. The k
tiles of a q tile are visited in order and the running max changes only on
kept tiles, so the keep map depends on the visit order; under `causal`,
tiles wholly above the diagonal are skipped as well (they count in the keep
map as zeros). Tile sizes follow the reference's halving rule:
`bq = min(block_q, S)`, halved while it does not divide S (so S = 131 gives
tiles of 1).
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = 0  # kernel launches since the last reset, both routes (chip_smoke reads it)
route_launches = {"tensor_core": 0, "cuda_core": 0}  # the same, per route

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_CHUNK = 1 << 28  # score elements per slice of the plain version (1 GiB of f32)


def tile_sizes(S: int, block_q: int, block_k: int) -> tuple[int, int]:
    """The reference's tiles: each block size capped at S, halved until it
    divides S."""
    bq, bk = min(block_q, S), min(block_k, S)
    while S % bq:
        bq //= 2
    while S % bk:
        bk //= 2
    return bq, bk


def route(dtype: torch.dtype, d: int, bq: int, bk: int) -> str:
    """The kernel a CUDA tensor goes to: "tensor_core" for bf16, head_dim 32,
    64 or 128 and tiles of 64 or 128 rows, else "cuda_core"."""
    if dtype == torch.bfloat16 and d in (32, 64, 128) and bq in (64, 128) and bk in (64, 128):
        return "tensor_core"
    return "cuda_core"


def log_threshold(threshold: float) -> float:
    """The decision offset: a tile is kept iff its max >= running max + this."""
    return math.log(max(threshold, 1e-30))


def tile_decisions(blk_max: torch.Tensor, log_thresh: float, bq: int, bk: int, causal: bool):
    """Visit the k tiles of every (bh, q tile) in order. blk_max [BH, nq, nk]
    f32 -> (keep [BH, nq, nk] bool, margin [BH, nq, nk] f32: the tile max less
    the running max plus log_thresh it was held to; >= 0 keeps it)."""
    BH, nq, nk = blk_max.shape
    lt = torch.tensor(log_thresh, dtype=torch.float32, device=blk_max.device)
    run = torch.full((BH, nq), -1e30, dtype=torch.float32, device=blk_max.device)
    qi = torch.arange(nq, device=blk_max.device)
    keep, margin = [], []
    for j in range(nk):
        bm = blk_max[:, :, j]
        limit = run + lt
        kj = bm >= limit
        if causal:
            kj = kj & (j * bk <= qi * bq + bq - 1)[None, :]
        run = torch.where(kj, torch.maximum(run, bm), run)
        keep.append(kj)
        margin.append(bm - limit)
    return torch.stack(keep, dim=-1), torch.stack(margin, dim=-1)


def _scores(q, k, causal: bool) -> torch.Tensor:
    """(q . k^T in f32) x 1/sqrt(d), f32 scale; -1e30 above the diagonal."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=torch.float32, device=q.device)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        above = torch.arange(S, device=q.device)[None, :] > torch.arange(S, device=q.device)[:, None]
        s = s.masked_fill(above, -1e30)
    return s


def block_max(q, k, bq: int, bk: int, causal: bool) -> torch.Tensor:
    """The largest scaled (and causally masked) score of every tile:
    [BH, S/bq, S/bk] f32."""
    BH, S, _ = q.shape
    rows = max(1, _PLAIN_CHUNK // (S * S))
    return torch.cat([_scores(q[b:b + rows], k[b:b + rows], causal)
                      .reshape(-1, S // bq, bq, S // bk, bk).amax(dim=(2, 4)) for b in range(0, BH, rows)])


def skip_softmax_flash_plain(q, k, v, threshold: float = 1e-3, block_q: int = 128, block_k: int = 128,
                             causal: bool = False):
    """Plain PyTorch version (the reference's `_skip_softmax_ref`): dense f32
    scores, the tile decisions in visit order, then a softmax over the kept
    entries. Works through BH in slices of at most 2^28 scores; each row is
    computed whole, so the slicing changes no value."""
    BH, S, _ = q.shape
    bq, bk = tile_sizes(S, block_q, block_k)
    nq, nk = S // bq, S // bk
    keep, _ = tile_decisions(block_max(q, k, bq, bk, causal), log_threshold(threshold), bq, bk, causal)
    out = torch.empty_like(q)
    rows = max(1, _PLAIN_CHUNK // (S * S))
    for b in range(0, BH, rows):
        s = _scores(q[b:b + rows], k[b:b + rows], causal)
        kf = keep[b:b + rows, :, None, :, None].expand(-1, nq, bq, nk, bk).reshape(s.shape)
        s = torch.where(kf, s, torch.full_like(s, -1e30))
        p = torch.softmax(s, dim=-1)
        p = torch.where(s > -1e29, p, torch.zeros_like(p))
        out[b:b + rows] = torch.einsum("bqk,bkd->bqd", p, v[b:b + rows].float()).to(q.dtype)
    return out, keep.to(torch.int32)


def skip_softmax_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, threshold: float = 1e-3,
                       block_q: int = 128, block_k: int = 128, causal: bool = False):
    """q, k, v [BH, S, d] -> (out [BH, S, d] in q's dtype, keep [BH, nq, nk]
    int32)."""
    BH, S, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"skip_softmax_flash: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return skip_softmax_flash_plain(q, k, v, threshold, block_q, block_k, causal)
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPES) or d not in (16, 32, 64, 128):
        raise ValueError(f"skip_softmax_flash kernel: f32 or bf16, head_dim 16/32/64/128, got {q.dtype} d={d}")
    bq, bk = tile_sizes(S, block_q, block_k)
    if bq > 128 or bk > 128:
        raise ValueError(f"skip_softmax_flash kernel: tiles of at most 128 rows, got {bq} x {bk}")
    global launches
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        q, k, v = q.clone(), k.clone(), v.clone()
    out = torch.empty_like(q)
    keep = torch.empty((BH, S // bq, S // bk), dtype=torch.int32, device=q.device)
    ptrs = [_build.ptr(t) for t in (q, k, v, out, keep)]
    which = route(q.dtype, d, bq, bk)
    if which == "tensor_core":
        fn = _build.function("skip_softmax_flash", "skip_softmax_flash_tc",
                             [_build.c_void_p] * 5 + [_build.c_int] * 5 + [_build.c_float] * 2
                             + [_build.c_int, _build.c_void_p])
        err = fn(*ptrs, BH, S, d, bq, bk, 1.0 / math.sqrt(d), log_threshold(threshold), int(causal),
                 _build.stream())
    else:
        fn = _build.function("skip_softmax_flash", "skip_softmax_flash",
                             [_build.c_void_p] * 5 + [_build.c_int] * 6 + [_build.c_float] * 2
                             + [_build.c_int, _build.c_void_p])
        err = fn(*ptrs, BH, S, d, bq, bk, _DTYPES[q.dtype], 1.0 / math.sqrt(d), log_threshold(threshold),
                 int(causal), _build.stream())
    _build.check(err, f"skip_softmax_flash ({which} route)")
    launches += 1
    route_launches[which] += 1
    return out, keep
