"""Attention sparsity: flash skip-softmax and VSA (port of
`sparsity/attention_sparsity.py`).

Skip-softmax: scores split into [Tq x Tk] blocks; a block whose max score
lies more than `log(threshold)` below its row of blocks' max contributes
less than `threshold` relative probability mass and is skipped.
`skip_softmax_attention` computes that mask exactly (calibration, accuracy
evaluation, tests); the serving engine turns it into skipped work with the
kernel of `ops/cuda/sparse_attention.py`, whose test compares against the
running max of the tiles kept so far instead. `calibrate_threshold` finds
the largest threshold whose block sparsity stays within a target.

VSA (video sparse attention): a compression branch over block-mean-pooled
K/V plus exact attention on each query block's top-K key blocks.

Plain PyTorch throughout: none of this reaches a kernel.
"""

from __future__ import annotations

import math

import torch


def block_skip_mask(scores: torch.Tensor, threshold: float, block_q: int = 16,
                    block_k: int = 16) -> torch.Tensor:
    """scores [B, n, Tq, Tk] (scaled, masked, before the softmax) -> the
    boolean keep mask of its [bq, bk] blocks, expanded to the scores' shape."""
    B, n, Tq, Tk = scores.shape
    bq, bk = min(block_q, Tq), min(block_k, Tk)
    nq, nk = Tq // bq, Tk // bk
    blk_max = scores.reshape(B, n, nq, bq, nk, bk).amax(dim=(3, 5))  # [B, n, nq, nk]
    row_max = blk_max.amax(dim=-1, keepdim=True)
    keep = blk_max >= row_max + math.log(max(threshold, 1e-30))
    return keep[:, :, :, None, :, None].expand(B, n, nq, bq, nk, bk).reshape(B, n, Tq, Tk)


def skip_softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, threshold: float = 1e-3,
                           causal: bool = True, block_q: int = 16, block_k: int = 16):
    """q, k, v [B, T, n, d] -> (out [B, T, n, d] in v's dtype, block sparsity:
    the share of VALID (unmasked) entries whose block is skipped, a 0-d
    tensor)."""
    d, T = q.shape[-1], q.shape[1]
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        ar = torch.arange(T, device=q.device)
        s = s + torch.where(ar[None, :] <= ar[:, None], 0.0, -math.inf)[None, None]
    keep = block_skip_mask(s, threshold, block_q, block_k)
    s_kept = torch.where(keep, s, torch.full_like(s, -math.inf))
    p = torch.softmax(s_kept, dim=-1)
    p = torch.where(torch.isfinite(s_kept), p, torch.zeros_like(p))
    out = torch.einsum("bnqk,bknd->bqnd", p.to(v.dtype), v)
    valid = torch.isfinite(s)
    sparsity = 1.0 - (keep & valid).sum() / valid.sum().clamp_min(1)
    return out, sparsity


def calibrate_threshold(q, k, v, target_sparsity: float = 0.5, causal: bool = True, n_steps: int = 12) -> float:
    """The largest threshold whose block sparsity is <= target: a binary
    search over log10(threshold) in [-12, 0]."""
    lo, hi = -12.0, 0.0
    best = lo
    for _ in range(n_steps):
        mid = (lo + hi) / 2
        _, sp = skip_softmax_attention(q, k, v, 10.0 ** mid, causal)
        if float(sp) <= target_sparsity:
            best, lo = mid, mid
        else:
            hi = mid
    return 10.0 ** best


def tile_3d_indices(video_shape: tuple, block_3d: tuple) -> torch.Tensor:
    """The token permutation that makes each (bt, bh, bw) tile of a (T, H, W)
    video contiguous: token (t, h, w) -> its tile's slot. Returns the gather
    index [T H W]."""
    T, H, W = video_shape
    bt, bh, bw = block_3d
    tiles = torch.arange(T * H * W).reshape(T // bt, bt, H // bh, bh, W // bw, bw)
    return tiles.permute(0, 2, 4, 1, 3, 5).reshape(-1)


def vsa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_size: int = 64,
                  top_k_ratio: float = 0.5, gate_compress=0.5):
    """Two-branch VSA over tile-ordered tokens q, k, v [B, S, n, d] (permute
    video tokens with `tile_3d_indices` first): queries attend to the
    block-mean-pooled K/V (compression branch), and each query block attends
    exactly to its top-K key blocks ranked by the pooled scores (sparse
    branch); out = compression * gate_compress + sparse. Returns (out
    [B, S, n, d] in q's dtype, block_keep [B, n, nB, nB] bool)."""
    B, S, n, d = q.shape
    bs = min(block_size, S)
    while S % bs:
        bs //= 2
    nB = S // bs
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()

    k_c = k.float().reshape(B, nB, bs, n, d).mean(dim=2)  # [B, nB, n, d]
    v_c = v.float().reshape(B, nB, bs, n, d).mean(dim=2)
    s_c = torch.einsum("bqnd,bknd->bnqk", q32, k_c) * scale  # [B, n, S, nB]
    out_comp = torch.einsum("bnqk,bknd->bqnd", torch.softmax(s_c, dim=-1), v_c)

    imp = s_c.reshape(B, n, nB, bs, nB).mean(dim=3)  # [B, n, nQb, nKb]
    kcount = max(int(round(top_k_ratio * nB)), 1)
    thresh = torch.sort(imp, dim=-1).values[..., nB - kcount][..., None]
    block_keep = imp >= thresh

    s_f = torch.einsum("bqnd,bknd->bnqk", q32, k.float()) * scale
    keep_full = block_keep[:, :, :, None, :, None].expand(B, n, nB, bs, nB, bs).reshape(B, n, S, S)
    s_f = torch.where(keep_full, s_f, torch.full_like(s_f, -math.inf))
    out_sparse = torch.einsum("bnqk,bknd->bqnd", torch.softmax(s_f, dim=-1), v.float())

    g = torch.as_tensor(gate_compress, dtype=torch.float32)
    return (out_comp * g + out_sparse).to(q.dtype), block_keep
