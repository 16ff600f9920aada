"""Paged KV cache: page-pool storage + block tables (port of
`serve/paged_cache.py`).

  pages:       [L, n_pages, n_kv, page_size, hd]  (kv-head-major: one page
               row of one kv head is one contiguous read of the attention
               kernels; stored dtype)
  block_table: [max_seqs, max_pages_per_seq] int32 (page ids, -1 = unused)
  seq_lens:    [max_seqs] int32

Allocation and free are host-side (the scheduler owns the free list). The
pool is updated IN PLACE: `append_token_kv`, the engine's page writes and the
scheduler's table edits change the `PagedKV` they are given and return it,
where the JAX package returns a new one; the values are the same.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class PagedKV:
    k_pages: torch.Tensor  # [L, n_pages, n_kv, page, hd]
    v_pages: torch.Tensor
    block_table: torch.Tensor  # [max_seqs, max_pages] int32
    seq_lens: torch.Tensor  # [max_seqs] int32
    # Packed-NVFP4 pool: k/v_pages hold plane-packed nibbles
    # [L, n_pages, n_kv, page, hd/2] uint8 and these the E4M3 block scales'
    # bytes [L, n_pages, n_kv, page, hd/16] uint8 (the dense kernel cache's
    # plane layout, `ops/cuda/kv_attention.py`). None = plain pages.
    k_scales: Optional[torch.Tensor] = None
    v_scales: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def max_pages(self) -> int:
        return self.block_table.shape[1]

    @property
    def packed_nvfp4(self) -> bool:
        return self.k_scales is not None


def init_paged(n_layers: int, n_pages: int, page_size: int, n_kv: int, hd: int, max_seqs: int,
               max_pages_per_seq: int, dtype=torch.bfloat16, packed_nvfp4: bool = False,
               device="cpu") -> PagedKV:
    def pool(last, dt):
        return torch.zeros((n_layers, n_pages, n_kv, page_size, last), dtype=dt, device=device)

    table = dict(block_table=torch.full((max_seqs, max_pages_per_seq), -1, dtype=torch.int32, device=device),
                 seq_lens=torch.zeros((max_seqs,), dtype=torch.int32, device=device))
    if packed_nvfp4:
        return PagedKV(k_pages=pool(hd // 2, torch.uint8), v_pages=pool(hd // 2, torch.uint8),
                       k_scales=pool(hd // 16, torch.uint8), v_scales=pool(hd // 16, torch.uint8), **table)
    return PagedKV(k_pages=pool(hd, dtype), v_pages=pool(hd, dtype), **table)


def append_token_kv(cache: PagedKV, k: torch.Tensor, v: torch.Tensor) -> PagedKV:
    """Write one token's k/v [L, B, n_kv, hd] for every slot at its current
    position and advance every length by one, in place. Idle slots write too:
    the scheduler keeps the scratch page mapped for them."""
    page = cache.page_size
    pos = cache.seq_lens.long()
    page_ids = torch.gather(cache.block_table, 1, (pos // page)[:, None])[:, 0].clamp_min(0).long()
    poff = pos % page
    # the advanced indices (pages axis 1, offsets axis 3) put the slot axis
    # first: the target is [B, L, n_kv, hd]
    cache.k_pages[:, page_ids, :, poff] = k.transpose(0, 1).to(cache.k_pages.dtype)
    cache.v_pages[:, page_ids, :, poff] = v.transpose(0, 1).to(cache.v_pages.dtype)
    cache.seq_lens += 1
    return cache


def gather_sequence_kv(cache: PagedKV, layer_k: torch.Tensor, layer_v: torch.Tensor, out_dtype=None):
    """One layer's pages [n_pages, n_kv, page, hd] gathered per sequence into
    [B, max_pages*page, n_kv, hd]; the caller masks positions past seq_len."""
    bt = cache.block_table.clamp_min(0).long()

    def one(pages):
        g = pages[bt]  # [B, P, n_kv, page, hd]
        B, P, n_kv, pg, hd = g.shape
        g = g.transpose(2, 3).reshape(B, P * pg, n_kv, hd)
        return g if out_dtype is None else g.to(out_dtype)

    return one(layer_k), one(layer_v)
