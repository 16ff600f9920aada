"""Token sampling: greedy / temperature / top-k / top-p (port of
`serve/sampling.py`). Random draws come from an explicit `torch.Generator`,
so they differ from JAX's keys: the tests compare greedy tokens exactly and
sampled tokens by their support."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0  # 0 = off
    top_p: float = 1.0  # 1 = off


def sample(logits: torch.Tensor, cfg: SamplingConfig,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int32)."""
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = logits.float() / cfg.temperature
    if cfg.top_k and cfg.top_k > 0:
        kth = torch.sort(l, dim=-1).values[:, -cfg.top_k][:, None]
        l = torch.where(l < kth, torch.full_like(l, -float("inf")), l)
    if cfg.top_p < 1.0:
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_l, dim=-1), dim=-1)
        # smallest set with cumulative mass >= top_p (the best always stays)
        k_keep = torch.sum(cum < cfg.top_p, dim=-1) + 1
        cutoff = torch.gather(sorted_l, -1, (k_keep - 1)[:, None])
        l = torch.where(l < cutoff, torch.full_like(l, -float("inf")), l)
    probs = torch.softmax(l, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
