"""KD loss balancers (port of `distill/loss_balancers.py`): one scalar from
several loss terms (logits KD, feature losses, the student's CE), by fixed
weights or by each term's moving-average magnitude."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class StaticLossBalancer:
    """Fixed weights: sum of w_i * loss_i."""

    weights: tuple[float, ...]

    def __call__(self, losses: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(losses) != len(self.weights):
            raise ValueError(f"{len(losses)} losses for {len(self.weights)} weights")
        total = 0.0
        for w, loss in zip(self.weights, losses):
            total = total + w * loss
        return total


@dataclasses.dataclass
class DynamicLossBalancerState:
    ema: torch.Tensor  # [n_terms] running loss magnitudes, f32


def init_dynamic_balancer(n_terms: int, device=None) -> DynamicLossBalancerState:
    return DynamicLossBalancerState(ema=torch.ones((n_terms,), dtype=torch.float32, device=device))


def dynamic_balance(losses: Sequence[torch.Tensor], state: DynamicLossBalancerState,
                    decay: float = 0.99) -> tuple[torch.Tensor, DynamicLossBalancerState]:
    """Each term over its EMA magnitude (the EMA takes no gradient), then the
    mean: terms of different natural scales contribute alike."""
    vec = torch.stack([loss.float() for loss in losses])
    ema = decay * state.ema + (1 - decay) * vec.detach()
    total = torch.mean(vec / torch.clamp(ema, min=1e-8))
    return total, DynamicLossBalancerState(ema=ema)
