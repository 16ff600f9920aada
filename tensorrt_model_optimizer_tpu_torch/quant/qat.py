"""Quantization-aware training (port of `quant/qat.py`), in part.

Ported: `cross_entropy`, the loss the speculative drafts train on. The
rest of the module (the STE train step, `qat_loss`, the optimizers) is
still to port with the training-side modules (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy. logits [B, T, V], targets [B, T]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0].mean()
