"""Knowledge-distillation losses (port of `distill/losses.py`).

 - `logits_kl`: temperature-scaled KL(teacher || student) (Hinton KD);
 - `mft_loss`: cross-entropy against the teacher's distribution nudged
   toward the ground-truth token (minifinetuning's correction);
 - `mgd_loss`: feature MSE, optionally through a linear projector.
"""

from __future__ import annotations

from typing import Optional

import torch


def logits_kl(student_logits: torch.Tensor, teacher_logits: torch.Tensor, temperature: float = 1.0,
              reduction: str = "mean") -> torch.Tensor:
    """KL(teacher || student) over the last axis, times temperature^2."""
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    tp = torch.softmax(teacher_logits.float() / t, dim=-1)
    tlogp = torch.log_softmax(teacher_logits.float() / t, dim=-1)
    kl = torch.sum(tp * (tlogp - sp), dim=-1) * (t * t)
    return kl.mean() if reduction == "mean" else kl


def mft_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor, targets: torch.Tensor,
             correction: float = 0.3) -> torch.Tensor:
    """Cross-entropy against (1 - correction) * p_teacher + correction * onehot."""
    tp = torch.softmax(teacher_logits.float(), dim=-1)
    onehot = torch.nn.functional.one_hot(targets.long(), tp.shape[-1]).float()
    mix = (1.0 - correction) * tp + correction * onehot
    sp = torch.log_softmax(student_logits.float(), dim=-1)
    return -torch.mean(torch.sum(mix * sp, dim=-1))


def mgd_loss(student_feat: torch.Tensor, teacher_feat: torch.Tensor,
             projector: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Feature MSE, the student's features first through `projector` [d_s, d_t]."""
    s = student_feat.float()
    if projector is not None:
        s = s @ projector.float()
    return torch.mean((s - teacher_feat.float()) ** 2)
