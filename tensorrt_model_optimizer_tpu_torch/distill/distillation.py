"""Distillation as a loss function and a step (port of
`distill/distillation.py`).

The student and the teacher forwards compose in one loss, the teacher's
logits detached (JAX's `stop_gradient`): `kd_weight * KD + (1 - kd_weight)
* CE`. QAD is the student's forward with fake quant active (pass a layout
and its quantizer state). `forward_fn` / `teacher_forward_fn` select a
registry family's forward (returning (logits, state)) for either side.
Training forwards read `attn_impl="flash"` as the einsum attention
(`quant.qat.train_cfg`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import llama
from ..quant import qat as qat_mod
from . import losses


@dataclasses.dataclass(frozen=True)
class KDConfig:
    temperature: float = 1.0
    kd_weight: float = 0.5  # kd_weight * KD + (1 - kd_weight) * CE
    loss: str = "logits_kl"  # "logits_kl" | "mft"
    mft_correction: float = 0.3


def distill_loss(model_cfg: llama.LlamaConfig, student_params: dict, teacher_params: dict, tokens: torch.Tensor,
                 kd: KDConfig = KDConfig(), layout: Optional[llama.QuantLayout] = None,
                 qstate: Optional[dict] = None, teacher_cfg=None, forward_fn=None,
                 teacher_forward_fn=None) -> torch.Tensor:
    """The combined CE + KD loss of one batch (the teacher frozen)."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    cfg = qat_mod.train_cfg(model_cfg)
    if forward_fn is not None:
        s_logits = forward_fn(cfg, student_params, inp, layout=layout, qstate=qstate)[0]
    else:
        s_logits = llama.forward(cfg, student_params, inp, layout=layout, qstate=qstate)[0]
    tcfg = qat_mod.train_cfg(teacher_cfg or model_cfg)
    tfwd = teacher_forward_fn or forward_fn
    with torch.no_grad():
        if tfwd is not None:
            t_logits = tfwd(tcfg, teacher_params, inp)[0]
        else:
            t_logits = llama.forward(tcfg, teacher_params, inp)[0]
    ce = qat_mod.cross_entropy(s_logits, tgt)
    if kd.loss == "mft":
        kdl = losses.mft_loss(s_logits, t_logits, tgt, kd.mft_correction)
    else:
        kdl = losses.logits_kl(s_logits, t_logits, kd.temperature)
    return kd.kd_weight * kdl + (1.0 - kd.kd_weight) * ce


def make_distill_step(model_cfg: llama.LlamaConfig, kd: KDConfig = KDConfig(), lr: float = 1e-4,
                      layout: Optional[llama.QuantLayout] = None, teacher_cfg=None, forward_fn=None,
                      teacher_forward_fn=None):
    """An SGD distillation step: step(student, teacher, tokens, qstate=None)
    -> (student, loss); pass `layout` and the qstate for QAD."""

    def step(student_params, teacher_params, tokens, qstate=None):
        loss, grads = qat_mod.value_and_grad(
            lambda p: distill_loss(model_cfg, p, teacher_params, tokens, kd, layout, qstate, teacher_cfg,
                                   forward_fn, teacher_forward_fn), student_params)
        return qat_mod.sgd_update(student_params, grads, lr), loss

    return step


def export_student(student_params: dict) -> dict:
    """The standalone student (`distill/mode.py` export): the params already
    are it in this functional design; kept for the API's names."""
    return student_params
