"""FastNAS / GradNAS channel pruning for a small ConvNet (port of
`nas/cv.py`).

A quantizable classifier (stages of a 3x3 convolution, group norm, SiLU and
a stride-2 3x3 convolution, then a linear head) whose sites reuse the
UNet's convolution and linear (`models/unet.conv` / `dense`); each stage's
output channels scored by the L2 norm of their weights (FastNAS) or by the
summed squared loss gradient (GradNAS); and a binary search
(`opt.searcher.binary_search`) for the smallest uniform width ratio whose
loss stays within the budget. Scores are numpy, and the channels kept are
`np.argsort`'s, so JAX's scores give JAX's choice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..models import unet
from ..models.llama import QuantLayout
from ..opt.searcher import binary_search
from ..quant import qat


@dataclasses.dataclass(frozen=True)
class CVConfig:
    in_channels: int = 3
    widths: tuple = (16, 32)
    num_classes: int = 10
    groups: int = 4
    dtype: Any = torch.float32

    @staticmethod
    def tiny(**kw) -> "CVConfig":
        base = dict(in_channels=3, widths=(8, 16), num_classes=10, groups=4)
        base.update(kw)
        return CVConfig(**base)


def _plan(cfg: CVConfig):
    p, cin = [], cfg.in_channels
    for i, w in enumerate(cfg.widths):
        p.append((f"stage{i}.conv", "conv3", (w, cin, 3, 3)))
        p.append((f"stage{i}.down", "conv3", (w, w, 3, 3)))  # stride 2
        cin = w
    p.append(("head", "dense", (cfg.num_classes, cin)))
    return p


def init_params(cfg: CVConfig, generator: torch.Generator, device=None) -> dict:
    """Seeded N(0, 1/fan_in) weights and zero biases on `device` (the card
    unless the caller passes the CPU; `generator` lives there)."""
    dev = resolve_device(device)
    params = {}
    for name, _, shape in _plan(cfg):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        params[name] = w.div_(math.sqrt(math.prod(shape[1:]))).to(cfg.dtype)
        params[f"{name}__bias"] = torch.zeros((shape[0],), dtype=cfg.dtype, device=dev)
    return params


def build_layout(cfg: CVConfig, qcfg) -> QuantLayout:
    sites = {}
    for name, _, _ in _plan(cfg):
        sites[f"{name}.weight"] = qcfg.resolve(f"{name}.weight_quantizer")
        sites[f"{name}.input"] = qcfg.resolve(f"{name}.input_quantizer")
    return QuantLayout(sites=tuple(sites.items()))


def forward(cfg: CVConfig, params: dict, x: torch.Tensor, *, layout=None, qstate=None, calib: bool = False):
    """x [B, H, W, in_channels] -> (logits f32 [B, num_classes], new_qstate or None)."""
    layout = layout or QuantLayout(sites=())
    sub: dict = {}
    h = x.to(cfg.dtype)
    for i in range(len(cfg.widths)):
        h = unet.conv(h, params, f"stage{i}.conv", layout, qstate, calib, sub)
        h = F.silu(unet.group_norm(h, cfg.groups).float()).to(h.dtype)
        h = unet.conv(h, params, f"stage{i}.down", layout, qstate, calib, sub, stride=2)
        h = F.silu(h.float()).to(h.dtype)
    logits = unet.dense(torch.mean(h, dim=(1, 2)), params, "head", layout, qstate, calib, sub)
    return logits.float(), (sub if sub else None)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.gather(torch.log_softmax(logits, dim=-1), -1, labels.long()[:, None]))


def magnitude_scores(cfg: CVConfig, params: dict) -> dict:
    """Each stage's out-channel L2 norms (FastNAS importance), numpy."""
    return {f"stage{i}.conv": torch.sqrt(torch.sum(params[f"stage{i}.conv"].float() ** 2, dim=(1, 2, 3)))
            .detach().cpu().numpy() for i in range(len(cfg.widths))}


def gradnas_scores(cfg: CVConfig, params: dict, batches) -> dict:
    """GradNAS importance: each stage's out-channel squared loss gradient,
    summed over the batches, numpy."""
    acc = {f"stage{i}.conv": 0.0 for i in range(len(cfg.widths))}
    for x, y in batches:
        _, g = qat.value_and_grad(lambda p: cross_entropy(forward(cfg, p, x)[0], y), params)
        for name in acc:
            acc[name] = acc[name] + torch.sum(g[name].float() ** 2, dim=(1, 2, 3))
    return {k: v.detach().cpu().numpy() for k, v in acc.items()}


def slice_model(cfg: CVConfig, params: dict, scores: dict, ratio: float):
    """Keep the top `ratio` of every stage's channels (by importance, in
    their original order; widths rounded down to multiples of 4, at least
    4) -> (the smaller config, its params)."""
    new_w = tuple(max(int(w * ratio) // 4 * 4, 4) for w in cfg.widths)
    new_params = dict(params)
    prev_keep = None
    for i, w in enumerate(new_w):
        keep = torch.from_numpy(np.sort(np.argsort(-scores[f"stage{i}.conv"])[:w]))
        conv = params[f"stage{i}.conv"]
        if prev_keep is not None:
            conv = conv[:, prev_keep]
        new_params[f"stage{i}.conv"] = conv[keep]
        new_params[f"stage{i}.conv__bias"] = params[f"stage{i}.conv__bias"][keep]
        new_params[f"stage{i}.down"] = params[f"stage{i}.down"][keep][:, keep]
        new_params[f"stage{i}.down__bias"] = params[f"stage{i}.down__bias"][keep]
        prev_keep = keep
    new_params["head"] = params["head"][:, prev_keep]
    return dataclasses.replace(cfg, widths=new_w), new_params


def fastnas_prune(cfg: CVConfig, params: dict, batches, max_loss_increase: float = 0.10, steps: int = 6,
                  score_mode: str = "magnitude"):
    """Binary-search the smallest uniform width ratio whose loss on the first
    two batches stays within (1 + max_loss_increase) of the full model's ->
    (config, params, ratio)."""
    scores = gradnas_scores(cfg, params, batches) if score_mode == "gradnas" else magnitude_scores(cfg, params)

    def loss_of(c, p) -> float:
        with torch.no_grad():
            return sum(float(cross_entropy(forward(c, p, x)[0], y)) for x, y in batches[:2])

    base = loss_of(cfg, params)
    best_cut = binary_search(0.0, 0.75, lambda cut: loss_of(*slice_model(cfg, params, scores, 1.0 - cut))
                             <= base * (1 + max_loss_increase), steps=steps)
    ratio = 1.0 - best_cut
    sub_cfg, sub = slice_model(cfg, params, scores, ratio)
    return sub_cfg, sub, ratio
