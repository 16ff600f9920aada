"""SmoothQuant: alpha-blended per-channel scale migration, activation to
weight (port of `quant/calib/smoothquant.py`).

    s_j = clamp(act_amax_j^alpha / w_amax_j^(1 - alpha))

with w_amax_j the input channel's largest weight magnitude over every
linear sharing the input. The activation is multiplied by
pre_quant_scale = 1/s and weight column j by s_j. Leading dims ([L, ...]
stacks) broadcast.
"""

from __future__ import annotations

from typing import Sequence

import torch


def smoothquant_scales(act_amax: torch.Tensor, weights: Sequence[torch.Tensor], alpha: float = 1.0,
                       eps: float = 1e-5) -> torch.Tensor:
    """Per-channel migration scale s (the activation is divided by s)."""
    w_amax = None
    for w in weights:
        wa = torch.amax(torch.abs(w.float()), dim=-2)
        w_amax = wa if w_amax is None else torch.maximum(w_amax, wa)
    a = torch.clamp_min(act_amax.float(), eps)
    wmx = torch.clamp_min(w_amax, eps)
    s = torch.pow(a, alpha) / torch.pow(wmx, 1.0 - alpha)
    s = torch.clamp(s, 1e-4, 1e4)
    return torch.where(act_amax <= eps, torch.ones_like(s), s)  # degenerate channels keep 1


def _fold(weights, s):
    return [(w.float() * s[..., None, :]).to(w.dtype) for w in weights]


def apply_smoothquant(act_amax: torch.Tensor, weights: Sequence[torch.Tensor],
                      alpha: float = 1.0) -> tuple[list, torch.Tensor]:
    """(weights with s folded into their columns, pre_quant_scale = 1/s)."""
    s = smoothquant_scales(act_amax, weights, alpha)
    return _fold(weights, s), 1.0 / s


AUTO_ALPHAS = tuple(round(0.1 * i, 1) for i in range(1, 11))


def smoothquant_auto_losses(x: torch.Tensor, act_amax: torch.Tensor, weights: Sequence[torch.Tensor],
                            wq_fns: Sequence, alphas: Sequence[float] = AUTO_ALPHAS, act_levels: float = 127.0,
                            include_identity: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(each candidate's scale s [n, L, d_in], its quantized-GEMM output MSE
    [n, L]) for x [L, n_tok, d_in]: no migration (s = 1) first where
    `include_identity`, then each alpha, simulating the weight quantizers
    (`wq_fns`) and a per-tensor static INT8 activation quantizer (the amax
    of the scaled capture)."""
    xf = x.float()
    wfs = [w.float() for w in weights]
    y_refs = [torch.einsum("lnk,lok->lno", xf, wf) for wf in wfs]
    errs, scales = [], []
    for alpha in ((None, *alphas) if include_identity else alphas):
        s = torch.ones_like(act_amax.float()) if alpha is None else smoothquant_scales(act_amax, weights, alpha)
        xs_ = xf * (1.0 / s)[:, None, :]
        a_amax = torch.amax(torch.abs(xs_), dim=(1, 2), keepdim=True)
        a_sc = torch.where(a_amax == 0, torch.ones_like(a_amax), a_amax / act_levels)
        xq = torch.clamp(torch.round(xs_ / a_sc), -act_levels - 1, act_levels) * a_sc
        err = 0.0
        for wf, qfn, y_ref in zip(wfs, wq_fns, y_refs):
            y_q = torch.einsum("lnk,lok->lno", xq, qfn(wf * s[:, None, :]).float())
            err = err + torch.mean((y_ref - y_q) ** 2, dim=(1, 2))
        errs.append(err)
        scales.append(s)
    return torch.stack(scales), torch.stack(errs)


def smoothquant_auto(x: torch.Tensor, act_amax: torch.Tensor, weights: Sequence[torch.Tensor],
                     wq_fns: Sequence, alphas: Sequence[float] = AUTO_ALPHAS, act_levels: float = 127.0,
                     include_identity: bool = True) -> tuple[list, torch.Tensor, torch.Tensor]:
    """Per-layer auto-alpha SmoothQuant: each layer takes the candidate of
    `smoothquant_auto_losses` whose loss is least. Returns (folded weights,
    pre_quant_scale = 1/s, best candidate index [L])."""
    scales, errs = smoothquant_auto_losses(x, act_amax, weights, wq_fns, alphas, act_levels, include_identity)
    best = torch.argmin(errs, dim=0)
    s = torch.take_along_dim(scales, best[None, :, None], dim=0)[0]
    return _fold(weights, s), 1.0 / s, best
