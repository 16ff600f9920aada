"""AWQ: activation-aware weight quantization, lite and clip (port of
`quant/calib/awq.py`).

 - awq_lite: grid-search alpha in [0, 1]; per-channel scale s =
   normalize(act_absmean^alpha); the loss is the layer-output MSE
   || X W^T - (X / s) Q(W * s)^T || on captured activations, the best alpha
   kept per layer.
 - awq_clip: per-output-row clip-ratio search shrinking the weight-block
   amax, minimizing || X W^T - X Q_clip(W)^T || over a ratio grid.

Leading dims ([L, ...] stacks) broadcast; `quant.ptq` calls both one layer
at a time.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from . import linspace


def _normalize_scale(s: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """AWQ's stabilization: s / sqrt(max(s) * min(s)), clamped."""
    smax = torch.amax(s, dim=-1, keepdim=True)
    smin = torch.amin(s, dim=-1, keepdim=True)
    s = s / torch.sqrt(torch.clamp_min(smax * smin, eps))
    return torch.clamp(s, eps, 1.0 / eps)


def awq_lite_losses(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    quant_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                    act_absmean: torch.Tensor, alpha_step: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """(the alpha grid [n], the group's layer-output MSE for each alpha [n,
    ...]) for `weights` [..., d_out, d_in] sharing the captured input x
    [..., n_tok, d_in]."""
    x32 = x.float()
    n_alpha = int(round(1.0 / alpha_step)) + 1
    alphas = linspace(0.0, 1.0, n_alpha, x.device)
    base = torch.clamp_min(act_absmean.float(), 1e-8)
    refs = [torch.einsum("...ni,...oi->...no", x32, w.float()) for w in weights]
    losses = []
    for alpha in alphas:
        s = _normalize_scale(torch.pow(base, alpha))
        xs = x32 / s[..., None, :]
        loss = 0.0
        for w, qfn, ref in zip(weights, quant_fns, refs):
            wq = qfn((w.float() * s[..., None, :]).to(w.dtype))
            out = torch.einsum("...ni,...oi->...no", xs, wq.float())
            loss = loss + torch.mean((out - ref) ** 2, dim=(-2, -1))
            del wq, out
        losses.append(loss)
    return alphas, torch.stack(losses)


def awq_lite_search(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    quant_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                    act_absmean: torch.Tensor, alpha_step: float = 0.1) -> tuple[torch.Tensor, torch.Tensor]:
    """(best alpha [...], best scale s [..., d_in]): the alpha of
    `awq_lite_losses`' grid whose loss is least. At run time the activation
    is multiplied by 1/s, the weights by s."""
    alphas, losses = awq_lite_losses(x, weights, quant_fns, act_absmean, alpha_step)
    best_alpha = alphas[torch.argmin(losses, dim=0)]
    base = torch.clamp_min(act_absmean.float(), 1e-8)
    return best_alpha, _normalize_scale(torch.pow(base, best_alpha[..., None]))


def awq_clip_losses(x: torch.Tensor, w: torch.Tensor, block_size: int,
                    quant_with_amax: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    n_ratios: int = 8, max_shrink: float = 0.5) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(block amax [..., d_out, d_in / block], the ratio grid [n], each
    output row's MSE for each ratio [n, ..., d_out]). `quant_with_amax(w,
    amax_full)` fake-quantizes under an explicit element-wise amax. d_in
    must be a whole number of blocks: the JAX package's reshape raises
    otherwise, and so does this."""
    x32, w32 = x.float(), w.float()
    K = w.shape[-1]
    bsz = min(block_size, K)
    if K % bsz:
        raise ValueError(f"awq_clip: d_in = {K} is not a whole number of {bsz}-wide blocks "
                         "(the JAX package's block reshape raises here too)")
    nblk = K // bsz
    amax0 = torch.amax(torch.abs(w32).reshape(*w32.shape[:-1], nblk, bsz), dim=-1)
    ratios = linspace(1.0, max_shrink, n_ratios, x.device)
    ref = torch.einsum("...ni,...oi->...no", x32, w32)
    losses = []
    for r in ratios:
        wq = quant_with_amax(w32, torch.repeat_interleave(amax0 * r, bsz, dim=-1))
        out = torch.einsum("...ni,...oi->...no", x32, wq.float())
        losses.append(torch.mean((out - ref) ** 2, dim=-2))
        del wq, out
    return amax0, ratios, torch.stack(losses)


def awq_clip_search(x: torch.Tensor, w: torch.Tensor, block_size: int,
                    quant_with_amax: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    n_ratios: int = 8, max_shrink: float = 0.5) -> torch.Tensor:
    """Per-block clipped amax [..., d_out, d_in / block]: each output row's
    ratio of `awq_clip_losses`' grid whose MSE is least."""
    amax0, ratios, losses = awq_clip_losses(x, w, block_size, quant_with_amax, n_ratios, max_shrink)
    return amax0 * ratios[torch.argmin(losses, dim=0)][..., None]
