"""MSE calibration: amax grid searches (port of `quant/calib/mse.py`).

`mse_amax_search` sweeps amax = amax0 * r over a shrink grid and keeps the
r minimizing || x - Q(x) ||^2 (weights are their own data);
`local_hessian_amax_search` picks each (row, block)'s ratio by the output
error || X (W - Q(W))^T ||^2 on captured activations.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import linspace


def mse_amax_losses(x: torch.Tensor, amax0: torch.Tensor,
                    quant_with_amax: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    expand: Callable[[torch.Tensor], torch.Tensor] = lambda a: a,
                    n_steps: int = 16, start: float = 0.3, stop: float = 1.0,
                    reduce_axes: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(the ratio grid [n], || x - Q(x) ||^2's mean for amax0 * each ratio
    [n, ...]). `expand(amax)` broadcasts a reduced amax against x;
    `reduce_axes` are the axes of x each amax element covers (None: all,
    one ratio for the tensor)."""
    x32 = x.float()
    ratios = linspace(start, stop, n_steps, x.device)
    losses = []
    for r in ratios:
        err = (quant_with_amax(x32, expand(amax0 * r)).float() - x32) ** 2
        losses.append(torch.mean(err) if reduce_axes is None else torch.mean(err, dim=reduce_axes))
    return ratios, torch.stack(losses)


def mse_amax_search(x: torch.Tensor, amax0: torch.Tensor,
                    quant_with_amax: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    expand: Callable[[torch.Tensor], torch.Tensor] = lambda a: a,
                    n_steps: int = 16, start: float = 0.3, stop: float = 1.0,
                    reduce_axes: tuple | None = None) -> torch.Tensor:
    """The best amax (amax0's shape): the ratio of `mse_amax_losses`' grid
    whose loss is least."""
    ratios, losses = mse_amax_losses(x, amax0, quant_with_amax, expand, n_steps, start, stop, reduce_axes)
    return amax0 * ratios[torch.argmin(losses, dim=0)]


def local_hessian_losses(x: torch.Tensor, w: torch.Tensor, amax0: torch.Tensor,
                         quant_with_amax: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                         block_size: int, n_steps: int = 8, start: float = 0.5) -> tuple[torch.Tensor, torch.Tensor]:
    """(the ratio grid [n], sum_t (x_blk @ dW_blk^T)^2 of each (row, block)
    of amax0 [O, K / bsz] for each ratio [n, O, K / bsz]). A K that is not a
    multiple of the block is padded with zero columns (they add nothing to
    the loss)."""
    x32, w32 = x.float(), w.float()
    O, K = w32.shape
    bsz = min(block_size, K)
    nblk = -(-K // bsz)
    Kp = nblk * bsz
    if Kp != K:
        x32 = torch.nn.functional.pad(x32, (0, Kp - K))
        w32 = torch.nn.functional.pad(w32, (0, Kp - K))
    ratios = linspace(start, 1.0, n_steps, x.device)
    xb = x32.reshape(-1, nblk, bsz)
    losses = []
    for r in ratios:
        full = torch.repeat_interleave(amax0 * r, bsz, dim=-1)[:, :Kp]
        dw = (w32 - quant_with_amax(w32, full)).reshape(O, nblk, bsz)
        e = torch.einsum("tbk,obk->obt", xb, dw)
        losses.append(torch.sum(e * e, dim=-1))
        del e, dw
    return ratios, torch.stack(losses)


def local_hessian_amax_search(x: torch.Tensor, w: torch.Tensor, amax0: torch.Tensor,
                              quant_with_amax: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                              block_size: int, n_steps: int = 8, start: float = 0.5) -> torch.Tensor:
    """Hessian-weighted block-scale search: each (row, block) of amax0 [O,
    K / bsz] takes the ratio of `local_hessian_losses`' grid whose loss is
    least."""
    ratios, losses = local_hessian_losses(x, w, amax0, quant_with_amax, block_size, n_steps, start)
    return amax0 * ratios[torch.argmin(losses, dim=0)]
