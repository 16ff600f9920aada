"""N:M structured magnitude sparsity (port of `sparsity/magnitude.py`).

Within every group of M consecutive input-dim elements the N largest
magnitudes are kept. The ranking is a stable argsort of the f32
magnitudes, as JAX's `jnp.argsort`: where |w| ties inside a group (bf16
weights often do), the lower index is kept, so both packages' masks are
the same bits. `apply_mask` is multiplicative, as JAX's: a masked-off
negative weight becomes -0.0 (as in eager JAX; XLA compiles JAX's f32
multiply into a select, which writes +0.0). Either way the value is 0.
"""

from __future__ import annotations

import torch


def nm_mask(w: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """Boolean keep-mask of w's shape: within each group of `m` along the
    last axis, the `n` largest |w| (ties to the lower index)."""
    K = w.shape[-1]
    if K % m:
        raise ValueError(f"last dim {K} not divisible by m={m}")
    g = torch.abs(w.float()).reshape(*w.shape[:-1], K // m, m)
    return _top_n(g, n).reshape(w.shape)


def _top_n(g: torch.Tensor, n: int) -> torch.Tensor:
    """[..., m] scores -> the mask of each group's n largest (a stable
    descending order: equal scores keep the lower index first)."""
    order = torch.argsort(-g, dim=-1, stable=True)
    mask = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
    return mask.scatter_(-1, order[..., :n], True)


def apply_mask(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (w * mask.to(w.dtype)).to(w.dtype)


def sparsity_ratio(mask: torch.Tensor) -> float:
    return float(1.0 - torch.mean(mask.float()))
