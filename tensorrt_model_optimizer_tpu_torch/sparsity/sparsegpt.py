"""SparseGPT's Hessian (port of `sparsity/sparsegpt.py`, `hessian_from_acts`
only): the second-order statistic GPTQ shares with SparseGPT. The pruning
itself comes with the sparsity slice."""

from __future__ import annotations

import torch


def hessian_from_acts(x: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """H = X^T X plus mean-diagonal damping. x: [n_tokens, K] -> [K, K] f32."""
    x32 = x.float()
    H = x32.t() @ x32
    damp = damp_frac * torch.mean(torch.diagonal(H))
    return H + damp * torch.eye(H.shape[0], dtype=torch.float32, device=H.device)
