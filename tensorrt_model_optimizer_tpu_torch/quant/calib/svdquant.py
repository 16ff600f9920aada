"""SVDQuant: a low-rank branch kept in high precision plus a quantized
residual (port of `quant/calib/svdquant.py`): W = B @ A (top-r SVD) +
Q(W - B @ A). The branch is a LoRA adapter of the model's forward; the
weight becomes the residual before calibration. The SVD is
`torch.linalg.svd` (JAX's is XLA's, not a Pallas kernel)."""

from __future__ import annotations

import torch


def svd_split(w: torch.Tensor, rank: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-`rank` SVD factors of w [O, K]: (A [r, K], B [O, r], residual
    [O, K] in w's dtype)."""
    w32 = w.float()
    u, s, vh = torch.linalg.svd(w32, full_matrices=False)
    B = u[:, :rank] * s[None, :rank]
    A = vh[:rank, :]
    return A, B, (w32 - B @ A).to(w.dtype)


def svdquant_weights(params_layers: dict, names, rank: int = 16) -> tuple[dict, dict]:
    """Split every named projection [L, O, K], one layer at a time: (layers
    with the residuals, adapters {name: {"A" [L, r, K], "B" [L, O, r],
    "scale" [L]}})."""
    new_layers = dict(params_layers)
    adapters = {}
    for name in names:
        w = params_layers[name]
        parts = [svd_split(w[i], rank) for i in range(w.shape[0])]
        new_layers[name] = torch.stack([p[2] for p in parts])
        adapters[name] = {"A": torch.stack([p[0] for p in parts]).to(w.dtype),
                          "B": torch.stack([p[1] for p in parts]).to(w.dtype),
                          "scale": torch.ones((w.shape[0],), dtype=torch.float32, device=w.device)}
    return new_layers, adapters
