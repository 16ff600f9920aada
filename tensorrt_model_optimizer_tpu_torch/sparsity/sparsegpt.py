"""SparseGPT: Hessian-aware N:M sparsification with weight reconstruction
(port of `sparsity/sparsegpt.py`).

With H = X^T X + λI from calibration activations the weight is processed in
column blocks: a block's N:M mask is chosen once, by the OBS saliency
(W / d)^2 on the block's weights as they stand when the block begins (d the
diagonal of H^-1's upper Cholesky factor); then column by column the pruned
weights are zeroed and their error spread over the block's later columns
through that factor's rows. The block's errors E [O, B] reach the later
blocks once, as E @ Hinv[block rows, later columns], the form of the port's
GPTQ (`quant/calib/gptq.py`): JAX adds every column's error into a full
[O, K] accumulator (at the 8B down_proj a 235 MB update a column, 14336
times); the sum is the same, only the order of the f32 additions differs.
H^-1's factor comes from H's own Cholesky (`cholesky_inverse`), where JAX
takes `cholesky(inv(H))`. Rows are independent, so `sparsify` prunes the
projections that share an input as one stacked weight.

When K is not a multiple of the block, the block falls back to the group
size m, as JAX's does (the anchor's K = 704 takes this path).
"""

from __future__ import annotations

import torch

from .magnitude import _top_n


def hessian_from_acts(x: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """H = X^T X plus mean-diagonal damping. x: [n_tokens, K] -> [K, K] f32."""
    x32 = x.float()
    H = x32.t() @ x32
    damp = damp_frac * torch.mean(torch.diagonal(H))
    return H + damp * torch.eye(H.shape[0], dtype=torch.float32, device=H.device)


def hinv_factor(H: torch.Tensor) -> torch.Tensor:
    """The upper Cholesky factor of H^-1 (its rows index W's columns), H^-1
    taken from H's own factor: JAX's cholesky(inv(H)).T, but an f32 inverse
    of a Hessian of 512 tokens at K = 4096 is not positive definite."""
    return torch.linalg.cholesky(torch.cholesky_inverse(torch.linalg.cholesky(H)), upper=True)


def sparsegpt_prune(w: torch.Tensor, H: torch.Tensor, n: int = 2, m: int = 4,
                    block: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """(pruned and reconstructed weight [O, K] in w's dtype, keep mask [O, K]
    bool). The pruned weights are exactly 0 (+0.0)."""
    O, K = w.shape
    block = min(block, K)
    if K % block:
        block = m
    Hinv = hinv_factor(H)
    d = torch.diagonal(Hinv)
    W = w.float().clone()
    M = torch.zeros((O, K), dtype=torch.bool, device=w.device)
    for start in range(0, K, block):
        end = start + block
        Wb = W[:, start:end].clone()
        db = d[start:end]
        mask_b = _top_n(((Wb / db[None, :]) ** 2).reshape(O, block // m, m), n).reshape(O, block)
        Hb = Hinv[start:end, start:end]
        E = torch.empty((O, block), dtype=torch.float32, device=w.device)
        for ci in range(block):
            wcol = Wb[:, ci]
            q = torch.where(mask_b[:, ci], wcol, 0.0)
            err = (wcol - q) / db[ci]
            Wb[:, ci + 1:] -= err[:, None] * Hb[ci, ci + 1:][None, :]
            Wb[:, ci] = q
            E[:, ci] = err
        W[:, start:end] = Wb
        M[:, start:end] = mask_b
        if end < K:
            W[:, end:] -= E @ Hinv[start:end, end:]
    return W.to(w.dtype), M
