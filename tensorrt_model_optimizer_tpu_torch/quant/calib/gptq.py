"""GPTQ: Hessian-compensated weight quantization (port of
`quant/calib/gptq.py`).

The weight is processed in column blocks with H = X^T X from calibration
activations: each column is quantized on its grid and its error spread
over the later columns through the rows of the upper Cholesky factor of
H^-1 (the OBS update). Within a block the columns go one at a time; the
block's errors E [O, B] reach the later columns once, as E @ Hinv[block
rows, later columns]. The JAX package adds every column's error to a full
[O, K] accumulator instead (at the 8B down_proj a 235 MB update a column,
14336 times); the sum is the same, only the order of the f32 additions
differs. Rows are independent, so `quant.ptq` runs the projections that
share an input as one stacked weight.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...ops import numerics
from ...sparsity.sparsegpt import hessian_from_acts
from ..quantizer import QuantizerConfig


def gptq_quantize(w: torch.Tensor, H: torch.Tensor,
                  quant_col: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  amax_full: torch.Tensor, block: int = 128) -> torch.Tensor:
    """The GPTQ-updated fake-quantized weight [O, K] in w's dtype."""
    O, K = w.shape
    block = min(block, K)
    if K % block:
        block = 1
    # the upper Cholesky factor of H^-1 (rows index columns), H^-1 taken
    # from H's own factor: JAX's cholesky(inv(H)).T, but an f32 inverse of
    # a Hessian of 512 tokens at K = 4096 is not positive definite
    Hinv = torch.linalg.cholesky(torch.cholesky_inverse(torch.linalg.cholesky(H)), upper=True)
    d = torch.diagonal(Hinv)
    W = w.float().clone()
    for start in range(0, K, block):
        end = start + block
        Wb = W[:, start:end].clone()
        Ab = amax_full[:, start:end]
        Hb = Hinv[start:end, start:end]
        E = torch.empty((O, block), dtype=torch.float32, device=w.device)
        for ci in range(block):
            wcol = Wb[:, ci]
            q = quant_col(wcol, Ab[:, ci])
            err = (wcol - q) / d[start + ci]
            Wb[:, ci + 1:] -= err[:, None] * Hb[ci, ci + 1:][None, :]
            Wb[:, ci] = q
            E[:, ci] = err
        W[:, start:end] = Wb
        if end < K:
            W[:, end:] -= E @ Hinv[start:end, end:]
    return W.to(w.dtype)


def gptq_int_col(num_bits: int):
    """Column quantizer on the symmetric INT grid."""

    def quant_col(col: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
        return numerics.fake_quant_int(col, amax, num_bits)

    return quant_col


def amax_grid_for(w: torch.Tensor, wcfg: QuantizerConfig) -> torch.Tensor:
    """Element-wise amax grid of the weight quantizer, from the original
    weights (the scales are fixed before the column loop)."""
    base = wcfg.sequential[0] if wcfg.sequential else wcfg
    w32 = torch.abs(w.float())
    if base.block is not None and base.block.sizes:
        return numerics.block_reduce_amax(w32, base.block.sizes)
    if base.axis is not None:
        kept = tuple(a % w.ndim for a in base.axis)
        red = tuple(i for i in range(w.ndim) if i not in kept)
        return torch.amax(w32, dim=red, keepdim=True).expand(w.shape)
    return torch.amax(w32).expand(w.shape)


def col_quantizer(wcfg: QuantizerConfig):
    """The column quantizer of a weight config (its first stage when
    sequential)."""
    base = wcfg.sequential[0] if wcfg.sequential else wcfg
    if base.is_fp:
        e, m = base.num_bits
        return lambda col, am: numerics.fake_quant_fp(col, am, e, m)
    return gptq_int_col(base.num_bits)


def gptq_calibrate_weight(w: torch.Tensor, x: torch.Tensor, wcfg: QuantizerConfig, block: int = 128,
                          damp: float = 0.01) -> torch.Tensor:
    """One-call GPTQ of a linear: activations x [n_tok, K], weight [O, K] ->
    the error-compensated fake-quantized weight (stored in place of the
    original: the quantizer then sees values already on its grid)."""
    return gptq_quantize(w, hessian_from_acts(x, damp), col_quantizer(wcfg), amax_grid_for(w, wcfg), block)
