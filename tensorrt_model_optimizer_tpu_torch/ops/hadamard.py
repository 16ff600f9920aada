"""Fast Walsh-Hadamard transform, the rotation primitive of the quantizer's
`rotate` option (port of `ops/hadamard.py`).

An orthonormal FWHT in log2(n) butterfly steps, no materialized H. H is
symmetric and orthonormal, so rotating both the activation and the weight's
input dim keeps the product: (x H)(W H)^T = x W^T.
"""

from __future__ import annotations

import torch


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Orthonormal fast Walsh-Hadamard transform along `axis` (dim = 2^k)."""
    ax = axis % x.ndim
    n = x.shape[ax]
    if not is_pow2(n):
        raise ValueError(f"FWHT dim must be a power of 2, got {n}")
    x = torch.movedim(x, ax, -1)
    shape = x.shape
    h = 1
    while h < n:
        x = x.reshape(*shape[:-1], n // (2 * h), 2, h)
        a, b = x[..., 0, :], x[..., 1, :]
        x = torch.stack([a + b, a - b], dim=-2)
        h *= 2
    x = x.reshape(shape) / torch.sqrt(torch.tensor(float(n), dtype=x.dtype, device=x.device))
    return torch.movedim(x, -1, ax)


def largest_pow2_divisor(n: int) -> int:
    return n & (-n)


def blocked_fwht(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """FWHT over the largest power-of-2 blocks dividing the dim (a dim that
    is not a power of 2 rotates blockwise, as grouped Hadamard in QuaRot)."""
    ax = axis % x.ndim
    n = x.shape[ax]
    b = largest_pow2_divisor(n)
    if b == n:
        return fwht(x, ax)
    x = torch.movedim(x, ax, -1)
    shape = x.shape
    x = fwht(x.reshape(*shape[:-1], n // b, b), -1)
    return torch.movedim(x.reshape(shape), -1, ax)
