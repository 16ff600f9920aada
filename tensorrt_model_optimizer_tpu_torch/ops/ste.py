"""Straight-through estimators for fake quantization (port of `ops/ste.py`).

Each fake-quant family gets a `torch.autograd.Function` with JAX's
`custom_vjp` contract:

 - static-amax formats (int, fp): dL/dx = g * 1[|x| <= amax], dL/damax = 0
   (amax is calibration state; LSQ trains it through its own function);
 - NVFP4 (with or without a calibrated global amax), the MX formats, MXINT,
   generic dynamic blocks, dynamic per-token or per-tensor scales, and the
   `pass_through_bwd` mode: identity backward, zero for the global amax;
 - `fake_quant_int_lsq`: the LSQ gradient wrt amax, (round(v) - v) / bound
   inside the range and sign(v) at the clip, summed over the axes along
   which amax broadcasts, as JAX's `_lsq_bwd` sums it, with its divisions
   by the bound as XLA compiles them (products by the f32 reciprocal).

The forwards are `ops/numerics.py`'s, bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import numerics


def _clip_mask(x: torch.Tensor, amax: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return (torch.abs(x.float()) <= amax.float()).to(g.dtype)


class _ClippedSTE(torch.autograd.Function):
    """y = fn(x, amax); dx = g * 1[|x| <= amax], damax = 0."""

    @staticmethod
    def forward(ctx, x, amax, fn):
        ctx.save_for_backward(x, amax)
        return fn(x, amax)

    @staticmethod
    def backward(ctx, g):
        x, amax = ctx.saved_tensors
        da = torch.zeros_like(amax) if ctx.needs_input_grad[1] else None
        return g * _clip_mask(x, amax, g), da, None


class _IdentitySTE(torch.autograd.Function):
    """y = fn(x); dx = g, and zero for the optional amax argument."""

    @staticmethod
    def forward(ctx, x, amax, fn):
        ctx.amax_shape = None if amax is None else (amax.shape, amax.dtype, amax.device)
        return fn(x) if amax is None else fn(x, amax)

    @staticmethod
    def backward(ctx, g):
        da = None
        if ctx.needs_input_grad[1]:
            shape, dtype, device = ctx.amax_shape
            da = torch.zeros(shape, dtype=dtype, device=device)
        return g, da, None


def fake_quant_int_ste(x: torch.Tensor, amax: torch.Tensor, num_bits: int = 8, unsigned: bool = False,
                       narrow_range: bool = False) -> torch.Tensor:
    amax = torch.as_tensor(amax, device=x.device)
    return _ClippedSTE.apply(x, amax, lambda t, a: numerics.fake_quant_int(t, a, num_bits, unsigned, narrow_range))


def fake_quant_fp_ste(x: torch.Tensor, amax: torch.Tensor, ebits: int = 4, mbits: int = 3) -> torch.Tensor:
    amax = torch.as_tensor(amax, device=x.device)
    return _ClippedSTE.apply(x, amax, lambda t, a: numerics.fake_quant_fp(t, a, ebits, mbits))


def fake_quant_nvfp4_ste(x: torch.Tensor, block_size: int = 16, global_amax: Optional[torch.Tensor] = None,
                         axis: int = -1) -> torch.Tensor:
    """NVFP4 fake quant with identity backward (dynamic block scales); the
    global amax, where given, takes a zero gradient."""
    if global_amax is None:
        return _IdentitySTE.apply(x, None, lambda t: numerics.fake_quant_nvfp4(t, block_size, None, axis))
    return _IdentitySTE.apply(x, global_amax, lambda t, a: numerics.fake_quant_nvfp4(t, block_size, a, axis))


def fake_quant_mx_ste(x: torch.Tensor, ebits: int, mbits: int, block_size: int = 32, axis: int = -1) -> torch.Tensor:
    return _IdentitySTE.apply(x, None, lambda t: numerics.fake_quant_mx(t, ebits, mbits, block_size, axis))


def pass_through(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """`fn` forward with identity backward (the `pass_through_bwd` mode, and
    every dynamic-scale format)."""
    return _IdentitySTE.apply(x, None, fn)


class _LSQ(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, amax, num_bits):
        ctx.save_for_backward(x, amax)
        ctx.num_bits = num_bits
        return numerics.fake_quant_int(x, amax, num_bits)

    @staticmethod
    def backward(ctx, g):
        x, amax = ctx.saved_tensors
        bound = float(2 ** (ctx.num_bits - 1) - 1)
        # XLA compiles JAX's divisions by the constant bound into products
        # by its f32 reciprocal (JAX's QAT step runs compiled, under the
        # layer scan): at a channel's largest weight v lands on one side of
        # the bound or the other by that last bit, so the port multiplies
        # as XLA does
        inv = torch.tensor(1.0 / bound, dtype=torch.float32, device=x.device)
        scale = torch.clamp(amax.float(), min=1e-12) * inv
        v = x.float() / scale
        inside = torch.abs(v) <= bound
        dx = g * inside.to(g.dtype)
        if not ctx.needs_input_grad[1]:
            return dx, None, None
        # dq/damax per element, then summed over the axes amax broadcasts over
        ga = g.float() * torch.where(inside, (torch.round(v) - v) * inv, torch.sign(v))
        extra = ga.ndim - amax.ndim
        if extra > 0:
            ga = ga.sum(dim=tuple(range(extra)))
        for ax in range(amax.ndim):
            if amax.shape[ax] == 1 and ga.shape[ax] != 1:
                ga = ga.sum(dim=ax, keepdim=True)
        return dx, ga.float().reshape(amax.shape), None


def fake_quant_int_lsq(x: torch.Tensor, amax: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """INT fake quant with the LSQ gradient wrt amax (learned scale): inside
    the range dy/damax = (round(v) - v) / bound, at the clip +-1."""
    return _LSQ.apply(x, torch.as_tensor(amax, device=x.device), num_bits)
