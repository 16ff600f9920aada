"""Quantization numerics on tensors (port of `ops/numerics.py`).

Bit-exact with the JAX reference for the formats this slice serves: the
integer grids (round half to even, as `torch.round` and `jnp.round` both do),
the saturating E4M3/E5M2 casts, per-block amax and its expansion, and the
signed int4 nibble pack. NVFP4, MX and NF4 come with their own slices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .formats import fp_max_representable, int_max_bound, int_min_bound


def cast_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Saturating round trip through E4M3 (the clamp keeps NaN out)."""
    x32 = torch.clamp(x.float(), -448.0, 448.0)
    return x32.to(torch.float8_e4m3fn).float()


def cast_e5m2(x: torch.Tensor) -> torch.Tensor:
    x32 = torch.clamp(x.float(), -57344.0, 57344.0)
    return x32.to(torch.float8_e5m2).float()


def fp_cast(x: torch.Tensor, ebits: int, mbits: int) -> torch.Tensor:
    if (ebits, mbits) == (4, 3):
        return cast_e4m3(x)
    if (ebits, mbits) == (5, 2):
        return cast_e5m2(x)
    raise NotImplementedError(
        f"E{ebits}M{mbits} rounding comes with the NVFP4/MX slice")


# --------------------------------------------------------------------------
# INT fake / real quant
# --------------------------------------------------------------------------


def int_scale_from_amax(amax: torch.Tensor, num_bits: int, unsigned: bool = False,
                        narrow_range: bool = False) -> torch.Tensor:
    bound = int_max_bound(num_bits, unsigned, narrow_range)
    amax = torch.as_tensor(amax).float()
    scale = amax / bound
    # zero-amax guard: degenerate channels quantize to 0 with scale 1
    return torch.where(amax == 0.0, torch.ones_like(scale), scale)


def fake_quant_int(x: torch.Tensor, amax: torch.Tensor, num_bits: int = 8,
                   unsigned: bool = False, narrow_range: bool = False) -> torch.Tensor:
    """Symmetric int fake quant: round(x/scale) clamped, times scale."""
    dtype = x.dtype
    scale = int_scale_from_amax(amax, num_bits, unsigned, narrow_range)
    lo = float(int_min_bound(num_bits, unsigned, narrow_range))
    hi = float(int_max_bound(num_bits, unsigned, narrow_range))
    q = torch.clamp(torch.round(x.float() / scale), lo, hi)
    return (q * scale).to(dtype)


def real_quant_int(x: torch.Tensor, amax: torch.Tensor, num_bits: int = 8,
                   unsigned: bool = False, narrow_range: bool = False):
    """Returns (int values as int8, f32 scale), for num_bits <= 8."""
    scale = int_scale_from_amax(amax, num_bits, unsigned, narrow_range)
    lo = float(int_min_bound(num_bits, unsigned, narrow_range))
    hi = float(int_max_bound(num_bits, unsigned, narrow_range))
    q = torch.clamp(torch.round(x.float() / scale), lo, hi)
    # XLA's f32 -> int8 convert saturates (unsigned 8-bit codes > 127 land
    # on 127); torch's wraps, so saturate first
    return torch.clamp(q, -128, 127).to(torch.int8), scale


def fake_quant_fp(x: torch.Tensor, amax: Optional[torch.Tensor], ebits: int,
                  mbits: int) -> torch.Tensor:
    """Scaled mini-float fake quant (ScaledE4M3 semantics): amax maps onto
    the format's max; without amax, a plain saturating cast."""
    dtype = x.dtype
    x32 = x.float()
    if amax is None:
        return fp_cast(x32, ebits, mbits).to(dtype)
    maxval = fp_max_representable(ebits, mbits)
    amax32 = torch.as_tensor(amax).float()
    scale = torch.where(amax32 == 0.0, torch.ones_like(amax32), amax32 / maxval)
    return (fp_cast(x32 / scale, ebits, mbits) * scale).to(dtype)


# --------------------------------------------------------------------------
# Block helpers
# --------------------------------------------------------------------------


def _normalize_axes(sizes, ndim: int, shape: Optional[Sequence[int]] = None):
    """Resolve negative axes; clamp block size to the axis length."""
    out = []
    for ax, bs in sizes:
        ax = ax % ndim
        if shape is not None:
            bs = min(bs, shape[ax])
        out.append((ax, bs))
    return sorted(out)


def _pad_to_blocks(x: torch.Tensor, norm) -> torch.Tensor:
    """Zero-pad blocked axes up to the next block multiple."""
    pads = [0] * (2 * x.ndim)
    needs = False
    for ax, bs in norm:
        r = x.shape[ax] % bs
        if r:
            # F.pad lists (last-dim lo, hi, second-to-last lo, hi, ...)
            pads[2 * (x.ndim - 1 - ax) + 1] = bs - r
            needs = True
    return torch.nn.functional.pad(x, pads) if needs else x


def _blocked_view(x: torch.Tensor, sizes):
    norm = _normalize_axes(sizes, x.ndim, x.shape)
    xp = _pad_to_blocks(x, norm)
    shape, reduce_axes = [], []
    axmap = dict(norm)
    for ax in range(x.ndim):
        d = xp.shape[ax]
        if ax in axmap:
            bs = axmap[ax]
            shape.extend([d // bs, bs])
            reduce_axes.append(len(shape) - 1)
        else:
            shape.append(d)
    return xp, xp.reshape(shape), tuple(reduce_axes)


def block_amax_compact(x: torch.Tensor, sizes) -> torch.Tensor:
    """Per-block amax in compact form: blocked axes become ceil(d/block)."""
    _, xb, red = _blocked_view(x, sizes)
    return torch.amax(torch.abs(xb), dim=red)


def block_reduce_amax(x: torch.Tensor, sizes) -> torch.Tensor:
    """Per-block amax broadcast back to x's shape."""
    xp, xb, red = _blocked_view(x, sizes)
    amax = torch.amax(torch.abs(xb), dim=red, keepdim=True)
    full = amax.expand(xb.shape).reshape(xp.shape)
    return full[tuple(slice(0, d) for d in x.shape)]


def expand_block_scale(scale: torch.Tensor, x_shape, sizes) -> torch.Tensor:
    """Expand a compact per-block scale to x_shape by repeating blocks."""
    norm = _normalize_axes(sizes, len(x_shape), x_shape)
    out = scale
    for ax, bs in norm:
        out = torch.repeat_interleave(out, bs, dim=ax)
    out = out[tuple(slice(0, d) for d in x_shape)]
    return out.expand(tuple(x_shape))


# --------------------------------------------------------------------------
# INT4 nibble pack / unpack (two's complement, even index in the low nibble)
# --------------------------------------------------------------------------


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """out = hi << 4 | lo with lo = even index, hi = odd index."""
    lo = codes[..., 0::2]
    hi = codes[..., 1::2]
    return ((hi << 4) | (lo & 0xF)).to(torch.uint8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    lo = packed & 0xF
    hi = (packed >> 4) & 0xF
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack signed int4 values [-8, 7] into uint8 nibbles."""
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    return pack_nibbles(u)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    u = unpack_nibbles(packed).to(torch.int32)
    return torch.where(u >= 8, u - 16, u).to(torch.int8)
