"""Quantization numerics on tensors (port of `ops/numerics.py`).

Bit-exact with the JAX reference: the integer grids (round half to even, as
`torch.round` and `jnp.round` both do), the saturating E4M3/E5M2 casts, the
arithmetic mini-float rounding (`fp_round`, `fp4_round`), NVFP4's two-level
scales, the MX formats' shared E8M0 scale, per-block amax and its expansion,
the nibble packs, and NVFP4's two packed forms (interleaved nibbles for
weights, planes for the KV cache). Exponents and powers of two go through the f32 bit
pattern (`_floor_log2`, `_exp2i`), so they are exact on every device. NF4
comes with its own slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .formats import fp_emax, fp_max_representable, int_max_bound, int_min_bound

_F32_TINY = 1.1754943508222875e-38  # smallest normal f32, 2^-126


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) as int32 for normal positive f32 `x` (the biased
    exponent field; what `frexp(x)[1] - 1` gives)."""
    return ((x.view(torch.int32) >> 23) & 0xFF) - 127


def _exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact f32 2^e for int32 `e` in [-149, 127] (what `ldexp(1.0, e)`
    gives), built from the bit pattern: subnormal below -126."""
    e = e.to(torch.int32)
    normal = (e + 127) << 23
    sub = torch.ones_like(e) << torch.clamp(e + 149, 0, 22)
    return torch.where(e >= -126, normal, sub).view(torch.float32)


def fp_round(x: torch.Tensor, ebits: int, mbits: int, saturate: bool = True) -> torch.Tensor:
    """Round `x` to the nearest (E, M) mini-float value, ties to even;
    normals and subnormals. With `saturate`, magnitudes beyond the largest
    representable clamp to it."""
    x = x.float()
    maxval = fp_max_representable(ebits, mbits)
    bias = 2 ** (ebits - 1) - 1
    absx = torch.abs(x)
    e = _floor_log2(torch.clamp_min(absx, _F32_TINY))
    # subnormals round on the fixed 2^(1-bias-mbits) grid
    e = torch.clamp_min(e, 1 - bias)
    quantum = _exp2i(e - mbits)
    q = torch.round(x / quantum) * quantum
    if saturate:
        q = torch.clamp(q, -maxval, maxval)
    return torch.where(absx == 0.0, torch.zeros_like(q), q)


# E2M1 representable magnitudes, and the midpoints between neighbours
E2M1_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
_E2M1_MIDPOINTS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


def fp4_round(x: torch.Tensor) -> torch.Tensor:
    """E2M1 rounding with the reference's decision boundaries: <= 0.25 -> 0,
    < 0.75 -> 0.5, <= 1.25 -> 1, < 1.75 -> 1.5, <= 2.5 -> 2, < 3.5 -> 3,
    <= 5 -> 4, else 6 (ties to the even mantissa)."""
    x = x.float()
    m = torch.abs(x)
    mag = torch.full_like(m, 6.0)
    for le, bound, val in ((True, 5.0, 4.0), (False, 3.5, 3.0), (True, 2.5, 2.0), (False, 1.75, 1.5),
                           (True, 1.25, 1.0), (False, 0.75, 0.5), (True, 0.25, 0.0)):
        mag = torch.where(m <= bound if le else m < bound, val, mag)
    return torch.sign(x) * mag


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
    if (ebits, mbits) == (2, 1):
        return fp4_round(x)
    return fp_round(x, ebits, mbits)


def e8m0_scale(amax: torch.Tensor, elem_emax: int) -> torch.Tensor:
    """OCP MX shared scale: 2^(floor(log2(amax)) - emax_elem), clamped to
    E8M0's [-127, 127]; a zero amax gives 1. A subnormal amax counts as
    zero, as it does under XLA, which flushes subnormals."""
    amax = torch.abs(amax.float())
    e = torch.clamp(_floor_log2(torch.clamp_min(amax, _F32_TINY)) - elem_emax, -127, 127)
    scale = _exp2i(e)
    return torch.where(amax < _F32_TINY, torch.ones_like(scale), scale)


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
# NVFP4 (E2M1 values, E4M3 block scales, f32 global scale) and MX formats
# --------------------------------------------------------------------------

NVFP4_GLOBAL_DIV = 6.0 * 448.0


def nvfp4_global_scale(global_amax: torch.Tensor) -> torch.Tensor:
    ga = torch.abs(torch.as_tensor(global_amax).float())
    s = ga / NVFP4_GLOBAL_DIV
    return torch.where(ga == 0.0, torch.ones_like(s), s)


def nvfp4_block_scale(block_amax: torch.Tensor, global_scale: torch.Tensor) -> torch.Tensor:
    """Two-level scale: e4m3(block_amax / (6 gs)) * gs, saturated at 448; a
    block scale that rounds to zero becomes 1."""
    gs = global_scale.float()
    s8 = cast_e4m3(block_amax.float() / (6.0 * gs))
    s8 = torch.where(s8 <= 0.0, torch.ones_like(s8), s8)
    return s8 * gs


def fake_quant_nvfp4(x: torch.Tensor, block_size: int = 16,
                     global_amax: Optional[torch.Tensor] = None, axis: int = -1) -> torch.Tensor:
    """NVFP4 fake quant along `axis` with dynamic per-block scales under a
    global amax (computed from `x` when None)."""
    dtype = x.dtype
    x32 = x.float()
    if global_amax is None:
        global_amax = torch.amax(torch.abs(x32))
    gs = nvfp4_global_scale(global_amax)
    sizes = ((axis % x.ndim, block_size),)
    sb = nvfp4_block_scale(block_amax_compact(x32, sizes), gs)
    sb_full = expand_block_scale(sb, x32.shape, sizes)
    return (fp4_round(x32 / sb_full) * sb_full).to(dtype)


def _nvfp4_codes(x: torch.Tensor, block_size: int, global_amax: Optional[torch.Tensor]):
    """E2M1 codes of `x` along the last axis, the E4M3 block scales as stored
    (non-positive scales replaced by 1, saturated at 448) and the f32 global
    scale: the shared arithmetic of the two packed forms."""
    x32 = x.float()
    if global_amax is None:
        global_amax = torch.amax(torch.abs(x32))
    gs = nvfp4_global_scale(global_amax)
    sizes = ((x32.ndim - 1, block_size),)
    s8_val = cast_e4m3(block_amax_compact(x32, sizes) / (6.0 * gs))
    s8_val = torch.where(s8_val <= 0.0, torch.ones_like(s8_val), s8_val)
    s8 = torch.clamp(s8_val, -448.0, 448.0).to(torch.float8_e4m3fn)
    sb_full = expand_block_scale(s8_val * gs, x32.shape, sizes)
    return fp4_to_codes(fp4_round(x32 / sb_full)), s8, gs


def real_quant_nvfp4(x: torch.Tensor, block_size: int = 16,
                     global_amax: Optional[torch.Tensor] = None):
    """Packed NVFP4 along the last axis: (uint8 nibbles [..., N/2] with the
    even index in the low nibble, block scales as float8_e4m3fn
    [..., N/block], f32 global scale). Decoded block scale = e4m3 value x
    global scale."""
    codes, s8, gs = _nvfp4_codes(x, block_size, global_amax)
    return pack_nibbles(codes), s8, gs


def real_quant_nvfp4_planes(x: torch.Tensor, block_size: int = 16,
                            global_amax: Optional[torch.Tensor] = None):
    """Plane-packed NVFP4 along the last axis (the serving KV-cache layout):
    byte j holds the codes of elements j (low nibble) and j + N/2 (high
    nibble). The arithmetic is `real_quant_nvfp4`'s; only the byte order
    differs. Returns (planes uint8 [..., N/2], the E4M3 block scales' bit
    patterns as uint8 [..., N/block], f32 global scale)."""
    codes, s8, gs = _nvfp4_codes(x, block_size, global_amax)
    h = x.shape[-1] // 2
    return codes[..., :h] | (codes[..., h:] << 4), s8.view(torch.uint8), gs


def nvfp4_planes_code_load(planes: torch.Tensor, scale_bits: torch.Tensor,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Plane-packed NVFP4 -> code-domain values (E2M1 value x E4M3 block
    scale, no global scale): what the attention kernels decode in registers."""
    codes = torch.cat([planes & 0xF, (planes >> 4) & 0xF], dim=-1)
    vals = codes_to_fp4(codes)
    s = scale_bits.view(torch.float8_e4m3fn).float()
    block = vals.shape[-1] // s.shape[-1]
    sexp = expand_block_scale(s, vals.shape, ((vals.ndim - 1, block),))
    return (vals * sexp).to(out_dtype)


_TABLES: dict = {}


def _table(values: tuple, device: torch.device) -> torch.Tensor:
    """`values` as an f32 tensor on `device`, made once per device: a host
    copy would break a CUDA-graph capture, and the decode steps' eager first
    run makes every table it needs before its capture."""
    key = (values, device)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.tensor(values, dtype=torch.float32, device=device)
    return t


def fp4_to_codes(q: torch.Tensor) -> torch.Tensor:
    """E2M1 values -> 4-bit codes (sign bit | index of the nearest
    magnitude, the lower index on a tie)."""
    m = torch.abs(q.float())
    mids = _table(_E2M1_MIDPOINTS, m.device)
    idx = torch.bucketize(m.contiguous(), mids)  # number of midpoints strictly below m
    sign = (q < 0).to(torch.uint8) << 3
    return idx.to(torch.uint8) | sign


def codes_to_fp4(codes: torch.Tensor) -> torch.Tensor:
    mags = _table(E2M1_VALUES, codes.device)
    c = codes.to(torch.int64)
    sign = torch.where((c & 0x8) != 0, -1.0, 1.0)
    return sign * mags[c & 0x7]


def fake_quant_mx(x: torch.Tensor, ebits: int, mbits: int, block_size: int = 32,
                  axis: int = -1) -> torch.Tensor:
    """MXFP4/6/8 fake quant: per-block E8M0 scale, elements cast to (E, M)."""
    dtype = x.dtype
    x32 = x.float()
    sizes = ((axis % x.ndim, block_size),)
    scale = e8m0_scale(block_amax_compact(x32, sizes), fp_emax(ebits, mbits))
    s_full = expand_block_scale(scale, x32.shape, sizes)
    return (fp_cast(x32 / s_full, ebits, mbits) * s_full).to(dtype)


# --------------------------------------------------------------------------
# Nibble pack / unpack (even index in the low nibble); INT4 is two's complement
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
