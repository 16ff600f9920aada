"""Weight-only GEMMs: bf16 activations x packed weights (port of the
weight-only kernels of `ops/pallas/qmm.py`).

Three kernels, each one function that the JAX package wrote in several TPU
layouts (plane, word, word2, bd2, perm, bd4 exist to suit Mosaic's tiling
and bitcast order; here a weight row is contiguous in K and a thread reads
it 16 bytes at a time):

  `int4_wo_matmul`  csrc/qmm_int4_wo.cu   qmm_int4_bd2 / qmm_int4 /
                                          qmm_int4_word / qmm_int4_word2
  `fp4_wo_matmul`   csrc/qmm_fp4_wo.cu    qmm_nvfp4_word2 / qmm_nvfp4 /
                                          qmm_nvfp4_perm / qmm_nvfp4_word /
                                          qmm_nvfp4_bd4 (NVFP4 and MXFP4)
  `byte_wo_matmul`  csrc/qmm_byte_wo.cu   qmm_int8 / qmm_fp8

All three share one tensor-core main loop (`csrc/qmm_wo_common.cuh`): the
weights decode to bf16 exactly (int4 and int8 codes, e4m3 values, and
e2m1 x block scale, which has at most 6 significant bits), the products sum
in f32, and the scales that are not exact in bf16 apply to f32 sums:

  int4:  y = sum_b s[b, o] * (sum_{k in block b} x[n, k] q[o, k])   blocks in order
  fp4:   y = gs * sum_k x[n, k] * (e2m1[o, k] * s[o, k / bsz])
  byte:  y = scale[o] * sum_k x[n, k] * q[o, k]

The plain versions compute the same sums in f32 with `torch.matmul`; the
tensor cores add in another order, so kernel and plain version agree to f32
rounding of the sums and to the bf16 rounding of the output, not bit for
bit. On a CUDA tensor a wrapper launches its kernel or raises; only CPU
tensors take the plain version.

At decode (N <= 16) the kernels split K over the grid in whole 128-wide
blocks (`qmm.decode_splits`: as many splits as one wave of blocks holds)
and sum the splits' f32 partials in split order inside the same launch, so
a call is one launch and its result does not change from run to run. The
int4 partial of a split is its blocks' scaled sums in order, so only the
order of the f32 additions differs from the plain version's. The partials
and the per-tile arrival counters live in a workspace allocated once per
(device, stream) and reused (`qmm._workspace`, shared with the W4A8 decode
route): the kernels leave every counter at 0, no call allocates it again
once it is large enough, and two calls on one stream never overlap (the
engine runs one stream).

Layouts (this port's own; `quant/compress.py` `word_convert_site` makes them):

  "int4wo"   packed [O, Kp/2] uint8, the byte order of "int4a8"
             (`ops/cuda/qmm.py`), Kp = K rounded up to 128; scales [Kp/B,
             O] f32 for blocks of B = 128 or 64 (NF4_WEIGHT_ONLY_CFG's:
             the decode route then reads each half of a 128-block apart). The packer decides the rounding: the
             layout names whose JAX pack rounds the block scales to bf16
             (bd2, word, word2) store bf16-rounded values, "blockdot" keeps
             the f32 scales, so the kernel reads f32 either way.
  "nvfp4wo"  packed [O, Kp/2] uint8, natural E2M1 codes, byte i of a row =
             code(k = 2i) | code(k = 2i + 1) << 4, Kp = K rounded up to 64;
             scales [O, Kp/16] float8_e4m3fn; global_scale f32 scalar.
  "mxfp4wo"  the same bytes; scales [O, Kp/32] int8 exponents clamped to
             [-126, 127] (the scale is 2^e, as JAX's `_exp_to_bf16` makes it).
  "int8", "fp8"  the canonical packs as they are: q [O, K] one byte a
             weight, scale [O, 1] or scalar.
  Padded k's hold code 0 and the scale 1, so they add nothing.

The byte order is fixed (no run-time probe): it is the counterpart of JAX's
`_bitcast_order` Mosaic probe, which decides its word layouts' row order.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops import numerics
from . import _build
from .qmm import A8_BLOCK, _decode_split, int4_a8_codes

FP4_PAD = 64  # fp4 rows pad to the kernel's K tile

# kernel launches since the last reset (chip_smoke reads and resets them)
launches = {"qmm_int4_wo": 0, "qmm_fp4_wo": 0, "qmm_byte_wo": 0}

# --------------------------------------------------------------------------
# fp4 layout: packer and decoders
# --------------------------------------------------------------------------


def fp4_rows_pack(packed: torch.Tensor, scale_lo: torch.Tensor, scale_hi: torch.Tensor,
                  block: int):
    """Plane-packed E2M1 codes [O/2, K] (`quant/compress.py` "nvfp4" /
    "mxfp4") + plane block scales [O/2, K/block] (e4m3 values or int8
    exponents) -> (row bytes [O, Kp/2], scales [O, Kp/block], K)."""
    O2, K = packed.shape
    if K % block or scale_lo.shape[-1] * block != K:
        raise NotImplementedError(f"fp4 rows need whole {block}-wide blocks, got K={K} with "
                                  f"{scale_lo.shape[-1]} scales")
    codes = torch.cat([packed & 0xF, (packed >> 4) & 0xF], dim=0)  # [O, K]
    Kp = -(-K // FP4_PAD) * FP4_PAD
    byte = numerics.pack_nibbles(torch.nn.functional.pad(codes, (0, Kp - K)))
    scales = torch.cat([scale_lo, scale_hi], dim=0)
    if scales.dtype == torch.int8:
        scales = torch.nn.functional.pad(torch.clamp(scales, -126, 127), (0, (Kp - K) // block))
    else:  # e4m3: pad the bit patterns with 1.0 (0x38)
        bits = torch.nn.functional.pad(scales.view(torch.uint8), (0, (Kp - K) // block), value=0x38)
        scales = bits.view(torch.float8_e4m3fn)
    return byte.contiguous(), scales.contiguous(), K


def fp4_block(scales: torch.Tensor) -> int:
    """The block width a scales array implies: e4m3 -> NVFP4's 16, int8
    exponents -> MXFP4's 32."""
    if scales.dtype == torch.float8_e4m3fn:
        return 16
    if scales.dtype == torch.int8:
        return 32
    raise TypeError(f"fp4 scales are float8_e4m3fn (NVFP4) or int8 exponents (MXFP4), got {scales.dtype}")


def fp4_rows_values(packed: torch.Tensor) -> torch.Tensor:
    """Row bytes [O, Kp/2] -> E2M1 values [O, Kp] f32."""
    return numerics.codes_to_fp4(numerics.unpack_nibbles(packed))


def fp4_rows_scales(scales: torch.Tensor) -> torch.Tensor:
    """Stored block scales -> f32 values (e4m3 decoded, or 2^e)."""
    if scales.dtype == torch.int8:
        return numerics._exp2i(scales.to(torch.int32))
    return scales.float()


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def int4_block(packed: torch.Tensor, scales: torch.Tensor) -> int:
    """The K block width (128 or 64) an "int4wo" pack's shapes imply."""
    Kp, nblk = packed.shape[1] * 2, scales.shape[0]
    if Kp % A8_BLOCK or nblk * A8_BLOCK not in (Kp, 2 * Kp):
        raise ValueError(f"int4_wo: packed {tuple(packed.shape)} and scales {tuple(scales.shape)} "
                         "are not 128- or 64-wide blocks")
    return Kp // nblk


def int4_wo_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                         out_dtype=None) -> torch.Tensor:
    """[N, K] x "int4wo" arrays -> [N, O]: f32 block sums, times the block's
    scale, blocks in order."""
    N, K = x.shape
    nblk, O = scales.shape
    bsz = int4_block(packed, scales)
    codes = int4_a8_codes(packed).float()  # [O, Kp]
    xp = torch.nn.functional.pad(x.float(), (0, nblk * bsz - K))
    s = scales.float()
    acc = torch.zeros((N, O), dtype=torch.float32, device=x.device)
    for b in range(nblk):
        blk = slice(b * bsz, (b + 1) * bsz)
        acc = acc + (xp[:, blk] @ codes[:, blk].t()) * s[b]
    return acc.to(out_dtype or x.dtype)


def fp4_wo_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                        global_scale: Optional[torch.Tensor] = None, out_dtype=None) -> torch.Tensor:
    """[N, K] x "nvfp4wo" / "mxfp4wo" arrays -> [N, O]: code x block scale
    (exact), one f32 sum over K, the global scale on the output."""
    N, K = x.shape
    Kp = packed.shape[1] * 2
    s = torch.repeat_interleave(fp4_rows_scales(scales), fp4_block(scales), dim=-1)
    w = fp4_rows_values(packed) * s
    y = torch.nn.functional.pad(x.float(), (0, Kp - K)) @ w.t()
    if global_scale is not None:
        y = y * global_scale.float()
    return y.to(out_dtype or x.dtype)


def byte_wo_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                         out_dtype=None) -> torch.Tensor:
    """[N, K] x q [O, K] (int8 or e4m3) -> [N, O]: one f32 sum over K, the
    scale (scalar or per output channel) on the output."""
    y = (x.float() @ q.float().t()) * scale.float().reshape(1, -1)
    return y.to(out_dtype or x.dtype)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _check_x(x: torch.Tensor, what: str, *others: torch.Tensor) -> torch.Tensor:
    """What every kernel asks of its activations, on the card: bf16, rows
    contiguous and 16-byte aligned, everything on one device."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the kernel takes bf16 activations, got {x.dtype}")
    if x.shape[1] % 8:
        raise ValueError(f"{what}: K must be a multiple of 8 (16-byte row loads), got {x.shape[1]}")
    if not all(t.is_cuda and t.device == x.device for t in others):
        raise ValueError(f"{what}: tensors on different devices")
    return _ready(x)


def _ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (a copy only where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def int4_wo_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [N, K], packed [O, Kp/2] uint8, scales [Kp/B, O] f32 (B = 128 or
    64) -> [N, O] in x's dtype."""
    N, K = x.shape
    nblk, O = scales.shape
    if packed.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise TypeError(f"int4_wo: want uint8 codes and f32 scales, got {packed.dtype}/{scales.dtype}")
    Kp = packed.shape[1] * 2
    if packed.shape[0] != O or not Kp - A8_BLOCK < K <= Kp:
        raise ValueError(f"int4_wo: shapes x {tuple(x.shape)} packed {tuple(packed.shape)} "
                         f"scales {tuple(scales.shape)}")
    bsz = int4_block(packed, scales)
    if x.device.type == "cpu":
        return int4_wo_matmul_plain(x, packed, scales)
    _build.refuse_grad("qmm_int4_wo", x, packed, scales)
    x = _check_x(x, "int4_wo", packed, scales)
    packed, scales = _ready(packed), _ready(scales)
    y = torch.empty((N, O), dtype=torch.bfloat16, device=x.device)
    ws, counters, n_split = _decode_split(x.device, N, O, Kp)
    fn = _build.function("qmm_int4_wo", "int4_wo_gemm",
                         [_build.c_void_p] * 4 + [_build.c_int] * 5 + [_build.c_void_p] * 2 + [_build.c_int]
                         + [_build.c_void_p])
    _build.check(fn(_build.ptr(x), _build.ptr(packed), _build.ptr(scales), _build.ptr(y),
                    N, K, O, Kp, bsz, ws, counters, n_split, _build.stream()), "int4_wo_gemm")
    launches["qmm_int4_wo"] += 1
    return y


def fp4_wo_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                  global_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [N, K], packed [O, Kp/2] uint8, scales [O, Kp/16] e4m3 (NVFP4) or
    [O, Kp/32] int8 exponents (MXFP4), global_scale f32 scalar or None ->
    [N, O] in x's dtype."""
    N, K = x.shape
    O, half = packed.shape
    Kp, block = 2 * half, fp4_block(scales)
    if packed.dtype != torch.uint8:
        raise TypeError(f"fp4_wo: want uint8 codes, got {packed.dtype}")
    if Kp % FP4_PAD or scales.shape != (O, Kp // block) or not Kp - FP4_PAD < K <= Kp:
        raise ValueError(f"fp4_wo: shapes x {tuple(x.shape)} packed {tuple(packed.shape)} "
                         f"scales {tuple(scales.shape)}")
    if global_scale is not None and (global_scale.numel() != 1 or global_scale.dtype != torch.float32):
        raise ValueError("fp4_wo: global_scale must be one f32 value")
    if x.device.type == "cpu":
        return fp4_wo_matmul_plain(x, packed, scales, global_scale)
    _build.refuse_grad("qmm_fp4_wo", x, packed, scales, global_scale)
    x = _check_x(x, "fp4_wo", packed, scales, *(() if global_scale is None else (global_scale,)))
    packed, scales = _ready(packed), _ready(scales)
    gs = _build.c_void_p(None) if global_scale is None else _build.ptr(global_scale.contiguous())
    y = torch.empty((N, O), dtype=torch.bfloat16, device=x.device)
    ws, counters, n_split = _decode_split(x.device, N, O, Kp)
    fn = _build.function("qmm_fp4_wo", "fp4_wo_gemm",
                         [_build.c_void_p] * 5 + [_build.c_int] * 5 + [_build.c_void_p] * 2 + [_build.c_int]
                         + [_build.c_void_p])
    _build.check(fn(_build.ptr(x), _build.ptr(packed), _build.ptr(scales), gs, _build.ptr(y),
                    N, K, O, Kp, int(block == 32), ws, counters, n_split, _build.stream()), "fp4_wo_gemm")
    launches["qmm_fp4_wo"] += 1
    return y


def byte_wo_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [N, K], q [O, K] int8 or float8_e4m3fn, scale f32 scalar or per
    output channel ([O, 1] or [O]) -> [N, O] in x's dtype."""
    N, K = x.shape
    O = q.shape[0]
    if q.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise TypeError(f"byte_wo: want int8 or float8_e4m3fn weights, got {q.dtype}")
    if q.shape != (O, K) or scale.numel() not in (1, O):
        raise ValueError(f"byte_wo: shapes x {tuple(x.shape)} q {tuple(q.shape)} scale {tuple(scale.shape)}")
    if x.device.type == "cpu":
        return byte_wo_matmul_plain(x, q, scale)
    _build.refuse_grad("qmm_byte_wo", x, q, scale)
    if K % 16:
        raise ValueError(f"byte_wo: K must be a multiple of 16 (16-byte weight loads), got {K}")
    x = _check_x(x, "byte_wo", q, scale)
    q = _ready(q)
    col = scale.float().reshape(-1).expand(O).contiguous()
    y = torch.empty((N, O), dtype=torch.bfloat16, device=x.device)
    ws, counters, n_split = _decode_split(x.device, N, O, K)
    fn = _build.function("qmm_byte_wo", "byte_wo_gemm",
                         [_build.c_void_p] * 4 + [_build.c_int] * 4 + [_build.c_void_p] * 2 + [_build.c_int]
                         + [_build.c_void_p])
    _build.check(fn(_build.ptr(x), _build.ptr(q), _build.ptr(col), _build.ptr(y),
                    N, K, O, int(q.dtype == torch.float8_e4m3fn), ws, counters, n_split, _build.stream()),
                 "byte_wo_gemm")
    launches["qmm_byte_wo"] += 1
    return y
