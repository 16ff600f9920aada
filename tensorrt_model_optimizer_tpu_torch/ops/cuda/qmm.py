"""W4A8 GEMM: int4 block-128 weights x per-token int8 activations (port of
`ops/pallas/qmm.py` `qmm_int4_w48`).

Kernel: `csrc/qmm_w4a8.cu` (its header says what bounds it on an H100 and
what its design does about that). On a CUDA tensor `w4a8_matmul` launches
the kernel or raises; only CPU tensors take the plain PyTorch version.

Numerics: y_f32[n, o] = sum_b s[b, o] * (sum_{k in block b} x8[n, k] q[o, k]),
blocks in order, each block's integer sum exact. The plain version computes
the same sums in the same order (an f32 matmul of integer values below 2^24
is exact), so kernel and plain version agree bit for bit. JAX's kernel sums
the blocks in another order (and folds an offset-binary side term), which is
why the tests hold the two at a 1e-3 relative tolerance.

Layout "int4a8", this port's own (`int4_a8_pack`), chosen for the kernel
and matched to JAX's "int4w48" by value (`int4_rows_pack` makes the bytes,
which the weight-only layout "int4wo" of `ops/cuda/qmm_wo.py` shares):

  packed [O, Kp/2] uint8, Kp = K rounded up to the 128-wide block. Each row
      is contiguous in K, so a thread reads 32 codes of one row with one
      16-byte load. Within every group of 8 k's, byte i (i < 4) holds
      nib(k_{8g+i}) | nib(k_{8g+i+4}) << 4 (two's complement nibbles), so
      one 32-bit word decodes with two masks and one byte-wise subtract into
      two int8x4 words whose k order matches four contiguous activation
      bytes each -- the `__dp4a` operands. Padded k's hold code 0.
  scales [Kp/128, O] bf16: the f32 block scales rounded to bf16, as JAX's
      `int4_w48_pack` does (qmm.py:1324-1327); stored block-major so the
      threads of a block read one block's scales with coalesced loads.

The byte order is fixed (no run-time probe): it is the counterpart of JAX's
`_bitcast_order_i8` Mosaic probe.
"""

from __future__ import annotations

import torch

from . import _build

A8_BLOCK = 128  # the kernel's K block (one bf16 scale per 128 codes)

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def int4_rows_pack(packed: torch.Tensor, scale_lo: torch.Tensor, scale_hi: torch.Tensor):
    """Plane-packed int4 [O/2, K] (`quant/compress.py` "int4") + f32 plane
    block scales [O/2, nblk] -> (row bytes [O, Kp/2] uint8 in the order the
    docstring gives, f32 scales [nblk, O], K). The last block may be short
    (K = 704, or one block over K < 128): its tail holds code 0."""
    O2, K = packed.shape
    nblk = scale_lo.shape[-1]
    if -(-K // A8_BLOCK) != nblk:
        raise NotImplementedError(
            f"the int4 kernels take 128-wide K blocks, got {nblk} blocks over K={K}")
    nib = packed.to(torch.int32)
    codes = torch.cat([nib & 0xF, (nib >> 4) & 0xF], dim=0)  # [O, K] two's complement nibbles
    Kp = nblk * A8_BLOCK
    c = torch.nn.functional.pad(codes, (0, Kp - K)).reshape(2 * O2, Kp // 8, 2, 4)
    byte = (c[:, :, 0, :] | (c[:, :, 1, :] << 4)).to(torch.uint8)
    scales = torch.cat([scale_lo, scale_hi], dim=0).float()
    return byte.reshape(2 * O2, Kp // 2).contiguous(), scales.t().contiguous(), K


def int4_a8_pack(packed: torch.Tensor, scale_lo: torch.Tensor, scale_hi: torch.Tensor) -> dict:
    """Plane-packed int4 -> the "int4a8" arrays (see the docstring)."""
    byte, scales, K = int4_rows_pack(packed, scale_lo, scale_hi)
    return {"packed": byte, "scales": scales.to(torch.bfloat16), "in_features": K}


def int4_a8_codes(packed: torch.Tensor) -> torch.Tensor:
    """"int4a8" packed [O, Kp/2] -> signed codes [O, Kp] as int8."""
    O, half = packed.shape
    p = packed.to(torch.int16).reshape(O, half // 4, 1, 4)
    c = torch.cat([p & 0xF, (p >> 4) & 0xF], dim=2).reshape(O, 2 * half)
    return torch.where(c >= 8, c - 16, c).to(torch.int8)


def w4a8_matmul_plain(x8: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [N, K] int8 x "int4a8" arrays -> [N, O] f32."""
    N, K = x8.shape
    nblk, O = scales.shape
    codes = int4_a8_codes(packed).float()  # [O, Kp]
    xp = torch.nn.functional.pad(x8.float(), (0, nblk * A8_BLOCK - K))
    s = scales.float()
    acc = torch.zeros((N, O), dtype=torch.float32, device=x8.device)
    for b in range(nblk):
        blk = slice(b * A8_BLOCK, (b + 1) * A8_BLOCK)
        r = xp[:, blk] @ codes[:, blk].t()  # exact integer sums
        acc = acc + r * s[b]
    return acc


def _check(x8, packed, scales):
    N, K = x8.shape
    nblk, O = scales.shape
    if x8.dtype != torch.int8 or packed.dtype != torch.uint8 or scales.dtype != torch.bfloat16:
        raise TypeError(f"w4a8: want int8/uint8/bf16, got {x8.dtype}/{packed.dtype}/{scales.dtype}")
    if packed.shape != (O, nblk * A8_BLOCK // 2) or K > nblk * A8_BLOCK or K % 16:
        raise ValueError(f"w4a8: shapes x {tuple(x8.shape)} packed {tuple(packed.shape)} "
                         f"scales {tuple(scales.shape)} (K must be a multiple of 16)")


def w4a8_matmul(x8: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x8 [N, K] int8, packed [O, Kp/2] uint8, scales [Kp/128, O] bf16 ->
    [N, O] f32, before the caller's per-token activation scale."""
    _check(x8, packed, scales)
    if x8.device.type == "cpu":
        return w4a8_matmul_plain(x8, packed, scales)
    if not (packed.is_cuda and scales.is_cuda and x8.is_cuda):
        raise ValueError("w4a8: tensors on different devices")
    global launches
    N, K = x8.shape
    nblk, O = scales.shape
    x8, packed, scales = x8.contiguous(), packed.contiguous(), scales.contiguous()
    if x8.data_ptr() % 16:
        x8 = x8.clone()
    y = torch.empty((N, O), dtype=torch.float32, device=x8.device)
    fn = _build.function("qmm_w4a8", "w4a8_gemm",
                         [_build.c_void_p] * 4 + [_build.c_int] * 4 + [_build.c_void_p])
    _build.check(fn(_build.ptr(x8), _build.ptr(packed), _build.ptr(scales), _build.ptr(y),
                    N, K, O, nblk, _build.stream()), "w4a8_gemm")
    launches += 1
    return y
