"""W4A8 GEMM: int4 block-128 weights x per-token int8 activations (port of
`ops/pallas/qmm.py` `qmm_int4_w48`).

Kernel: `csrc/qmm_w4a8.cu`, on the int8 tensor cores (its header says what
bounds each route on an H100 and what its design does about that). Two
routes, by N: prefill (N > 16) wgmma on tiles of 192 output rows x 128
tokens, fed by the TMA into a 5-stage ring; decode (N <= 16) mma.sync with
the weights in the MMA's M dimension and K split over the grid in whole
128-blocks (`w4a8_decode_splits`), the splits summed in order by the last
one to arrive, in the same launch. On a CUDA
tensor `w4a8_matmul` launches the kernel or raises; only CPU tensors take
the plain PyTorch version.

Numerics: y_f32[n, o] = sum_b s[b, o] * (sum_{k in block b} x8[n, k] q[o, k]),
each block's integer sum exact, folded into f32 blocks in order. The decode
route folds each split's blocks from 0.0 and then adds the splits in order;
`w4a8_matmul_plain` takes the same split (`n_split`, by default the one the
kernel takes for the shape on the tensor's device), and an f32 matmul of
integer values below 2^24 is exact, so kernel and plain version agree bit
for bit on both routes. JAX's kernel sums the blocks in another order (and
folds an offset-binary side term), which is why the tests hold the two at
a 1e-3 relative tolerance.

Layout "int4a8", this port's own (`int4_a8_pack`), chosen for the kernel
and matched to JAX's "int4w48" by value (`int4_rows_pack` makes the bytes,
which the weight-only layout "int4wo" of `ops/cuda/qmm_wo.py` shares):

  packed [O, Kp/2] uint8, Kp = K rounded up to the 128-wide block. Each row
      is contiguous in K, so a thread reads 32 codes of one row with one
      16-byte load. Within every group of 8 k's, byte i (i < 4) holds
      nib(k_{8g+i}) | nib(k_{8g+i+4}) << 4 (two's complement nibbles), so
      one 32-bit word gives, with a mask (and a shift for the low nibbles),
      two int8x4 words of 16 x the codes (a nibble in the high half of a
      byte is an exact int8) whose k order matches four contiguous
      activation bytes each: a fragment word of the MMA. Padded k's hold
      code 0.
  scales [Kp/128, O] bf16: the f32 block scales rounded to bf16, as JAX's
      `int4_w48_pack` does (qmm.py:1324-1327); stored block-major so the
      threads of a block read one block's scales with coalesced loads.

The byte order is fixed (no run-time probe): it is the counterpart of JAX's
`_bitcast_order_i8` Mosaic probe.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

A8_BLOCK = 128  # the kernel's K block (one bf16 scale per 128 codes)

launches = 0  # kernel launches since the last reset (chip_smoke reads it)

# The decode route of the split-K GEMMs (`csrc/qmm_w4a8.cu` and
# `csrc/qmm_wo_common.cuh` `decode_kernel`): their shared policy
SPLIT_K = 128              # K blocks a split is made of (int4's scale block)
DECODE_ROWS = 64           # output rows of a block: 2 warps of 32
TILE_ROWS = 32             # output rows of a warp, the fix-up's tile
TILE_FLOATS = 512          # f32 partials of a tile: 32 rows x 16 tokens
DECODE_WAVE = (6, 4)       # blocks an SM holds at N <= 8 / N <= 16 (the kernels' launch bounds)
MIN_SPLIT_BLOCKS = 4       # K blocks a split holds at least, where K has them


def decode_splits(O: int, Kp: int, N: int, sms: int) -> int:
    """Splits of the decode route's K: the ceil(Kp / 128) whole K blocks
    shared out over as many splits as one wave of blocks (DECODE_WAVE per
    SM) holds beside the ceil(O / DECODE_ROWS) row tiles, but no split of
    fewer than MIN_SPLIT_BLOCKS blocks where K has that many. One wave: a
    second, part-filled one would double the time; a few blocks a split:
    each split costs its tile a partial's write, a fence, an atomic and the
    fix-up's read, which outlast one block's loads."""
    nkb = -(-Kp // SPLIT_K)
    tiles = -(-O // DECODE_ROWS)
    return max(1, min(-(-nkb // MIN_SPLIT_BLOCKS), DECODE_WAVE[N > 8] * sms // tiles))


def w4a8_decode_splits(N: int, Kp: int, O: int, sms: int) -> int:
    """Splits of K the W4A8 kernel takes for x [N, K] over packed rows of
    Kp = nblk * 128 codes on a card with `sms` SMs: `decode_splits` at
    N <= 16 (the decode route), 1 at N > 16 (the prefill route)."""
    return decode_splits(O, Kp, N, sms) if N <= 16 else 1


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(_index(device)).multi_processor_count


_workspace: dict = {}  # (device index, stream) -> (f32 partials, int32 arrival counters)


def _decode_split(device: torch.device, N: int, O: int, Kp: int):
    """(workspace, counters, n_split) for a launch on the current stream: no
    workspace at N > 16 (the prefill route) or at one split."""
    if N > 16:
        return _build.c_void_p(None), _build.c_void_p(None), 1
    n_split = decode_splits(O, Kp, N, _sms(device))
    if n_split == 1:
        return _build.c_void_p(None), _build.c_void_p(None), 1
    tiles = -(-O // DECODE_ROWS) * (DECODE_ROWS // TILE_ROWS)
    key = (_index(device), torch.cuda.current_stream(device).cuda_stream)
    ws, counters = _workspace.get(key, (None, None))
    if ws is None or ws.numel() < tiles * n_split * TILE_FLOATS:
        ws = torch.empty(tiles * n_split * TILE_FLOATS, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < tiles:
        counters = torch.zeros(tiles, dtype=torch.int32, device=device)  # the kernels leave them at 0
    _workspace[key] = (ws, counters)
    return _build.ptr(ws), _build.ptr(counters), n_split


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


def w4a8_matmul_plain(x8: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                      n_split: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: [N, K] int8 x "int4a8" arrays -> [N, O] f32.

    The nblk K blocks go in `n_split` runs of whole blocks (run i: blocks
    i * nblk // n_split .. (i + 1) * nblk // n_split - 1); each run folds its
    blocks' scaled sums in order from 0.0, then the runs add in order, the
    decode route's schedule. n_split = 1 is one left-to-right fold over all
    blocks: the sums of the prefill route and of the CPU. None: the split
    the kernel takes for this shape on x8's device (`w4a8_decode_splits` on
    a CUDA tensor, 1 on the CPU)."""
    N, K = x8.shape
    nblk, O = scales.shape
    if n_split is None:
        n_split = w4a8_decode_splits(N, nblk * A8_BLOCK, O, _sms(x8.device)) if x8.is_cuda else 1
    if not 1 <= n_split <= nblk:
        raise ValueError(f"w4a8: n_split {n_split} outside 1..{nblk}")
    codes = int4_a8_codes(packed).float()  # [O, Kp]
    xp = torch.nn.functional.pad(x8.float(), (0, nblk * A8_BLOCK - K))
    s = scales.float()
    total = None
    for sp in range(n_split):
        acc = torch.zeros((N, O), dtype=torch.float32, device=x8.device)
        for b in range(sp * nblk // n_split, (sp + 1) * nblk // n_split):
            blk = slice(b * A8_BLOCK, (b + 1) * A8_BLOCK)
            r = xp[:, blk] @ codes[:, blk].t()  # exact integer sums
            acc = acc + r * s[b]
        total = acc if total is None else total + acc
    return total


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
    [N, O] f32, before the caller's per-token activation scale. N <= 16
    takes the decode route (K split over the grid), N > 16 the prefill
    route."""
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
    if packed.data_ptr() % 16:
        packed = packed.clone()
    y = torch.empty((N, O), dtype=torch.float32, device=x8.device)
    ws, counters, n_split = _decode_split(x8.device, N, O, nblk * A8_BLOCK)
    fn = _build.function("qmm_w4a8", "w4a8_gemm",
                         [_build.c_void_p] * 4 + [_build.c_int] * 4 + [_build.c_void_p] * 2 + [_build.c_int]
                         + [_build.c_void_p])
    _build.check(fn(_build.ptr(x8), _build.ptr(packed), _build.ptr(scales), _build.ptr(y),
                    N, K, O, nblk, ws, counters, n_split, _build.stream()), "w4a8_gemm")
    launches += 1
    return y
