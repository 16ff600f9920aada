"""One-token GQA decode attention over the stored-form, kv-head-major KV
cache (port of `ops/pallas/kv_attention.py` `kv_decode_attention`).

Kernel: `csrc/kv_decode_attention.cu`, formats bf16 / int8 / fp8 / nvfp4: a
split over the cache (flash-decoding). Each of `n_splits(S)` blocks of a
(sequence, kv head) takes SPLIT_ROWS of the cache's S rows, reads those <
pos and writes its softmax max, denominator and accumulator to scratch (a
split wholly past pos writes an empty state); a second kernel merges the
splits and folds in the current token. `pos` is a 0-d int32 tensor that
only the device reads (the Pallas kernel's scalar prefetch): the grid
depends on S alone, so a captured CUDA graph replays at every pos. On a
CUDA tensor the wrapper launches the kernels or raises; only CPU tensors
take the plain PyTorch version.

Semantics (split attention): the cache rows `< pos` are valid, row `pos`
and above are not read, and the current token's code-domain k/v arrive
separately and join the softmax. The caller folds the per-layer global
scales: k's into q (with 1/sqrt(hd)), v's into the returned context.

Stored forms: bf16 values, int8 codes and fp8 e4m3 values are `[B, n_kv, S,
hd]`. NVFP4 is `[B, n_kv, S, hd/2]` plane-packed bytes (byte j = code[j] |
code[j + hd/2] << 4) with `k_scales` / `v_scales` `[B, n_kv, S, hd/16]`, the
E4M3 block scales' bytes; the kernel decodes E2M1 x E4M3 in registers, as
`numerics.nvfp4_planes_code_load` does, and the f32 global scale stays with
the caller.
"""

from __future__ import annotations

import torch

from .. import numerics
from . import _build

launches = 0  # calls that launched the kernels since the last reset (chip_smoke reads it); each call
#               launches two: the split kernel, then the merge

SPLIT_ROWS = 256  # cache rows of a split (the kernel holds at most 256)

# format -> (kernel's code, stored dtype)
FORMATS = {"bf16": (0, torch.bfloat16), "int8": (1, torch.int8), "fp8": (2, torch.float8_e4m3fn),
           "nvfp4": (3, torch.uint8)}


def decode_rows(rows: torch.Tensor, scales, fmt: str) -> torch.Tensor:
    """Stored rows [..., C] -> f32 code-domain values [..., hd]."""
    if fmt == "nvfp4":
        return numerics.nvfp4_planes_code_load(rows, scales, torch.float32)
    return rows.float()


def n_splits(rows: int, split_rows: int = SPLIT_ROWS) -> int:
    """Splits of the kernel's grid over the cache's `rows` (S): at least
    one, so that pos = 0 still folds in the current token."""
    return max(1, -(-rows // split_rows))


def _pos_tensor(pos, device) -> torch.Tensor:
    """pos as the 0-d int32 tensor on `device` the kernel reads (an int
    becomes one: a host-to-device copy, so not inside a captured graph)."""
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype != torch.int32 or pos.device != device:
            raise TypeError(f"kv_attention: pos is one int32 on {device}, got {pos.dtype} {tuple(pos.shape)} "
                            f"on {pos.device}")
        return pos.reshape(())
    return torch.tensor(int(pos), dtype=torch.int32, device=device)


def kv_decode_attention_plain(q, k_cache, v_cache, k_new, v_new, pos, fmt: str,
                              k_scales=None, v_scales=None) -> torch.Tensor:
    """Plain PyTorch version: softmax over the valid rows plus the new token.
    Every row is decoded and the rows >= pos are masked out (weight 0), so
    pos (an int or a 0-d int32 tensor) is never read on the host."""
    B, HR, hd = q.shape
    n_kv, S = k_cache.shape[1], k_cache.shape[2]
    rep = HR // n_kv
    q3 = q.float().reshape(B, n_kv, rep, hd)
    pos = _pos_tensor(pos, q.device)

    def rows(cache, scales, new):
        return torch.cat([decode_rows(cache, scales, fmt), new.float().reshape(B, n_kv, 1, hd)], dim=2)

    kk, vv = rows(k_cache, k_scales, k_new), rows(v_cache, v_scales, v_new)
    live = torch.cat([torch.arange(S, device=q.device) < pos, torch.ones(1, dtype=torch.bool, device=q.device)])
    s = torch.einsum("bgrd,bgsd->bgrs", q3, kk)
    p = torch.softmax(torch.where(live, s, torch.full_like(s, -float("inf"))), dim=-1)
    return torch.einsum("bgrs,bgsd->bgrd", p, vv).reshape(B, HR, hd)


def kv_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        k_new: torch.Tensor, v_new: torch.Tensor, pos, fmt: str,
                        k_scales=None, v_scales=None) -> torch.Tensor:
    """q [B, n_kv*rep, hd] f32 pre-scaled; caches [B, n_kv, S, C] stored
    form (with `k_scales` / `v_scales` for nvfp4); k_new/v_new [B, n_kv, 1,
    hd] code domain; pos = valid rows, a 0-d int32 tensor on q's device
    (read there, clamped to [0, S]) or an int (checked, then copied there).
    Returns the code-domain context [B, n_kv*rep, hd] f32."""
    B, HR, hd = q.shape
    _, n_kv, S, C = k_cache.shape
    if fmt not in FORMATS:
        raise NotImplementedError(f"kv format {fmt!r}: the stored forms are {sorted(FORMATS)}")
    nvfp4 = fmt == "nvfp4"
    bad_pos = not isinstance(pos, torch.Tensor) and not 0 <= int(pos) <= S
    if C != (hd // 2 if nvfp4 else hd) or HR % n_kv or v_cache.shape != k_cache.shape or bad_pos:
        raise ValueError(f"kv_attention: q {tuple(q.shape)} cache {tuple(k_cache.shape)} pos {pos} fmt {fmt}")
    if nvfp4 and (k_scales is None or v_scales is None or k_scales.shape != (B, n_kv, S, hd // 16)
                  or v_scales.shape != k_scales.shape):
        raise ValueError("kv_attention: nvfp4 needs k_scales / v_scales [B, n_kv, S, hd/16]")
    if q.device.type == "cpu":
        return kv_decode_attention_plain(q, k_cache, v_cache, k_new, v_new, pos, fmt, k_scales, v_scales)
    code, dtype = FORMATS[fmt]
    rep = HR // n_kv
    if k_cache.dtype != dtype or v_cache.dtype != dtype:
        raise TypeError(f"kv_attention: fmt {fmt} needs {dtype} caches, got {k_cache.dtype}")
    if nvfp4 and (k_scales.dtype != torch.uint8 or v_scales.dtype != torch.uint8):
        raise TypeError(f"kv_attention: nvfp4 scales are uint8 bytes, got {k_scales.dtype}")
    if hd not in (32, 64, 128) or rep not in (1, 2, 4, 8):
        raise ValueError(f"kv_attention kernel: head_dim {hd} / rep {rep} unsupported")
    global launches
    q = q.float().contiguous()
    kn = k_new.float().reshape(B, n_kv, hd).contiguous()
    vn = v_new.float().reshape(B, n_kv, hd).contiguous()
    k_cache, v_cache = k_cache.contiguous(), v_cache.contiguous()
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("kv_attention kernel: the caches' storage must be 16-byte aligned (16-byte row loads)")
    if nvfp4:
        k_scales, v_scales = k_scales.contiguous(), v_scales.contiguous()
    ks, vs = (_build.ptr(k_scales), _build.ptr(v_scales)) if nvfp4 else (None, None)
    pos = _pos_tensor(pos, q.device)
    out = torch.empty((B, HR, hd), dtype=torch.float32, device=q.device)
    n_split = n_splits(S, SPLIT_ROWS)
    part_ml = torch.empty((B, n_kv, n_split, rep, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, n_kv, n_split, rep, hd), dtype=torch.float32, device=q.device)
    fn = _build.function("kv_decode_attention", "kv_decode_attention",
                         [_build.c_int] * 3 + [_build.c_void_p] * 11 + [_build.c_int] * 5
                         + [_build.c_void_p])
    _build.check(fn(code, hd, rep, _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache), ks, vs,
                    _build.ptr(kn), _build.ptr(vn), _build.ptr(pos), _build.ptr(part_ml), _build.ptr(part_acc),
                    _build.ptr(out), B, n_kv, S, SPLIT_ROWS, n_split, _build.stream()), "kv_decode_attention")
    launches += 1
    return out
