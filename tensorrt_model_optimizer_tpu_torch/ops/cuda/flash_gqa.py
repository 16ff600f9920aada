"""Causal GQA flash attention (port of `ops/pallas/flash_gqa.py`
`flash_attention_gqa`).

Kernel: `csrc/flash_gqa.cu` (tensor cores; bf16, head_dim 32/64/128, any
T). On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch version. The kv head of query head h is
h // rep; keys above the diagonal are masked (and their tiles skipped by the
kernel). q is read in place through its strides, so a `[B, T, H, d]`-major
tensor seen as `[B, H, T, d]` (the engine's `q.transpose(1, 2)`) costs no
copy, and the output is laid out as q is.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

launches = 0  # kernel launches since the last reset (chip_smoke reads it)


def flash_attention_gqa_plain(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Plain PyTorch version: f32 scores and softmax, output in q's dtype."""
    B, H, T, d = q.shape
    rep = H // k.shape[1]
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    kk = torch.repeat_interleave(k.float(), rep, dim=1)
    vv = torch.repeat_interleave(v.float(), rep, dim=1)
    s = (q.float() @ kk.transpose(-1, -2)) * scale
    if causal:
        Tk = k.shape[2]
        keep = torch.arange(Tk, device=q.device)[None, :] <= torch.arange(T, device=q.device)[:, None]
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    return (torch.softmax(s, dim=-1) @ vv).to(q.dtype)


def _rows_aligned(t: torch.Tensor) -> bool:
    """Rows the kernel can copy 16 bytes at a time: the last dimension
    contiguous, every row starting on a 16-byte boundary."""
    return t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1]) and t.data_ptr() % 16 == 0


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q [B, H, T, d], k/v [B, Hkv, T, d] -> [B, H, T, d] in q's dtype."""
    B, H, T, d = q.shape
    Hkv = k.shape[1]
    if H % Hkv or k.shape != (B, Hkv, T, d) or v.shape != k.shape:
        raise ValueError(f"flash_gqa: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if q.device.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, causal, sm_scale)
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16) or d not in (32, 64, 128):
        raise ValueError(f"flash_gqa kernel: bf16 and head_dim 32/64/128, got {q.dtype} d={d}")
    global launches
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    q = q if _rows_aligned(q) else q.clone(memory_format=torch.contiguous_format)
    k, v = (t if t.is_contiguous() and _rows_aligned(t) else t.clone(memory_format=torch.contiguous_format)
            for t in (k, v))
    out = torch.empty_like(q)  # q's layout when q is dense (a transposed view included), else contiguous
    fn = _build.function("flash_gqa", "flash_gqa",
                         [_build.c_void_p] * 4 + [_build.c_int] * 5 + [_build.c_float, _build.c_int]
                         + [ctypes.c_longlong] * 6 + [_build.c_void_p])
    _build.check(fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), B, H, Hkv, T, d,
                    scale, int(causal), *q.stride()[:3], *out.stride()[:3], _build.stream()), "flash_gqa")
    launches += 1
    return out
