"""Real-quant compression: pack calibrated weights (port of
`quant/compress.py`).

`compress_weight` produces the JAX package's canonical packs bit for bit:
"int4" (plane-packed nibbles, byte[o, k] = nib(w[o + O/2, k]) << 4 |
nib(w[o, k]), f32 block scales split per plane), "int8" (per-channel),
"fp8" (per-tensor) and "bf16". NVFP4 and MX packs come with the NVFP4 slice.

The serving layout for W4A8 is this port's own, "int4a8": its packer
`int4_a8_pack` and its decoder live beside the kernel that reads it
(`ops/cuda/qmm.py`), which says what the bytes hold. `convert_int4_a8`
turns every "int4" site into it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import llama
from ..ops import numerics
from ..ops.cuda.qmm import A8_BLOCK, int4_a8_codes, int4_a8_pack
from . import quantizer as Q
from .ptq import QuantizedModel

def _int4_nibbles(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 [-8, 7] -> low nibble uint8."""
    return (q.to(torch.int32) & 0xF).to(torch.uint8)


def plane_pack(nibbles: torch.Tensor) -> torch.Tensor:
    """[O, K] 4-bit codes -> [O/2, K] bytes, rows (o, o + O/2) per byte."""
    O = nibbles.shape[-2]
    lo = nibbles[..., : O // 2, :]
    hi = nibbles[..., O // 2:, :]
    return ((hi << 4) | (lo & 0xF)).to(torch.uint8)


def plane_unpack_int4(packed: torch.Tensor):
    """[O/2, K] bytes -> (rows [0, O/2), rows [O/2, O)) as signed int8."""
    p = packed.to(torch.int16)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo).to(torch.int8)
    hi = torch.where(hi >= 8, hi - 16, hi).to(torch.int8)
    return lo, hi


def compress_weight(w: torch.Tensor, cfg: Q.QuantizerConfig,
                    state: Optional[Q.QuantizerState]) -> tuple[str, dict]:
    """Pack one [O, K] (or stacked [L, O, K]) weight per its quantizer config."""
    base = cfg.sequential[0] if cfg.sequential else cfg
    if not cfg.enable:
        return "bf16", {"w": w.to(torch.bfloat16)}
    if base.is_fp and (base.num_bits == (2, 1) or (base.block is not None and base.block.scale_bits)):
        raise NotImplementedError("NVFP4/MX weight packs come with the NVFP4 slice")
    if base.is_fp and base.num_bits == (4, 3):
        amax = state.amax if state is not None else None
        if cfg.sequential and isinstance(amax, tuple):
            amax = amax[-1]
        if amax is None:
            amax = torch.amax(torch.abs(w), dim=(-2, -1))
        scale = torch.clamp_min(amax.float(), 1e-12) / 448.0
        sc = scale[..., None, None] if scale.ndim == w.ndim - 2 else scale
        qw = torch.clamp(w.float() / sc, -448.0, 448.0).to(torch.float8_e4m3fn)
        return "fp8", {"q": qw, "scale": scale.float()}
    if not base.is_fp and base.num_bits == 4:
        amax = state.amax if state is not None else None
        if cfg.sequential and isinstance(amax, tuple):
            amax = amax[0]
        bsz = dict(base.block.sizes).get(-1, 128) if base.block else w.shape[-1]
        bsz = min(bsz, w.shape[-1])
        if amax is None:
            amax = numerics.block_amax_compact(w.float(), ((-1, bsz),))
        scale = amax.float() / 7.0
        scale = torch.where(amax == 0.0, torch.ones_like(scale), scale)
        s_full = numerics.expand_block_scale(scale, w.shape, ((-1, bsz),))
        q = torch.clamp(torch.round(w.float() / s_full), -8, 7)
        packed = plane_pack(_int4_nibbles(q))
        O = w.shape[-2]
        return "int4", {
            "packed": packed,
            "scale_lo": scale[..., : O // 2, :].float().contiguous(),
            "scale_hi": scale[..., O // 2:, :].float().contiguous(),
        }
    if not base.is_fp and base.num_bits == 8:
        amax = state.amax if state is not None else None
        if amax is None:
            amax = torch.amax(torch.abs(w), dim=-1, keepdim=True)
        scale = numerics.int_scale_from_amax(amax, 8)
        q = torch.clamp(torch.round(w.float() / scale), -128, 127).to(torch.int8)
        return "int8", {"q": q, "scale": scale.float()}
    return "bf16", {"w": w.to(torch.bfloat16)}


def _infer_bsz(K: int, nblk: int) -> int:
    """Block size from (K, n_blocks), allowing a ragged last block."""
    if K % nblk == 0:
        return K // nblk
    b = 1
    while b * nblk < K:
        b *= 2
    return b


def decompress_weight(kind: str, arrays: dict, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Reference dequantization (the correctness baseline of the kernels)."""
    if kind == "bf16":
        return arrays["w"].to(out_dtype)
    if kind == "int8":
        return (arrays["q"].float() * arrays["scale"]).to(out_dtype)
    if kind == "fp8":
        sc = arrays["scale"]
        sc = sc[..., None, None] if sc.ndim == arrays["q"].ndim - 2 else sc
        return (arrays["q"].float() * sc).to(out_dtype)
    if kind == "int4":
        lo, hi = plane_unpack_int4(arrays["packed"])
        K = arrays["packed"].shape[-1]
        nblk = arrays["scale_lo"].shape[-1]
        bsz = _infer_bsz(K, nblk)

        def ex(sc, plane):
            shp = plane.shape[:-1] + (nblk * bsz,)
            return numerics.expand_block_scale(sc, shp, ((-1, bsz),))[..., :K]

        lo_f = lo.float() * ex(arrays["scale_lo"], lo)
        hi_f = hi.float() * ex(arrays["scale_hi"], hi)
        return torch.cat([lo_f, hi_f], dim=-2).to(out_dtype)
    if kind == "int4a8":
        codes = int4_a8_codes(arrays["packed"]).float()
        sc = numerics.expand_block_scale(arrays["scales"].float().t(), codes.shape,
                                         ((-1, A8_BLOCK),))
        return (codes * sc)[:, : arrays["in_features"]].to(out_dtype)
    raise NotImplementedError(f"kind {kind!r} is not ported yet")


@dataclasses.dataclass
class CompressedModel:
    """Packed-weight model: projections replaced by packed dicts.
    `kinds` maps site name -> format kind (drives kernel dispatch)."""

    model_cfg: llama.LlamaConfig
    params: dict
    kinds: dict[str, str]
    layout: llama.QuantLayout
    qstate: llama.QuantState

    @property
    def packed_bytes(self) -> int:
        total = 0
        for name in llama.PROJ_NAMES:
            for a in self.params["layers"][name].values():
                if isinstance(a, torch.Tensor):
                    total += a.numel() * a.element_size()
        return total


def layer_arrays(arrays: dict, i: int) -> dict:
    """Layer `i` of a stacked packed-arrays dict (ints pass through)."""
    return {k: (v[i] if isinstance(v, torch.Tensor) else v) for k, v in arrays.items()}


def _stack_arrays(per_layer: list[dict]) -> dict:
    return {k: (torch.stack([d[k] for d in per_layer]) if isinstance(per_layer[0][k], torch.Tensor)
                else per_layer[0][k]) for k in per_layer[0]}


@torch.no_grad()
def compress(model: QuantizedModel) -> CompressedModel:
    """Pack every projection weight per its calibrated quantizer, one layer
    at a time (an 8B layer's f32 transients, not the whole stack's)."""
    new_layers = dict(model.params["layers"])
    kinds = {}
    L = model.model_cfg.num_hidden_layers
    for name in llama.PROJ_NAMES:
        wcfg = model.layout.get(f"{name}.weight")
        st = model.qstate.get(name, {}).get("weight")
        w = model.params["layers"][name]
        outs = [compress_weight(w[i], wcfg, llama.slice_state(st, i)) for i in range(L)]
        kinds[name] = outs[0][0]
        new_layers[name] = _stack_arrays([a for _, a in outs])
    params = dict(model.params)
    params["layers"] = new_layers
    return CompressedModel(model.model_cfg, params, kinds, model.layout, model.qstate)


@torch.no_grad()
def convert_int4_a8(cm: CompressedModel) -> CompressedModel:
    """One-time serving-layout conversion: every "int4" site -> "int4a8"."""
    new_layers = dict(cm.params["layers"])
    kinds = dict(cm.kinds)
    L = cm.model_cfg.num_hidden_layers
    for name, kind in cm.kinds.items():
        if kind != "int4":
            continue
        arr = cm.params["layers"][name]
        new_layers[name] = _stack_arrays([
            int4_a8_pack(arr["packed"][i], arr["scale_lo"][i], arr["scale_hi"][i])
            for i in range(L)])
        kinds[name] = "int4a8"
    params = dict(cm.params)
    params["layers"] = new_layers
    return dataclasses.replace(cm, params=params, kinds=kinds)
