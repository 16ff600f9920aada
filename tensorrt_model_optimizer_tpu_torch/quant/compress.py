"""Real-quant compression: pack calibrated weights (port of
`quant/compress.py`).

`compress_weight` produces the JAX package's canonical packs bit for bit:
"int4" (plane-packed nibbles, byte[o, k] = nib(w[o + O/2, k]) << 4 |
nib(w[o, k]), f32 block scales split per plane), "nvfp4" (E2M1 code planes,
E4M3 block scales, f32 global scale), "mxfp4" (E2M1 code planes, int8 E8M0
exponents), "int8" (per-channel), "fp8" (per-tensor) and "bf16".

The serving layouts are this port's own, one for each format whatever TPU
layout name the engine is given: "int4a8" (W4A8), "int4wo", "nvfp4wo" and
"mxfp4wo" (weight-only). Their packers and decoders live beside the kernels
that read them (`ops/cuda/qmm.py`, `ops/cuda/qmm_wo.py`), which say what the
bytes hold. `convert_packed_layouts` turns every 4-bit site into its serving
layout; "int8" and "fp8" are served as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import llama
from ..ops import numerics
from ..ops.cuda import qmm_wo
from ..ops.cuda.qmm import A8_BLOCK, int4_a8_codes, int4_a8_pack, int4_rows_pack
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
                    state: Optional[Q.QuantizerState], scales: Optional[torch.Tensor] = None) -> tuple[str, dict]:
    """Pack one [O, K] (or stacked [L, O, K]) weight per its quantizer config.
    `scales` quantizes under these scales instead of those the amax gives
    (to repack at another packer's, an exported checkpoint's): NVFP4's
    global scale or INT4's block scales [..., O, nblk]; no other format
    takes them."""
    base = cfg.sequential[0] if cfg.sequential else cfg
    if not cfg.enable:
        return "bf16", {"w": w.to(torch.bfloat16)}
    sbits = base.block.scale_bits if base.block is not None else None
    nvfp4 = base.is_fp and base.num_bits == (2, 1) and sbits == (4, 3)
    int4 = not base.is_fp and base.num_bits == 4
    if scales is not None and not (nvfp4 or int4):
        raise ValueError("compress_weight: only NVFP4 and INT4 take given scales")
    if nvfp4:
        bsz = min(dict(base.block.sizes).get(-1, 16), w.shape[-1])
        g_amax = state.amax if state is not None and state.amax is not None else torch.amax(torch.abs(w))
        gs = numerics.nvfp4_global_scale(g_amax) if scales is None else scales.float()
        w32 = w.float()
        s_val = numerics.cast_e4m3(numerics.block_amax_compact(w32, ((-1, bsz),)) / (6.0 * gs))
        s_val = torch.where(s_val <= 0.0, torch.ones_like(s_val), s_val)
        sb_full = numerics.expand_block_scale(s_val * gs, w.shape, ((-1, bsz),))
        packed = plane_pack(numerics.fp4_to_codes(numerics.fp4_round(w32 / sb_full)))
        O = w.shape[-2]
        return "nvfp4", {
            "packed": packed,
            "scale_lo": s_val[..., : O // 2, :].to(torch.float8_e4m3fn).contiguous(),
            "scale_hi": s_val[..., O // 2:, :].to(torch.float8_e4m3fn).contiguous(),
            "global_scale": gs.float(),
        }
    if base.is_fp and sbits == (8, 0):
        e, m = base.num_bits
        bsz = min(dict(base.block.sizes).get(-1, 32), w.shape[-1])
        w32 = w.float()
        if (e, m) != (2, 1) or w.shape[-1] % bsz or w.shape[-2] % 2:
            # MXFP6/MXFP8 and ragged shapes: the fake-quantized weight in
            # bf16 (its values are the MX grid points)
            return "bf16", {"w": numerics.fake_quant_mx(w32, e, m, bsz).to(torch.bfloat16)}
        scale = numerics.e8m0_scale(numerics.block_amax_compact(w32, ((-1, bsz),)), numerics.fp_emax(2, 1))
        s_full = numerics.expand_block_scale(scale, w32.shape, ((-1, bsz),))
        packed = plane_pack(numerics.fp4_to_codes(numerics.fp4_round(w32 / s_full)))
        # scale = 2^exp exactly; the clamp is torch's stand-in for XLA's
        # saturating int8 convert (the exponent lies in [-127, 127] anyway)
        exp = torch.clamp(numerics._floor_log2(scale), -128, 127).to(torch.int8)
        O = w.shape[-2]
        return "mxfp4", {"packed": packed,
                         "exp_lo": exp[..., : O // 2, :].contiguous(),
                         "exp_hi": exp[..., O // 2:, :].contiguous()}
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
    if int4:
        amax = state.amax if state is not None else None
        if cfg.sequential and isinstance(amax, tuple):
            amax = amax[0]
        bsz = dict(base.block.sizes).get(-1, 128) if base.block else w.shape[-1]
        bsz = min(bsz, w.shape[-1])
        if amax is None:
            amax = numerics.block_amax_compact(w.float(), ((-1, bsz),))
        scale = amax.float() / 7.0
        scale = torch.where(amax == 0.0, torch.ones_like(scale), scale) if scales is None else scales.float()
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
    if kind in ("nvfp4", "mxfp4"):
        p = arrays["packed"]
        lo = numerics.codes_to_fp4(p & 0xF)
        hi = numerics.codes_to_fp4((p >> 4) & 0xF)
        if kind == "nvfp4":
            gs = arrays["global_scale"]
            gsb = gs[..., None, None] if gs.ndim else gs
            s_lo = arrays["scale_lo"].float() * gsb
            s_hi = arrays["scale_hi"].float() * gsb
        else:
            s_lo = numerics._exp2i(arrays["exp_lo"].to(torch.int32))
            s_hi = numerics._exp2i(arrays["exp_hi"].to(torch.int32))
        bsz = p.shape[-1] // s_lo.shape[-1]
        lo_f = lo * numerics.expand_block_scale(s_lo, lo.shape, ((-1, bsz),))
        hi_f = hi * numerics.expand_block_scale(s_hi, hi.shape, ((-1, bsz),))
        return torch.cat([lo_f, hi_f], dim=-2).to(out_dtype)
    if kind in ("int4a8", "int4wo"):
        codes = int4_a8_codes(arrays["packed"]).float()
        sc = numerics.expand_block_scale(arrays["scales"].float().t(), codes.shape,
                                         ((-1, A8_BLOCK),))
        return (codes * sc)[:, : arrays["in_features"]].to(out_dtype)
    if kind in ("nvfp4wo", "mxfp4wo"):
        vals = qmm_wo.fp4_rows_values(arrays["packed"])
        sc = qmm_wo.fp4_rows_scales(arrays["scales"])
        if kind == "nvfp4wo":
            sc = sc * arrays["global_scale"]
        sc = numerics.expand_block_scale(sc, vals.shape, ((-1, qmm_wo.fp4_block(arrays["scales"])),))
        return (vals * sc)[:, : arrays["in_features"]].to(out_dtype)
    raise NotImplementedError(f"kind {kind!r} is not ported yet")


@dataclasses.dataclass
class CompressedModel:
    """Packed-weight model: projections replaced by packed dicts.
    `kinds` maps site name -> format kind (drives kernel dispatch);
    `adapters` is SVDQuant's low-rank branch {name: {"A" [L, r, K], "B" [L,
    O, r], "scale" [L]}}, served in high precision, or None."""

    model_cfg: llama.LlamaConfig
    params: dict
    kinds: dict[str, str]
    layout: llama.QuantLayout
    qstate: llama.QuantState
    adapters: Optional[dict] = None

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
    return CompressedModel(model.model_cfg, params, kinds, model.layout, model.qstate, model.adapters)


def compress_bf16(cfg, params) -> CompressedModel:
    """Raw (unquantized) params as a bf16-kind CompressedModel, the weights
    as they are, so the engine serves dense models (the RULER calibration of
    `sparsity/ruler.py`, dense baselines)."""
    layers = dict(params["layers"])
    kinds = {}
    for name in llama.PROJ_NAMES:
        if name in layers and not isinstance(layers[name], dict):
            layers[name] = {"w": layers[name]}
            kinds[name] = "bf16"
    return CompressedModel(cfg, {**params, "layers": layers}, kinds, llama.QuantLayout(sites=()), {})


# TPU layout names the engine accepts, per canonical kind. Every weight-only
# name maps to the one port layout of its format; the name still decides
# where the JAX pack rounds the int4 block scales to bf16.
INT4_LAYOUTS = ("bd2", "word", "word2", "blockdot", "a8")
FP4_LAYOUTS = ("word2", "word", "perm", "blockdot", "bd4")


def word_convert_site(kind: str, arr: dict, layout: str) -> tuple[str, dict]:
    """Convert ONE packed site ([O/2, K] planes of one layer) to its serving
    layout: int4 -> "int4a8" (layout "a8") or "int4wo", nvfp4 -> "nvfp4wo",
    mxfp4 -> "mxfp4wo". Other kinds pass through unchanged."""
    if kind == "int4":
        if layout == "xla":
            raise NotImplementedError(
                "int4_layout 'xla' (XLA-native s4 storage, no Pallas kernel) comes with the "
                "remaining-formats slice")
        if layout not in INT4_LAYOUTS:
            raise ValueError(f"int4_layout {layout!r}: choices {INT4_LAYOUTS}")
        if layout == "a8":
            return "int4a8", int4_a8_pack(arr["packed"], arr["scale_lo"], arr["scale_hi"])
        byte, scales, K = int4_rows_pack(arr["packed"], arr["scale_lo"], arr["scale_hi"])
        if layout != "blockdot":  # JAX's bd2 / word / word2 packs round the scales to bf16
            scales = scales.to(torch.bfloat16).float()
        return "int4wo", {"packed": byte, "scales": scales, "in_features": K}
    if kind in ("nvfp4", "mxfp4"):
        if layout == "i8":
            raise NotImplementedError(
                "nvfp4_layout 'i8' (W8A8 serving of an NVFP4 checkpoint, its values re-encoded as int8) comes with "
                "the remaining-formats slice")
        if layout not in FP4_LAYOUTS:
            raise ValueError(f"nvfp4_layout {layout!r}: choices {FP4_LAYOUTS}")
        if kind == "nvfp4":
            byte, scales, K = qmm_wo.fp4_rows_pack(arr["packed"], arr["scale_lo"], arr["scale_hi"], 16)
            return "nvfp4wo", {"packed": byte, "scales": scales,
                               "global_scale": arr["global_scale"], "in_features": K}
        block = arr["packed"].shape[-1] // arr["exp_lo"].shape[-1]
        byte, scales, K = qmm_wo.fp4_rows_pack(arr["packed"], arr["exp_lo"], arr["exp_hi"], block)
        if block != qmm_wo.fp4_block(scales):
            raise NotImplementedError(f"MXFP4 serving takes 32-wide blocks, got {block}")
        return "mxfp4wo", {"packed": byte, "scales": scales, "in_features": K}
    return kind, arr


@torch.no_grad()
def convert_packed_layouts(cm: CompressedModel, nvfp4: str = "word2", int4: str = "bd2",
                           mxfp4: str = "word2") -> CompressedModel:
    """One-time serving-layout conversion of every packed 4-bit site, one
    layer at a time. Layout names per format follow
    `EngineConfig.{nvfp4,int4}_layout`."""
    want = {"nvfp4": nvfp4, "int4": int4, "mxfp4": mxfp4}
    new_layers = dict(cm.params["layers"])
    kinds = dict(cm.kinds)
    L = cm.model_cfg.num_hidden_layers
    for name, kind in cm.kinds.items():
        if kind not in want:
            continue
        outs = [word_convert_site(kind, layer_arrays(cm.params["layers"][name], i), want[kind])
                for i in range(L)]
        kinds[name] = outs[0][0]
        new_layers[name] = _stack_arrays([a for _, a in outs])
    params = dict(cm.params)
    params["layers"] = new_layers
    return dataclasses.replace(cm, params=params, kinds=kinds)
