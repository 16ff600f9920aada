"""Vision-language model (LLaVA-style) with PTQ support (port of
`models/vlm.py`).

pixels [B, H, W, 3] -> ViT patch encoder -> 2-layer GELU projector -> image
tokens [B, P, H_lm] put before the text embeddings -> the Llama stack
(`llama.forward(input_embeds=...)`) -> logits at the text positions.

The LM's sites resolve as `llama.build_layout` resolves them; the ViT's and
the projector's resolve the same preset rules under `vision.*` / `proj.*`.
The ViT's blocks are stacked `[depth, ...]` with their quantizer state, as
JAX's scan carries them. Calibration collects every site's amax in one
forward a batch.

One deliberate difference (ROADMAP queue 3): the text tokens' embedding
lookup applies the `embed_tokens` weight quantizer where the layout enables
it, as `llama.forward` does for tokens; JAX's `forward` looks the rows up in
the unquantized table. No preset enables that site, so both agree under
every preset.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.config import QuantizeConfig
from . import llama
from .dit import attention, gelu, layer_norm
from .llama import QuantLayout, _map_state, slice_state, stack_states

VISION_PROJ = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 64
    patch_size: int = 8
    hidden_size: int = 128
    depth: int = 2
    num_heads: int = 4
    dtype: Any = torch.float32

    @property
    def n_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return 3 * self.patch_size ** 2


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    vision: ViTConfig
    lm: llama.LlamaConfig

    @staticmethod
    def tiny(**kw) -> "VLMConfig":
        return VLMConfig(vision=ViTConfig(), lm=llama.LlamaConfig.tiny(), **kw)


def _vit_shapes(v: ViTConfig) -> dict:
    h = v.hidden_size
    return {"attn.qkv": (3 * h, h), "attn.proj": (h, h), "mlp.fc1": (4 * h, h), "mlp.fc2": (h, 4 * h)}


def _proj_shapes(cfg: VLMConfig) -> dict:
    return {"fc1": (cfg.lm.hidden_size, cfg.vision.hidden_size), "fc2": (cfg.lm.hidden_size, cfg.lm.hidden_size)}


def init_params(cfg: VLMConfig, generator: torch.Generator, device=None) -> dict:
    """Seeded N(0, 1/fan_in) weights on `device` (the card unless the caller
    passes the CPU; `generator` lives there): the ViT, the projector, and
    the LM through `llama.init_params`."""
    dev = resolve_device(device)
    v = cfg.vision
    h = v.hidden_size

    def winit(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(shape[-1])).to(v.dtype)

    blocks = {}
    for name, (o, k) in _vit_shapes(v).items():
        blocks[name] = torch.stack([winit((o, k)) for _ in range(v.depth)])
        blocks[name + "__bias"] = torch.zeros((v.depth, o), dtype=v.dtype, device=dev)
    return {
        "vision": {"patch_embed": winit((h, v.patch_dim)), "pos_embed": winit((v.n_patches, h)) * 0.02,
                   "blocks": blocks, "ln_f": torch.ones((h,), dtype=v.dtype, device=dev)},
        "proj": {name: winit(shape) for name, shape in _proj_shapes(cfg).items()},
        "lm": llama.init_params(cfg.lm, generator, device=dev),
    }


def build_layout(cfg: VLMConfig, qcfg: QuantizeConfig) -> QuantLayout:
    sites = dict(llama.build_layout(cfg.lm, qcfg).sites)
    for name in VISION_PROJ:
        full = f"vision.blocks.0.{name}"
        sites[f"vision.{name}.weight"] = qcfg.resolve(f"{full}.weight_quantizer")
        sites[f"vision.{name}.input"] = qcfg.resolve(f"{full}.input_quantizer")
    for name in ("fc1", "fc2"):
        sites[f"proj.{name}.weight"] = qcfg.resolve(f"proj.{name}.weight_quantizer")
        sites[f"proj.{name}.input"] = qcfg.resolve(f"proj.{name}.input_quantizer")
    return QuantLayout(sites=tuple(sites.items()))


def init_quant_state(cfg: VLMConfig, layout: QuantLayout, device=None) -> dict:
    state = llama.init_quant_state(cfg.lm, layout, device)
    v = cfg.vision

    def stacked(site_cfg, shape):
        st = Q.init_state(site_cfg, shape, device)
        return _map_state(lambda a: a.expand((v.depth,) + tuple(a.shape)).clone(), st)

    for prefix, shapes, make in (("vision.", _vit_shapes(v), stacked),
                                 ("proj.", _proj_shapes(cfg), lambda c, s: Q.init_state(c, s, device))):
        for name, shape in shapes.items():
            wcfg, icfg = layout.get(f"{prefix}{name}.weight"), layout.get(f"{prefix}{name}.input")
            sub = {}
            if wcfg.enable:
                sub["weight"] = make(wcfg, shape)
            if icfg.enable:
                sub["input"] = make(icfg, (1, shape[1]))
            if sub:
                state[prefix + name] = sub
    return state


def _qlin(x, w, b, site, layout, sub, calib):
    """Quantized linear (DiT's semantics; `sub` is the site's own state) ->
    (y, the site's state or None)."""
    wcfg = layout.get(f"{site}.weight")
    icfg = layout.get(f"{site}.input")
    sub = dict(sub) if sub else {}
    if icfg.enable or sub.get("input") is not None:
        st = sub.get("input")
        if calib:
            sub["input"] = Q.collect(x, icfg, st if st is not None else Q.QuantizerState())
        else:
            x = Q.quantize(x, icfg, st)
    w_eff = w
    if wcfg.enable:
        st = sub.get("weight")
        if calib:
            sub["weight"] = Q.collect(w, wcfg, st if st is not None else Q.QuantizerState())
        else:
            w_eff = Q.quantize(w, wcfg, st)
    y = x @ w_eff.t().to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y, (sub if sub else None)


def encode_image(cfg: VLMConfig, params: dict, pixels: torch.Tensor, *, layout=None, qstate=None, calib=False):
    """ViT patch encoder and projector -> (image tokens [B, P, H_lm] in the
    LM's dtype, the vision and projector sites' new state)."""
    v = cfg.vision
    lay = layout or QuantLayout(sites=())
    vp = params["vision"]
    B = pixels.shape[0]
    p, g = v.patch_size, v.img_size // v.patch_size
    x = pixels.to(v.dtype).reshape(B, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, v.patch_dim)
    s = x @ vp["patch_embed"].t().to(v.dtype) + vp["pos_embed"][None]
    vstate = {k.split("vision.", 1)[1]: sub for k, sub in (qstate or {}).items() if k.startswith("vision.")} or None
    emitted = []
    for i in range(v.depth):
        lstate = slice_state(vstate, i) or {}
        bp = {k: t[i] for k, t in vp["blocks"].items()}
        ns: dict = {}

        def lin(z, name):
            y, st = _qlin(z, bp[name], bp[name + "__bias"], f"vision.{name}", lay, lstate.get(name), calib)
            if st:
                ns[name] = st
            return y

        ctx = attention(lin(layer_norm(s), "attn.qkv"), v.num_heads)
        s = s + lin(ctx, "attn.proj")
        s = s + lin(gelu(lin(layer_norm(s), "mlp.fc1")), "mlp.fc2")
        emitted.append(ns)
    s = llama.rms_norm(s, vp["ln_f"], 1e-6)
    new_states = {f"vision.{k}": sub for k, sub in stack_states(emitted).items()}
    pr = params["proj"]
    y, st = _qlin(s, pr["fc1"], None, "proj.fc1", lay, (qstate or {}).get("proj.fc1"), calib)
    if st:
        new_states["proj.fc1"] = st
    y, st = _qlin(gelu(y), pr["fc2"], None, "proj.fc2", lay, (qstate or {}).get("proj.fc2"), calib)
    if st:
        new_states["proj.fc2"] = st
    return y.to(cfg.lm.dtype), new_states


def _lm_only(qstate):
    if not qstate:
        return qstate
    return {k: v for k, v in qstate.items() if not k.startswith(("vision.", "proj."))} or None


def forward(cfg: VLMConfig, params: dict, pixels: torch.Tensor, tokens: torch.Tensor, *,
            layout: Optional[QuantLayout] = None, qstate: Optional[dict] = None, calib: bool = False):
    """Image tokens before the text embeddings, one causal pass over the LM
    -> (logits at the text positions [B, T, V], new_qstate or None)."""
    lay = layout or QuantLayout(sites=())
    img, new_vision = encode_image(cfg, params, pixels, layout=lay, qstate=qstate, calib=calib)
    emb_w = params["lm"]["embed_tokens"]
    ew_cfg = lay.get("embed_tokens.weight")
    if ew_cfg.enable and not calib:
        emb_w = Q.quantize(emb_w, ew_cfg, (qstate or {}).get("embed_tokens.weight"))
    x = torch.cat([img, emb_w[tokens].to(cfg.lm.dtype)], dim=1)
    logits, lm_state, _ = llama.forward(cfg.lm, params["lm"], None, input_embeds=x, layout=lay,
                                        qstate=_lm_only(qstate), calib=calib)
    new_state = {**(lm_state or {}), **(new_vision or {})}
    return logits[:, img.shape[1]:], (new_state if new_state else None)


def quantize_vlm(cfg: VLMConfig, params: dict, quant_cfg, calib_batches):
    """PTQ: max calibration over (pixels, tokens) batches, one forward a
    batch -> (layout, qstate)."""
    from ..quant.config import get_preset

    qcfg = get_preset(quant_cfg) if isinstance(quant_cfg, str) else quant_cfg
    layout = build_layout(cfg, qcfg)
    qstate = init_quant_state(cfg, layout, params["proj"]["fc1"].device)
    with torch.no_grad():
        for px, tk in calib_batches:
            qstate = {**qstate, **forward(cfg, params, px, tk, layout=layout, qstate=qstate, calib=True)[1]}
    return layout, qstate
