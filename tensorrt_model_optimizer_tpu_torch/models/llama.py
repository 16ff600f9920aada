"""Llama-family model on tensors with quantizer sites (port of
`models/llama.py`).

Parameters are the JAX package's pytree as a dict of tensors: per-layer
weights are stacked on a leading layer axis `[L, ...]` and kept in the
reference's `[out, in]` layout (y = x @ W^T), so preset wildcards and quant
axes carry over unchanged. Quantizer state is the same dict of
`QuantizerState`s with stacked `[L, ...]` amaxes. The JAX `lax.scan` over
layers is a Python loop here.

Ported: the config (`tiny`, `llama3_8b`, llama-3.1 `RopeScaling`), norms,
RoPE, the site layout, and `forward` on the einsum attention path without a
cache (calibration and fake-quant evaluation), with LoRA adapters (the
SVDQuant low-rank branch) and activation capture for the calibration
algorithms (`capture_tokens`). The cached forward, the flash `attn_impl` and
the Qwen/DBRX variants come with later slices and raise
`NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.config import QuantizeConfig
from ..quant.quantizer import QuantizerConfig, QuantizerState

Params = dict
QuantState = dict


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """HF `rope_scaling`: llama3 (transformers `_compute_llama3_parameters`).
    Yarn comes with the MoE-families slice."""

    rope_type: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 4096
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    dtype=torch.float32)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        base = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=8, rope_theta=500000.0,
                    rope_scaling=RopeScaling(), max_position_embeddings=131072)
        base.update(kw)
        return LlamaConfig(**base)


def _layer_shapes(cfg: LlamaConfig) -> dict[str, tuple[int, int]]:
    """Per-layer projection shapes, [out, in]."""
    h, hd = cfg.hidden_size, cfg.hd
    return {
        "self_attn.q_proj": (cfg.num_attention_heads * hd, h),
        "self_attn.k_proj": (cfg.num_key_value_heads * hd, h),
        "self_attn.v_proj": (cfg.num_key_value_heads * hd, h),
        "self_attn.o_proj": (h, cfg.num_attention_heads * hd),
        "mlp.gate_proj": (cfg.intermediate_size, h),
        "mlp.up_proj": (cfg.intermediate_size, h),
        "mlp.down_proj": (h, cfg.intermediate_size),
    }


PROJ_NAMES = (
    "self_attn.q_proj",
    "self_attn.k_proj",
    "self_attn.v_proj",
    "self_attn.o_proj",
    "mlp.gate_proj",
    "mlp.up_proj",
    "mlp.down_proj",
)
BMM_NAMES = ("self_attn.k_bmm", "self_attn.v_bmm")


def init_params(cfg: LlamaConfig, generator: torch.Generator, device=None) -> Params:
    """Seeded random weights, N(0, 1/fan_in) in `cfg.dtype`, made on the
    device layer by layer (the full-width run has no checkpoint to load).
    `generator` must live on the same device."""
    dev = resolve_device(device)
    L, h = cfg.num_hidden_layers, cfg.hidden_size

    def winit(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(fan_in)).to(cfg.dtype)

    layers: dict[str, Any] = {
        "input_layernorm": torch.ones((L, h), dtype=cfg.dtype, device=dev),
        "post_attention_layernorm": torch.ones((L, h), dtype=cfg.dtype, device=dev),
    }
    for name, (o, inp) in _layer_shapes(cfg).items():
        stacked = torch.empty((L, o, inp), dtype=cfg.dtype, device=dev)
        for i in range(L):  # one layer's f32 transient at a time
            stacked[i] = winit((o, inp), inp)
        layers[name] = stacked
    params: Params = {
        "embed_tokens": winit((cfg.vocab_size, h), h),
        "layers": layers,
        "norm": torch.ones((h,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = winit((cfg.vocab_size, h), h)
    return params


# --------------------------------------------------------------------------
# Quantization layout
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantLayout:
    """Resolved per-site quantizer configs (uniform across layers)."""

    sites: tuple[tuple[str, QuantizerConfig], ...]

    def get(self, key: str) -> QuantizerConfig:
        for k, v in self.sites:
            if k == key:
                return v
        return Q.DISABLED


def build_layout(cfg: LlamaConfig, qcfg: QuantizeConfig) -> QuantLayout:
    sites = {}
    for name in PROJ_NAMES:
        full = f"model.layers.0.{name}"
        sites[f"{name}.weight"] = qcfg.resolve(f"{full}.weight_quantizer")
        sites[f"{name}.input"] = qcfg.resolve(f"{full}.input_quantizer")
        sites[f"{name}.output"] = qcfg.resolve(f"{full}.output_quantizer")
    for name in BMM_NAMES:
        sites[name] = qcfg.resolve(f"model.layers.0.{name}_quantizer")
    sites["lm_head.weight"] = qcfg.resolve("lm_head.weight_quantizer")
    sites["lm_head.input"] = qcfg.resolve("lm_head.input_quantizer")
    sites["embed_tokens.weight"] = qcfg.resolve("model.embed_tokens.weight_quantizer")
    return QuantLayout(sites=tuple(sites.items()))


def _map_state(fn, st: QuantizerState) -> QuantizerState:
    """Apply `fn` to every tensor of a state (tuple amaxes included)."""
    def one(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(one(x) for x in a)
        return fn(a)

    return QuantizerState(amax=one(st.amax), pre_quant_scale=one(st.pre_quant_scale),
                          bias=one(st.bias))


def init_quant_state(cfg: LlamaConfig, layout: QuantLayout, device=None) -> QuantState:
    """Quantizer state; per-layer sites get a stacked leading L dim."""
    L = cfg.num_hidden_layers
    shapes = _layer_shapes(cfg)

    def stacked(site_cfg, shape):
        st = Q.init_state(site_cfg, shape, device)
        return _map_state(lambda a: a.expand((L,) + tuple(a.shape)).clone(), st)

    state: QuantState = {}
    for name in PROJ_NAMES:
        o, inp = shapes[name]
        wcfg, icfg = layout.get(f"{name}.weight"), layout.get(f"{name}.input")
        sub = {}
        if wcfg.enable:
            sub["weight"] = stacked(wcfg, (o, inp))
        if icfg.enable:
            sub["input"] = stacked(icfg, (1, 1, inp))
        if sub:
            state[name] = sub
    for name in BMM_NAMES:
        bcfg = layout.get(name)
        if bcfg.enable:
            state[name] = stacked(bcfg, (1, 1, cfg.num_key_value_heads, cfg.hd))
    lw = layout.get("lm_head.weight")
    if lw.enable:
        state["lm_head.weight"] = Q.init_state(lw, (cfg.vocab_size, cfg.hidden_size), device)
    return state


def slice_state(state, i: int):
    """Layer `i` of a stacked state tree (dicts of QuantizerState)."""
    if state is None:
        return None
    if isinstance(state, QuantizerState):
        return _map_state(lambda a: a[i], state)
    return {k: slice_state(v, i) for k, v in state.items()}


def stack_states(per_layer: list):
    """Inverse of `slice_state` over a list of per-layer trees."""
    first = per_layer[0]
    if isinstance(first, QuantizerState):
        def stk(field):
            vals = [getattr(s, field) for s in per_layer]
            if vals[0] is None:
                return None
            if isinstance(vals[0], tuple):
                return tuple(None if vals[0][j] is None else torch.stack([v[j] for v in vals])
                             for j in range(len(vals[0])))
            return torch.stack(vals)

        return QuantizerState(amax=stk("amax"), pre_quant_scale=stk("pre_quant_scale"),
                              bias=stk("bias"))
    return {k: stack_states([p[k] for p in per_layer]) for k in first}


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def norm(cfg, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Config-selected block norm (RMSNorm for Llama)."""
    return rms_norm(x, w, cfg.rms_norm_eps)


def rope_freqs(hd: int, theta: float, scaling: Optional[RopeScaling] = None, device=None):
    """Per-pair inverse frequencies and the cos/sin attention factor."""
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=device) / half)
    if scaling is not None:
        if scaling.rope_type != "llama3":
            raise NotImplementedError(f"rope_scaling {scaling.rope_type!r} comes with the MoE-families slice")
        wavelen = 2.0 * math.pi / freqs
        low_wl = scaling.original_max_position_embeddings / scaling.low_freq_factor
        high_wl = scaling.original_max_position_embeddings / scaling.high_freq_factor
        smooth = (scaling.original_max_position_embeddings / wavelen
                  - scaling.low_freq_factor) / (scaling.high_freq_factor - scaling.low_freq_factor)
        interp = (1.0 - smooth) * freqs / scaling.factor + smooth * freqs
        freqs = torch.where(wavelen > low_wl, freqs / scaling.factor,
                            torch.where(wavelen < high_wl, freqs, interp))
    return freqs, 1.0


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """Rotary embedding (split-half pairing); x: [B, T, n, hd]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs, attn_factor = rope_freqs(hd, theta, scaling, x.device)
    angles = positions[..., None].float() * freqs  # [B, T, half]
    cos = (torch.cos(angles) * attn_factor)[..., None, :]
    sin = (torch.sin(angles) * attn_factor)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def _qsite(x, site_cfg: QuantizerConfig, st, calib: bool):
    """Quantize (or, calibrating, collect) at one site -> (y, new_state)."""
    if not site_cfg.enable and st is None:
        return x, st
    if calib:
        return x, Q.collect(x, site_cfg, st if st is not None else QuantizerState())
    return Q.quantize(x, site_cfg, st), st


def _linear(x, w, name, layout: QuantLayout, lstate, calib, adapters=None):
    """Quantized linear: y = q_in(x) @ q_w(w)^T (QuantLinear analog).

    `adapters` optionally carries this layer's LoRA factors {name: {"A" [r,
    K], "B" [O, r], "scale" []}}: (x @ A^T) @ B^T * scale is added on the
    input-quantized x, the branch itself unquantized."""
    wcfg = layout.get(f"{name}.weight")
    icfg = layout.get(f"{name}.input")
    sub = dict(lstate.get(name, {})) if lstate is not None else {}
    x, ist = _qsite(x, icfg, sub.get("input"), calib)
    if ist is not None:
        sub["input"] = ist
    w_eff = w
    if wcfg.enable:
        wst = sub.get("weight")
        if calib:
            sub["weight"] = Q.collect(w, wcfg, wst if wst is not None else QuantizerState())
        else:
            w_eff = Q.quantize(w, wcfg, wst)
    y = x @ w_eff.t().to(x.dtype)
    if adapters is not None and name in adapters:
        ad = adapters[name]
        lo = (x @ ad["A"].t().to(x.dtype)) @ ad["B"].t().to(x.dtype)
        y = y + lo * ad["scale"].to(y.dtype)
    return y, (sub if sub else None)


def _attention(cfg, x, lp, lstate, layout, positions, mask, calib, adapters=None):
    """-> (out, new_state, ctx): ctx is the o_proj input."""
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    B, T, _ = x.shape
    new_state = {}
    proj = {}
    for p in ("q", "k", "v"):
        name = f"self_attn.{p}_proj"
        proj[p], s = _linear(x, lp[name], name, layout, lstate, calib, adapters)
        if s:
            new_state[name] = s
    q = rope(proj["q"].reshape(B, T, nH, hd), positions, cfg.rope_theta, cfg.rope_scaling)
    k = rope(proj["k"].reshape(B, T, nKV, hd), positions, cfg.rope_theta, cfg.rope_scaling)
    v = proj["v"].reshape(B, T, nKV, hd)
    # KV-cache quantizer sites, post-rope
    k, kst = _qsite(k, layout.get("self_attn.k_bmm"), (lstate or {}).get("self_attn.k_bmm"), calib)
    if kst is not None:
        new_state["self_attn.k_bmm"] = kst
    v, vst = _qsite(v, layout.get("self_attn.v_bmm"), (lstate or {}).get("self_attn.v_bmm"), calib)
    if vst is not None:
        new_state["self_attn.v_bmm"] = vst
    rep = nH // nKV
    k_all = torch.repeat_interleave(k, rep, dim=2)
    v_all = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k_all.float())
    scores = scores / math.sqrt(hd) + mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs, v_all).reshape(B, T, nH * hd)
    out, s = _linear(ctx, lp["self_attn.o_proj"], "self_attn.o_proj", layout, lstate, calib, adapters)
    if s:
        new_state["self_attn.o_proj"] = s
    return out, new_state, ctx


def _mlp(x, lp, lstate, layout, calib, adapters=None):
    """-> (out, new_state, y): y is the down_proj input."""
    new_state = {}
    g, s = _linear(x, lp["mlp.gate_proj"], "mlp.gate_proj", layout, lstate, calib, adapters)
    if s:
        new_state["mlp.gate_proj"] = s
    u, s = _linear(x, lp["mlp.up_proj"], "mlp.up_proj", layout, lstate, calib, adapters)
    if s:
        new_state["mlp.up_proj"] = s
    y = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    d, s = _linear(y, lp["mlp.down_proj"], "mlp.down_proj", layout, lstate, calib, adapters)
    if s:
        new_state["mlp.down_proj"] = s
    return d, new_state, y


def _grab(x: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """[B, T, D] -> the first n_tokens rows of its [B*T, D] flattening (the
    activation capture of the sequential calibration algorithms)."""
    flat = x.reshape(-1, x.shape[-1])
    return flat[: min(n_tokens, flat.shape[0])]


GLOBAL_SITES = ("lm_head", "embed_tokens")
CAPTURE_KEYS = ("attn_in", "o_in", "mlp_in", "down_in")  # the capture points of a decoder layer


def forward(cfg: LlamaConfig, params: Params, tokens: torch.Tensor, *,
            layout: Optional[QuantLayout] = None, qstate: Optional[QuantState] = None,
            calib: bool = False, cache: Optional[dict] = None, capture_tokens: int = 0,
            adapters: Optional[dict] = None):
    """Forward pass -> (logits f32 [B, T, V], new_qstate, None), or with
    `capture_tokens > 0` (logits, new_qstate, None, captures): captures maps
    "attn_in", "o_in", "mlp_in", "down_in" to stacked [L, n_tokens, d]
    inputs of the projections.

    `layout=None` runs the plain model; `calib=True` runs unquantized while
    collecting amax into the returned qstate. `adapters` {name: {"A" [L, r,
    K], "B" [L, O, r], "scale" [L]}} adds each projection's LoRA branch.
    """
    if cache is not None:
        raise NotImplementedError(
            "the cached llama forward comes with a later slice; serving uses serve.engine")
    layout = layout or QuantLayout(sites=())
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, device=dev, dtype=torch.int32)[None, :].expand(B, T)

    ew_cfg = layout.get("embed_tokens.weight")
    ew_state = (qstate or {}).get("embed_tokens.weight")
    emb_w = params["embed_tokens"]
    if ew_cfg.enable and not calib:
        emb_w = Q.quantize(emb_w, ew_cfg, ew_state)
    x = emb_w[tokens].to(cfg.dtype)

    ar = torch.arange(T, device=dev)
    mask = torch.where(ar[None, :] <= ar[:, None], 0.0, -1e9).float()[None, None]

    per_layer_state = {k: v for k, v in (qstate or {}).items()
                       if not k.startswith(GLOBAL_SITES)} or None
    layers = params["layers"]
    emitted = []
    captures: dict = {k: [] for k in CAPTURE_KEYS} if capture_tokens else {}
    for i in range(cfg.num_hidden_layers):
        lp = {k: v[i] for k, v in layers.items()}
        lstate = slice_state(per_layer_state, i)
        ad = None if adapters is None else {n: {k: a[i] for k, a in f.items()} for n, f in adapters.items()}
        h = norm(cfg, x, lp["input_layernorm"])
        attn, st_a, o_in = _attention(cfg, h, lp, lstate, layout, positions, mask, calib, ad)
        x = x + attn
        h2 = norm(cfg, x, lp["post_attention_layernorm"])
        mlp_out, st_m, down_in = _mlp(h2, lp, lstate, layout, calib, ad)
        x = x + mlp_out
        emitted.append({**st_a, **st_m})
        if capture_tokens:
            for k, t in zip(CAPTURE_KEYS, (h, o_in, h2, down_in)):
                captures[k].append(_grab(t, capture_tokens))

    x = norm(cfg, x, params["norm"])
    head_w = params.get("lm_head", params["embed_tokens"])
    new_qstate = stack_states(emitted) if emitted and emitted[0] else {}
    lw_cfg = layout.get("lm_head.weight")
    lstate_global = (qstate or {}).get("lm_head.weight")
    if lw_cfg.enable:
        if calib:
            new_qstate["lm_head.weight"] = Q.collect(head_w, lw_cfg, lstate_global or QuantizerState())
        else:
            head_w = Q.quantize(head_w, lw_cfg, lstate_global)
            new_qstate["lm_head.weight"] = lstate_global
    if ew_cfg.enable and calib:
        new_qstate["embed_tokens.weight"] = Q.collect(params["embed_tokens"], ew_cfg,
                                                      ew_state or QuantizerState())
    elif ew_cfg.enable:
        new_qstate["embed_tokens.weight"] = ew_state
    logits = (x @ head_w.t().to(x.dtype)).float()
    out_qstate = new_qstate if (calib or qstate) else None
    if capture_tokens:
        return logits, out_qstate, None, {k: torch.stack(v) for k, v in captures.items()}
    return logits, out_qstate, None
