"""Llama-family model on tensors with quantizer sites (port of
`models/llama.py`).

Parameters are the JAX package's pytree as a dict of tensors: per-layer
weights are stacked on a leading layer axis `[L, ...]` and kept in the
reference's `[out, in]` layout (y = x @ W^T), so preset wildcards and quant
axes carry over unchanged. Quantizer state is the same dict of
`QuantizerState`s with stacked `[L, ...]` amaxes. The JAX `lax.scan` over
layers is a Python loop here.

Ported: the config (`tiny`, `llama3_8b`, `RopeScaling` llama3 and yarn),
the Qwen2 / Qwen3 / DBRX variants (`attention_bias`, `qk_norm`, `clip_qkv`,
`norm_type="layernorm"`), RoPE, the site layout, `forward` (calibration,
fake-quant evaluation, LoRA adapters, activation capture for the
calibration algorithms, and the cached forward over `init_cache`'s dict),
`forward_unrolled` (a layout per layer) and `attn_impl="flash"`: the
no-cache causal attention through `ops/cuda/flash_gqa.py` (its kernel on
the card, its plain version on the CPU), where JAX's runs `flash_gqa`
through `ops/pallas/flash_wrapper.py`. The attention pieces of the GPT-OSS
and Llama4 families live here as in JAX: `sink_softmax` (a layer with a
`self_attn.sinks` leaf attends through it, and never through flash) and
`rope_interleaved`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from .. import resolve_device
from ..ops.cuda import flash_gqa
from ..quant import quantizer as Q
from ..quant.config import QuantizeConfig
from ..quant.quantizer import QuantizerConfig, QuantizerState
from ..trace.tracer import scanned

Params = dict
QuantState = dict


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """HF `rope_scaling`: llama3 (transformers `_compute_llama3_parameters`)
    or yarn (`_compute_yarn_parameters`: NTK-by-parts between the beta_fast
    and beta_slow correction dims, and the 0.1 ln(factor) + 1 temperature
    on cos / sin)."""

    rope_type: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192
    attention_factor: Optional[float] = None  # yarn only, as the rest below
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    truncate: bool = True


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
    attention_bias: bool = False  # Qwen2: q/k/v biases
    qk_norm: bool = False  # Qwen3: per-head RMSNorm of q and k before rope
    norm_type: str = "rmsnorm"  # "rmsnorm" | "layernorm" (DBRX)
    clip_qkv: Optional[float] = None  # DBRX: q/k/v clamped to +-clip_qkv
    # "einsum", or "flash": the no-cache causal attention through the flash
    # kernel (a cached forward or an explicit mask keeps the einsum)
    attn_impl: str = "einsum"
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    def layer_flags(self) -> tuple:
        """Each layer's flag, JAX's per-layer scan input: True where the
        layer's mask keeps only `span()` besides causality."""
        return (False,) * self.num_hidden_layers

    def span(self) -> Optional[tuple]:
        """What a flagged layer's mask keeps besides causality (`span_mask`'s
        ("window", w) or ("chunk", c)); None where no layer is flagged."""
        return None

    def rope_qk(self, q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, lp: dict, flag: bool = False):
        """q [B, T, nH, hd], k [B, T, nKV, hd] after the per-head RMSNorms
        (Qwen3: `lp`'s q_norm / k_norm) and split-half rope; `flag`: the
        layer's (`layer_flags`), unused here."""
        if self.qk_norm:
            q = rms_norm(q, lp["self_attn.q_norm"], self.rms_norm_eps)
            k = rms_norm(k, lp["self_attn.k_norm"], self.rms_norm_eps)
        return rope(q, positions, self.rope_theta, self.rope_scaling), rope(k, positions, self.rope_theta,
                                                                            self.rope_scaling)

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
    if cfg.attention_bias:
        for name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
            layers[name + "__bias"] = torch.zeros((L, _layer_shapes(cfg)[name][0]), dtype=cfg.dtype, device=dev)
    if cfg.qk_norm:
        layers["self_attn.q_norm"] = torch.ones((L, cfg.hd), dtype=cfg.dtype, device=dev)
        layers["self_attn.k_norm"] = torch.ones((L, cfg.hd), dtype=cfg.dtype, device=dev)
    params: Params = {
        "embed_tokens": winit((cfg.vocab_size, h), h),
        "layers": layers,
        "norm": torch.ones((h,), dtype=cfg.dtype, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = winit((cfg.vocab_size, h), h)
    return params


def param_specs(cfg: LlamaConfig) -> dict:
    """The JAX package's PartitionSpecs as tuples of mesh-axis names (None:
    not sharded): megatron column / row parallel over "tensor", the plan
    `serve/tp.py` serves by and `opt/state.save_sharded` writes the shards
    of."""
    col, row = (None, "tensor", None), (None, None, "tensor")
    layers = {"input_layernorm": (None, None), "post_attention_layernorm": (None, None),
              "self_attn.q_proj": col, "self_attn.k_proj": col, "self_attn.v_proj": col,
              "self_attn.o_proj": row, "mlp.gate_proj": col, "mlp.up_proj": col, "mlp.down_proj": row}
    if cfg.attention_bias:
        for name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
            layers[name + "__bias"] = (None, "tensor")
    if cfg.qk_norm:
        layers["self_attn.q_norm"] = layers["self_attn.k_norm"] = (None, None)
    return {"embed_tokens": ("tensor", None), "layers": layers, "norm": (None,),
            **({} if cfg.tie_word_embeddings else {"lm_head": ("tensor", None)})}


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


def layer_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Bias-free LayerNorm (DBRX's blocks)."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w


def norm(cfg, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Config-selected block norm: RMSNorm, or LayerNorm for DBRX."""
    return (layer_norm if cfg.norm_type == "layernorm" else rms_norm)(x, w, cfg.rms_norm_eps)


def rope_freqs(hd: int, theta: float, scaling: Optional[RopeScaling] = None, device=None):
    """Per-pair inverse frequencies and the cos/sin attention factor, with
    the llama3 or yarn scaling applied."""
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=device) / half)
    attn_factor = 1.0
    if scaling is not None and scaling.rope_type not in ("llama3", "yarn"):
        raise NotImplementedError(f"rope_scaling {scaling.rope_type!r}: llama3 and yarn are the JAX package's")
    if scaling is not None and scaling.rope_type == "yarn":
        orig = scaling.original_max_position_embeddings

        def corr_dim(n_rot):
            return (hd * math.log(orig / (n_rot * 2 * math.pi))) / (2 * math.log(theta))

        low, high = corr_dim(scaling.beta_fast), corr_dim(scaling.beta_slow)
        if scaling.truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0.0), min(high, hd - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp((torch.arange(half, dtype=torch.float32, device=device) - low) / (high - low), 0.0, 1.0)
        extrap_w = 1.0 - ramp
        freqs = (freqs / scaling.factor) * (1.0 - extrap_w) + freqs * extrap_w
        attn_factor = (scaling.attention_factor if scaling.attention_factor is not None
                       else (0.1 * math.log(scaling.factor) + 1.0 if scaling.factor > 1 else 1.0))
    if scaling is not None and scaling.rope_type == "llama3":
        wavelen = 2.0 * math.pi / freqs
        low_wl = scaling.original_max_position_embeddings / scaling.low_freq_factor
        high_wl = scaling.original_max_position_embeddings / scaling.high_freq_factor
        smooth = (scaling.original_max_position_embeddings / wavelen
                  - scaling.low_freq_factor) / (scaling.high_freq_factor - scaling.low_freq_factor)
        interp = (1.0 - smooth) * freqs / scaling.factor + smooth * freqs
        freqs = torch.where(wavelen > low_wl, freqs / scaling.factor,
                            torch.where(wavelen < high_wl, freqs, interp))
    return freqs, attn_factor


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


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor, theta: float,
                     scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """Rotary embedding on interleaved (complex) pairs (x[2i], x[2i+1]),
    Llama4's `apply_rotary_emb`, in f32; x: [B, T, n, hd]."""
    freqs, attn_factor = rope_freqs(x.shape[-1], theta, scaling, x.device)
    angles = positions[..., None].float() * freqs
    cos = (torch.cos(angles) * attn_factor)[..., None, :]
    sin = (torch.sin(angles) * attn_factor)[..., None, :]
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape).to(x.dtype)


def sink_softmax(scores: torch.Tensor, sinks: torch.Tensor, out_dtype) -> torch.Tensor:
    """GPT-OSS's attention-sink softmax over scores [B, nH, T, S] f32: a
    learned logit per head joins the max and the denominator, and its
    probability mass is dropped. Computed in place on `scores` (the
    einsum engine's score tensor is the layer's largest), with no
    concatenated sink column: the same values as JAX's softmax over it."""
    sk = sinks.float()[None, :, None, None]
    m = torch.maximum(torch.amax(scores, dim=-1, keepdim=True), sk)
    e = scores.sub_(m).exp_()
    return e.div_(e.sum(dim=-1, keepdim=True).add_(torch.exp(sk - m))).to(out_dtype)


def _qsite(x, site_cfg: QuantizerConfig, st, calib: bool):
    """Quantize (or, calibrating, collect) at one site -> (y, new_state)."""
    if not site_cfg.enable and st is None:
        return x, st
    if calib:
        return x, Q.collect(x, site_cfg, st if st is not None else QuantizerState())
    return Q.quantize(x, site_cfg, st), st


def _linear(x, w, name, layout: QuantLayout, lstate, calib, adapters=None, bias=None):
    """Quantized linear: y = q_in(x) @ q_w(w)^T (+ bias) (QuantLinear analog).

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
    if bias is not None:
        y = y + bias.to(y.dtype)
    if adapters is not None and name in adapters:
        ad = adapters[name]
        lo = (x @ ad["A"].t().to(x.dtype)) @ ad["B"].t().to(x.dtype)
        y = y + lo * ad["scale"].to(y.dtype)
    return y, (sub if sub else None)


def _write_at(cache: torch.Tensor, rows: torch.Tensor, pos) -> torch.Tensor:
    """cache [B, S, ...] with rows [B, T, ...] at pos .. pos + T - 1 (a new
    tensor: JAX's dynamic_update_slice)."""
    out = cache.clone()
    out[:, int(pos): int(pos) + rows.shape[1]] = rows.to(cache.dtype)
    return out


def _attention(cfg, x, lp, lstate, layout, positions, mask, calib, adapters=None, cache_kv=None):
    """-> (out, new_state, ctx, new_cache): ctx is the o_proj input;
    `cache_kv` (k [B, S, n_kv, hd], v, pos) is written at pos and attended
    over whole (new_cache its (k, v)), else None."""
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    B, T, _ = x.shape
    new_state = {}
    proj = {}
    for p in ("q", "k", "v"):
        name = f"self_attn.{p}_proj"
        proj[p], s = _linear(x, lp[name], name, layout, lstate, calib, adapters, lp.get(name + "__bias"))
        if s:
            new_state[name] = s
    if cfg.clip_qkv is not None:  # DBRX clamps the fused qkv output; elementwise, so each split alike
        proj = {p: torch.clamp(t, -cfg.clip_qkv, cfg.clip_qkv) for p, t in proj.items()}
    q = proj["q"].reshape(B, T, nH, hd)
    k = proj["k"].reshape(B, T, nKV, hd)
    v = proj["v"].reshape(B, T, nKV, hd)
    q, k = cfg.rope_qk(q, k, positions, lp)  # Qwen3: per-head RMSNorm before rope
    # KV-cache quantizer sites, post-rope
    k, kst = _qsite(k, layout.get("self_attn.k_bmm"), (lstate or {}).get("self_attn.k_bmm"), calib)
    if kst is not None:
        new_state["self_attn.k_bmm"] = kst
    v, vst = _qsite(v, layout.get("self_attn.v_bmm"), (lstate or {}).get("self_attn.v_bmm"), calib)
    if vst is not None:
        new_state["self_attn.v_bmm"] = vst
    new_cache = None
    if cache_kv is not None:
        ck, cv, pos = cache_kv
        k_all, v_all = _write_at(ck, k, pos), _write_at(cv, v, pos)
        new_cache = (k_all, v_all)
    else:
        k_all, v_all = k, v
    sinks = lp.get("self_attn.sinks")  # [nH] GPT-OSS's learned sink logits
    if cache_kv is None and cfg.attn_impl == "flash" and sinks is None:
        ctx = flash_gqa.flash_attention_gqa(q.transpose(1, 2), k_all.transpose(1, 2), v_all.transpose(1, 2), True)
        ctx = ctx.transpose(1, 2).reshape(B, T, nH * hd).to(x.dtype)
    else:
        rep = nH // nKV
        k_all = torch.repeat_interleave(k_all, rep, dim=2)
        v_all = torch.repeat_interleave(v_all, rep, dim=2)
        scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k_all.float())
        scores = scores / math.sqrt(hd) + mask
        if sinks is not None:
            probs = sink_softmax(scores, sinks, x.dtype)
        else:
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs, v_all.to(x.dtype)).reshape(B, T, nH * hd)
    out, s = _linear(ctx, lp["self_attn.o_proj"], "self_attn.o_proj", layout, lstate, calib, adapters,
                     lp.get("self_attn.o_proj__bias"))
    if s:
        new_state["self_attn.o_proj"] = s
    return out, new_state, ctx, new_cache


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


def _decoder_layer(cfg, layout, calib, x, lp, lstate, positions, mask, adapters=None, cache_kv=None):
    """One decoder layer -> (x_out, emitted state, taps, new (k, v) or None)."""
    h = norm(cfg, x, lp["input_layernorm"])
    attn, st_a, o_in, new_cache = _attention(cfg, h, lp, lstate, layout, positions, mask, calib, adapters, cache_kv)
    x = x + attn
    h2 = norm(cfg, x, lp["post_attention_layernorm"])
    mlp_out, st_m, down_in = _mlp(h2, lp, lstate, layout, calib, adapters)
    return x + mlp_out, {**st_a, **st_m}, (h, o_in, h2, down_in), new_cache


def decoder_layer(cfg: LlamaConfig, layout: QuantLayout, calib: bool, x: torch.Tensor, lp: dict, lstate,
                  positions: torch.Tensor, mask: torch.Tensor, adapters: Optional[dict] = None):
    """One decoder layer -> (x_out, the layer's emitted state, (h, o_in, h2,
    down_in)): the inputs of its projections, for the captures."""
    return _decoder_layer(cfg, layout, calib, x, lp, lstate, positions, mask, adapters)[:3]


def causal_mask(T: int, device) -> torch.Tensor:
    """[1, 1, T, T] additive causal mask (0 / -1e9, f32)."""
    ar = torch.arange(T, device=device)
    return torch.where(ar[None, :] <= ar[:, None], 0.0, -1e9).float()[None, None]


def span_mask(S: int, qpos: torch.Tensor, span: Optional[tuple] = None) -> torch.Tensor:
    """[T, S] additive mask (0 / -1e9, f32) of queries at positions qpos [T]
    (a tensor on any device: no host read) over keys at 0 .. S - 1: causal,
    and within `span` where given: ("window", w), the last w keys with the
    query's own (GPT-OSS's sliding layers), or ("chunk", c), the query's
    chunk of c positions (Llama4's rope layers)."""
    kpos, q = torch.arange(S, device=qpos.device)[None, :], qpos[:, None]
    keep = kpos <= q
    if span is not None:
        kind, n = span
        keep = keep & ((kpos > q - n) if kind == "window" else (kpos // n == q // n))
    return torch.where(keep, 0.0, -1e9)


def cache_mask(S: int, positions: torch.Tensor) -> torch.Tensor:
    """[1, 1, T, S] additive mask of a cached forward: query t (at
    positions[0, t]) sees keys at positions <= its own."""
    kpos = torch.arange(S, device=positions.device)[None, :]
    return torch.where(kpos <= positions[0][:, None], 0.0, -1e9).float()[None, None]


GLOBAL_SITES = ("lm_head", "embed_tokens")
CAPTURE_KEYS = ("attn_in", "o_in", "mlp_in", "down_in")  # the capture points of a decoder layer


def _positions(B: int, T: int, cache, device) -> torch.Tensor:
    start = int(cache["pos"]) if cache is not None else 0
    return (start + torch.arange(T, device=device, dtype=torch.int32))[None, :].expand(B, T)


def forward(cfg: LlamaConfig, params: Params, tokens: Optional[torch.Tensor], *,
            layout: Optional[QuantLayout] = None, qstate: Optional[QuantState] = None,
            calib: bool = False, cache: Optional[dict] = None, positions: Optional[torch.Tensor] = None,
            capture_tokens: int = 0, adapters: Optional[dict] = None, mask: Optional[torch.Tensor] = None,
            input_embeds: Optional[torch.Tensor] = None):
    """Forward pass -> (logits f32 [B, T, V], new_qstate, new_cache), or with
    `capture_tokens > 0` (logits, new_qstate, new_cache, captures): captures
    maps "attn_in", "o_in", "mlp_in", "down_in" to stacked [L, n_tokens, d]
    inputs of the projections.

    `layout=None` runs the plain model; `calib=True` runs unquantized while
    collecting amax into the returned qstate. `adapters` {name: {"A" [L, r,
    K], "B" [L, O, r], "scale" [L]}} adds each projection's LoRA branch.
    `cache` ({"k", "v" [L, B, S, n_kv, hd], "pos"}, `init_cache`) runs the
    cached forward: the tokens' k/v land at rows pos .. pos + T - 1 and each
    query attends to the rows at or before its position; the new cache is
    returned (the given one is not written). `mask` ([1, 1, T, S] additive)
    overrides the causal mask (and keeps the einsum attention);
    `input_embeds` [B, T, H] replaces the token lookup.
    """
    layout = layout or QuantLayout(sites=())
    B, T = input_embeds.shape[:2] if input_embeds is not None else tokens.shape
    dev = input_embeds.device if input_embeds is not None else tokens.device
    if positions is None:
        positions = _positions(B, T, cache, dev)

    ew_cfg = layout.get("embed_tokens.weight")
    ew_state = (qstate or {}).get("embed_tokens.weight")
    if input_embeds is not None:
        x = input_embeds.to(cfg.dtype)
    else:
        emb_w = params["embed_tokens"]
        if ew_cfg.enable and not calib:
            emb_w = Q.quantize(emb_w, ew_cfg, ew_state)
        x = emb_w[tokens].to(cfg.dtype)

    if mask is not None:
        if cfg.attn_impl == "flash":  # a non-causal mask cannot take the flash path
            cfg = dataclasses.replace(cfg, attn_impl="einsum")
    elif cache is not None:
        mask = cache_mask(cache["k"].shape[2], positions)
    else:
        mask = causal_mask(T, dev)

    per_layer_state = {k: v for k, v in (qstate or {}).items()
                       if not k.startswith(GLOBAL_SITES)} or None
    layers = scanned(params["layers"])  # JAX's lax.scan over this stack
    emitted, new_k, new_v = [], [], []
    captures: dict = {k: [] for k in CAPTURE_KEYS} if capture_tokens else {}
    for i in range(cfg.num_hidden_layers):
        lp = {k: v[i] for k, v in layers.items()}
        lstate = slice_state(per_layer_state, i)
        ad = None if adapters is None else {n: {k: a[i] for k, a in f.items()} for n, f in adapters.items()}
        ckv = None if cache is None else (cache["k"][i], cache["v"][i], cache["pos"])
        x, st, taps, kv = _decoder_layer(cfg, layout, calib, x, lp, lstate, positions, mask, ad, ckv)
        emitted.append(st)
        if kv is not None:
            new_k.append(kv[0])
            new_v.append(kv[1])
        if capture_tokens:
            for k, t in zip(CAPTURE_KEYS, taps):
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
    new_cache = None
    if cache is not None:
        new_cache = {"k": torch.stack(new_k), "v": torch.stack(new_v), "pos": cache["pos"] + T}
    out_qstate = new_qstate if (calib or qstate) else None
    if capture_tokens:
        return logits, out_qstate, new_cache, {k: torch.stack(v) for k, v in captures.items()}
    return logits, out_qstate, new_cache


def slice_layer(tree, i: int):
    """Layer `i` of a stacked [L, ...] tree of tensors."""
    if isinstance(tree, dict):
        return {k: slice_layer(v, i) for k, v in tree.items()}
    return tree[i]


def forward_unrolled(cfg: LlamaConfig, params: Params, tokens: torch.Tensor, layer_layouts: list,
                     qstate_list: Optional[list] = None, calib: bool = False, cache: Optional[dict] = None):
    """Forward with a distinct quant layout per layer (an AutoQuantize
    result); quantizer state is a per-layer list. Returns (logits,
    new_states), or with `cache` (`forward`'s dict) (logits, new_states,
    new_cache)."""
    B, T = tokens.shape
    positions = _positions(B, T, cache, tokens.device)
    x = params["embed_tokens"][tokens].to(cfg.dtype)
    mask = cache_mask(cache["k"].shape[2], positions) if cache is not None else causal_mask(T, tokens.device)
    new_states, new_k, new_v = [], [], []
    for i in range(cfg.num_hidden_layers):
        lp = slice_layer(params["layers"], i)
        ckv = None if cache is None else (cache["k"][i], cache["v"][i], cache["pos"])
        x, st, _, kv = _decoder_layer(cfg, layer_layouts[i], calib, x, lp,
                                      qstate_list[i] if qstate_list else None, positions, mask, None, ckv)
        new_states.append(st)
        if kv is not None:
            new_k.append(kv[0])
            new_v.append(kv[1])
    x = norm(cfg, x, params["norm"])
    head_w = params.get("lm_head", params["embed_tokens"])
    logits = (x @ head_w.t().to(x.dtype)).float()
    if cache is not None:
        return logits, new_states, {"k": torch.stack(new_k), "v": torch.stack(new_v), "pos": cache["pos"] + T}
    return logits, new_states


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """The cached forward's cache: {"k", "v" [L, B, max_len, n_kv, hd]
    zeros, "pos" a 0-d int32 tensor}."""
    dev = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}
