"""Llama4 text model, the Scout-style all-MoE stack (port of
`models/llama4.py`): the Mixtral stacked-expert MoE with Llama4's twists:

 - interleaved rope (`llama.rope_interleaved`: complex pairs, not split
   halves);
 - nope layers: every `no_rope_layer_interval`-th layer (or HF's explicit
   `no_rope_layers` flags) skips rope and scales q by the log-floor
   attention temperature (`attn_scale`, `floor_scale`);
 - a weightless L2 (RMS) qk-norm after rope, on rope layers only;
 - chunked attention on rope layers: a key is visible only within the
   query's `attention_chunk_size` chunk; nope layers stay fully causal;
 - sigmoid input-scaled routing (`mixtral.route` /
   `dispatch_combine`) and a dense shared expert added to the routed
   output (`shared.*` sites).

Only the all-MoE layout (`interleave_moe_layer_step=1`) exists, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.config import QuantizeConfig
from ..trace.tracer import scanned
from . import llama, mixtral

SHARED_NAMES = ("shared.gate_proj", "shared.up_proj", "shared.down_proj")


@dataclasses.dataclass(frozen=True)
class Llama4Config(mixtral.MixtralConfig):
    num_experts: int = 16
    top_k: int = 1
    router_sigmoid_input_scaled: bool = True
    interleave_moe_layer_step: int = 1
    no_rope_layer_interval: int = 4
    # HF `no_rope_layers` (1 = rope) per layer; overrides the interval rule
    no_rope_layers: Optional[tuple] = None
    attention_chunk_size: int = 8192
    attn_temperature_tuning: bool = True
    attn_scale: float = 0.1
    floor_scale: float = 8192.0
    use_qk_norm: bool = True

    def use_rope_layers(self) -> tuple:
        if self.no_rope_layers is not None:
            return tuple(bool(v) for v in self.no_rope_layers)
        return tuple((i + 1) % self.no_rope_layer_interval != 0 for i in range(self.num_hidden_layers))

    def layer_flags(self) -> tuple:
        """The rope layers: they attend within their chunk."""
        return self.use_rope_layers()

    def span(self) -> Optional[tuple]:
        return ("chunk", self.attention_chunk_size)

    def rope_qk(self, q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, lp: dict, flag: bool = False):
        return rope_or_temperature(self, q, k, positions, flag)

    @staticmethod
    def tiny(**kw) -> "Llama4Config":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=4,
                    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                    dtype=torch.float32, num_experts=4, top_k=1, attention_chunk_size=8, floor_scale=8.0)
        base.update(kw)
        return Llama4Config(**base)


def shared_shapes(cfg: Llama4Config) -> dict:
    """The shared expert's weight shapes, [out, in]."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    return {"shared.gate_proj": (inter, h), "shared.up_proj": (inter, h), "shared.down_proj": (h, inter)}


def init_params(cfg: Llama4Config, generator: torch.Generator, device=None) -> dict:
    """Mixtral's seeded weights plus the shared expert `[L, out, in]`,
    N(0, 1/fan_in) in `cfg.dtype`, one layer at a time on the device."""
    if cfg.interleave_moe_layer_step != 1:
        raise NotImplementedError("only the all-MoE (Scout-style) layout is supported, as in JAX")
    dev = resolve_device(device)
    params = mixtral.init_params(cfg, generator, dev)
    L = cfg.num_hidden_layers
    for name, (o, i) in shared_shapes(cfg).items():
        stacked = torch.empty((L, o, i), dtype=cfg.dtype, device=dev)
        for li in range(L):
            w = torch.randn((o, i), generator=generator, dtype=torch.float32, device=dev)
            stacked[li] = w.div_(math.sqrt(i)).to(cfg.dtype)
        params["layers"][name] = stacked
    return params


def param_specs(cfg: Llama4Config) -> dict:
    specs = mixtral.param_specs(cfg)
    specs["layers"]["shared.gate_proj"] = specs["layers"]["shared.up_proj"] = (None, "tensor", None)
    specs["layers"]["shared.down_proj"] = (None, None, "tensor")
    return specs


def build_layout(cfg: Llama4Config, qcfg: QuantizeConfig) -> llama.QuantLayout:
    sites = dict(mixtral.build_layout(cfg, qcfg).sites)
    for name in SHARED_NAMES:
        full = f"model.layers.0.{name}"
        sites[f"{name}.weight"] = qcfg.resolve(f"{full}.weight_quantizer")
        sites[f"{name}.input"] = qcfg.resolve(f"{full}.input_quantizer")
    return llama.QuantLayout(sites=tuple(sites.items()))


def init_quant_state(cfg: Llama4Config, layout: llama.QuantLayout, device=None) -> dict:
    """Mixtral's state plus the shared expert's, stacked [L, ...] like a
    dense layer's."""
    base = mixtral.init_quant_state(
        cfg, llama.QuantLayout(sites=tuple((k, v) for k, v in layout.sites if not k.startswith("shared."))), device)
    L = cfg.num_hidden_layers
    for name, shape in shared_shapes(cfg).items():
        wcfg, icfg = layout.get(f"{name}.weight"), layout.get(f"{name}.input")
        sub = {}
        if wcfg.enable:
            st = Q.init_state(wcfg, shape, device)
            sub["weight"] = llama._map_state(lambda a: a.expand((L,) + tuple(a.shape)).clone(), st)
        if icfg.enable:
            st = Q.init_state(icfg, (1, 1, shape[1]), device)
            sub["input"] = llama._map_state(lambda a: a.expand((L,) + tuple(a.shape)).clone(), st)
        if sub:
            base[name] = sub
    return base


def _l2norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)).to(x.dtype)


def temperature(cfg: Llama4Config, positions: torch.Tensor) -> torch.Tensor:
    """The nope layers' q scale at each position [B, T] (f32):
    log1p(floor((pos + 1) / floor_scale)) * attn_scale + 1."""
    return torch.log1p(torch.floor((positions.float() + 1.0) / cfg.floor_scale)) * cfg.attn_scale + 1.0


def rope_or_temperature(cfg: Llama4Config, q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
                        use_rope: bool):
    """Llama4's q/k treatment, shared with the serving engine: interleaved
    rope (then the weightless L2 qk-norm) on a rope layer; the log-floor
    temperature on q on a nope layer. JAX computes both and selects with
    `where` on a traced flag; the layer's flag is a Python bool here, so
    the branch taken gives the same values."""
    if use_rope:
        q = llama.rope_interleaved(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = llama.rope_interleaved(k, positions, cfg.rope_theta, cfg.rope_scaling)
        if cfg.use_qk_norm:
            q, k = _l2norm(q, cfg.rms_norm_eps), _l2norm(k, cfg.rms_norm_eps)
        return q, k
    if cfg.attn_temperature_tuning:
        q = (q.float() * temperature(cfg, positions)[..., None, None]).to(q.dtype)
    return q, k


def _attention_l4(cfg, x, lp, lstate, layout, positions, mask, calib, use_rope: bool):
    """Llama4 attention (no biases, no sinks) -> (out, emitted state)."""
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    B, T, _ = x.shape
    new_state, proj = {}, {}
    for p in ("q", "k", "v"):
        name = f"self_attn.{p}_proj"
        proj[p], s = llama._linear(x, lp[name], name, layout, lstate, calib)
        if s:
            new_state[name] = s
    q = proj["q"].reshape(B, T, nH, hd)
    k = proj["k"].reshape(B, T, nKV, hd)
    v = proj["v"].reshape(B, T, nKV, hd)
    q, k = rope_or_temperature(cfg, q, k, positions, use_rope)
    k, kst = llama._qsite(k, layout.get("self_attn.k_bmm"), (lstate or {}).get("self_attn.k_bmm"), calib)
    if kst is not None:
        new_state["self_attn.k_bmm"] = kst
    v, vst = llama._qsite(v, layout.get("self_attn.v_bmm"), (lstate or {}).get("self_attn.v_bmm"), calib)
    if vst is not None:
        new_state["self_attn.v_bmm"] = vst
    rep = nH // nKV
    k_all, v_all = torch.repeat_interleave(k, rep, dim=2), torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k_all.float()) / math.sqrt(hd) + mask
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bnqk,bknd->bqnd", probs, v_all.to(x.dtype)).reshape(B, T, nH * hd)
    out, s = llama._linear(ctx, lp["self_attn.o_proj"], "self_attn.o_proj", layout, lstate, calib)
    if s:
        new_state["self_attn.o_proj"] = s
    return out, new_state


def _shared_mlp(x, lp, lstate, layout, calib):
    """The dense shared expert: down(silu(gate x) * up x), the product in f32."""
    new_state, out = {}, {}
    for name in SHARED_NAMES[:2]:
        out[name], s = llama._linear(x, lp[name], name, layout, lstate, calib)
        if s:
            new_state[name] = s
    y = (torch.nn.functional.silu(out["shared.gate_proj"].float()) * out["shared.up_proj"].float()).to(x.dtype)
    d, s = llama._linear(y, lp["shared.down_proj"], "shared.down_proj", layout, lstate, calib)
    if s:
        new_state["shared.down_proj"] = s
    return d, new_state


def forward(cfg: Llama4Config, params: dict, tokens: torch.Tensor, *,
            layout: Optional[llama.QuantLayout] = None, qstate: Optional[dict] = None,
            calib: bool = False, capture_tokens: int = 0):
    """Prefill forward -> (logits f32 [B, T, V], state), or with
    `capture_tokens > 0` (logits, state, captures {"attn_in", "moe_in"}
    [L, n, H]). Rope layers attend within their chunk, nope layers over
    the whole causal past; each layer adds the shared expert to the routed
    output."""
    layout = layout or llama.QuantLayout(sites=())
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device, dtype=torch.int32)[None, :].expand(B, T)
    x = params["embed_tokens"][tokens].to(cfg.dtype)
    ar = torch.arange(T, device=tokens.device)
    masks = {False: llama.causal_mask(T, tokens.device),
             True: llama.span_mask(T, ar, cfg.span())[None, None]}
    per_layer = {k: v for k, v in (qstate or {}).items() if not k.startswith(llama.GLOBAL_SITES)} or None
    emitted, captures = [], {"attn_in": [], "moe_in": []}
    layers = scanned(params["layers"])  # JAX's lax.scan over this stack
    for i, use_rope in enumerate(cfg.layer_flags()):
        lp = {k: v[i] for k, v in layers.items()}
        lstate = llama.slice_state(per_layer, i)
        h = llama.norm(cfg, x, lp["input_layernorm"])
        if capture_tokens:
            captures["attn_in"].append(llama._grab(h, capture_tokens))
        attn, st_a = _attention_l4(cfg, h, lp, lstate, layout, positions, masks[use_rope], calib, use_rope)
        x = x + attn
        h = llama.norm(cfg, x, lp["post_attention_layernorm"])
        if capture_tokens:
            captures["moe_in"].append(llama._grab(h, capture_tokens))
        moe_out, st_m = mixtral._moe_mlp(cfg, h, lp, lstate, layout, calib)
        shared_out, st_s = _shared_mlp(h, lp, lstate, layout, calib)
        x = x + moe_out + shared_out
        emitted.append({**st_a, **st_m, **st_s})
    logits = mixtral._head(cfg, params, x)
    st = (llama.stack_states(emitted) if emitted and emitted[0] else {}) if (calib or qstate) else None
    if capture_tokens:
        return logits, st, {k: torch.stack(v) for k, v in captures.items()}
    return logits, st
