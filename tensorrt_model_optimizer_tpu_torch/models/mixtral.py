"""Mixtral-style MoE model with quantized experts (port of
`models/mixtral.py`): Mixtral, Qwen3-MoE and DBRX share it.

Llama's attention, then a top-k routed expert MLP. Experts are stacked
`[L, E, out, in]`; expert weight quantizers hold per-expert amax (`[L, E,
...]`), the block's input quantizer one state per layer on gate_proj (gate
and up share it; down's input is not quantized).

Dispatch computes JAX's capacity assignment by index, not by its one-hot
`[S, k, E, C]` einsum (137 GB at Qwen3-30B-A3B's prefill, 8.6 GB at
Mixtral's): the flattened (token, choice) pairs, token-major as JAX
flattens them, take their place `pos` in their expert's queue as the
running count of earlier pairs routed there; a pair is kept when pos < C
and dropped otherwise. The kept pairs' tokens are copied into the expert
rows `[E * C, H]` (a dump row takes the dropped ones) and the experts'
outputs gathered back under the routing weights. The same pairs are kept
and dropped as in JAX, bit for bit, with no host sync (no `nonzero`, no
boolean indexing, no `.item()`), so the graphed decode step captures it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.config import QuantizeConfig
from ..quant.quantizer import QuantizerState
from ..trace.tracer import scanned, tied
from . import llama


@dataclasses.dataclass(frozen=True)
class MixtralConfig(llama.LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    # renormalize the top-k routing weights (Mixtral always; Qwen3-MoE's
    # `norm_topk_prob`)
    norm_topk_prob: bool = True
    # GPT-OSS: softmax over the top-k logits instead of top-k of the softmax
    router_softmax_after_topk: bool = False
    # Llama4: sigmoid of the top-k logits scales the expert inputs; the
    # outputs sum unweighted
    router_sigmoid_input_scaled: bool = False
    router_bias: bool = False
    moe_bias: bool = False  # per-expert gate/up/down biases
    # clamped swiglu: gate <= limit, |up| <= limit, (up + 1) gate sigmoid(a gate)
    swiglu_limit: Optional[float] = None
    swiglu_alpha: float = 1.702

    def route_dispatch(self, x: torch.Tensor, lp: dict) -> "Dispatch":
        """The serving engine's routing of x [S, H]: `route` on the layer's
        router logits, then the capacity assignment (`route` is looked up
        when called, so a caller may wrap it)."""
        S = x.shape[0]
        topw, topi = route(self, router_logits(self, x, lp))
        return dispatch_combine(self, topw, topi, S, capacity(self, S))

    @staticmethod
    def tiny(**kw) -> "MixtralConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                    dtype=torch.float32, num_experts=4, top_k=2)
        base.update(kw)
        return MixtralConfig(**base)


MOE_NAMES = ("moe.gate_proj", "moe.up_proj", "moe.down_proj")
MLP_NAMES = ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")


def llama_part(cfg: MixtralConfig) -> llama.LlamaConfig:
    """The LlamaConfig fields of a MixtralConfig."""
    return llama.LlamaConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(llama.LlamaConfig)})


def expert_shapes(cfg: MixtralConfig) -> dict:
    """Per-expert weight shapes, [out, in]."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    return {"moe.gate_proj": (inter, h), "moe.up_proj": (inter, h), "moe.down_proj": (h, inter)}


def init_params(cfg: MixtralConfig, generator: torch.Generator, device=None) -> dict:
    """Seeded random weights: llama's, with the dense MLP replaced by a
    router `[L, E, H]` and expert stacks `[L, E, out, in]`, N(0, 1/fan_in)
    in `cfg.dtype`, made one expert at a time on the device."""
    dev = resolve_device(device)
    params = llama.init_params(dataclasses.replace(llama_part(cfg), intermediate_size=1), generator, dev)
    layers = params["layers"]
    for name in MLP_NAMES:
        del layers[name]
    L, E, h = cfg.num_hidden_layers, cfg.num_experts, cfg.hidden_size

    def winit(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(fan_in)).to(cfg.dtype)

    layers["moe.router"] = winit((L, E, h), h)
    for name, (o, i) in expert_shapes(cfg).items():
        stacked = torch.empty((L, E, o, i), dtype=cfg.dtype, device=dev)
        for li in range(L):
            for e in range(E):
                stacked[li, e] = winit((o, i), i)
        layers[name] = stacked
    return params


def param_specs(cfg: MixtralConfig) -> dict:
    """The JAX package's PartitionSpecs as tuples of mesh-axis names:
    experts over "expert", within an expert optional tensor parallelism."""
    specs = llama.param_specs(llama_part(cfg))
    layers = specs["layers"]
    for name in MLP_NAMES:
        del layers[name]
    layers["moe.router"] = (None, None, None)
    layers["moe.gate_proj"] = layers["moe.up_proj"] = (None, "expert", "tensor", None)
    layers["moe.down_proj"] = (None, "expert", None, "tensor")
    return specs


def build_layout(cfg: MixtralConfig, qcfg: QuantizeConfig) -> llama.QuantLayout:
    sites = dict(llama.build_layout(cfg, qcfg).sites)
    for name in MLP_NAMES:
        for kind in ("weight", "input", "output"):
            sites.pop(f"{name}.{kind}", None)
    for name in MOE_NAMES:
        full = f"model.layers.0.{name}"
        sites[f"{name}.weight"] = qcfg.resolve(f"{full}.weight_quantizer")
        sites[f"{name}.input"] = qcfg.resolve(f"{full}.input_quantizer")
    sites["moe.router.weight"] = qcfg.resolve("model.layers.0.moe.router.weight_quantizer")
    return llama.QuantLayout(sites=tuple(sites.items()))


def init_quant_state(cfg: MixtralConfig, layout: llama.QuantLayout, device=None) -> dict:
    """llama's state for the attention sites; expert weights per expert
    `[L, E, ...]`, the block input `[L, ...]`."""
    base = llama.init_quant_state(
        llama_part(cfg), llama.QuantLayout(sites=tuple((k, v) for k, v in layout.sites if not k.startswith("moe."))),
        device)
    for name in MLP_NAMES:
        base.pop(name, None)
    L, E = cfg.num_hidden_layers, cfg.num_experts
    for name, shape in expert_shapes(cfg).items():
        wcfg, icfg = layout.get(f"{name}.weight"), layout.get(f"{name}.input")
        sub = {}
        if wcfg.enable:
            st = Q.init_state(wcfg, shape, device)
            sub["weight"] = llama._map_state(lambda a: a.expand((L, E) + tuple(a.shape)).clone(), st)
        if icfg.enable:
            st = Q.init_state(icfg, (1, 1, shape[1]), device)
            sub["input"] = llama._map_state(lambda a: a.expand((L,) + tuple(a.shape)).clone(), st)
        if sub:
            base[name] = sub
    return base


def route(cfg: MixtralConfig, logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Routing shared by the calibration / fake-quant forward and the
    engine: logits [S, E] f32 -> (topw, topi) [S, k], the top-k experts
    (of the raw logits for Llama4 and GPT-OSS, else of their softmax) and
    their `route_weights`."""
    raw = cfg.router_sigmoid_input_scaled or cfg.router_softmax_after_topk
    topi = torch.topk(logits if raw else torch.softmax(logits, dim=-1), cfg.top_k, dim=-1)[1]
    return route_weights(cfg, logits, topi), topi


def route_weights(cfg: MixtralConfig, logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The weights of the chosen experts idx [S, k] on logits [S, E] f32:
    Llama4 the chosen logits' sigmoid; GPT-OSS the softmax over the chosen
    logits; else the softmax's probabilities, renormalised where
    `norm_topk_prob`."""
    if cfg.router_sigmoid_input_scaled:
        return torch.sigmoid(logits.gather(-1, idx))
    if cfg.router_softmax_after_topk:
        return torch.softmax(logits.gather(-1, idx), dim=-1)
    w = torch.softmax(logits, dim=-1).gather(-1, idx)
    return w / torch.sum(w, dim=-1, keepdim=True) if cfg.norm_topk_prob else w


def capacity(cfg: MixtralConfig, S: int) -> int:
    """Rows an expert takes for S tokens: max(int(capacity_factor S k / E), 1)."""
    return max(int(cfg.capacity_factor * S * cfg.top_k / cfg.num_experts), 1)


@dataclasses.dataclass
class Dispatch:
    """The capacity assignment of S tokens' k choices, by index.

    `dest` [S * k] is each (token, choice) pair's expert row e * C + pos,
    or E * C (the dump row) for a dropped pair; `keep` [S * k] bool;
    `src` [E * C] the token each expert row holds, or S (a zero row) where
    the row is empty; `w_in` / `w_out` [S * k] f32 the weights a pair
    scales its input and its output by (0 where dropped)."""

    dest: torch.Tensor
    keep: torch.Tensor
    src: torch.Tensor
    w_in: Optional[torch.Tensor]
    w_out: torch.Tensor
    C: int

    @property
    def experts(self) -> int:
        return self.src.shape[0] // self.C


def dispatch_combine(cfg: MixtralConfig, topw: torch.Tensor, topi: torch.Tensor, S: int, C: int) -> Dispatch:
    """JAX's capacity dispatch ([S, E, C] one-hot einsums) by index: the
    pair (s, j) lands at place pos = (pairs before it, token-major, routed
    to the same expert) of its expert's queue, and is kept when pos < C."""
    E, k = cfg.num_experts, cfg.top_k
    flat = topi.reshape(S * k).long()
    # [E, S k]: each expert's running count along the pairs, an innermost
    # scan (over [S k, E] the outer-dim scan took 50 ms a layer on an H100 at
    # S k = 131072)
    onehot = (torch.arange(E, device=flat.device)[:, None] == flat[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32).gather(0, flat[None, :])[0].long() - 1
    keep = pos < C
    dump = E * C
    dest = torch.where(keep, flat * C + pos, torch.full_like(flat, dump))
    tok = torch.arange(S * k, device=topi.device) // k
    src = torch.full((dump + 1,), S, dtype=torch.long, device=topi.device)
    src.index_copy_(0, dest, tok)  # every dropped pair writes the dump row, which is cut off
    w = torch.where(keep, topw.reshape(S * k).float(), torch.zeros((), device=topw.device))
    if cfg.router_sigmoid_input_scaled:  # Llama4: the weight scales the token on its way in
        return Dispatch(dest, keep, src[:dump], w, keep.float(), C)
    return Dispatch(dest, keep, src[:dump], None, w, C)


def dispatch_tokens(d: Dispatch, x: torch.Tensor, E: int) -> torch.Tensor:
    """x [S, H] -> the experts' rows [E, C, H] in x's dtype (empty rows 0)."""
    S, H = x.shape
    xp = torch.cat([x, torch.zeros((1, H), dtype=x.dtype, device=x.device)])
    if d.w_in is None:
        return xp[d.src].reshape(E, d.C, H)
    # the input weight of each row's pair, an f32 product rounded to x's dtype
    w_row = torch.zeros((E * d.C + 1,), dtype=torch.float32, device=x.device)
    w_row.index_copy_(0, d.dest, d.w_in)
    return (xp[d.src].float() * w_row[:-1, None]).to(x.dtype).reshape(E, d.C, H)


def combine_tokens(d: Dispatch, ye: torch.Tensor, S: int, k: int, dtype) -> torch.Tensor:
    """The experts' outputs ye [E, C, H] -> [S, H]: each token's kept pairs'
    rows times their weights, summed in f32."""
    H = ye.shape[-1]
    rows = torch.cat([ye.reshape(-1, H), torch.zeros((1, H), dtype=ye.dtype, device=ye.device)])
    return (rows[d.dest].float() * d.w_out[:, None]).reshape(S, k, H).sum(dim=1).to(dtype)


def combine_local(d: Dispatch, ye: torch.Tensor, e0: int, S: int, k: int, dtype, ep=None, tp=None) -> torch.Tensor:
    """`combine_tokens` of experts e0 .. e0 + n - 1's outputs ye [n, C, H]
    (all E experts where n = E) under expert parallelism: the down
    partials SUMmed over `tp` (each expert's down K sharded over it), the
    other experts' rows 0, and the combined partial SUMmed over `ep` (the
    axis the experts shard over). `ep` / `tp`: `parallel.mesh.Axis`, or
    None for one rank."""
    if tp is not None:
        ye = tp.sum(ye)
    E = d.experts
    if ye.shape[0] != E:  # the other ranks' experts' rows are 0 here: this rank's pairs only
        full = torch.zeros((E,) + tuple(ye.shape[1:]), dtype=ye.dtype, device=ye.device)
        full[e0:e0 + ye.shape[0]] = ye
        ye = full
    out = combine_tokens(d, ye, S, k, dtype)
    return ep.sum(out) if ep is not None else out


def expert_act(cfg: MixtralConfig, g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Expert nonlinearity in f32: silu(gate) * up, or GPT-OSS's clamped swiglu."""
    gf, uf = g.float(), u.float()
    if cfg.swiglu_limit is not None:
        gf = torch.clamp_max(gf, cfg.swiglu_limit)
        uf = torch.clamp(uf, -cfg.swiglu_limit, cfg.swiglu_limit)
        return (uf + 1.0) * gf * torch.sigmoid(cfg.swiglu_alpha * gf)
    return torch.nn.functional.silu(gf) * uf


def router_logits(cfg: MixtralConfig, x: torch.Tensor, lp: dict) -> torch.Tensor:
    """x [S, H] -> f32 router logits [S, E]."""
    logits = x.float() @ lp["moe.router"].float().t()
    if cfg.router_bias:
        logits = logits + lp["moe.router__bias"].float()
    return logits


def expert_stacks(lp: dict) -> list:
    """A layer's expert stacks [E, ...] (the biases too), in the order
    JAX's dispatch einsums meet them: gate, up, then down."""
    names = ("moe.gate_proj", "moe.up_proj", "moe.gate_proj__bias", "moe.up_proj__bias", "moe.down_proj",
             "moe.down_proj__bias")
    return [lp[n] for n in names if n in lp]


def _moe_mlp(cfg: MixtralConfig, x, lp, lstate, layout, calib, ep=None, tp=None):
    """Top-k routed expert MLP with capacity dispatch; x [B, T, H] ->
    (y [B, T, H], emitted state). Under expert parallelism (`ep`, `tp`:
    `parallel.mesh.Axis`) the layer's stacks hold this rank's E / e
    experts, each its 1 / t of gate / up rows and down columns: routing and
    dispatch run over all E on the replicated activations, the local
    experts' rows through their shares (`combine_local`)."""
    B, T, H = x.shape
    E, k = cfg.num_experts, cfg.top_k
    S = B * T
    C = capacity(cfg, S)
    xf = x.reshape(S, H)
    topw, topi = route(cfg, router_logits(cfg, xf, lp))
    d = dispatch_combine(cfg, topw, topi, S, C)
    El = lp["moe.gate_proj"].shape[0]  # E, or this rank's share under expert parallelism
    if ep is not None and cfg.moe_bias:
        raise NotImplementedError("expert parallelism: expert biases are not sharded")
    e0 = ep.index * El if ep is not None else 0
    xe = dispatch_tokens(d, xf, E)[e0:e0 + El]
    lst = lstate or {}
    ist = lst.get("moe.gate_proj", {}).get("input")
    icfg = layout.get("moe.gate_proj.input")
    # pre_quant_scale applies even where the site is off (weight-only AWQ
    # folded its migration scale out of the weights: llama._qsite's rule)
    quant_in = (icfg.enable or (ist is not None and ist.pre_quant_scale is not None)) and not calib \
        and ist is not None

    def w_of(name, e):
        w = lp[name][e]
        wcfg = layout.get(f"{name}.weight")
        if not wcfg.enable or calib:
            return w
        return Q.quantize(w, wcfg, llama.slice_state(lst.get(name, {}).get("weight", QuantizerState()), e))

    tied(expert_stacks(lp))  # JAX's dispatch einsums batch over this axis
    ye = []
    for e in range(El):
        h_in = Q.quantize(xe[e], icfg, ist) if quant_in else xe[e]
        g = h_in @ w_of("moe.gate_proj", e).t().to(h_in.dtype)
        u = h_in @ w_of("moe.up_proj", e).t().to(h_in.dtype)
        if cfg.moe_bias:
            g = g + lp["moe.gate_proj__bias"][e].to(g.dtype)
            u = u + lp["moe.up_proj__bias"][e].to(u.dtype)
        y = expert_act(cfg, g, u).to(xe.dtype)
        dn = y @ w_of("moe.down_proj", e).t().to(y.dtype)
        if cfg.moe_bias:
            dn = dn + lp["moe.down_proj__bias"][e].to(dn.dtype)
        ye.append(dn)
    y = combine_local(d, torch.stack(ye), e0, S, k, x.dtype, ep, tp)

    new_state = {}
    if calib:
        for name in MOE_NAMES:
            wcfg = layout.get(f"{name}.weight")
            if wcfg.enable:
                st = lst.get(name, {}).get("weight", QuantizerState())
                new_state.setdefault(name, {})["weight"] = llama.stack_states(
                    [Q.collect(lp[name][e], wcfg, llama.slice_state(st, e)) for e in range(El)])
        st_in = lst.get("moe.gate_proj", {}).get("input")
        if icfg.enable or st_in is not None:
            # carried through where the site is off: weight-only AWQ parks
            # pre_quant_scale here
            new_state.setdefault("moe.gate_proj", {})["input"] = Q.collect(
                x, icfg, st_in if st_in is not None else QuantizerState())
    return y.reshape(B, T, H), new_state


def _layer(cfg, layout, calib, x, lp, lstate, positions, mask, capture_tokens, ep=None, tp=None):
    caps = {}
    h = llama.norm(cfg, x, lp["input_layernorm"])
    if capture_tokens:
        caps["attn_in"] = llama._grab(h, capture_tokens)
    attn, st_a, _, _ = llama._attention(cfg, h, lp, lstate, layout, positions, mask, calib)
    x = x + attn
    h = llama.norm(cfg, x, lp["post_attention_layernorm"])
    if capture_tokens:
        caps["moe_in"] = llama._grab(h, capture_tokens)
    moe_out, st_m = _moe_mlp(cfg, h, lp, lstate, layout, calib, ep, tp)
    return x + moe_out, {**st_a, **st_m}, caps


def _head(cfg, params, x):
    x = llama.norm(cfg, x, params["norm"])
    head_w = params.get("lm_head", params["embed_tokens"])
    return (x @ head_w.t().to(x.dtype)).float()


def forward(cfg: MixtralConfig, params: dict, tokens: torch.Tensor, *,
            layout: Optional[llama.QuantLayout] = None, qstate: Optional[dict] = None,
            calib: bool = False, capture_tokens: int = 0, ep=None, tp=None):
    """MoE forward (prefill style; serving runs `serve.engine`) -> (logits
    f32 [B, T, V], state), or with `capture_tokens > 0` (logits, state,
    captures): captures {"attn_in", "moe_in"} [L, n, H], the inputs the
    calibration searches see. The state is the emitted per-layer state
    (calibrating, or given one), else None. `ep` / `tp`: the expert-parallel
    axes of a rank holding its share of the expert stacks (`_moe_mlp`;
    `quant/sharded.py`)."""
    layout = layout or llama.QuantLayout(sites=())
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device, dtype=torch.int32)[None, :].expand(B, T)
    x = params["embed_tokens"][tokens].to(cfg.dtype)
    mask = llama.causal_mask(T, tokens.device)
    per_layer = {k: v for k, v in (qstate or {}).items() if not k.startswith(llama.GLOBAL_SITES)} or None
    emitted, captures = [], {"attn_in": [], "moe_in": []}
    layers = scanned(params["layers"])  # JAX's lax.scan over this stack
    for i in range(cfg.num_hidden_layers):
        lp = {k: v[i] for k, v in layers.items()}
        x, st, caps = _layer(cfg, layout, calib, x, lp, llama.slice_state(per_layer, i), positions, mask,
                             capture_tokens, ep, tp)
        emitted.append(st)
        for key, t in caps.items():
            captures[key].append(t)
    logits = _head(cfg, params, x)
    st = (llama.stack_states(emitted) if emitted and emitted[0] else {}) if (calib or qstate) else None
    if capture_tokens:
        return logits, st, {k: torch.stack(v) for k, v in captures.items()}
    return logits, st


def forward_unrolled(cfg: MixtralConfig, params: dict, tokens: torch.Tensor, layer_layouts: list,
                     qstate_list: Optional[list] = None, calib: bool = False):
    """Forward with a distinct quant layout per layer (an AutoQuantize
    result) -> (logits, per-layer emitted states)."""
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device, dtype=torch.int32)[None, :].expand(B, T)
    x = params["embed_tokens"][tokens].to(cfg.dtype)
    mask = llama.causal_mask(T, tokens.device)
    new_states = []
    for i in range(cfg.num_hidden_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        x, st, _ = _layer(cfg, layer_layouts[i], calib, x, lp, qstate_list[i] if qstate_list else None,
                          positions, mask, 0)
        new_states.append(st)
    return _head(cfg, params, x), new_states
