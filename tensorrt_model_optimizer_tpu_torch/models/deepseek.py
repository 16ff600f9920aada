"""DeepSeek-V3-style model: MLA attention and a group-limited sigmoid MoE
(port of `models/deepseek.py`).

 - **MLA (multi-head latent attention).** Queries go through a low-rank pair
   (q_a, its RMSNorm, q_b) or one q_proj (`q_lora_rank = 0`); keys and
   values come from a `kv_lora_rank` latent (kv_a, its RMSNorm) and one rope
   key shared by every head. The cache holds the latent and the rope key
   only, `[B, S, r]` + `[B, S, dr]` a layer. Without a cache the attention
   runs the naive expanded form (kv_b applied to every token, the
   probabilities cast to the model dtype before P.V); with one, the absorbed
   form in f32: q projected through kv_b's key half into the latent space,
   scores against the cached latent, the context taken back through kv_b's
   value half. The two forms compute one function.
 - **Routing** (`route`): sigmoid scores; a correction bias `e_bias` that
   moves only the choice; groups scored by the sum of their top two; the
   experts of all but the top `topk_group` groups set to -inf; the top k
   chosen, their weights taken from the scores, normalised (+1e-20) and
   times `routed_scaling_factor`.
 - **Dispatch.** JAX's capacity one-hot `[S, k, E, C]` (137 GB of f32 at
   V3's prefill) is not carried over: the port's index dispatch
   (`mixtral.dispatch_combine` / `dispatch_tokens` / `combine_tokens`) keeps
   and drops the same (token, choice) pairs, a token-major running count
   over the S k pairs against C = max(int(capacity_factor S k / E), 1).
   The shared experts run through `llama._mlp` under `_SharedLayoutView`.
 - **Layer groups.** The first `first_k_dense_replace` layers have a dense
   MLP (`layers_dense`), the rest the routed experts (`layers_moe`); each
   group has its stacked params, its quantizer state ({"dense", "moe"}) and
   its latent cache.

Quantizer sites keep the reference's names: `self_attn.{q_a,q_b,q,kv_a,
kv_b,o}_proj`, per-expert `moe.{gate,up,down}_proj` (`[L, E, ...]` amax),
`shared.*`, `mlp.*` and the latent-cache sites `self_attn.ckv_bmm` /
`self_attn.kpe_bmm`, which ride the k / v bmm rules. In both forms the
latent goes through `ckv_bmm`, then kv_b's input quantizer, before it is
cached; calibration collects kv_b's input statistics on the latent.

One deliberate difference from the JAX package: `softmax_scale_factor`
multiplies MLA's softmax scale 1/sqrt(dn + dr). It defaults to 1 (JAX's
scale); the HF loader sets it to transformers' `yarn_get_mscale(factor,
mscale_all_dim)^2` where the checkpoint's `rope_scaling` has
`mscale_all_dim` (1.874 for DeepSeek-V3's factor 40), which JAX's loader
drops.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch

from .. import resolve_device
from ..quant import quantizer as Q
from ..quant.config import QuantizeConfig
from ..quant.quantizer import QuantizerConfig, QuantizerState
from ..trace.tracer import scanned, tied
from . import llama, mixtral


@dataclasses.dataclass(frozen=True)
class DeepseekConfig(llama.LlamaConfig):
    # MLA
    q_lora_rank: int = 0  # 0 -> one q_proj
    kv_lora_rank: int = 128
    qk_nope_head_dim: int = 32
    qk_rope_head_dim: int = 16
    v_head_dim: int = 32
    # MoE
    n_routed_experts: int = 8
    num_experts_per_tok: int = 2
    n_shared_experts: int = 1
    moe_intermediate_size: int = 64
    first_k_dense_replace: int = 1
    n_group: int = 2
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    capacity_factor: float = 2.0
    # the port's own: multiplies the softmax scale (transformers' yarn
    # mscale squared for a loaded V3; 1.0 computes JAX's scale)
    softmax_scale_factor: float = 1.0
    # the routed experts as `serve.engine._moe_ffn` reads them: no biases,
    # silu(gate) * up (class constants, not fields)
    moe_bias = False
    swiglu_limit = None

    def route_dispatch(self, x: torch.Tensor, lp: dict) -> mixtral.Dispatch:
        """The serving engine's routing of x [S, H]: `route` (the bias in the
        choice only), then the capacity assignment (`route` is looked up
        when called, so a caller may wrap it)."""
        topw, topi = route(self, router_logits(x, lp), lp["moe.e_bias"])
        return dispatch(self, topw, topi, x.shape[0])

    @staticmethod
    def tiny(**kw) -> "DeepseekConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                    num_attention_heads=4, num_key_value_heads=4, max_position_embeddings=128, dtype=torch.float32,
                    q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    n_routed_experts=4, num_experts_per_tok=2, n_shared_experts=1, moe_intermediate_size=32,
                    first_k_dense_replace=1, n_group=2, topk_group=1)
        base.update(kw)
        return DeepseekConfig(**base)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


MOE_NAMES = ("moe.gate_proj", "moe.up_proj", "moe.down_proj")
SHARED_NAMES = ("shared.gate_proj", "shared.up_proj", "shared.down_proj")
DENSE_NAMES = ("mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")
CACHE_SITES = ("self_attn.ckv_bmm", "self_attn.kpe_bmm")


def attn_shapes(cfg: DeepseekConfig) -> dict[str, tuple[int, int]]:
    """The attention projections' [out, in] shapes (q_a / q_b or q_proj)."""
    h, nH = cfg.hidden_size, cfg.num_attention_heads
    dqk, dv, dr = cfg.qk_head_dim, cfg.v_head_dim, cfg.qk_rope_head_dim
    shapes = {"self_attn.kv_a_proj": (cfg.kv_lora_rank + dr, h),
              "self_attn.kv_b_proj": (nH * (cfg.qk_nope_head_dim + dv), cfg.kv_lora_rank),
              "self_attn.o_proj": (h, nH * dv)}
    if cfg.q_lora_rank:
        shapes["self_attn.q_a_proj"] = (cfg.q_lora_rank, h)
        shapes["self_attn.q_b_proj"] = (nH * dqk, cfg.q_lora_rank)
    else:
        shapes["self_attn.q_proj"] = (nH * dqk, h)
    return shapes


def attn_names(cfg: DeepseekConfig) -> tuple[str, ...]:
    return tuple(attn_shapes(cfg))


def ffn_shapes(cfg: DeepseekConfig) -> dict[str, tuple[int, int]]:
    """[out, in] of the dense MLP, of one routed expert and of the shared
    experts (n_shared_experts x moe_intermediate_size wide)."""
    h, f, m = cfg.hidden_size, cfg.intermediate_size, cfg.moe_intermediate_size
    ms = cfg.n_shared_experts * m
    return {"mlp.gate_proj": (f, h), "mlp.up_proj": (f, h), "mlp.down_proj": (h, f),
            "moe.gate_proj": (m, h), "moe.up_proj": (m, h), "moe.down_proj": (h, m),
            "shared.gate_proj": (ms, h), "shared.up_proj": (ms, h), "shared.down_proj": (h, ms)}


def group_layers(cfg: DeepseekConfig) -> tuple[int, int]:
    """(dense layers, MoE layers)."""
    Ld = cfg.first_k_dense_replace
    if not 0 <= Ld < cfg.num_hidden_layers:
        raise ValueError(f"first_k_dense_replace {Ld} must lie in [0, {cfg.num_hidden_layers})")
    return Ld, cfg.num_hidden_layers - Ld


def init_params(cfg: DeepseekConfig, generator: torch.Generator, device=None) -> dict:
    """Seeded random weights, N(0, 1/fan_in) in `cfg.dtype`, norms 1 and
    `e_bias` 0 (f32), made on the device one layer (one expert) at a time:
    {"embed_tokens", "norm", "lm_head", "layers_dense" (if any),
    "layers_moe"}. `generator` must live on the same device."""
    dev = resolve_device(device)
    h = cfg.hidden_size
    Ld, Lm = group_layers(cfg)
    fshapes = ffn_shapes(cfg)

    def winit(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return w.div_(math.sqrt(fan_in)).to(cfg.dtype)

    def stacked(lead: tuple, shape):  # [*lead, out, in], one [out, in] f32 transient at a time
        out = torch.empty(lead + tuple(shape), dtype=cfg.dtype, device=dev)
        flat = out.view(-1, *shape)
        for j in range(flat.shape[0]):
            flat[j] = winit(shape, shape[1])
        return out

    def attn_block(L):
        blk = {"input_layernorm": torch.ones((L, h), dtype=cfg.dtype, device=dev),
               "post_attention_layernorm": torch.ones((L, h), dtype=cfg.dtype, device=dev)}
        for name, shape in attn_shapes(cfg).items():
            blk[name] = stacked((L,), shape)
        if cfg.q_lora_rank:
            blk["self_attn.q_a_norm"] = torch.ones((L, cfg.q_lora_rank), dtype=cfg.dtype, device=dev)
        blk["self_attn.kv_a_norm"] = torch.ones((L, cfg.kv_lora_rank), dtype=cfg.dtype, device=dev)
        return blk

    params: dict[str, Any] = {"embed_tokens": winit((cfg.vocab_size, h), h),
                              "norm": torch.ones((h,), dtype=cfg.dtype, device=dev),
                              "lm_head": winit((cfg.vocab_size, h), h)}
    if Ld:
        dense = attn_block(Ld)
        for name in DENSE_NAMES:
            dense[name] = stacked((Ld,), fshapes[name])
        params["layers_dense"] = dense
    moe = attn_block(Lm)
    moe["moe.router"] = stacked((Lm,), (cfg.n_routed_experts, h))
    moe["moe.e_bias"] = torch.zeros((Lm, cfg.n_routed_experts), dtype=torch.float32, device=dev)
    for name in MOE_NAMES:
        moe[name] = stacked((Lm, cfg.n_routed_experts), fshapes[name])
    for name in SHARED_NAMES:
        moe[name] = stacked((Lm,), fshapes[name])
    params["layers_moe"] = moe
    return params


def param_specs(cfg: DeepseekConfig) -> dict:
    """The JAX package's PartitionSpecs as tuples of mesh-axis names: MLA's
    head projections over "tensor" (kv_a and q_a replicated, o_proj by
    rows), experts over "expert", shared experts and the dense MLP as
    llama's: the layout `quant/sharded.py` shards the expert stacks by and
    `opt/state.save_sharded` writes the shards of."""
    col, row = (None, "tensor", None), (None, None, "tensor")

    def attn_specs():
        sp = {"input_layernorm": (None, None), "post_attention_layernorm": (None, None),
              "self_attn.kv_a_proj": (None, None, None), "self_attn.kv_b_proj": col, "self_attn.o_proj": row,
              "self_attn.kv_a_norm": (None, None)}
        if cfg.q_lora_rank:
            sp.update({"self_attn.q_a_proj": (None, None, None), "self_attn.q_a_norm": (None, None),
                       "self_attn.q_b_proj": col})
        else:
            sp["self_attn.q_proj"] = col
        return sp

    specs: dict[str, Any] = {"embed_tokens": (None, None), "norm": (None,), "lm_head": ("tensor", None)}
    if cfg.first_k_dense_replace:
        specs["layers_dense"] = {**attn_specs(), "mlp.gate_proj": col, "mlp.up_proj": col, "mlp.down_proj": row}
    specs["layers_moe"] = {**attn_specs(), "moe.router": (None, None, None), "moe.e_bias": (None, None),
                           "moe.gate_proj": (None, "expert", "tensor", None),
                           "moe.up_proj": (None, "expert", "tensor", None),
                           "moe.down_proj": (None, "expert", None, "tensor"),
                           "shared.gate_proj": col, "shared.up_proj": col, "shared.down_proj": row}
    return specs


def build_layout(cfg: DeepseekConfig, qcfg: QuantizeConfig) -> llama.QuantLayout:
    sites: dict[str, QuantizerConfig] = {}
    for name in attn_names(cfg) + DENSE_NAMES + MOE_NAMES + SHARED_NAMES:
        full = f"model.layers.0.{name}"
        sites[f"{name}.weight"] = qcfg.resolve(f"{full}.weight_quantizer")
        sites[f"{name}.input"] = qcfg.resolve(f"{full}.input_quantizer")
    sites["moe.router.weight"] = qcfg.resolve("model.layers.0.moe.router.weight_quantizer")
    # the latent-cache sites ride the k / v bmm rules, so KV presets apply
    sites["self_attn.ckv_bmm"] = qcfg.resolve("model.layers.0.self_attn.k_bmm_quantizer")
    sites["self_attn.kpe_bmm"] = qcfg.resolve("model.layers.0.self_attn.v_bmm_quantizer")
    sites["lm_head.weight"] = qcfg.resolve("lm_head.weight_quantizer")
    sites["embed_tokens.weight"] = qcfg.resolve("embed_tokens.weight_quantizer")
    return llama.QuantLayout(sites=tuple(sites.items()))


def _stacked_state(site_cfg: QuantizerConfig, shape, lead: tuple, device) -> QuantizerState:
    st = Q.init_state(site_cfg, shape, device)
    return llama._map_state(lambda a: a.expand(lead + tuple(a.shape)).clone(), st)


def _site_states(layout, names, shapes, L: int, device, E: Optional[int] = None) -> dict:
    out = {}
    for name in names:
        wcfg, icfg = layout.get(f"{name}.weight"), layout.get(f"{name}.input")
        sub = {}
        if wcfg.enable:
            sub["weight"] = _stacked_state(wcfg, shapes[name], (L, E) if E is not None else (L,), device)
        if icfg.enable:
            sub["input"] = _stacked_state(icfg, (1, 1, shapes[name][1]), (L,), device)
        if sub:
            out[name] = sub
    return out


def init_quant_state(cfg: DeepseekConfig, layout: llama.QuantLayout, device=None) -> dict:
    """Two stacked state trees, {"dense": [Ld, ...], "moe": [Lm, ...]} (no
    "dense" without dense layers); routed experts' weight states [Lm, E,
    ...]."""
    dev = resolve_device(device)
    Ld, Lm = group_layers(cfg)
    shapes = {**attn_shapes(cfg), **ffn_shapes(cfg)}
    attn = list(attn_shapes(cfg))

    def cache_sites(L):
        out = {}
        for site, dim in zip(CACHE_SITES, (cfg.kv_lora_rank, cfg.qk_rope_head_dim)):
            ccfg = layout.get(site)
            if ccfg.enable:
                out[site] = _stacked_state(ccfg, (1, 1, dim), (L,), dev)
        return out

    state: dict[str, Any] = {}
    if Ld:
        state["dense"] = {**_site_states(layout, attn + list(DENSE_NAMES), shapes, Ld, dev), **cache_sites(Ld)}
    moe = _site_states(layout, attn + list(SHARED_NAMES), shapes, Lm, dev)
    moe.update(_site_states(layout, MOE_NAMES, shapes, Lm, dev, E=cfg.n_routed_experts))
    moe.update(cache_sites(Lm))
    state["moe"] = moe
    return state


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def softmax_scale(cfg: DeepseekConfig) -> float:
    """MLA's softmax scale: 1 / sqrt(qk_nope + qk_rope), JAX's, times the
    port's `softmax_scale_factor`."""
    return cfg.softmax_scale_factor / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)


def _mla_attention(cfg: DeepseekConfig, x, lp, lstate, layout, positions, mask, cache, calib):
    """MLA over x [B, T, H] -> (out, emitted state, new cache (ckv, kpe) or
    None). `cache` (ckv [B, S, r], kpe [B, S, dr], pos) runs the absorbed
    form against the cache with the tokens written at pos; None the naive
    expanded form over the tokens."""
    B, T, _ = x.shape
    nH = cfg.num_attention_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    scale = softmax_scale(cfg)
    new_state: dict[str, Any] = {}

    def lin(name, inp):
        y, s = llama._linear(inp, lp[name], name, layout, lstate, calib)
        if s:
            new_state[name] = s
        return y

    if cfg.q_lora_rank:
        cq = llama.rms_norm(lin("self_attn.q_a_proj", x), lp["self_attn.q_a_norm"], cfg.rms_norm_eps)
        q = lin("self_attn.q_b_proj", cq)
    else:
        q = lin("self_attn.q_proj", x)
    q = q.reshape(B, T, nH, dn + dr)
    q_nope = q[..., :dn]
    q_pe = llama.rope(q[..., dn:], positions, cfg.rope_theta, cfg.rope_scaling)

    ckv_full = lin("self_attn.kv_a_proj", x)  # [B, T, r + dr]
    c_kv = llama.rms_norm(ckv_full[..., :r], lp["self_attn.kv_a_norm"], cfg.rms_norm_eps)
    k_pe = llama.rope(ckv_full[..., None, r:], positions, cfg.rope_theta, cfg.rope_scaling)[:, :, 0]

    lst = lstate or {}
    c_kv, cst = llama._qsite(c_kv, layout.get("self_attn.ckv_bmm"), lst.get("self_attn.ckv_bmm"), calib)
    if cst is not None:
        new_state["self_attn.ckv_bmm"] = cst
    k_pe, pst = llama._qsite(k_pe, layout.get("self_attn.kpe_bmm"), lst.get("self_attn.kpe_bmm"), calib)
    if pst is not None:
        new_state["self_attn.kpe_bmm"] = pst

    # kv_b's input quantizer: statistics collected on the latent (its
    # matmul input in both forms), applied to it before it is cached
    wkv_b = lp["self_attn.kv_b_proj"]
    kvb_cfg, kvb_icfg = layout.get("self_attn.kv_b_proj.weight"), layout.get("self_attn.kv_b_proj.input")
    sub = dict(lst.get("self_attn.kv_b_proj", {}))
    if calib:
        if kvb_cfg.enable:
            sub["weight"] = Q.collect(wkv_b, kvb_cfg, sub.get("weight") or QuantizerState())
        if kvb_icfg.enable:
            sub["input"] = Q.collect(c_kv, kvb_icfg, sub.get("input") or QuantizerState())
    else:
        if kvb_cfg.enable:
            wkv_b = Q.quantize(wkv_b, kvb_cfg, sub.get("weight"))
        if kvb_icfg.enable:
            c_kv = Q.quantize(c_kv, kvb_icfg, sub.get("input"))
    if sub:
        new_state["self_attn.kv_b_proj"] = sub

    new_cache = None
    if cache is not None:
        cckv, ckpe, pos = cache
        cckv, ckpe = llama._write_at(cckv, c_kv, pos), llama._write_at(ckpe, k_pe, pos)
        new_cache = (cckv, ckpe)
        wkb = wkv_b.reshape(nH, dn + dv, r)
        wk, wv = wkb[:, :dn].float(), wkb[:, dn:].float()  # [nH, dn, r], [nH, dv, r]
        q_lat = torch.einsum("btnd,ndr->btnr", q_nope.float(), wk)
        ckv32 = cckv.float()
        scores = (torch.einsum("btnr,bsr->bnts", q_lat, ckv32)
                  + torch.einsum("btnd,bsd->bnts", q_pe.float(), ckpe.float())) * scale
        probs = torch.softmax(scores + mask, dim=-1)
        ctx_lat = torch.einsum("bnts,bsr->btnr", probs, ckv32)
        ctx = torch.einsum("btnr,ndr->btnd", ctx_lat, wv).to(x.dtype).reshape(B, T, nH * dv)
    else:
        kv = (c_kv @ wkv_b.t().to(c_kv.dtype)).reshape(B, T, nH, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, T, nH, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        scores = torch.einsum("btnd,bsnd->bnts", q_full.float(), k_full.float()) * scale
        probs = torch.softmax(scores + mask, dim=-1).to(x.dtype)
        ctx = torch.einsum("bnts,bsnd->btnd", probs, v).reshape(B, T, nH * dv)
    return lin("self_attn.o_proj", ctx), new_state, new_cache


def choose(cfg: DeepseekConfig, choice: torch.Tensor) -> torch.Tensor:
    """The experts chosen on choice scores [S, E] (sigmoid(logits) + e_bias)
    -> topi [S, k]: the top k within the top `topk_group` groups, a group
    scored by the sum of its top two."""
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    if cfg.n_group > 1:
        S, per = choice.shape[0], E // cfg.n_group
        top2 = torch.topk(choice.reshape(S, cfg.n_group, per), min(2, per), dim=-1).values.sum(dim=-1)  # [S, G]
        gidx = torch.topk(top2, cfg.topk_group, dim=-1).indices
        keep = torch.zeros_like(top2, dtype=torch.bool).scatter_(1, gidx, True)
        choice = choice.masked_fill(~keep.repeat_interleave(per, dim=-1), float("-inf"))
    return torch.topk(choice, k, dim=-1).indices


def _weights(cfg: DeepseekConfig, scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    topw = scores.gather(-1, idx)
    if cfg.norm_topk_prob and cfg.num_experts_per_tok > 1:
        topw = topw / (torch.sum(topw, dim=-1, keepdim=True) + 1e-20)
    return topw * cfg.routed_scaling_factor


def route_weights(cfg: DeepseekConfig, logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The weights of the chosen experts idx [S, k] on logits [S, E] f32:
    their sigmoid scores (never the bias), normalised (+1e-20) where
    `norm_topk_prob` and k > 1, times `routed_scaling_factor`."""
    return _weights(cfg, torch.sigmoid(logits), idx)


def route(cfg: DeepseekConfig, logits: torch.Tensor, e_bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3 routing (shared by the forward and the engine): logits
    [S, E] f32, e_bias [E] -> (topw [S, k] f32, topi [S, k]); the bias moves
    the choice only."""
    scores = torch.sigmoid(logits)
    choice = scores + e_bias.float()[None, :]
    topi = choose(cfg, choice)
    return _weights(cfg, scores, topi), topi


def capacity(cfg: DeepseekConfig, S: int) -> int:
    """Rows an expert takes for S tokens: max(int(capacity_factor S k / E), 1)."""
    return max(int(cfg.capacity_factor * S * cfg.num_experts_per_tok / cfg.n_routed_experts), 1)


@functools.cache
def _dispatch_cfg(E: int, k: int) -> mixtral.MixtralConfig:
    """What `mixtral`'s dispatch reads (experts, k; weights on the outputs)."""
    return mixtral.MixtralConfig(num_experts=E, top_k=k)


def dispatch(cfg: DeepseekConfig, topw: torch.Tensor, topi: torch.Tensor, S: int) -> mixtral.Dispatch:
    """JAX's capacity assignment of the S tokens' k choices, by index."""
    return mixtral.dispatch_combine(_dispatch_cfg(cfg.n_routed_experts, cfg.num_experts_per_tok), topw, topi, S,
                                    capacity(cfg, S))


def router_logits(x: torch.Tensor, lp: dict) -> torch.Tensor:
    """x [S, H] -> f32 router logits [S, E]."""
    return x.float() @ lp["moe.router"].float().t()


class _SharedLayoutView:
    """Maps `mlp.*` lookups (llama._mlp's naming) onto the `shared.*` sites."""

    def __init__(self, layout):
        self._layout = layout

    def get(self, key: str) -> QuantizerConfig:
        return self._layout.get(key.replace("mlp.", "shared.", 1))


def _moe_mlp(cfg: DeepseekConfig, x, lp, lstate, layout, calib, ep=None, tp=None):
    """Routed experts + shared experts; x [B, T, H] -> (y, emitted state).
    Under expert parallelism (`ep`, `tp`) the routed experts are this
    rank's share, as in `mixtral._moe_mlp`; the shared experts replicate."""
    B, T, H = x.shape
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    S = B * T
    xf = x.reshape(S, H)
    lst = lstate or {}
    new_state: dict[str, Any] = {}

    topw, topi = route(cfg, router_logits(xf, lp), lp["moe.e_bias"])
    d = dispatch(cfg, topw, topi, S)
    El = lp["moe.gate_proj"].shape[0]  # E, or this rank's share under expert parallelism
    e0 = ep.index * El if ep is not None else 0
    xe = mixtral.dispatch_tokens(d, xf, E)[e0:e0 + El]
    icfg = layout.get("moe.gate_proj.input")
    ist = lst.get("moe.gate_proj", {}).get("input")

    def w_of(name, e):
        wcfg = layout.get(f"{name}.weight")
        if not wcfg.enable or calib:
            return lp[name][e]
        return Q.quantize(lp[name][e], wcfg, llama.slice_state(lst.get(name, {}).get("weight", QuantizerState()), e))

    ye = []
    tied(mixtral.expert_stacks(lp))  # JAX's dispatch einsums batch over this axis
    for e in range(El):
        h_in = Q.quantize(xe[e], icfg, ist) if icfg.enable and not calib and ist is not None else xe[e]
        g = h_in @ w_of("moe.gate_proj", e).t().to(h_in.dtype)
        u = h_in @ w_of("moe.up_proj", e).t().to(h_in.dtype)
        y = (torch.nn.functional.silu(g.float()) * u.float()).to(xe.dtype)
        ye.append(y @ w_of("moe.down_proj", e).t().to(y.dtype))
    y = mixtral.combine_local(d, torch.stack(ye), e0, S, k, x.dtype, ep, tp)

    parts = ("gate_proj", "up_proj", "down_proj")
    shared, st_sh, _ = llama._mlp(x, {f"mlp.{p}": lp[f"shared.{p}"] for p in parts},
                                  {f"mlp.{p}": lst.get(f"shared.{p}", {}) for p in parts} if lstate else None,
                                  _SharedLayoutView(layout), calib)
    for p in parts:
        if st_sh.get(f"mlp.{p}"):
            new_state[f"shared.{p}"] = st_sh[f"mlp.{p}"]

    if calib:
        for name in MOE_NAMES:
            wcfg = layout.get(f"{name}.weight")
            if wcfg.enable:
                st = lst.get(name, {}).get("weight", QuantizerState())
                new_state.setdefault(name, {})["weight"] = llama.stack_states(
                    [Q.collect(lp[name][e], wcfg, llama.slice_state(st, e)) for e in range(El)])
        if icfg.enable:
            new_state.setdefault("moe.gate_proj", {})["input"] = Q.collect(
                x, icfg, ist if ist is not None else QuantizerState())
    return (y + shared.reshape(S, H)).reshape(B, T, H), new_state


def init_cache(cfg: DeepseekConfig, batch: int, max_len: int, dtype=None, device=None) -> dict:
    """The latent cache: {"ckv_moe" [Lm, B, S, r], "kpe_moe" [Lm, B, S, dr],
    ("ckv_dense", "kpe_dense" [Ld, ...] with dense layers), "pos" a 0-d
    int32 tensor}."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    Ld, Lm = group_layers(cfg)

    def zeros(L, width):
        return torch.zeros((L, batch, max_len, width), dtype=dtype, device=dev)

    out = {"ckv_moe": zeros(Lm, cfg.kv_lora_rank), "kpe_moe": zeros(Lm, cfg.qk_rope_head_dim),
           "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    if Ld:
        out["ckv_dense"], out["kpe_dense"] = zeros(Ld, cfg.kv_lora_rank), zeros(Ld, cfg.qk_rope_head_dim)
    return out


GROUPS = (("dense", "layers_dense"), ("moe", "layers_moe"))  # (state / cache key, params key), in layer order


def forward(cfg: DeepseekConfig, params: dict, tokens: torch.Tensor, *,
            layout: Optional[llama.QuantLayout] = None, qstate: Optional[dict] = None, calib: bool = False,
            cache: Optional[dict] = None, positions: Optional[torch.Tensor] = None, ep=None, tp=None):
    """-> (logits f32 [B, T, V], new qstate, new cache). qstate follows
    `init_quant_state`'s {"dense", "moe"} split; the state returned is the
    emitted one (calibrating, or given one), else None. `cache`
    (`init_cache`'s dict) runs the absorbed form with the tokens written at
    pos; the new cache is returned (the given one is not written). `ep` /
    `tp`: the expert-parallel axes of a rank holding its share of the
    routed experts (`_moe_mlp`; `quant/sharded.py`)."""
    layout = layout or llama.QuantLayout(sites=())
    B, T = tokens.shape
    if positions is None:
        positions = llama._positions(B, T, cache, tokens.device)
    x = params["embed_tokens"][tokens].to(cfg.dtype)
    mask = llama.cache_mask(cache["ckv_moe"].shape[2], positions) if cache is not None \
        else llama.causal_mask(T, tokens.device)
    new_cache = dict(cache) if cache is not None else None
    new_qstate: dict[str, Any] = {}
    for key, pkey in GROUPS:
        if pkey not in params:
            continue
        group, gstate = scanned(params[pkey]), (qstate or {}).get(key)  # JAX: a lax.scan a group
        emitted, ckvs, kpes = [], [], []
        for i in range(group["input_layernorm"].shape[0]):
            lp = {n: v[i] for n, v in group.items()}
            lstate = llama.slice_state(gstate, i)
            c = None if cache is None else (cache[f"ckv_{key}"][i], cache[f"kpe_{key}"][i], cache["pos"])
            h = llama.rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
            attn, st_a, nc = _mla_attention(cfg, h, lp, lstate, layout, positions, mask, c, calib)
            x = x + attn
            h = llama.rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
            if key == "moe":
                y, st_m = _moe_mlp(cfg, h, lp, lstate, layout, calib, ep, tp)
            else:
                y, st_m, _ = llama._mlp(h, lp, lstate, layout, calib)
            x = x + y
            emitted.append({**st_a, **st_m})
            if nc is not None:
                ckvs.append(nc[0])
                kpes.append(nc[1])
        if emitted and emitted[0]:
            new_qstate[key] = llama.stack_states(emitted)
        if cache is not None:
            new_cache[f"ckv_{key}"], new_cache[f"kpe_{key}"] = torch.stack(ckvs), torch.stack(kpes)
    if cache is not None:
        new_cache["pos"] = cache["pos"] + T
    x = llama.rms_norm(x, params["norm"], cfg.rms_norm_eps)
    head_w = params.get("lm_head", params["embed_tokens"])
    logits = (x @ head_w.t().to(x.dtype)).float()
    return logits, (new_qstate if (calib or qstate) else None), new_cache


# --------------------------------------------------------------------------
# PTQ entry (the reference's `examples/deepseek/ptq.py` flow)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DeepseekQuantizedModel:
    """PTQ handle of the DeepSeek model."""

    model_cfg: DeepseekConfig
    params: dict
    layout: llama.QuantLayout
    qstate: dict
    quant_cfg: QuantizeConfig

    def forward(self, tokens, **kw):
        return forward(self.model_cfg, self.params, tokens, layout=self.layout, qstate=self.qstate, **kw)


@torch.no_grad()
def quantize(cfg: DeepseekConfig, params: dict, quant_cfg, calib_batches, device=None) -> DeepseekQuantizedModel:
    """Max-calibration PTQ over the MLA + MoE model: each batch's forward
    collects every site's statistics into the state (the only method JAX's
    DeepSeek path has). `device` (cuda unless the caller says otherwise)
    must hold `params`."""
    from ..quant.config import get_preset

    dev = resolve_device(device)
    if isinstance(quant_cfg, str):
        quant_cfg = get_preset(quant_cfg)
    layout = build_layout(cfg, quant_cfg)
    qstate = init_quant_state(cfg, layout, dev)
    for batch in calib_batches:
        qstate = forward(cfg, params, batch.to(dev), layout=layout, qstate=qstate, calib=True)[1]
    return DeepseekQuantizedModel(cfg, params, layout, qstate, quant_cfg)
