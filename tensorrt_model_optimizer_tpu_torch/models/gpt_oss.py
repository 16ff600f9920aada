"""GPT-OSS MoE family (port of `models/gpt_oss.py`): the Mixtral
stacked-expert MoE with GPT-OSS's three twists:

 - attention sinks: a learned logit per head joins the softmax's max and
   denominator, and its mass is dropped (`llama.sink_softmax`, taken by
   `llama._attention` wherever the layer has a `self_attn.sinks` leaf);
 - alternating sliding / full attention: a sliding layer sees only the
   last `sliding_window` keys. Each layer takes its mask by its type;
 - clamped-swiglu experts with biases and top-k-then-softmax routing
   (`mixtral` config flags `swiglu_limit`, `moe_bias`,
   `router_softmax_after_topk`, `router_bias`).

RoPE is yarn-scaled (`llama.rope_freqs`). The HF loader de-interleaves the
fused `gate_up_proj` into the stacked gate / up planes
(`hf_loader.load_hf_moe_checkpoint`), and `export.hf_export` writes the
native MXFP4 format back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import resolve_device
from ..quant.config import QuantizeConfig
from ..trace.tracer import scanned
from . import llama, mixtral


@dataclasses.dataclass(frozen=True)
class GptOssConfig(mixtral.MixtralConfig):
    sliding_window: int = 128
    # "sliding_attention" / "full_attention" per layer; None: HF's default,
    # alternating with a sliding layer first
    layer_types: Optional[tuple] = None
    attention_bias: bool = True  # q/k/v biases; o_proj's comes with the family
    router_bias: bool = True
    moe_bias: bool = True
    router_softmax_after_topk: bool = True
    swiglu_limit: Optional[float] = 7.0
    norm_topk_prob: bool = False

    def resolved_layer_types(self) -> tuple:
        if self.layer_types is not None:
            return tuple(self.layer_types)
        return tuple("sliding_attention" if i % 2 == 0 else "full_attention" for i in range(self.num_hidden_layers))

    def layer_flags(self) -> tuple:
        """The sliding layers (where the config has a window)."""
        if not self.sliding_window:
            return super().layer_flags()
        return tuple(t == "sliding_attention" for t in self.resolved_layer_types())

    def span(self) -> Optional[tuple]:
        return ("window", self.sliding_window) if self.sliding_window else None

    @staticmethod
    def tiny(**kw) -> "GptOssConfig":
        base = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                    dtype=torch.float32, num_experts=4, top_k=2, sliding_window=8)
        base.update(kw)
        return GptOssConfig(**base)


def init_params(cfg: GptOssConfig, generator: torch.Generator, device=None) -> dict:
    """Mixtral's seeded weights plus the family's leaves, as JAX's: zero
    sinks, o_proj bias, router bias and expert biases."""
    dev = resolve_device(device)
    params = mixtral.init_params(cfg, generator, dev)
    L, E = cfg.num_hidden_layers, cfg.num_experts
    h, inter, nH = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    layers = params["layers"]

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    layers["self_attn.sinks"] = zeros(L, nH)
    if cfg.attention_bias:
        layers["self_attn.o_proj__bias"] = zeros(L, h)
    if cfg.router_bias:
        layers["moe.router__bias"] = zeros(L, E)
    if cfg.moe_bias:
        layers["moe.gate_proj__bias"] = zeros(L, E, inter)
        layers["moe.up_proj__bias"] = zeros(L, E, inter)
        layers["moe.down_proj__bias"] = zeros(L, E, h)
    return params


def param_specs(cfg: GptOssConfig) -> dict:
    specs = mixtral.param_specs(cfg)
    layers = specs["layers"]
    layers["self_attn.sinks"] = (None, None)
    if cfg.attention_bias:
        layers["self_attn.o_proj__bias"] = (None, None)
    if cfg.router_bias:
        layers["moe.router__bias"] = (None, None)
    if cfg.moe_bias:
        layers["moe.gate_proj__bias"] = layers["moe.up_proj__bias"] = (None, "expert", "tensor")
        layers["moe.down_proj__bias"] = (None, "expert", None)
    return specs


def build_layout(cfg: GptOssConfig, qcfg: QuantizeConfig) -> llama.QuantLayout:
    return mixtral.build_layout(cfg, qcfg)


def init_quant_state(cfg: GptOssConfig, layout: llama.QuantLayout, device=None) -> dict:
    return mixtral.init_quant_state(cfg, layout, device)


def forward(cfg: GptOssConfig, params: dict, tokens: torch.Tensor, *,
            layout: Optional[llama.QuantLayout] = None, qstate: Optional[dict] = None,
            calib: bool = False, capture_tokens: int = 0):
    """Prefill forward -> (logits f32 [B, T, V], state), or with
    `capture_tokens > 0` (logits, state, captures {"attn_in", "moe_in"}
    [L, n, H]): mixtral's layer under each layer's mask, sliding or full."""
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
    for i, sliding in enumerate(cfg.layer_flags()):
        lp = {k: v[i] for k, v in layers.items()}
        x, st, caps = mixtral._layer(cfg, layout, calib, x, lp, llama.slice_state(per_layer, i), positions,
                                     masks[sliding], capture_tokens)
        emitted.append(st)
        for key, t in caps.items():
            captures[key].append(t)
    logits = mixtral._head(cfg, params, x)
    st = (llama.stack_states(emitted) if emitted and emitted[0] else {}) if (calib or qstate) else None
    if capture_tokens:
        return logits, st, {k: torch.stack(v) for k, v in captures.items()}
    return logits, st
