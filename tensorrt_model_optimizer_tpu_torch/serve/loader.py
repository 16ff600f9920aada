"""Deploy path: load an exported unified checkpoint into the serving engine
(port of `serve/loader.py`, the dense branch).

`export.hf_export.export_hf_checkpoint(...)` -> directory ->
`load_quantized_checkpoint` -> `CompressedModel` -> `Engine`, exactly as
`quant.compress.compress`'s output goes in (`int4_layout="a8"` serves
loaded INT4 weights as W4A8). The exported packings become the canonical
plane packing `compress` produces: NVFP4's adjacent nibbles and INT4-AWQ's
output pairs are unpacked and re-planed (`_adjacent_to_plane`,
`_outpair_to_plane`); each format's scales are rebuilt, and the static
input amax from `input_scale`.

The layout comes from the recorded algorithm, as the reference's: NVFP4 and
NVFP4_SVDQUANT -> NVFP4_DEFAULT_CFG, W4A16_AWQ -> INT4_AWQ_CFG, W4A8_AWQ ->
W4A8_AWQ_BETA_CFG, FP8 -> FP8_DEFAULT_CFG, W8A8_SQ_PER_CHANNEL ->
INT8_SMOOTHQUANT_CFG, INT8 -> INT8_DEFAULT_CFG, MXFP4 -> MXFP4_DEFAULT_CFG,
MXFP8 -> MXFP8_DEFAULT_CFG (MXFP4's and MXFP8's weights are their fp16
grid values, served as bf16; NF4 exports as W4A16_AWQ at 64-blocks, MXFP6
as NONE, as JAX's exports do).
W4A8_AWQ's weights load as INT4 (its `weight_scale_2` is the deploy
kernel's fp8 range, which this engine's W4A8 does not use); SVDQuant's
`svdquant_lora_{a,b}` become the model's adapters (scale 1: the export
folded it into B), and every `pre_quant_scale` the input site's. One deliberate
difference: an input quantizer that needs a calibrated amax stays off
where the checkpoint has no `input_scale` for it (a weight-only export),
where the reference enables it with no amax; for NVFP4 that serves a
weight-only checkpoint as W4A4 with a per-call activation amax, a function
the exported model never computed.

MoE checkpoints (qwen3_moe, mixtral) load their router, Qwen3's q/k norms
and every expert's weights into `[L, E, ...]` stacks, and the block's
shared `input_scale` (expert 0's gate_proj) into the gate_proj input
state, as the reference's loader does. One difference: INT4 (W4A16_AWQ,
W4A8_AWQ) experts load here, where the reference's MoE branch raises ("not
wired"); the conversion is the dense layers'. Qwen2's attention biases and
Qwen3's q/k norms load wherever the checkpoint has them (the reference's
dense branch leaves them out).
"""

from __future__ import annotations

import json
import os

import torch

from .. import resolve_device
from ..export import hf_export
from ..models import hf_loader, llama, mixtral
from ..quant import config as qconfig
from ..quant import quantizer as Q
from ..quant.compress import CompressedModel

# quant_algo -> the preset whose quantizer layout the loaded model takes
_LAYOUT_PRESET = {
    "NVFP4": "NVFP4_DEFAULT_CFG",
    "W4A16_AWQ": "INT4_AWQ_CFG",
    "W4A8_AWQ": "W4A8_AWQ_BETA_CFG",
    "FP8": "FP8_DEFAULT_CFG",
    "W8A8_SQ_PER_CHANNEL": "INT8_SMOOTHQUANT_CFG",
    "INT8": "INT8_DEFAULT_CFG",
    "MXFP4": "MXFP4_DEFAULT_CFG",
    "MXFP8": "MXFP8_DEFAULT_CFG",
}
_UNPORTED: dict[str, str] = {}  # quant_algo -> the slice that brings it: none


def _nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return packed & 0xF, (packed >> 4) & 0xF


def _adjacent_to_plane(packed_adj: torch.Tensor) -> torch.Tensor:
    """[O, K/2] adjacent-packed nibbles (the NVFP4 export layout) -> [O/2, K]
    plane-packed bytes, byte[o, k] = code[o + O/2, k] << 4 | code[o, k]."""
    O = packed_adj.shape[0]
    codes = torch.stack(_nibbles(packed_adj), dim=-1).reshape(O, -1)
    return ((codes[O // 2:] << 4) | codes[:O // 2]).to(torch.uint8)


def _outpair_to_plane(packed_op: torch.Tensor) -> torch.Tensor:
    """[O/2, K] output-pair-packed nibbles (INT4-AWQ: low nibble the even
    row, high the odd) -> [O/2, K] plane-packed bytes."""
    O2, K = packed_op.shape
    codes = torch.stack(_nibbles(packed_op), dim=1).reshape(2 * O2, K)
    return ((codes[O2:] << 4) | codes[:O2]).to(torch.uint8)


def load_quantized_checkpoint(path: str, device=None) -> CompressedModel:
    """A `CompressedModel` on `device` (cuda unless the caller passes
    device="cpu") from an exported checkpoint directory."""
    with open(os.path.join(path, "hf_quant_config.json")) as f:
        qc = json.load(f)["quantization"]
    with open(os.path.join(path, "config.json")) as f:
        cfg_d = json.load(f)
    return compressed_from_export(cfg_d, qc, hf_export.load_exported(path), device)


def _site(algo: str, get) -> tuple[str, dict]:
    """(kind, canonical arrays) of one projection's tensors of the export,
    `get(suffix, fn)` stacking `fn` of each tensor over the leading (layer,
    expert) dims."""
    if algo == "NVFP4":
        packed = get("weight", _adjacent_to_plane)
        ws = get("weight_scale", lambda t: t)
        O2 = packed.shape[-2]
        return "nvfp4", {"packed": packed, "scale_lo": ws[..., :O2, :].contiguous(),
                         "scale_hi": ws[..., O2:, :].contiguous(),
                         "global_scale": get("weight_scale_2", lambda t: t.reshape(()).float())}
    if algo in ("W4A16_AWQ", "W4A8_AWQ"):
        packed = get("weight", _outpair_to_plane)
        ws = get("weight_scale", lambda t: t.float())
        O2 = packed.shape[-2]
        return "int4", {"packed": packed, "scale_lo": ws[..., :O2, :].contiguous(),
                        "scale_hi": ws[..., O2:, :].contiguous()}
    if algo in ("FP8", "INT8", "W8A8_SQ_PER_CHANNEL"):
        per_tensor = algo == "FP8"
        return ("fp8" if per_tensor else "int8"), {
            "q": get("weight", lambda t: t),
            "scale": get("weight_scale", lambda t: t.float().reshape(-1, 1)[:1] if per_tensor
                         else t.float().reshape(-1, 1))}
    return "bf16", {"w": get("weight", lambda t: t)}  # NONE, and MXFP4's and MXFP8's fp16 grid values


@torch.no_grad()
def compressed_from_export(cfg_d: dict, qc: dict, tensors, device=None) -> CompressedModel:
    """The loader's conversion over any name -> tensor mapping of an export
    (a checkpoint directory's, or `hf_export._iter_export_tensors` held in
    memory), with config.json's fields `cfg_d` and hf_quant_config's
    "quantization" `qc`."""
    dev = resolve_device(device)
    mt = cfg_d.get("model_type")
    if mt in ("gpt_oss", "llama4", "llama4_text"):
        # GPT-OSS exports its native MXFP4 format, which the HF loader reads;
        # Llama4's shared expert has no name in the unified checkpoint
        raise NotImplementedError(f"model_type {mt!r}: the unified checkpoint loader serves dense Llama and the "
                                  "Mixtral family; a GPT-OSS checkpoint loads through "
                                  "models.hf_loader.load_hf_moe_checkpoint, as in JAX")
    cfg = hf_loader.config_from_hf(cfg_d)
    is_moe = mt in ("qwen3_moe", "mixtral")
    if is_moe:
        cfg = mixtral.MixtralConfig(**{**cfg.__dict__,
                                       "intermediate_size": cfg_d.get("moe_intermediate_size",
                                                                      cfg_d["intermediate_size"]),
                                       "num_experts": cfg_d.get("num_experts", cfg_d.get("num_local_experts")),
                                       "top_k": cfg_d.get("num_experts_per_tok", 2),
                                       "norm_topk_prob": cfg_d.get("norm_topk_prob", True)})
    algo = qc["quant_algo"].removesuffix("_SVDQUANT")  # SVDQuant: the base format plus the low-rank tensors
    if algo in _UNPORTED:
        raise NotImplementedError(f"loading a {algo} checkpoint comes with {_UNPORTED[algo]}")
    L = cfg.num_hidden_layers

    def stack(fmt: str, fn=lambda t: t) -> torch.Tensor:
        return torch.stack([fn(tensors[fmt.format(i=i)].to(dev)) for i in range(L)])

    layers: dict = {
        "input_layernorm": stack("model.layers.{i}.input_layernorm.weight").to(cfg.dtype),
        "post_attention_layernorm": stack("model.layers.{i}.post_attention_layernorm.weight").to(cfg.dtype),
    }
    for ours, fmt in hf_loader.HF_NAMES.items():  # Qwen3's q/k norms, Qwen2's biases
        if not ours.startswith(("self_attn.q_norm", "self_attn.k_norm")) and not ours.endswith("__bias"):
            continue
        if fmt.format(i=0) in tensors:
            layers[ours] = stack(fmt).to(cfg.dtype)
    kinds: dict[str, str] = {}
    qstate: dict = {}
    adapters: dict = {}
    for name, hf_fmt in hf_export.PROJ_TO_HF.items():
        if is_moe and name.startswith("mlp."):
            continue  # an MoE checkpoint carries experts instead
        key = hf_fmt + ".{suffix}"
        kinds[name], layers[name] = _site(algo, lambda suffix, fn: stack(key.format(i="{i}", suffix=suffix), fn))
        if kinds[name] == "bf16":
            layers[name]["w"] = layers[name]["w"].to(cfg.dtype)
        if hf_fmt.format(i=0) + ".svdquant_lora_a" in tensors:
            adapters[name] = {"A": stack(key.format(i="{i}", suffix="svdquant_lora_a")).to(cfg.dtype),
                              "B": stack(key.format(i="{i}", suffix="svdquant_lora_b")).to(cfg.dtype),
                              "scale": torch.ones((L,), dtype=torch.float32, device=dev)}
        pqs = hf_fmt.format(i=0) + ".pre_quant_scale"
        if pqs in tensors:
            qstate.setdefault(name, {})["input"] = Q.QuantizerState(
                pre_quant_scale=stack(key.format(i="{i}", suffix="pre_quant_scale")).float())
    in_scale_fmts = {name: hf_fmt + ".input_scale" for name, hf_fmt in hf_export.PROJ_TO_HF.items()}
    if is_moe:
        router_fmt, exp_fmt, projs = hf_loader.moe_names(mt)
        layers["moe.router"] = stack(router_fmt).to(cfg.dtype)
        E = cfg.num_experts
        for ours, theirs in projs.items():
            def get(suffix, fn, theirs=theirs):
                return torch.stack([torch.stack([fn(tensors[exp_fmt.format(i=i, e=e, proj=theirs) + "." + suffix]
                                                    .to(dev)) for e in range(E)]) for i in range(L)])

            kinds[ours], layers[ours] = _site(algo, get)
            if kinds[ours] == "bf16":
                layers[ours]["w"] = layers[ours]["w"].to(cfg.dtype)
        # the experts share the block's input scale; expert 0's gate_proj carries it
        in_scale_fmts["moe.gate_proj"] = exp_fmt.format(i="{i}", e=0, proj=projs["moe.gate_proj"]) + ".input_scale"

    params = {
        "embed_tokens": tensors["model.embed_tokens.weight"].to(dev).to(cfg.dtype),
        "layers": layers,
        "norm": tensors["model.norm.weight"].to(dev).to(cfg.dtype),
    }
    if "lm_head.weight" in tensors:
        params["lm_head"] = tensors["lm_head.weight"].to(dev).to(cfg.dtype)

    preset = _LAYOUT_PRESET.get(algo)
    build = mixtral.build_layout if is_moe else llama.build_layout
    layout = build(cfg, qconfig.get_preset(preset)) if preset else llama.QuantLayout(sites=())
    # static input amax from input_scale; an input quantizer the checkpoint
    # has no scale for was off when it was exported
    sites = dict(layout.sites)
    for name, fmt in in_scale_fmts.items():
        icfg = layout.get(f"{name}.input")
        if not icfg.enable or icfg.dynamic or (is_moe and name.startswith("mlp.")):
            continue
        if fmt.format(i=0) not in tensors:
            sites[f"{name}.input"] = Q.DISABLED
            continue
        div = 6.0 * 448.0 if algo == "NVFP4" else (448.0 if icfg.is_fp else 127.0)
        amax = stack(fmt, lambda t: t.reshape(()).float() * div)
        sub = qstate.setdefault(name, {})
        sub["input"] = sub.get("input", Q.QuantizerState()).replace(amax=amax)
    layout = llama.QuantLayout(sites=tuple(sites.items()))
    return CompressedModel(cfg, params, kinds, layout, qstate, adapters or None)

