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
INT8_SMOOTHQUANT_CFG, INT8 -> INT8_DEFAULT_CFG, MXFP4 -> MXFP4_DEFAULT_CFG.
W4A8_AWQ's weights load as INT4 (its `weight_scale_2` is the deploy
kernel's fp8 range, which this engine's W4A8 does not use); SVDQuant's
`svdquant_lora_{a,b}` become the model's adapters (scale 1: the export
folded it into B), and every `pre_quant_scale` the input site's. One deliberate
difference: an input quantizer that needs a calibrated amax stays off
where the checkpoint has no `input_scale` for it (a weight-only export),
where the reference enables it with no amax; for NVFP4 that serves a
weight-only checkpoint as W4A4 with a per-call activation amax, a function
the exported model never computed.

Not ported (raise `NotImplementedError` naming the slice): MoE checkpoints
and MXFP8.
"""

from __future__ import annotations

import json
import os

import torch

from .. import resolve_device
from ..export import hf_export
from ..models import hf_loader, llama
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
}
_UNPORTED = {"MXFP8": "the remaining-formats slice (MXFP8)"}


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


@torch.no_grad()
def compressed_from_export(cfg_d: dict, qc: dict, tensors, device=None) -> CompressedModel:
    """The loader's conversion over any name -> tensor mapping of an export
    (a checkpoint directory's, or `hf_export._iter_export_tensors` held in
    memory), with config.json's fields `cfg_d` and hf_quant_config's
    "quantization" `qc`."""
    dev = resolve_device(device)
    if cfg_d.get("model_type") in ("qwen3_moe", "mixtral"):
        raise NotImplementedError("MoE deploy loading comes with the MoE-families slice")
    cfg = hf_loader.config_from_hf(cfg_d)
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
    kinds: dict[str, str] = {}
    qstate: dict = {}
    adapters: dict = {}
    for name, hf_fmt in hf_export.PROJ_TO_HF.items():
        key = hf_fmt + ".{suffix}"
        if algo == "NVFP4":
            packed = stack(key.format(i="{i}", suffix="weight"), _adjacent_to_plane)
            ws = stack(key.format(i="{i}", suffix="weight_scale"))
            O2 = packed.shape[1]
            layers[name] = {"packed": packed, "scale_lo": ws[:, :O2].contiguous(), "scale_hi": ws[:, O2:].contiguous(),
                            "global_scale": stack(key.format(i="{i}", suffix="weight_scale_2"),
                                                  lambda t: t.reshape(()).float())}
            kinds[name] = "nvfp4"
        elif algo in ("W4A16_AWQ", "W4A8_AWQ"):
            packed = stack(key.format(i="{i}", suffix="weight"), _outpair_to_plane)
            ws = stack(key.format(i="{i}", suffix="weight_scale")).float()
            O2 = packed.shape[1]
            layers[name] = {"packed": packed, "scale_lo": ws[:, :O2].contiguous(), "scale_hi": ws[:, O2:].contiguous()}
            kinds[name] = "int4"
        elif algo in ("FP8", "INT8", "W8A8_SQ_PER_CHANNEL"):
            per_tensor = algo == "FP8"
            layers[name] = {"q": stack(key.format(i="{i}", suffix="weight")),
                            "scale": stack(key.format(i="{i}", suffix="weight_scale"),
                                           lambda t: t.float().reshape(-1, 1)[:1] if per_tensor
                                           else t.float().reshape(-1, 1))}
            kinds[name] = "fp8" if per_tensor else "int8"
        else:  # NONE, and MXFP4's fp16 grid values
            layers[name] = {"w": stack(key.format(i="{i}", suffix="weight")).to(cfg.dtype)}
            kinds[name] = "bf16"
        if hf_fmt.format(i=0) + ".svdquant_lora_a" in tensors:
            adapters[name] = {"A": stack(key.format(i="{i}", suffix="svdquant_lora_a")).to(cfg.dtype),
                              "B": stack(key.format(i="{i}", suffix="svdquant_lora_b")).to(cfg.dtype),
                              "scale": torch.ones((L,), dtype=torch.float32, device=dev)}
        pqs = hf_fmt.format(i=0) + ".pre_quant_scale"
        if pqs in tensors:
            qstate.setdefault(name, {})["input"] = Q.QuantizerState(
                pre_quant_scale=stack(key.format(i="{i}", suffix="pre_quant_scale")).float())

    params = {
        "embed_tokens": tensors["model.embed_tokens.weight"].to(dev).to(cfg.dtype),
        "layers": layers,
        "norm": tensors["model.norm.weight"].to(dev).to(cfg.dtype),
    }
    if "lm_head.weight" in tensors:
        params["lm_head"] = tensors["lm_head.weight"].to(dev).to(cfg.dtype)

    preset = _LAYOUT_PRESET.get(algo)
    layout = llama.build_layout(cfg, qconfig.get_preset(preset)) if preset else llama.QuantLayout(sites=())
    # static input amax from input_scale; an input quantizer the checkpoint
    # has no scale for was off when it was exported
    sites = dict(layout.sites)
    for name, hf_fmt in hf_export.PROJ_TO_HF.items():
        icfg = layout.get(f"{name}.input")
        if not icfg.enable or icfg.dynamic:
            continue
        if hf_fmt.format(i=0) + ".input_scale" not in tensors:
            sites[f"{name}.input"] = Q.DISABLED
            continue
        div = 6.0 * 448.0 if algo == "NVFP4" else (448.0 if icfg.is_fp else 127.0)
        amax = stack(hf_fmt + ".input_scale", lambda t: t.reshape(()).float() * div)
        sub = qstate.setdefault(name, {})
        sub["input"] = sub.get("input", Q.QuantizerState()).replace(amax=amax)
    layout = llama.QuantLayout(sites=tuple(sites.items()))
    return CompressedModel(cfg, params, kinds, layout, qstate, adapters or None)
