"""HF checkpoint loading and saving (port of `models/hf_loader.py`): the
Llama family (llama, mistral, Qwen2's attention biases, Qwen3's q/k norms)
and the MoE families (`load_hf_moe_checkpoint`: qwen3_moe, mixtral, dbrx,
gpt_oss with its MXFP4-shipped experts, llama4 / llama4_text, deepseek_v3
through `load_hf_deepseek_checkpoint`).

Reads `config.json` and every `*.safetensors` file of a directory into the
stacked-layer params dict (experts stacked `[L, E, out, in]`), and writes
one back (`save_hf_checkpoint`, MoE stacks under the qwen3_moe or mixtral
names). `deepseek_v2` raises: it routes by a softmax (and carries no
`e_score_correction_bias`), where the port's DeepSeek has V3's sigmoid
router; JAX's loader fails on the missing bias instead. The
safetensors format is parsed and written here (an 8-byte little-endian
header length, a JSON header padded with spaces to a multiple of 8, then
raw little-endian bytes) so the port needs no `safetensors` package; BF16
and the fp8 types arrive as integer views and become the torch dtype bit for
bit. `save_safetensors` lays a file out as `safetensors.torch.save_file`
0.8.0 does (tensors by dtype, widest first in its enum's order, then by
name; compact header JSON), so a file it writes is byte-equal to that
library's.
"""

from __future__ import annotations

import json
import math
import os
import struct
from glob import glob
from typing import Any, Optional

import numpy as np
import torch

from .. import resolve_device
from .llama import LlamaConfig, RopeScaling

_NP_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "U16": np.uint16, "BOOL": np.bool_, "F8_E4M3": np.uint8, "F8_E5M2": np.uint8,
}
_VIEWED = {"BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2}

# safetensors' Dtype enum, in its order: a file lists its tensors by dtype,
# the last of these first
_ST_ORDER = ("BOOL", "F4", "F6_E2M3", "F6_E3M2", "U8", "I8", "F8_E5M2", "F8_E4M3", "F8_E8M0", "I16", "U16",
             "F16", "BF16", "I32", "U32", "F32", "C64", "F64", "I64", "U64")
_ST_NAMES = {torch.bool: "BOOL", torch.uint8: "U8", torch.int8: "I8", torch.float8_e5m2: "F8_E5M2",
             torch.float8_e4m3fn: "F8_E4M3", torch.int16: "I16", torch.uint16: "U16", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int32: "I32", torch.float32: "F32", torch.float64: "F64", torch.int64: "I64"}


def save_safetensors(tensors: dict, path: str) -> None:
    """Write {name: tensor} (any device) as one safetensors file, laid out
    byte for byte as `safetensors.torch.save_file(tensors, path)` 0.8.0
    lays it out. Each tensor comes to the host once, as it is written."""
    rank = {name: i for i, name in enumerate(_ST_ORDER)}
    items = sorted(tensors.items(), key=lambda kv: (-rank[_ST_NAMES[kv[1].dtype]], kv[0]))
    header, off = {}, 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for _, t in items:
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().data)


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """transformers' `yarn_get_mscale`: 0.1 mscale ln(factor) + 1 (1 for a
    factor <= 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def _rope_scaling_from_hf(d: dict) -> Optional[RopeScaling]:
    rs = d.get("rope_scaling")
    if not rs:
        return None
    rope_type = rs.get("rope_type", rs.get("type", "llama3"))
    if rope_type == "yarn":
        factor = float(rs.get("factor", 1.0))
        attention_factor = rs.get("attention_factor")
        mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")
        if attention_factor is None and mscale and mscale_all:
            # DeepSeek's yarn: the temperature from the mscale pair
            attention_factor = yarn_mscale(factor, mscale) / yarn_mscale(factor, mscale_all)
        return RopeScaling(
            rope_type="yarn", factor=factor, attention_factor=attention_factor,
            beta_fast=float(rs.get("beta_fast") or 32.0), beta_slow=float(rs.get("beta_slow") or 1.0),
            truncate=bool(rs.get("truncate", True)),
            original_max_position_embeddings=int(rs.get("original_max_position_embeddings")
                                                 or d.get("max_position_embeddings", 4096)))
    if rope_type != "llama3":
        raise NotImplementedError(f"rope_scaling type {rope_type!r} unsupported")
    return RopeScaling(
        rope_type=rope_type,
        factor=float(rs.get("factor", 8.0)),
        low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
        high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
        original_max_position_embeddings=int(rs.get("original_max_position_embeddings", 8192)),
    )


# model types of JAX's loaders that the port refuses -> why
NOT_PORTED = {"deepseek_v2": "DeepSeek-V2 routes by a softmax over the experts (no e_score_correction_bias); "
                             "the port's DeepSeek serves V3's sigmoid router only"}


def config_from_hf(d: dict) -> LlamaConfig:
    mt = d.get("model_type")
    if mt in NOT_PORTED:
        raise NotImplementedError(f"model_type {mt!r}: {NOT_PORTED[mt]}")
    return LlamaConfig(
        rope_scaling=_rope_scaling_from_hf(d),
        attention_bias=d.get("attention_bias", mt == "qwen2"),
        qk_norm=mt in ("qwen3", "qwen3_moe"),
        vocab_size=d["vocab_size"],
        hidden_size=d["hidden_size"],
        intermediate_size=d["intermediate_size"],
        num_hidden_layers=d["num_hidden_layers"],
        num_attention_heads=d["num_attention_heads"],
        num_key_value_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
        head_dim=d.get("head_dim"),
        rope_theta=d.get("rope_theta", 10000.0),
        rms_norm_eps=d.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=d.get("tie_word_embeddings", False),
        max_position_embeddings=d.get("max_position_embeddings", 4096),
        dtype=torch.bfloat16,
    )


class SafetensorsDir:
    """Name -> tensor view over every `*.safetensors` file of a directory
    (or over one file, given its path). Files are memory-mapped; a tensor
    is read when it is asked for."""

    def __init__(self, path: str):
        files = [path] if os.path.isfile(path) else sorted(glob(os.path.join(path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no safetensors under {path}")
        self._entries: dict[str, tuple[np.memmap, dict]] = {}
        for f in files:
            with open(f, "rb") as fh:
                (n,) = struct.unpack("<Q", fh.read(8))
                header = json.loads(fh.read(n))
            data = np.memmap(f, dtype=np.uint8, mode="r", offset=8 + n)
            for name, meta in header.items():
                if name != "__metadata__":
                    self._entries[name] = (data, meta)

    def __contains__(self, name) -> bool:
        return name in self._entries

    def __getitem__(self, name: str) -> torch.Tensor:
        data, meta = self._entries[name]
        if meta["dtype"] not in _NP_DTYPES:
            raise NotImplementedError(f"safetensors dtype {meta['dtype']} of {name}")
        lo, hi = meta["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=np.dtype(_NP_DTYPES[meta["dtype"]]).newbyteorder("<"))
        t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="), copy=True).reshape(meta["shape"]))
        if meta["dtype"] in _VIEWED:
            t = t.view(_VIEWED[meta["dtype"]])
        return t

    def keys(self):
        return self._entries.keys()

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def config_to_hf(cfg: LlamaConfig) -> dict:
    """config.json's fields, in the JAX package's order (its
    `config_to_hf`), so the JSON files are byte-equal: llama, qwen3 (q/k
    norms), and for a MixtralConfig qwen3_moe (q/k norms) or mixtral."""
    out: dict[str, Any] = {}
    if cfg.rope_scaling is not None:
        rs = cfg.rope_scaling
        out["rope_scaling"] = {
            "rope_type": rs.rope_type,
            "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position_embeddings,
        }
    arch = ["Qwen3ForCausalLM"] if cfg.qk_norm else ["LlamaForCausalLM"]
    mt = "qwen3" if cfg.qk_norm else "llama"
    if getattr(cfg, "num_experts", None):
        mt = "qwen3_moe" if cfg.qk_norm else "mixtral"
        arch = ["Qwen3MoeForCausalLM"] if cfg.qk_norm else ["MixtralForCausalLM"]
        out |= {"num_experts" if cfg.qk_norm else "num_local_experts": cfg.num_experts,
                "num_experts_per_tok": cfg.top_k, "norm_topk_prob": cfg.norm_topk_prob}
        if cfg.qk_norm:  # qwen3_moe: the expert width is moe_intermediate_size
            out["moe_intermediate_size"] = cfg.intermediate_size
    return out | {
        "architectures": arch,
        "model_type": mt,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "head_dim": cfg.hd,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
        "torch_dtype": "bfloat16",
    }


HF_NAMES = {  # stacked-layer params -> per-layer HF tensor names, in the JAX writer's order
    "input_layernorm": "model.layers.{i}.input_layernorm.weight",
    "post_attention_layernorm": "model.layers.{i}.post_attention_layernorm.weight",
    "self_attn.q_proj": "model.layers.{i}.self_attn.q_proj.weight",
    "self_attn.k_proj": "model.layers.{i}.self_attn.k_proj.weight",
    "self_attn.v_proj": "model.layers.{i}.self_attn.v_proj.weight",
    "self_attn.o_proj": "model.layers.{i}.self_attn.o_proj.weight",
    "mlp.gate_proj": "model.layers.{i}.mlp.gate_proj.weight",
    "mlp.up_proj": "model.layers.{i}.mlp.up_proj.weight",
    "mlp.down_proj": "model.layers.{i}.mlp.down_proj.weight",
    "self_attn.q_proj__bias": "model.layers.{i}.self_attn.q_proj.bias",
    "self_attn.k_proj__bias": "model.layers.{i}.self_attn.k_proj.bias",
    "self_attn.v_proj__bias": "model.layers.{i}.self_attn.v_proj.bias",
    "self_attn.q_norm": "model.layers.{i}.self_attn.q_norm.weight",
    "self_attn.k_norm": "model.layers.{i}.self_attn.k_norm.weight",
}
MOE_LEAVES = ("moe.router", "moe.gate_proj", "moe.up_proj", "moe.down_proj")


def moe_names(model_type: str) -> tuple[str, str, dict]:
    """(router name, expert name, our projection -> theirs) of an HF MoE
    checkpoint: qwen3_moe's mlp.gate / mlp.experts.{e}.{gate,up,down}_proj,
    or mixtral's block_sparse_moe.gate / experts.{e}.{w1,w3,w2}. The
    formats take {i}, {e} and {proj}."""
    if model_type == "qwen3_moe":
        return ("model.layers.{i}.mlp.gate.weight", "model.layers.{i}.mlp.experts.{e}.{proj}",
                {"moe.gate_proj": "gate_proj", "moe.up_proj": "up_proj", "moe.down_proj": "down_proj"})
    if model_type == "mixtral":
        return ("model.layers.{i}.block_sparse_moe.gate.weight",
                "model.layers.{i}.block_sparse_moe.experts.{e}.{proj}",
                {"moe.gate_proj": "w1", "moe.up_proj": "w3", "moe.down_proj": "w2"})
    raise NotImplementedError(f"MoE model_type {model_type!r}")


def save_hf_checkpoint(cfg: LlamaConfig, params: dict, path: str) -> None:
    """Inverse of the loaders: config.json (indent 1) and one
    model.safetensors of f32 tensors under the HF names, as the JAX
    package's `save_hf_checkpoint` writes them (byte-equal files); MoE
    stacks unstack to per-expert modules under the qwen3_moe names for a
    q/k-norm config, the mixtral names otherwise."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=1)
    flat = {"model.embed_tokens.weight": params["embed_tokens"], "model.norm.weight": params["norm"]}
    if not cfg.tie_word_embeddings:
        flat["lm_head.weight"] = params.get("lm_head", params["embed_tokens"])
    layers = params["layers"]
    extra = sorted(set(layers) - set(HF_NAMES) - set(MOE_LEAVES))
    if extra:
        raise NotImplementedError(f"save_hf_checkpoint: layer leaves {extra} are not written by the JAX package")
    for ours, fmt in HF_NAMES.items():
        if ours in layers:
            for i in range(cfg.num_hidden_layers):
                flat[fmt.format(i=i)] = layers[ours][i]
    if "moe.gate_proj" in layers:
        router_fmt, exp_fmt, projs = moe_names("qwen3_moe" if cfg.qk_norm else "mixtral")
        for i in range(cfg.num_hidden_layers):
            flat[router_fmt.format(i=i)] = layers["moe.router"][i]
            for ours, theirs in projs.items():
                for e in range(layers[ours].shape[1]):
                    flat[exp_fmt.format(i=i, e=e, proj=theirs) + ".weight"] = layers[ours][i, e]
    save_safetensors({k: v.float() for k, v in flat.items()}, os.path.join(path, "model.safetensors"))


def _reader(path: str, dtype, dev):
    raw = SafetensorsDir(path)
    return raw, lambda name: raw[name].to(device=dev).to(dtype)


def _head(params: dict, cfg, raw, get) -> dict:
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight") if "lm_head.weight" in raw else params["embed_tokens"]
    return params


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, device=None) -> tuple[LlamaConfig, dict]:
    """Returns (config, params) from an HF Llama-family checkpoint
    directory (Qwen2's biases and Qwen3's q/k norms where the config has
    them), every tensor cast to `dtype` on `device`."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    cfg = LlamaConfig(**{**cfg.__dict__, "dtype": dtype})
    raw, get = _reader(path, dtype, dev)
    L = cfg.num_hidden_layers
    stack = lambda fmt: torch.stack([get(fmt.format(i=i)) for i in range(L)])
    layers: dict[str, Any] = {
        "input_layernorm": stack("model.layers.{i}.input_layernorm.weight"),
        "post_attention_layernorm": stack("model.layers.{i}.post_attention_layernorm.weight"),
    }
    for ours in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                 "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
        layers[ours] = stack("model.layers.{i}." + ours + ".weight")
    if cfg.attention_bias:
        for proj in ("q_proj", "k_proj", "v_proj"):
            layers[f"self_attn.{proj}__bias"] = stack("model.layers.{i}.self_attn." + proj + ".bias")
    if cfg.qk_norm:
        layers["self_attn.q_norm"] = stack("model.layers.{i}.self_attn.q_norm.weight")
        layers["self_attn.k_norm"] = stack("model.layers.{i}.self_attn.k_norm.weight")
    params = {"embed_tokens": get("model.embed_tokens.weight"), "layers": layers, "norm": get("model.norm.weight")}
    return cfg, _head(params, cfg, raw, get)


def _load_dbrx(path: str, d: dict, dtype, dev):
    """DBRX: the fused Wqkv (split into q, k, v), the qkv clamp, LayerNorm
    blocks and the fused expert GLU: w1 (gate) and v1 (up) arrive as [E *
    I, H] stacks, w2 too but applied untransposed, so our [out = H, in = I]
    down weight is each expert's transpose."""
    from .mixtral import MixtralConfig

    attn, ffn = d.get("attn_config", {}), d.get("ffn_config", {})
    h, nH = d["d_model"], d["n_heads"]
    n_kv = attn.get("kv_n_heads", nH)
    E, inter = ffn.get("moe_num_experts", 8), ffn.get("ffn_hidden_size")
    cfg = MixtralConfig(
        vocab_size=d["vocab_size"], hidden_size=h, intermediate_size=inter, num_hidden_layers=d["n_layers"],
        num_attention_heads=nH, num_key_value_heads=n_kv, rope_theta=attn.get("rope_theta", 500000.0),
        rms_norm_eps=1e-5, norm_type="layernorm", clip_qkv=attn.get("clip_qkv"),
        tie_word_embeddings=d.get("tie_word_embeddings", False), max_position_embeddings=d.get("max_seq_len", 4096),
        num_experts=E, top_k=ffn.get("moe_top_k", 4),
        # moe_normalize_expert_weights: the p-norm order, 1.0 a plain renormalisation
        norm_topk_prob=ffn.get("moe_normalize_expert_weights") is not None, dtype=dtype)
    raw, get = _reader(path, dtype, dev)
    L, hd = cfg.num_hidden_layers, cfg.hd
    stack = lambda fmt: torch.stack([get(fmt.format(i=i)) for i in range(L)])
    blk = "transformer.blocks.{i}."
    layers = {
        "input_layernorm": stack(blk + "norm_attn_norm.norm_1.weight"),
        "post_attention_layernorm": stack(blk + "norm_attn_norm.norm_2.weight"),
        "self_attn.o_proj": stack(blk + "norm_attn_norm.attn.out_proj.weight"),
        "moe.router": stack(blk + "ffn.router.layer.weight"),
    }
    qkv = stack(blk + "norm_attn_norm.attn.Wqkv.weight")  # [L, (nH + 2 kv) hd, H]
    layers["self_attn.q_proj"] = qkv[:, : nH * hd]
    layers["self_attn.k_proj"] = qkv[:, nH * hd: (nH + n_kv) * hd]
    layers["self_attn.v_proj"] = qkv[:, (nH + n_kv) * hd:]
    layers["moe.gate_proj"] = stack(blk + "ffn.experts.mlp.w1").reshape(L, E, inter, h)
    layers["moe.up_proj"] = stack(blk + "ffn.experts.mlp.v1").reshape(L, E, inter, h)
    layers["moe.down_proj"] = stack(blk + "ffn.experts.mlp.w2").reshape(L, E, inter, h).transpose(-1, -2)
    params = {"embed_tokens": get("transformer.wte.weight"), "layers": layers, "norm": get("transformer.norm_f.weight")}
    return cfg, _head(params, cfg, raw, get)


def mxfp4_dequant(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """GPT-OSS's shipped MXFP4 expert tensor -> f32 [..., K, rows]: `blocks`
    [..., rows, G, 16] uint8 (two E2M1 codes a byte, the low nibble first),
    `scales` [..., rows, G] biased-127 E8M0, 32-wide blocks along the
    contraction dim K = 32 G; the last two axes swapped at the end, as
    transformers' `convert_moe_packed_tensors` returns them."""
    from ..ops import numerics

    b = blocks.to(torch.int32)
    v = torch.stack([numerics.codes_to_fp4(b & 0xF), numerics.codes_to_fp4((b >> 4) & 0xF)], dim=-1)
    v = v.reshape(*blocks.shape[:-1], blocks.shape[-1] * 2)
    e = scales.to(torch.int32) - 127
    v = v * torch.ldexp(torch.ones(e.shape, device=v.device), e)[..., None]
    return v.reshape(*v.shape[:-2], -1).transpose(-1, -2)


def gpt_oss_from_tensors(d: dict, raw, dtype=torch.bfloat16, device=None):
    """GPT-OSS's (config, params) from config.json's fields `d` and any name
    -> tensor mapping `raw` (a checkpoint directory's, or `export.hf_export`'s
    GPT-OSS tensors held in memory): the fused `mlp.experts.gate_up_proj`
    [E, H, 2I] de-interleaved (gate the even columns, up the odd:
    `GptOssExperts.forward`) into the stacked [E, I, H] gate / up planes,
    `down_proj` [E, I, H] transposed; MXFP4-shipped experts (`{proj}_blocks`
    / `_scales`) dequantized (`mxfp4_dequant`); biases, sinks, the router's
    bias; the config's `layer_types`, `sliding_window` and yarn rope
    (`truncate` read)."""
    from .gpt_oss import GptOssConfig

    dev = resolve_device(device)

    cfg = GptOssConfig(**{**config_from_hf(d).__dict__, "dtype": dtype,
                          "num_experts": d.get("num_local_experts", d.get("num_experts")),
                          "top_k": d.get("num_experts_per_tok", 4), "sliding_window": d.get("sliding_window", 128),
                          "layer_types": tuple(d["layer_types"]) if d.get("layer_types") else None,
                          "attention_bias": d.get("attention_bias", True)})
    get = lambda name: raw[name].to(device=dev).to(dtype)
    L = cfg.num_hidden_layers
    stack = lambda fmt: torch.stack([get(fmt.format(i=i)) for i in range(L)])

    def expert_weight(i: int, proj: str) -> torch.Tensor:
        base = f"model.layers.{i}.mlp.experts.{proj}"
        if f"{base}_blocks" not in raw:
            return get(base)
        return mxfp4_dequant(raw[f"{base}_blocks"].to(dev), raw[f"{base}_scales"].to(dev)).to(dtype)

    pre = "model.layers.{i}."
    layers: dict[str, Any] = {
        "input_layernorm": stack(pre + "input_layernorm.weight"),
        "post_attention_layernorm": stack(pre + "post_attention_layernorm.weight"),
        "self_attn.sinks": stack(pre + "self_attn.sinks"),
        "moe.router": stack(pre + "mlp.router.weight"),
        "moe.router__bias": stack(pre + "mlp.router.bias"),
    }
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        layers[f"self_attn.{proj}"] = stack(pre + f"self_attn.{proj}.weight")
        layers[f"self_attn.{proj}__bias"] = stack(pre + f"self_attn.{proj}.bias")
    gate_up = torch.stack([expert_weight(i, "gate_up_proj") for i in range(L)])  # [L, E, H, 2I]
    gu_bias = stack(pre + "mlp.experts.gate_up_proj_bias")  # [L, E, 2I]
    layers["moe.gate_proj"] = gate_up[..., 0::2].transpose(-1, -2).contiguous()
    layers["moe.up_proj"] = gate_up[..., 1::2].transpose(-1, -2).contiguous()
    del gate_up
    layers["moe.gate_proj__bias"] = gu_bias[..., 0::2].contiguous()
    layers["moe.up_proj__bias"] = gu_bias[..., 1::2].contiguous()
    layers["moe.down_proj"] = torch.stack([expert_weight(i, "down_proj") for i in range(L)]).transpose(-1, -2).contiguous()
    layers["moe.down_proj__bias"] = stack(pre + "mlp.experts.down_proj_bias")
    params = {"embed_tokens": get("model.embed_tokens.weight"), "layers": layers, "norm": get("model.norm.weight")}
    return cfg, _head(params, cfg, raw, get)


def _load_llama4(path: str, d: dict, dtype, dev):
    """Llama4's text stack (Scout-style all-MoE): the config nested under
    `text_config` and the weights under `language_model.` in a multimodal
    checkpoint; the fused `feed_forward.experts.gate_up_proj` [E, H, 2I] is
    chunked (gate the first I columns, unlike GPT-OSS's interleave), the
    shared expert comes in, and `interleave_moe_layer_step != 1` raises, as
    in JAX."""
    from .llama4 import Llama4Config

    td = d.get("text_config", d)
    prefix = "language_model." if "text_config" in d else ""
    if td.get("interleave_moe_layer_step", 1) != 1:
        raise NotImplementedError("only all-MoE Llama4 (interleave_moe_layer_step=1) is supported, as in JAX")
    cfg = Llama4Config(
        vocab_size=td["vocab_size"], hidden_size=td["hidden_size"], intermediate_size=td["intermediate_size"],
        num_hidden_layers=td["num_hidden_layers"], num_attention_heads=td["num_attention_heads"],
        num_key_value_heads=td["num_key_value_heads"], head_dim=td.get("head_dim"),
        rope_theta=td.get("rope_theta", 500000.0), rope_scaling=_rope_scaling_from_hf(td),
        rms_norm_eps=td.get("rms_norm_eps", 1e-5), tie_word_embeddings=td.get("tie_word_embeddings", False),
        max_position_embeddings=td.get("max_position_embeddings", 4096),
        num_experts=td.get("num_local_experts", 16), top_k=td.get("num_experts_per_tok", 1),
        # HF writes the resolved per-layer flags; they win over the every-4th rule
        no_rope_layers=tuple(td["no_rope_layers"]) if td.get("no_rope_layers") else None,
        no_rope_layer_interval=4, attention_chunk_size=td.get("attention_chunk_size", 8192),
        attn_temperature_tuning=bool(td.get("attn_temperature_tuning", True)), attn_scale=td.get("attn_scale", 0.1),
        floor_scale=td.get("floor_scale", 8192.0), use_qk_norm=td.get("use_qk_norm", True), dtype=dtype)
    raw = SafetensorsDir(path)
    get = lambda name: raw[prefix + name].to(device=dev).to(dtype)
    L, inter = cfg.num_hidden_layers, cfg.intermediate_size
    stack = lambda fmt: torch.stack([get(fmt.format(i=i)) for i in range(L)])
    pre = "model.layers.{i}."
    layers: dict[str, Any] = {
        "input_layernorm": stack(pre + "input_layernorm.weight"),
        "post_attention_layernorm": stack(pre + "post_attention_layernorm.weight"),
        "moe.router": stack(pre + "feed_forward.router.weight"),
    }
    for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
        layers[f"self_attn.{proj}"] = stack(pre + f"self_attn.{proj}.weight")
    gate_up = stack(pre + "feed_forward.experts.gate_up_proj")  # [L, E, H, 2I]
    layers["moe.gate_proj"] = gate_up[..., :inter].transpose(-1, -2).contiguous()
    layers["moe.up_proj"] = gate_up[..., inter:].transpose(-1, -2).contiguous()
    del gate_up
    layers["moe.down_proj"] = stack(pre + "feed_forward.experts.down_proj").transpose(-1, -2).contiguous()
    for proj in ("gate_proj", "up_proj", "down_proj"):
        layers[f"shared.{proj}"] = stack(pre + f"feed_forward.shared_expert.{proj}.weight")
    params = {"embed_tokens": get("model.embed_tokens.weight"), "layers": layers, "norm": get("model.norm.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight") if prefix + "lm_head.weight" in raw else params["embed_tokens"]
    return cfg, params


def load_hf_moe_checkpoint(path: str, dtype=torch.bfloat16, device=None):
    """(config, params) from an HF MoE checkpoint directory: qwen3_moe
    (router mlp.gate, experts mlp.experts.{e}.{gate,up,down}_proj, per-head
    q/k norms, expert width moe_intermediate_size), mixtral
    (block_sparse_moe.gate, experts.{e}.{w1,w3,w2}), dbrx, gpt_oss
    (`gpt_oss_from_tensors`) or llama4 / llama4_text (`_load_llama4`); experts
    stacked [L, E, out, in], every tensor cast to `dtype` on `device`;
    deepseek_v3 through `load_hf_deepseek_checkpoint` (deepseek_v2
    raises, naming its softmax router)."""
    from .mixtral import MixtralConfig

    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    mt = d.get("model_type")
    if mt in NOT_PORTED:
        raise NotImplementedError(f"model_type {mt!r}: {NOT_PORTED[mt]}")
    if mt == "deepseek_v3":
        return load_hf_deepseek_checkpoint(path, dtype, device)
    if mt == "dbrx":
        return _load_dbrx(path, d, dtype, dev)
    if mt == "gpt_oss":
        return gpt_oss_from_tensors(d, SafetensorsDir(path), dtype, dev)
    if mt in ("llama4", "llama4_text"):
        return _load_llama4(path, d, dtype, dev)
    router_fmt, exp_fmt, projs = moe_names(mt)
    inter = d["moe_intermediate_size"] if mt == "qwen3_moe" else d["intermediate_size"]
    cfg = MixtralConfig(**{**config_from_hf(d).__dict__, "dtype": dtype, "intermediate_size": inter,
                           "num_experts": d.get("num_experts", d.get("num_local_experts")),
                           "top_k": d.get("num_experts_per_tok", 2),
                           "norm_topk_prob": d.get("norm_topk_prob", True) if mt == "qwen3_moe" else True})
    raw, get = _reader(path, dtype, dev)
    L, E = cfg.num_hidden_layers, cfg.num_experts
    stack = lambda fmt: torch.stack([get(fmt.format(i=i)) for i in range(L)])
    layers: dict[str, Any] = {
        "input_layernorm": stack("model.layers.{i}.input_layernorm.weight"),
        "post_attention_layernorm": stack("model.layers.{i}.post_attention_layernorm.weight"),
        "moe.router": stack(router_fmt),
    }
    for ours in ("q_proj", "k_proj", "v_proj", "o_proj"):
        layers[f"self_attn.{ours}"] = stack("model.layers.{i}.self_attn." + ours + ".weight")
    if cfg.qk_norm:
        layers["self_attn.q_norm"] = stack("model.layers.{i}.self_attn.q_norm.weight")
        layers["self_attn.k_norm"] = stack("model.layers.{i}.self_attn.k_norm.weight")
    for ours, theirs in projs.items():
        layers[ours] = torch.stack([torch.stack([get(exp_fmt.format(i=i, e=e, proj=theirs) + ".weight")
                                                 for e in range(E)]) for i in range(L)])
    params = {"embed_tokens": get("model.embed_tokens.weight"), "layers": layers, "norm": get("model.norm.weight")}
    return cfg, _head(params, cfg, raw, get)


def deepseek_softmax_scale_factor(d: dict) -> float:
    """What transformers multiplies DeepSeek's softmax scale by
    (`DeepseekV3Attention.__init__`): yarn_mscale(factor, mscale_all_dim)^2
    where `rope_scaling` has a non-zero `mscale_all_dim`, else 1."""
    rs = d.get("rope_scaling") or {}
    m_all = rs.get("mscale_all_dim", 0)
    if not m_all:
        return 1.0
    m = yarn_mscale(float(rs["factor"]), float(m_all))
    return m * m


def deinterleave_rope_rows(w: torch.Tensor, dr: int, head_dim: int = 0) -> torch.Tensor:
    """Rope-branch output rows from interleaved (x0, y0, x1, y1, ...: real
    DeepSeek checkpoints, `rope_interleave`, which transformers'
    `apply_rotary_pos_emb_interleave` turns half-split on the activations)
    to half-split order, the order `llama.rope` rotates: new[j] = old[2j],
    new[dr/2 + j] = old[2j + 1]. `head_dim=0`: the last `dr` rows of `w`
    (kv_a_proj_with_mqa); `head_dim>0`: the last `dr` rows of every
    `head_dim` block (q_proj / q_b_proj)."""
    perm = torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)]).to(w.device)
    if head_dim == 0:
        nope = w.shape[0] - dr
        return torch.cat([w[:nope], w[nope:][perm]], dim=0)
    heads = w.reshape(w.shape[0] // head_dim, head_dim, *w.shape[1:])
    nope = head_dim - dr
    return torch.cat([heads[:, :nope], heads[:, nope:][:, perm]], dim=1).reshape(w.shape)


def deepseek_config_from_hf(d: dict, dtype=torch.bfloat16):
    """A DeepSeek-V3 config.json's fields -> DeepseekConfig (yarn's cos /
    sin factor from the mscale pair, the softmax factor from
    `deepseek_softmax_scale_factor`); deepseek_v2 raises."""
    from .deepseek import DeepseekConfig

    return DeepseekConfig(**{
        **config_from_hf(d).__dict__, "dtype": dtype,
        "q_lora_rank": d.get("q_lora_rank") or 0, "kv_lora_rank": d["kv_lora_rank"],
        "qk_nope_head_dim": d["qk_nope_head_dim"], "qk_rope_head_dim": d["qk_rope_head_dim"],
        "v_head_dim": d["v_head_dim"], "n_routed_experts": d["n_routed_experts"],
        "num_experts_per_tok": d["num_experts_per_tok"], "n_shared_experts": d.get("n_shared_experts", 1),
        "moe_intermediate_size": d["moe_intermediate_size"],
        "first_k_dense_replace": d.get("first_k_dense_replace", 0), "n_group": d.get("n_group", 1),
        "topk_group": d.get("topk_group", 1), "routed_scaling_factor": d.get("routed_scaling_factor", 1.0),
        "norm_topk_prob": d.get("norm_topk_prob", True),
        "softmax_scale_factor": deepseek_softmax_scale_factor(d)})


def load_hf_deepseek_checkpoint(path: str, dtype=torch.bfloat16, device=None):
    """(DeepseekConfig, params) from a transformers-convention DeepSeek-V3
    checkpoint directory: the dense and MoE layer groups stacked apart,
    experts [L, E, out, in], `e_score_correction_bias` as `moe.e_bias` in
    f32, the rope rows of q / q_b and kv_a_proj_with_mqa de-interleaved
    where `rope_interleave` (default true), every other tensor cast to
    `dtype` on `device`. The config's `softmax_scale_factor` is
    transformers' yarn mscale squared (`deepseek_softmax_scale_factor`)."""
    from .deepseek import attn_shapes

    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        d = json.load(f)
    cfg = deepseek_config_from_hf(d, dtype)
    raw, get = _reader(path, dtype, dev)
    interleaved = d.get("rope_interleave", True)
    dr, Ld, L, E = cfg.qk_rope_head_dim, cfg.first_k_dense_replace, cfg.num_hidden_layers, cfg.n_routed_experts
    pre = "model.layers.{i}."

    def attn_block(layers) -> dict:
        stk = lambda fmt: torch.stack([get((pre + fmt).format(i=i)) for i in layers])
        blk = {"input_layernorm": stk("input_layernorm.weight"),
               "post_attention_layernorm": stk("post_attention_layernorm.weight"),
               "self_attn.kv_a_norm": stk("self_attn.kv_a_layernorm.weight"),
               "self_attn.kv_b_proj": stk("self_attn.kv_b_proj.weight"),
               "self_attn.o_proj": stk("self_attn.o_proj.weight")}
        kva = stk("self_attn.kv_a_proj_with_mqa.weight")
        fix_q = (lambda w: deinterleave_rope_rows(w, dr, cfg.qk_head_dim)) if interleaved else (lambda w: w)
        blk["self_attn.kv_a_proj"] = torch.stack([deinterleave_rope_rows(w, dr) for w in kva]) if interleaved else kva
        if cfg.q_lora_rank:
            blk["self_attn.q_a_proj"] = stk("self_attn.q_a_proj.weight")
            blk["self_attn.q_a_norm"] = stk("self_attn.q_a_layernorm.weight")
            blk["self_attn.q_b_proj"] = torch.stack([fix_q(w) for w in stk("self_attn.q_b_proj.weight")])
        else:
            blk["self_attn.q_proj"] = torch.stack([fix_q(w) for w in stk("self_attn.q_proj.weight")])
        assert set(blk) >= set(attn_shapes(cfg))
        return blk

    params: dict[str, Any] = {"embed_tokens": get("model.embed_tokens.weight"), "norm": get("model.norm.weight")}
    params["lm_head"] = get("lm_head.weight") if "lm_head.weight" in raw else params["embed_tokens"]
    if Ld:
        dense = attn_block(range(Ld))
        for proj in ("gate_proj", "up_proj", "down_proj"):
            dense[f"mlp.{proj}"] = torch.stack([get(f"model.layers.{i}.mlp.{proj}.weight") for i in range(Ld)])
        params["layers_dense"] = dense
    rng = range(Ld, L)
    moe = attn_block(rng)
    moe["moe.router"] = torch.stack([get(f"model.layers.{i}.mlp.gate.weight") for i in rng])
    moe["moe.e_bias"] = torch.stack([raw[f"model.layers.{i}.mlp.gate.e_score_correction_bias"].to(
        device=dev, dtype=torch.float32) for i in rng])
    for proj in ("gate_proj", "up_proj", "down_proj"):
        moe[f"moe.{proj}"] = torch.stack([torch.stack([get(f"model.layers.{i}.mlp.experts.{e}.{proj}.weight")
                                                       for e in range(E)]) for i in rng])
        moe[f"shared.{proj}"] = torch.stack([get(f"model.layers.{i}.mlp.shared_experts.{proj}.weight")
                                             for i in rng])
    params["layers_moe"] = moe
    return cfg, params
