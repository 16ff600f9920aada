"""HF checkpoint loading and saving for dense Llama (port of
`models/hf_loader.py`).

Reads `config.json` and every `*.safetensors` file of a directory into the
stacked-layer params dict, and writes one back (`save_hf_checkpoint`). The
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
    "U8": np.uint8, "BOOL": np.bool_, "F8_E4M3": np.uint8, "F8_E5M2": np.uint8,
}
_VIEWED = {"BF16": torch.bfloat16, "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2}

# safetensors' Dtype enum, in its order: a file lists its tensors by dtype,
# the last of these first
_ST_ORDER = ("BOOL", "F4", "F6_E2M3", "F6_E3M2", "U8", "I8", "F8_E5M2", "F8_E4M3", "F8_E8M0", "I16", "U16",
             "F16", "BF16", "I32", "U32", "F32", "C64", "F64", "I64", "U64")
_ST_NAMES = {torch.bool: "BOOL", torch.uint8: "U8", torch.int8: "I8", torch.float8_e5m2: "F8_E5M2",
             torch.float8_e4m3fn: "F8_E4M3", torch.int16: "I16", torch.float16: "F16", torch.bfloat16: "BF16",
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


def _rope_scaling_from_hf(d: dict) -> Optional[RopeScaling]:
    rs = d.get("rope_scaling")
    if not rs:
        return None
    rope_type = rs.get("rope_type", rs.get("type", "llama3"))
    if rope_type != "llama3":
        raise NotImplementedError(f"rope_scaling type {rope_type!r} comes with the MoE-families slice")
    return RopeScaling(
        rope_type=rope_type,
        factor=float(rs.get("factor", 8.0)),
        low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
        high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
        original_max_position_embeddings=int(rs.get("original_max_position_embeddings", 8192)),
    )


def config_from_hf(d: dict) -> LlamaConfig:
    mt = d.get("model_type")
    if mt not in (None, "llama") or d.get("attention_bias"):
        raise NotImplementedError(f"model_type {mt!r} comes with a later slice; this one loads dense Llama")
    return LlamaConfig(
        rope_scaling=_rope_scaling_from_hf(d),
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
    """Name -> tensor view over every `*.safetensors` file of a directory.
    Files are memory-mapped; a tensor is read when it is asked for."""

    def __init__(self, path: str):
        files = sorted(glob(os.path.join(path, "*.safetensors")))
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
    """config.json's fields for a dense Llama, in the JAX package's order
    (its `config_to_hf`), so the JSON files are byte-equal."""
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
    return out | {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
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


HF_NAMES = {  # stacked-layer params -> per-layer HF tensor names
    "input_layernorm": "model.layers.{i}.input_layernorm.weight",
    "post_attention_layernorm": "model.layers.{i}.post_attention_layernorm.weight",
    "self_attn.q_proj": "model.layers.{i}.self_attn.q_proj.weight",
    "self_attn.k_proj": "model.layers.{i}.self_attn.k_proj.weight",
    "self_attn.v_proj": "model.layers.{i}.self_attn.v_proj.weight",
    "self_attn.o_proj": "model.layers.{i}.self_attn.o_proj.weight",
    "mlp.gate_proj": "model.layers.{i}.mlp.gate_proj.weight",
    "mlp.up_proj": "model.layers.{i}.mlp.up_proj.weight",
    "mlp.down_proj": "model.layers.{i}.mlp.down_proj.weight",
}


def save_hf_checkpoint(cfg: LlamaConfig, params: dict, path: str) -> None:
    """Inverse of `load_hf_checkpoint`: config.json (indent 1) and one
    model.safetensors of f32 tensors under the HF names, as the JAX
    package's `save_hf_checkpoint` writes them (byte-equal files)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_hf(cfg), f, indent=1)
    flat = {"model.embed_tokens.weight": params["embed_tokens"], "model.norm.weight": params["norm"]}
    if not cfg.tie_word_embeddings:
        flat["lm_head.weight"] = params.get("lm_head", params["embed_tokens"])
    layers = params["layers"]
    extra = sorted(set(layers) - set(HF_NAMES))
    if extra:
        raise NotImplementedError(f"save_hf_checkpoint: layer leaves {extra} come with a later slice")
    for ours, fmt in HF_NAMES.items():
        for i in range(cfg.num_hidden_layers):
            flat[fmt.format(i=i)] = layers[ours][i]
    save_safetensors({k: v.float() for k, v in flat.items()}, os.path.join(path, "model.safetensors"))


def load_hf_checkpoint(path: str, dtype=torch.bfloat16, device=None) -> tuple[LlamaConfig, dict]:
    """Returns (config, params) from an HF Llama checkpoint directory, with
    every tensor cast to `dtype` on `device`."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf(json.load(f))
    cfg = LlamaConfig(**{**cfg.__dict__, "dtype": dtype})
    raw = SafetensorsDir(path)

    def get(name):
        return raw[name].to(device=dev).to(dtype)

    L = cfg.num_hidden_layers
    stack = lambda fmt: torch.stack([get(fmt.format(i=i)) for i in range(L)])
    layers: dict[str, Any] = {
        "input_layernorm": stack("model.layers.{i}.input_layernorm.weight"),
        "post_attention_layernorm": stack("model.layers.{i}.post_attention_layernorm.weight"),
    }
    for ours in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                 "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"):
        layers[ours] = stack("model.layers.{i}." + ours + ".weight")
    params = {
        "embed_tokens": get("model.embed_tokens.weight"),
        "layers": layers,
        "norm": get("model.norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight") if "lm_head.weight" in raw else params["embed_tokens"]
    return cfg, params
