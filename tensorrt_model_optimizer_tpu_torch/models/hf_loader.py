"""HF checkpoint loading for dense Llama (port of `models/hf_loader.py`).

Reads `config.json` and every `*.safetensors` file of a directory into the
stacked-layer params dict. The safetensors format is parsed here (an 8-byte
little-endian header length, a JSON header, then raw little-endian bytes)
so the port needs no `safetensors` package; BF16 arrives as a `uint16` view
and becomes `torch.bfloat16` bit for bit.
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
    "U8": np.uint8, "BOOL": np.bool_,
}


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
        if meta["dtype"] == "BF16":
            t = t.view(torch.bfloat16)
        return t


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
