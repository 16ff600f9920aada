"""Speculative-draft export (port of `export/spec_export.py`).

Medusa heads and EAGLE drafts are saved as standalone checkpoints: one
safetensors file (through the port's own writer, `hf_loader.save_safetensors`;
bf16 stored as f32, as JAX's writer stores it) and a config.json naming the
draft and its base model. The files are byte-equal to JAX's.
"""

from __future__ import annotations

import json
import os

import torch

from .. import resolve_device
from ..models import hf_loader, llama


def _save(tensors: dict, path: str) -> None:
    hf_loader.save_safetensors({k: (v.float() if v.dtype == torch.bfloat16 else v) for k, v in tensors.items()},
                               path)


def _write_json(cfg: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)


def export_medusa(medusa: dict, base_cfg: llama.LlamaConfig, export_dir: str) -> dict:
    """medusa_heads.safetensors + medusa_config.json; returns the config."""
    os.makedirs(export_dir, exist_ok=True)
    tensors = {}
    for h, head in enumerate(medusa["heads"]):
        for b, blk in enumerate(head["blocks"]):
            tensors[f"medusa_heads.{h}.blocks.{b}.weight"] = blk
        tensors[f"medusa_heads.{h}.lm_head.weight"] = head["lm"]
    _save(tensors, os.path.join(export_dir, "medusa_heads.safetensors"))
    cfg = {
        "speculative_algo": "MEDUSA",
        "num_medusa_heads": len(medusa["heads"]),
        "num_medusa_layers": len(medusa["heads"][0]["blocks"]),
        "base_model": hf_loader.config_to_hf(base_cfg),
    }
    _write_json(cfg, os.path.join(export_dir, "medusa_config.json"))
    return cfg


def export_eagle(eagle: dict, base_cfg: llama.LlamaConfig, export_dir: str) -> dict:
    """eagle_draft.safetensors (the fusion projection, the norm and the
    stacked layers) + eagle_config.json; returns the config."""
    os.makedirs(export_dir, exist_ok=True)
    tensors = {"fc.weight": eagle["fc"], "norm.weight": eagle["norm"]}
    for name, arr in eagle["layers"].items():
        tensors[f"layers.{name}"] = arr
    _save(tensors, os.path.join(export_dir, "eagle_draft.safetensors"))
    cfg = {
        "speculative_algo": "EAGLE",
        "num_draft_layers": int(next(iter(eagle["layers"].values())).shape[0]),
        "base_model": hf_loader.config_to_hf(base_cfg),
    }
    _write_json(cfg, os.path.join(export_dir, "eagle_config.json"))
    return cfg


def load_medusa(export_dir: str, device=None) -> dict:
    """`export_medusa`'s heads back, as stored (f32), on `device` (cuda
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    with open(os.path.join(export_dir, "medusa_config.json")) as f:
        cfg = json.load(f)
    raw = hf_loader.SafetensorsDir(export_dir)
    heads = []
    for h in range(cfg["num_medusa_heads"]):
        blocks = [raw[f"medusa_heads.{h}.blocks.{b}.weight"].to(dev) for b in range(cfg["num_medusa_layers"])]
        heads.append({"blocks": blocks, "lm": raw[f"medusa_heads.{h}.lm_head.weight"].to(dev)})
    return {"heads": heads}
