"""Replayable optimization state and save / restore (port of `opt/state.py`:
`mto.save` / `mto.restore`).

A quantized model carries an ordered record of applied (mode, config,
metadata); restoring replays the modes in order to rebuild the quantized
structure, then loads the arrays. The directory is JAX's, file for file and
key for key, so a directory saved by either package restores in the other:

    modelopt_state.json      the ordered modes, their configs, the model config
    quant_state.safetensors  the quantizer state, flattened ("site/which/amax"), f32
    params.safetensors       the weights ("layers/mlp.down_proj"); bf16 tensors
                             stored as their raw uint16 bits under "<name>::bf16"
    adapters.safetensors     SVDQuant's low-rank branch ("<proj>/<part>"), f32

The files are written and read by the port's own safetensors code
(`models/hf_loader.py`). Sharded save / restore wait for multi-GPU
(ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

from .. import resolve_device
from ..models import hf_loader, llama
from ..quant import config as qconfig
from ..quant import ptq
from ..quant import quantizer as Q
from ..utils import tree as tree_util
from .mode import ModeDescriptor, ModeRegistry

opt_registry = ModeRegistry("opt")
quant_registry = ModeRegistry("quantization")

BF16_SUFFIX = "::bf16"
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32", torch.float16: "float16"}


@dataclasses.dataclass
class OptState:
    """Ordered (mode, config-dict, metadata-dict) records."""

    modes: list = dataclasses.field(default_factory=list)

    def add(self, name: str, config: dict, metadata: Optional[dict] = None):
        self.modes.append((name, config, metadata or {}))

    def to_json(self) -> dict:
        return {"modes": [[n, c, m] for n, c, m in self.modes], "version": 1}

    @staticmethod
    def from_json(d: dict) -> "OptState":
        return OptState(modes=[(n, c, m) for n, c, m in d["modes"]])


def modelopt_state(model: ptq.QuantizedModel) -> OptState:
    """The replayable state of a quantized model (`mto.modelopt_state`)."""
    st = OptState()
    st.add("quantize", qconfig.config_to_dict(model.quant_cfg),
           {"model_config": _model_cfg_to_dict(model.model_cfg)})
    return st


def _model_cfg_to_dict(cfg: llama.LlamaConfig) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = _DTYPE_NAMES[cfg.dtype]
    return d


def _model_cfg_from_dict(d: dict) -> llama.LlamaConfig:
    d = dict(d)
    d["dtype"] = {v: k for k, v in _DTYPE_NAMES.items()}[d["dtype"]]
    if isinstance(d.get("rope_scaling"), dict):
        d["rope_scaling"] = llama.RopeScaling(**d["rope_scaling"])
    return llama.LlamaConfig(**d)


def _qstate_to_named(qstate) -> dict:
    return {k: v.float() for k, v in tree_util.flatten_with_names(qstate).items()}


def _params_to_named(params) -> dict:
    named = {}
    for k, v in tree_util.flatten_with_names(params).items():
        if v.dtype == torch.bfloat16:
            named[k + BF16_SUFFIX] = v.view(torch.uint16)  # raw bits, as JAX's numpy writer stores them
        else:
            named[k] = v
    return named


def _named_from_file(path: str, device) -> dict:
    """{name: tensor on device} of one safetensors file, "::bf16" entries
    viewed back as bf16 under their bare names."""
    raw = hf_loader.SafetensorsDir(path)
    out = {}
    for k in raw.keys():
        t = raw[k]
        if k.endswith(BF16_SUFFIX):
            out[k[: -len(BF16_SUFFIX)]] = t.view(torch.bfloat16).to(device)
        else:
            out[k] = t.to(device)
    return out


def save(model: ptq.QuantizedModel, path: str, save_params: bool = True) -> None:
    """Save the weights and the replayable modelopt state (`mto.save`)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "modelopt_state.json"), "w") as f:
        json.dump(modelopt_state(model).to_json(), f, indent=1)
    hf_loader.save_safetensors(_qstate_to_named(model.qstate), os.path.join(path, "quant_state.safetensors"))
    if save_params:
        hf_loader.save_safetensors(_params_to_named(model.params), os.path.join(path, "params.safetensors"))
    if model.adapters:
        hf_loader.save_safetensors({f"{name}/{part}": t.float() for name, sub in model.adapters.items()
                                    for part, t in sub.items()}, os.path.join(path, "adapters.safetensors"))


def restore(path: str, params: Optional[dict] = None, device=None) -> ptq.QuantizedModel:
    """Rebuild a quantized model by replaying its recorded modes
    (`mto.restore`), on `device`. Weights load from params.safetensors
    unless `params` is given."""
    dev = resolve_device(device)
    with open(os.path.join(path, "modelopt_state.json")) as f:
        state = OptState.from_json(json.load(f))
    name, cfg_dict, meta = state.modes[0]
    if name != "quantize":
        raise ValueError(f"first mode {name!r} unsupported")
    model_cfg = _model_cfg_from_dict(meta["model_config"])
    quant_cfg = qconfig.config_from_dict(cfg_dict)
    if params is None:
        params = tree_util.nest(_named_from_file(os.path.join(path, "params.safetensors"), dev))
    layout = llama.build_layout(model_cfg, quant_cfg)
    qstate = llama.init_quant_state(model_cfg, layout, dev)
    saved = _named_from_file(os.path.join(path, "quant_state.safetensors"), dev)
    qstate = tree_util.unflatten_like(_ensure_slots(qstate, saved), saved)
    adapters = None
    ad_path = os.path.join(path, "adapters.safetensors")
    if os.path.exists(ad_path):
        adapters = tree_util.nest(_named_from_file(ad_path, dev))
    return ptq.QuantizedModel(model_cfg, params, layout, qstate, quant_cfg, adapters)


def _ensure_slots(qstate: dict, saved: dict) -> dict:
    """Add the pre_quant_scale slots (and input sites) that sequential
    calibration creates and the skeleton lacks, where the checkpoint has them."""
    out = {}
    for site, sub in qstate.items():
        if not isinstance(sub, dict):
            out[site] = sub
            continue
        new_sub = {}
        for part, st in sub.items():
            key = f"{site}/{part}/pre_quant_scale"
            if key in saved and st.pre_quant_scale is None:
                st = st.replace(pre_quant_scale=torch.zeros(saved[key].shape, dtype=torch.float32,
                                                            device=saved[key].device))
            new_sub[part] = st
        key = f"{site}/input/pre_quant_scale"
        if "input" not in new_sub and key in saved:
            new_sub["input"] = Q.QuantizerState(pre_quant_scale=torch.zeros(saved[key].shape, dtype=torch.float32,
                                                                            device=saved[key].device))
        out[site] = new_sub
    return out


def save_sharded(model: ptq.QuantizedModel, path: str) -> None:
    """Multi-host sharded save: it comes with multi-GPU (ROADMAP queue 1 item 7)."""
    raise NotImplementedError("save_sharded writes each rank's shards: it comes with multi-GPU "
                              "(ROADMAP queue 1 item 7); `save` writes one directory")


def restore_sharded(path: str, shardings=None) -> ptq.QuantizedModel:
    """Sharded restore: it comes with multi-GPU (ROADMAP queue 1 item 7)."""
    raise NotImplementedError("restore_sharded places each rank's shards: it comes with multi-GPU "
                              "(ROADMAP queue 1 item 7); `restore` reads one directory")


quant_registry.register(
    ModeDescriptor(
        name="quantize",
        convert=lambda handle, cfg, **kw: (ptq.quantize(*handle, cfg, **kw), {}),
        restore=lambda handle, cfg, meta: restore(meta["path"], params=handle),
        config_to_dict=qconfig.config_to_dict,
        config_from_dict=qconfig.config_from_dict,
    )
)
