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
(`models/hf_loader.py`).

`save_sharded(model, path, mesh)` is the multi-GPU save (JAX's writes
through orbax, which the port does not have): every rank of the mesh holds
the whole model and writes only its shards of the weights, by the family's
`param_specs` (Llama's column / row plan over "tensor", the experts over
"expert"), to `arrays/rank<r>.safetensors` (a shard that several ranks
hold is written by one of them), beside `arrays/index.json` (each weight's
whole shape, its spec and the mesh) and the replicated files rank 0 writes
as `save` does: `modelopt_state.json`, `quant_state.safetensors`,
`adapters.safetensors`. `restore_sharded(path, mesh)` gives each rank its
own shards (on the mesh's device); with no mesh it gathers the whole model.
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


def _param_specs(model: ptq.QuantizedModel) -> dict:
    """{leaf name: spec tuple} of the model's weights: Llama's plan, the
    MoE families' (experts over "expert") where the layers hold experts."""
    from ..models import mixtral

    if "moe.gate_proj" in model.params["layers"]:
        specs = mixtral.param_specs(model.model_cfg)
    else:
        specs = llama.param_specs(model.model_cfg)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    return flat(specs)


def _shard_of(spec: tuple, coords: dict, shape: dict) -> tuple:
    """The (dim, index, count) slices a rank at `coords` holds of a weight
    with `spec` on a mesh of `shape` (only the axes the mesh has shard)."""
    return tuple((dim, coords[ax], shape[ax]) for dim, ax in enumerate(spec) if ax in shape and shape[ax] > 1)


def _slice(t: torch.Tensor, shard: tuple) -> torch.Tensor:
    for dim, i, n in shard:
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide by {n}")
        t = t.narrow(dim, i * (size // n), size // n)
    return t.contiguous()


def save_sharded(model: ptq.QuantizedModel, path: str, mesh=None) -> None:
    """Each rank of `mesh` writes its shards of the weights (see the module
    docstring); no mesh: one process writes one shard, the whole model."""
    import torch.distributed as dist

    shape = dict(mesh.shape) if mesh is not None else {}
    coords = dict(mesh.coords) if mesh is not None else {}
    rank = mesh.rank if mesh is not None else 0
    specs = _param_specs(model)
    arrays = os.path.join(path, "arrays")
    os.makedirs(arrays, exist_ok=True)
    mine, index = {}, {}
    for name, t in tree_util.flatten_with_names(model.params).items():
        spec = tuple(specs.get(name, ()))
        shard = _shard_of(spec, coords, shape)
        index[name] = {"shape": list(t.shape), "spec": list(spec)}
        held = {ax for dim, ax in enumerate(spec) if ax in shape}
        if all(coords[ax] == 0 for ax in shape if ax not in held):  # one writer of each shard
            mine[name] = _slice(t, shard)
    hf_loader.save_safetensors(_params_to_named(mine), os.path.join(arrays, f"rank{rank}.safetensors"))
    if rank == 0:
        with open(os.path.join(arrays, "index.json"), "w") as f:
            json.dump({"params": index, "mesh": shape,
                       "ranks": _all_coords(mesh) if mesh is not None else {"0": {}}}, f, indent=1)
        save(model, path, save_params=False)
    if mesh is not None:
        dist.barrier()


def _all_coords(mesh) -> dict:
    """{rank: its coords} of every rank of the mesh (row-major over its axes)."""
    import itertools

    names = mesh.names
    return {str(r): dict(zip(names, c))
            for r, c in enumerate(itertools.product(*(range(mesh.shape[n]) for n in names)))}


def restore_sharded(path: str, mesh=None, device=None) -> ptq.QuantizedModel:
    """Restore a `save_sharded` directory: with `mesh`, each rank's own
    shards of the weights (the mesh's axes the save sharded over must have
    the saved sizes), on the mesh's device; with none, the whole model,
    gathered from every rank's file, on `device`."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    with open(os.path.join(path, "arrays", "index.json")) as f:
        index = json.load(f)
    saved_shape, ranks = index["mesh"], index["ranks"]
    files = {}

    def entry(r: str, name: str) -> torch.Tensor:
        if r not in files:
            files[r] = _named_from_file(os.path.join(path, "arrays", f"rank{r}.safetensors"), "cpu")
        return files[r][name]

    params = {}
    for name, meta in index["params"].items():
        spec = tuple(meta["spec"])
        held = [ax for ax in spec if ax in saved_shape and saved_shape[ax] > 1]
        writers = {r: c for r, c in ranks.items() if all(c[ax] == 0 for ax in saved_shape if ax not in held)}
        if mesh is not None:
            for ax in held:
                if mesh.size(ax) != saved_shape[ax]:
                    raise ValueError(f"{name}: saved over {ax}={saved_shape[ax]}, the mesh has {mesh.size(ax)}")
            (r,) = [r for r, c in writers.items() if all(c[ax] == mesh.index(ax) for ax in held)]
            params[name] = entry(r, name).to(dev)
            continue
        whole = None
        for r, c in writers.items():
            part = entry(r, name)
            if whole is None:
                whole = torch.empty(meta["shape"], dtype=part.dtype)
            view = whole
            for dim, ax in enumerate(spec):
                if ax in held:
                    n = meta["shape"][dim] // saved_shape[ax]
                    view = view.narrow(dim, c[ax] * n, n)
            view.copy_(part)
        params[name] = whole.to(dev)
    return restore(path, params=tree_util.nest(params), device=dev)


quant_registry.register(
    ModeDescriptor(
        name="quantize",
        convert=lambda handle, cfg, **kw: (ptq.quantize(*handle, cfg, **kw), {}),
        restore=lambda handle, cfg, meta: restore(meta["path"], params=handle),
        config_to_dict=qconfig.config_to_dict,
        config_from_dict=qconfig.config_from_dict,
    )
)
