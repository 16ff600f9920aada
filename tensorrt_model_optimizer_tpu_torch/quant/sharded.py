"""Calibration with the experts sharded over an (expert, tensor) mesh: the
multi-GPU PTQ of the MoE families and DeepSeek (the port of what
`examples/moe_ptq_sharded.py` and `examples/deepseek_ptq_sharded.py` run
under GSPMD).

JAX places the expert stacks by the family's `param_specs` (experts over
"expert"; each expert's gate / up rows and down columns over "tensor") and
XLA inserts the amax reductions the sharding implies. Here each rank holds
its slice of the expert stacks (`shard_experts`) and of their quantizer
states (`shard_expert_states`), runs the family's calibration forward with
the two axes passed in (`ep`, `tp`: routing on the replicated activations,
the local experts' rows, the down partial SUMmed over "tensor", the
combined partial over "expert", `mixtral.combine_local`; attention, the
router, the shared experts and the dense layers replicate), and the
quantizer sites that span shards have their amaxes reduced
(`merge_expert_states`):

 - an expert weight's amax: kept along a sharded dim (per channel along the
   rows of gate / up, blocks along down's K) it is gathered over "tensor";
   reduced over that dim (per tensor, or per channel along down's rows) it
   is MAX-reduced over "tensor"; the experts' stack is gathered over
   "expert";
 - the expert block's one shared input site (`moe.gate_proj`'s input): MAX
   over "expert". The calibration forward collects it on the block's whole
   input, which every rank holds, so the MAX returns the rank's own amax;
   the reduction keeps it right where a forward collects per expert.

Every other site sees replicated activations and weights: its amax is the
same on every rank. `quantize_sharded` returns the model with the whole
quantizer state (the same on every rank) and the rank's own expert slices.
"""

from __future__ import annotations

import torch

from ..models import llama, mixtral
from ..parallel.mesh import Mesh, all_gather, all_reduce
from . import quantizer as Q

EXPERT_SITES = ("moe.gate_proj", "moe.up_proj", "moe.down_proj")
# the dim of one expert's [O, K] weight each site shards over "tensor"
TENSOR_DIM = {"moe.gate_proj": 0, "moe.up_proj": 0, "moe.down_proj": 1}
GROUPS = ("layers", "layers_moe")  # where a family keeps its expert stacks


def _part(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide by {n}")
    return t.narrow(dim, i * (size // n), size // n).clone(memory_format=torch.contiguous_format)


def shard_experts(params: dict, mesh: Mesh, expert_axis: str = "expert", tensor_axis: str = "tensor") -> dict:
    """The rank's slice of every expert stack [L, E, O, K]: its E / e
    experts, and of each its gate / up rows or down columns over the tensor
    axis. Everything else is shared as it is."""
    out = dict(params)
    for g in GROUPS:
        if g not in params:
            continue
        layers = dict(params[g])
        for name in EXPERT_SITES:
            if name in layers:
                w = _part(layers[name], 1, mesh.size(expert_axis), mesh.index(expert_axis))
                layers[name] = _part(w, 2 + TENSOR_DIM[name], mesh.size(tensor_axis), mesh.index(tensor_axis))
        out[g] = layers
    return out


def _kept(cfg: Q.QuantizerConfig, shape: tuple, dim: int) -> bool:
    """Whether the amax of a weight of `shape` keeps `dim` (per channel or
    in blocks along it) rather than reducing over it."""
    wider = list(shape)
    wider[dim] *= 2
    return Q.amax_shape(cfg, tuple(shape)) != Q.amax_shape(cfg, tuple(wider))


def _shard_amax(a, wcfg, shape: tuple, name: str, mesh: Mesh, expert_axis: str, tensor_axis: str):
    """One expert weight's stacked amax [L, E, ...] of the whole model ->
    this rank's [L, E_local, ...] (`_merge_amax`'s inverse)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_shard_amax(x, wcfg, shape, name, mesh, expert_axis, tensor_axis) for x in a)
    a = _part(a, 1, mesh.size(expert_axis), mesh.index(expert_axis))
    dim = TENSOR_DIM[name]
    if _kept(wcfg, shape, dim) and a.ndim == 2 + len(shape):
        a = _part(a, 2 + dim, mesh.size(tensor_axis), mesh.index(tensor_axis))
    return a


def _expert_sites(qstate: dict, layout: llama.QuantLayout, params: dict, fn) -> dict:
    """qstate with each expert site's weight state through
    fn(state, wcfg, name, shape of one expert's weight in `params`) and
    its input state through fn(state, None, name, None)."""
    out = dict(qstate)
    for key, group in (("moe", "layers_moe"), (None, "layers")):
        if group not in params:
            continue
        sub = dict(qstate[key]) if key is not None else out
        for name in EXPERT_SITES:
            if name not in params[group] or name not in sub:
                continue
            site = dict(sub[name])
            if site.get("weight") is not None and site["weight"].amax is not None:
                wcfg = layout.get(f"{name}.weight")
                wcfg = wcfg.sequential[0] if wcfg.sequential else wcfg
                site["weight"] = fn(site["weight"], wcfg, name, tuple(params[group][name].shape[2:]))
            if site.get("input") is not None and site["input"].amax is not None:
                site["input"] = fn(site["input"], None, name, None)
            sub[name] = site
        if key is not None:
            out[key] = sub
    return out


def shard_expert_states(qstate: dict, layout: llama.QuantLayout, params: dict, mesh: Mesh,
                        expert_axis: str = "expert", tensor_axis: str = "tensor") -> dict:
    """This rank's share of the whole model's quantizer state (`params`:
    the whole model's, stacked over layers): each expert weight's amax
    sliced as `shard_experts` slices the weight. The calibration forward
    collects into it on the rank's expert slices."""
    def fn(st, wcfg, name, shape):
        if wcfg is None:
            return st
        return st.replace(amax=_shard_amax(st.amax, wcfg, shape, name, mesh, expert_axis, tensor_axis))

    return _expert_sites(qstate, layout, params, fn)


def _merge_amax(a, wcfg, local_shape: tuple, name: str, mesh: Mesh, expert_axis: str, tensor_axis: str):
    """One expert weight's stacked amax [L, E_local, ...] -> the whole
    model's [L, E, ...]."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_merge_amax(x, wcfg, local_shape, name, mesh, expert_axis, tensor_axis) for x in a)
    dim = TENSOR_DIM[name]
    if _kept(wcfg, local_shape, dim) and a.ndim == 2 + len(local_shape):
        a = all_gather(a, mesh, tensor_axis, 2 + dim)
    else:
        a = all_reduce(a, mesh, tensor_axis, "max")
    return all_gather(a, mesh, expert_axis, 1)


def merge_expert_states(qstate: dict, layout: llama.QuantLayout, params: dict, mesh: Mesh,
                        expert_axis: str = "expert", tensor_axis: str = "tensor") -> dict:
    """The whole model's quantizer state from a rank's sharded calibration
    (see the module docstring): `qstate` and `params` (the rank's expert
    slices) as the family keeps them, stacked over layers; DeepSeek's keyed
    by group ("dense", "moe")."""
    def fn(st, wcfg, name, shape):
        if wcfg is None:  # the expert block's one input site
            return st.replace(amax=all_reduce(st.amax, mesh, expert_axis, "max")) if name == "moe.gate_proj" else st
        return st.replace(amax=_merge_amax(st.amax, wcfg, shape, name, mesh, expert_axis, tensor_axis))

    return _expert_sites(qstate, layout, params, fn)


@torch.no_grad()
def quantize_sharded(family: str, cfg, params: dict, preset, batches, mesh: Mesh, expert_axis: str = "expert",
                     tensor_axis: str = "tensor", device=None):
    """Max-calibrate `family` ("mixtral", or "deepseek") with the experts
    sharded over the mesh: the rank's slice of `params` (the whole model's,
    the same on every rank) and of the initial state through the family's
    calibration forward a batch, with the expert and tensor axes passed in,
    then the spanning sites reduced. Returns the quantized model: the whole
    quantizer state, the rank's own expert slices in its params. Other
    calibration methods raise `NotImplementedError` (JAX's sharded
    examples calibrate by max)."""
    from .. import resolve_device
    from ..models import deepseek
    from ..parallel.mesh import Axis
    from . import ptq
    from .config import get_preset

    if family not in ("mixtral", "deepseek"):
        raise NotImplementedError(f"sharded calibration of family {family!r}: mixtral and deepseek are sharded")
    qcfg = get_preset(preset) if isinstance(preset, str) else preset
    method = ptq._method_of(qcfg.algorithm)
    if method != "max":
        raise NotImplementedError(f"sharded calibration by {method!r}: it calibrates by max")
    dev = resolve_device(device)
    fam = deepseek if family == "deepseek" else mixtral
    layout = fam.build_layout(cfg, qcfg)
    local = shard_experts(params, mesh, expert_axis, tensor_axis)
    qstate = shard_expert_states(fam.init_quant_state(cfg, layout, dev), layout, params, mesh, expert_axis,
                                 tensor_axis)
    ep, tp = Axis(mesh, expert_axis), Axis(mesh, tensor_axis)
    for b in batches:
        qstate = fam.forward(cfg, local, b.to(dev), layout=layout, qstate=qstate, calib=True, ep=ep, tp=tp)[1]
    qstate = merge_expert_states(qstate, layout, local, mesh, expert_axis, tensor_axis)
    if family == "deepseek":
        return deepseek.DeepseekQuantizedModel(cfg, local, layout, qstate, qcfg)
    return ptq.QuantizedModel(cfg, local, layout, qstate, qcfg, forward_fn=mixtral.forward)
