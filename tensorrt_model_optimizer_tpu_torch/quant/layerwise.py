"""Layer-by-layer max calibration with resume checkpoints (port of
`quant/layerwise.py`, the big-model path).

Activations go through the model one decoder layer at a time, so only one
layer's weights and the batches' activations need to be on the device: a
`params["layer_loader"](i) -> layer params` may bring each layer in (from
host memory, or from disk) instead of stacked `params["layers"]`. After
each layer the collected quantizer state and the activations are saved;
a restart resumes after the last completed layer.

Checkpoint: `state.pt` (`torch.save` of CPU tensors in plain dicts, read
back with `weights_only=True`) and `meta.json` ({"next_layer", "total"}, as
JAX writes it); JAX's pickle of numpy arrays is not read.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..models import llama
from . import quantizer as Q


def _plain(state):
    """Quantizer states -> dicts of tensors (CPU) for `torch.save`."""
    if isinstance(state, Q.QuantizerState):
        amax = state.amax
        return {"__qs__": True, "amax": list(amax) if isinstance(amax, tuple) else amax,
                "seq": isinstance(amax, tuple), "pre_quant_scale": state.pre_quant_scale, "bias": state.bias}
    if isinstance(state, dict):
        return {k: _plain(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().cpu()
    if isinstance(state, list):
        return [_plain(v) for v in state]
    return state


def _unplain(d, device):
    if isinstance(d, dict) and d.get("__qs__"):
        amax = _unplain(d["amax"], device)
        return Q.QuantizerState(amax=tuple(amax) if d["seq"] else amax,
                                pre_quant_scale=_unplain(d["pre_quant_scale"], device),
                                bias=_unplain(d["bias"], device))
    if isinstance(d, dict):
        return {k: _unplain(v, device) for k, v in d.items()}
    if isinstance(d, list):
        return [_unplain(v, device) for v in d]
    if isinstance(d, torch.Tensor):
        return d.to(device)
    return d


def _init_layer_state(cfg: llama.LlamaConfig, layout: llama.QuantLayout, device) -> dict:
    shapes = llama._layer_shapes(cfg)
    state = {}
    for name in llama.PROJ_NAMES:
        wcfg, icfg = layout.get(f"{name}.weight"), layout.get(f"{name}.input")
        sub = {}
        if wcfg.enable:
            sub["weight"] = Q.init_state(wcfg, shapes[name], device)
        if icfg.enable:
            sub["input"] = Q.init_state(icfg, (1, 1, shapes[name][1]), device)
        if sub:
            state[name] = sub
    for name in llama.BMM_NAMES:
        bcfg = layout.get(name)
        if bcfg.enable:
            state[name] = Q.init_state(bcfg, (1, 1, cfg.num_key_value_heads, cfg.hd), device)
    return state


@torch.no_grad()
def layerwise_calibrate(model_cfg: llama.LlamaConfig, params: llama.Params, layout: llama.QuantLayout,
                        batches: list, checkpoint_dir: Optional[str] = None) -> llama.QuantState:
    """Max-calibrate every site, one layer at a time -> the stacked qstate
    (as `ptq.quantize`'s max pass gives it, bit for bit). Runs on the device
    of `params["embed_tokens"]`."""
    dev = params["embed_tokens"].device
    L = model_cfg.num_hidden_layers
    tokens_list = [torch.as_tensor(b).to(dev) for b in batches]
    start, acts, layer_states = 0, None, []
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        meta_p = os.path.join(checkpoint_dir, "meta.json")
        if os.path.exists(meta_p):
            with open(meta_p) as f:
                start = json.load(f)["next_layer"]
            saved = torch.load(os.path.join(checkpoint_dir, "state.pt"), weights_only=True)
            layer_states = _unplain(saved["layer_states"], dev)
            acts = _unplain(saved["acts"], dev)
    if acts is None:
        acts = [params["embed_tokens"][t].to(model_cfg.dtype) for t in tokens_list]
    loader = params.get("layer_loader")

    for i in range(start, L):
        lp = loader(i) if loader is not None else {k: v[i] for k, v in params["layers"].items()}
        lstate = _init_layer_state(model_cfg, layout, dev)
        new_acts = []
        for x in acts:
            B, T = x.shape[:2]
            positions = torch.arange(T, device=dev, dtype=torch.int32)[None, :].expand(B, T)
            x, lstate, _ = llama.decoder_layer(model_cfg, layout, True, x, lp, lstate, positions,
                                               llama.causal_mask(T, dev))
            new_acts.append(x)
        acts = new_acts
        layer_states.append(lstate)
        del lp
        if checkpoint_dir:
            torch.save({"layer_states": _plain(layer_states), "acts": _plain(acts)},
                       os.path.join(checkpoint_dir, "state.pt"))
            with open(os.path.join(checkpoint_dir, "meta.json"), "w") as f:
                json.dump({"next_layer": i + 1, "total": L}, f)

    qstate = llama.stack_states(layer_states)
    lw = layout.get("lm_head.weight")
    if lw.enable:
        head_w = params.get("lm_head", params["embed_tokens"])
        qstate["lm_head.weight"] = Q.collect(head_w, lw, Q.init_state(lw, tuple(head_w.shape), dev))
    return qstate
