"""Model-level N:M sparsification (port of `sparsity/sparsify.py`: the
`mts.sparsify` / `mts.export` surface).

`sparsify` returns (params with the masked weights, masks {projection:
bool [L, O, K]}), by magnitude or by SparseGPT; `reapply` re-projects
weights onto their masks after a training step (QAT, distillation);
`export` folds the masks for good.

SparseGPT's Hessians come from one forward of the dense model per
calibration batch (every layer's inputs at once, not layer by layer, as
JAX's), the first `capture_tokens` tokens of each batch (`llama.forward`'s
captures, `quant.ptq.CAPTURE_GROUPS`). Each layer's projections that share
an input are pruned as one stacked weight (rows are independent), a layer
at a time, so one Hessian is live at once (at the 8B down_proj, 14336^2 f32:
0.82 GB).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..models import llama
from ..quant.ptq import CAPTURE_GROUPS
from . import magnitude, sparsegpt


def _captures(model_cfg, params, batches, capture_tokens: int) -> dict:
    """{capture key: [L, n_tok, K]} over the batches, concatenated in order."""
    caps = None
    for b in batches:
        more = llama.forward(model_cfg, params, b, capture_tokens=capture_tokens)[3]
        caps = more if caps is None else {k: torch.cat([caps[k], more[k]], dim=1) for k in caps}
    return caps


@torch.no_grad()
def sparsify(model_cfg: llama.LlamaConfig, params: llama.Params, method: str = "magnitude",
             pattern: tuple[int, int] = (2, 4), calib_batches: Optional[Iterable[torch.Tensor]] = None,
             capture_tokens: int = 128) -> tuple[llama.Params, dict]:
    """N:M-sparsify every projection ("magnitude" | "sparsegpt"). Returns
    (new_params, masks); the given params are not written."""
    n, m = pattern
    layers = params["layers"]
    new_layers = dict(layers)
    masks = {}
    if method == "magnitude":
        for name in llama.PROJ_NAMES:
            masks[name] = magnitude.nm_mask(layers[name], n, m)
            new_layers[name] = magnitude.apply_mask(layers[name], masks[name])
    elif method == "sparsegpt":
        if calib_batches is None:
            raise ValueError("sparsegpt requires calib_batches")
        caps = _captures(model_cfg, params, list(calib_batches), capture_tokens)
        for cap_key, members in CAPTURE_GROUPS.items():
            rows = [layers[name].shape[1] for name in members]
            outs = {name: [] for name in members}
            keeps = {name: [] for name in members}
            for li in range(model_cfg.num_hidden_layers):
                H = sparsegpt.hessian_from_acts(caps[cap_key][li])
                w, mask = sparsegpt.sparsegpt_prune(torch.cat([layers[name][li] for name in members]), H, n, m)
                del H
                for name, wp, mp in zip(members, torch.split(w, rows), torch.split(mask, rows)):
                    outs[name].append(wp)
                    keeps[name].append(mp)
            for name in members:
                new_layers[name], masks[name] = torch.stack(outs[name]), torch.stack(keeps[name])
        del caps
    else:
        raise ValueError(f"unknown sparsity method {method!r}")
    out = dict(params)
    out["layers"] = new_layers
    return out, masks


@torch.no_grad()
def reapply(params: llama.Params, masks: dict) -> llama.Params:
    """Re-project weights onto their masks (after a QAT / finetune step)."""
    new_layers = dict(params["layers"])
    for name, mask in masks.items():
        new_layers[name] = magnitude.apply_mask(new_layers[name], mask)
    out = dict(params)
    out["layers"] = new_layers
    return out


def export(params: llama.Params, masks: dict) -> llama.Params:
    """Fold the masks for good (`mts.export`)."""
    return reapply(params, masks)
