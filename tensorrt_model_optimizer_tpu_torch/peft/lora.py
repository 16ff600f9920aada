"""LoRA adapters and QLoRA (port of `peft/lora.py`).

Adapters are a tree of their own, {proj_name: {"A" [L, r, d_in], "B" [L,
d_out, r], "scale" [L]}}, that `llama.forward(adapters=...)` adds to each
projection; `init_adapters` creates it (A ~ N(0, 1/r), B = 0: the adapter
starts as the identity), `merge` folds B @ A into the base weights. QLoRA
is the same adapter training over a quantized base: pass a layout and its
quantizer state, and the base forward runs fake-quantized. The step trains
the adapters only (every tensor of their tree, `scale` included, as JAX's
`value_and_grad` over the tree does).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .. import resolve_device
from ..models import llama
from ..quant import qat as qat_mod
from ..utils.tree import map_pairs


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: tuple[str, ...] = llama.PROJ_NAMES  # the projections that get adapters


def init_adapters(cfg: llama.LlamaConfig, lcfg: LoRAConfig, generator: torch.Generator, device=None) -> dict:
    """A ~ N(0, 1/r) in the model's dtype, drawn from `generator` (on
    `device`) target by target; B = 0; scale = alpha / r in f32."""
    dev = resolve_device(device)
    shapes = llama._layer_shapes(cfg)
    L, r = cfg.num_hidden_layers, lcfg.rank
    out = {}
    for name in lcfg.targets:
        o, inp = shapes[name]
        a = torch.randn((L, r, inp), generator=generator, dtype=torch.float32, device=dev) / math.sqrt(r)
        out[name] = {"A": a.to(cfg.dtype), "B": torch.zeros((L, o, r), dtype=cfg.dtype, device=dev),
                     "scale": torch.full((L,), lcfg.alpha / r, dtype=torch.float32, device=dev)}
    return out


@torch.no_grad()
def merge(params: dict, adapters: dict) -> dict:
    """The base weights with each adapter folded in, W + scale * B @ A, in
    f32 then the weight's dtype (the disable-by-merge export)."""
    new_layers = dict(params["layers"])
    for name, ad in adapters.items():
        delta = torch.einsum("lor,lri->loi", ad["B"].float(), ad["A"].float())
        w = new_layers[name]
        new_layers[name] = (w.float() + delta * ad["scale"].float()[:, None, None]).to(w.dtype)
    return {**params, "layers": new_layers}


def make_lora_train_step(cfg: llama.LlamaConfig, lr: float = 1e-3, layout: Optional[llama.QuantLayout] = None):
    """step(adapters, params, tokens, qstate=None) -> (adapters, loss): an
    SGD step of the adapters (the base and its quantizer state frozen);
    with `layout` the base runs fake-quantized (QLoRA)."""
    tcfg = qat_mod.train_cfg(cfg)

    def loss_fn(adapters, params, qstate, tokens):
        logits = llama.forward(tcfg, params, tokens[:, :-1], layout=layout, qstate=qstate, adapters=adapters)[0]
        return qat_mod.cross_entropy(logits, tokens[:, 1:])

    def step(adapters, params, tokens, qstate=None):
        loss, grads = qat_mod.value_and_grad(lambda a: loss_fn(a, params, qstate, tokens), adapters)
        with torch.no_grad():
            new = map_pairs(lambda a, g: a.detach() - lr * g.to(a.dtype), adapters, grads)
        return new, loss

    return step
