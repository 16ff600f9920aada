"""AutoNAS and FastNAS: convert -> search -> export over Llama width / depth
subnets (port of `nas/autonas.py`: the `mtn.convert / search / profile`
surface).

The model becomes a SearchSpace of Hparams (each layer's FFN width, the
depth); a candidate subnet is materialized by importance-ordered slicing
(Minitron's scores), scored by its calibration loss (`qat.qat_loss` with no
quantizer sites) and searched by evolution under a parameter budget
(`search`), or cut by a binary search on a uniform FFN ratio under a loss
budget (`fastnas_prune`). `convert_traced` builds the search space of any
model from its traced forward (`trace.trace_dim_groups`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..models import llama
from ..opt.hparam import Hparam, SearchSpace
from ..opt.searcher import binary_search, evolutionary_search
from ..prune import minitron
from ..quant import qat


def profile(cfg: llama.LlamaConfig, seq_len: int = 1) -> dict:
    """Parameters and decode FLOPs a token of a config (`mtn.profile`)."""
    sh = llama._layer_shapes(cfg)
    layer_params = sum(o * i for o, i in sh.values()) + 2 * cfg.hidden_size
    total = layer_params * cfg.num_hidden_layers + 2 * cfg.vocab_size * cfg.hidden_size + cfg.hidden_size
    flops = (2 * layer_params * cfg.num_hidden_layers * seq_len
             + 2 * cfg.vocab_size * cfg.hidden_size * seq_len)
    return {"params": int(total), "flops_per_token": int(flops)}


def convert(cfg: llama.LlamaConfig, ffn_ratios=(0.5, 0.75, 1.0),
            depth_choices: Optional[tuple[int, ...]] = None) -> SearchSpace:
    """The search space (`mtn.convert`): each layer's FFN width at the
    ratios (multiples of 8), and the depth (full or half)."""
    hparams = {}
    base_I = cfg.intermediate_size
    for i in range(cfg.num_hidden_layers):
        hparams[f"layers.{i}.ffn"] = Hparam(
            f"layers.{i}.ffn", choices=tuple(sorted({max(int(base_I * r) // 8 * 8, 8) for r in ffn_ratios})))
    depths = depth_choices or tuple(sorted({cfg.num_hidden_layers, max(cfg.num_hidden_layers // 2, 1)}))
    hparams["depth"] = Hparam("depth", choices=depths)
    return SearchSpace(hparams)


def materialize(cfg: llama.LlamaConfig, params: llama.Params, scores: minitron.ImportanceScores,
                config: dict) -> tuple[llama.LlamaConfig, llama.Params]:
    """Slice the subnet a search-space config describes. The kept layers'
    FFN widths differ, so each is padded to the widest with zero channels
    (exact no-ops: silu(0) * 0 and zero down-proj columns)."""
    depth = config["depth"]
    keep_layers = np.sort(np.argsort(-scores.layer)[:depth])
    widths = [config[f"layers.{i}.ffn"] for i in keep_layers]
    max_w = max(widths)

    lay = params["layers"]
    dev = params["embed_tokens"].device
    kl = torch.from_numpy(np.asarray(keep_layers, np.int64)).to(dev)
    new_layers = {k: v[kl] for k, v in lay.items()}
    gate, up, down = new_layers["mlp.gate_proj"], new_layers["mlp.up_proj"], new_layers["mlp.down_proj"]
    g_out = torch.zeros((depth, max_w, cfg.hidden_size), dtype=gate.dtype, device=dev)
    u_out = torch.zeros_like(g_out)
    d_out = torch.zeros((depth, cfg.hidden_size, max_w), dtype=down.dtype, device=dev)
    for j, (li, w) in enumerate(zip(keep_layers, widths)):
        keep = torch.from_numpy(np.sort(np.argsort(-scores.ffn[li])[:w]).astype(np.int64)).to(dev)
        g_out[j, :w] = gate[j][keep]
        u_out[j, :w] = up[j][keep]
        d_out[j, :, :w] = down[j][:, keep]
    new_layers["mlp.gate_proj"], new_layers["mlp.up_proj"], new_layers["mlp.down_proj"] = g_out, u_out, d_out

    new_params = dict(params)
    new_params["layers"] = new_layers
    new_cfg = dataclasses.replace(cfg, num_hidden_layers=depth, intermediate_size=max_w, head_dim=cfg.hd)
    return new_cfg, new_params


def subnet_params(cfg: llama.LlamaConfig, config: dict) -> int:
    """Parameter count of a subnet config (a cheap constraint). As JAX's:
    the attention of `depth` layers and the `depth` widest FFNs."""
    sh = llama._layer_shapes(cfg)
    attn = sum(o * i for n, (o, i) in sh.items() if n.startswith("self_attn"))
    depth = config["depth"]
    widths = sorted((config[f"layers.{i}.ffn"] for i in range(len(config) - 1)), reverse=True)[:depth]
    ffn = sum(3 * w * cfg.hidden_size for w in widths)
    return attn * depth + ffn + 2 * cfg.vocab_size * cfg.hidden_size


@torch.no_grad()
def _loss(cfg, params, batches) -> float:
    """The summed calibration loss over the first two batches."""
    return sum(float(qat.qat_loss(cfg, llama.QuantLayout(sites=()), params, None, b)) for b in batches[:2])


def search(cfg: llama.LlamaConfig, params: llama.Params, space: SearchSpace, batches: list,
           param_budget_ratio: float = 0.8, iterations: int = 20, seed: int = 0):
    """Evolutionary subnet search under a parameter budget (`mtn.search`).
    Returns (SearchState, best cfg, best params)."""
    scores = minitron.importance(cfg, params, batches, capture_tokens=32)
    budget = param_budget_ratio * profile(cfg)["params"]

    def score_fn(config) -> float:
        return _loss(*materialize(cfg, params, scores, config), batches)

    def mutate(c, rng):
        keys = list(space.hparams)
        k = keys[rng.integers(0, len(keys))]
        c[k] = space.hparams[k].choices[rng.integers(0, len(space.hparams[k].choices))]
        return c

    state = evolutionary_search(space.sample, mutate, score_fn, satisfies=lambda c: subnet_params(cfg, c) <= budget,
                                iterations=iterations, population=6, seed=seed)
    best_cfg, best_params = materialize(cfg, params, scores, state.best_config)
    return state, best_cfg, best_params


def fastnas_prune(cfg: llama.LlamaConfig, params: llama.Params, batches: list, max_loss_increase: float = 0.05,
                  steps: int = 6):
    """FastNAS's binary search: the smallest uniform FFN ratio whose
    calibration loss stays within (1 + max_loss_increase) of the full
    model's. Returns (cfg, params, ratio) of the cut model."""
    scores = minitron.importance(cfg, params, batches, capture_tokens=32)
    base_loss = _loss(cfg, params, batches)

    def uniform(ratio: float) -> dict:
        w = max(int(cfg.intermediate_size * ratio) // 8 * 8, 8)
        return {**{f"layers.{i}.ffn": w for i in range(cfg.num_hidden_layers)}, "depth": cfg.num_hidden_layers}

    def feasible(ratio: float) -> bool:
        return _loss(*materialize(cfg, params, scores, uniform(ratio)), batches) <= base_loss * (1 + max_loss_increase)

    # binary_search finds the largest feasible x: search on the cut (1 - ratio)
    ratio = 1.0 - binary_search(0.0, 0.9, lambda cut: feasible(1.0 - cut), steps=steps)
    return materialize(cfg, params, scores, uniform(ratio)) + (ratio,)


def convert_traced(forward_fn, params: dict, cfg, *, width_ratios=(0.5, 0.75, 1.0),
                   min_width: int = 8) -> SearchSpace:
    """The search space from a traced forward (`trace.trace_dim_groups`
    over the aten graph of `forward_fn(params, tokens)`, any model): every
    multi-site dimension group becomes a width Hparam (ratio-scaled,
    `min_width`-aligned sizes and the full size), every `depth` group a
    depth Hparam over 1..L; groups that touch the embedding or the head
    are skipped (not prunable widths). JAX's names and choices."""
    from ..trace import trace_dim_groups

    res = trace_dim_groups(forward_fn, params, cfg)
    hparams = {}
    for g in res["groups"]:
        if g.name == "depth":  # one depth hparam a scanned stack
            key = f"depth.{g.sites[0][0].split('/')[0]}"
            hparams[key] = Hparam(key, choices=tuple(range(1, g.size + 1)))
            continue
        if any(s[0] in ("embed_tokens", "lm_head") for s in g.sites) or len(g.sites) < 2:
            continue
        align = min(min_width, g.size)
        choices = tuple(sorted({min(max(int(g.size * r) // align * align, align), g.size)
                                for r in width_ratios} | {g.size}))
        key = f"width.{g.name}"
        hparams[key] = Hparam(key, choices=choices)
    return SearchSpace(hparams=hparams)
