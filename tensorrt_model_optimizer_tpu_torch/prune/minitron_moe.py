"""Minitron expert pruning of the routed-MoE families (port of
`prune/minitron_moe.py`).

Expert importance is the mean routing probability over a calibration
capture (which experts the router uses); for the top-k-style routers
(Llama4's sigmoid, the softmax after the top-k) it is how often an expert is
selected. Each layer keeps its own top-`keep` experts, and every stacked
[L, E, ...] `moe.` leaf and the router rows gather them down, in their
order (routing among the kept experts is unchanged).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@torch.no_grad()
def expert_importance(cfg, params, batches, forward_fn=None, capture_tokens: int = 128) -> torch.Tensor:
    """Mean routing probability (or top-k usage) per (layer, expert):
    [L, E] f32, from the family forward's `moe_in` capture (the normed
    expert-block input) and the router weights."""
    from ..models import mixtral

    fwd = forward_fn or mixtral.forward
    dev = params["layers"]["moe.router"].device
    caps = [fwd(cfg, params, torch.as_tensor(b, device=dev), capture_tokens=capture_tokens)[2]["moe_in"]
            for b in batches]
    X = torch.cat(caps, dim=1).float()
    router = params["layers"]["moe.router"].float()  # [L, E, H]
    logits = torch.einsum("lnh,leh->lne", X, router)
    if cfg.router_bias:
        logits = logits + params["layers"]["moe.router__bias"][:, None, :]
    if cfg.router_sigmoid_input_scaled or cfg.router_softmax_after_topk:
        top = torch.topk(logits, cfg.top_k, dim=-1)[1]  # [L, n, k]
        onehot = torch.nn.functional.one_hot(top, cfg.num_experts).float()
        return torch.mean(torch.sum(onehot, dim=2), dim=1)
    return torch.mean(torch.softmax(logits, dim=-1), dim=1)


def prune_experts(cfg, params, keep: int, scores):
    """Keep each layer's `keep` most important experts. Returns (new_cfg,
    new_params); the given params are not written."""
    assert 1 <= keep <= cfg.num_experts
    L = cfg.num_hidden_layers
    s = scores.detach().float().cpu().numpy() if isinstance(scores, torch.Tensor) else np.asarray(scores)
    keep_idx = np.stack([np.sort(np.argsort(-s[i])[:keep]) for i in range(L)])  # [L, keep]
    layers = dict(params["layers"])
    for name, arr in list(layers.items()):
        if not name.startswith("moe."):
            continue
        idx = torch.from_numpy(keep_idx).to(arr.device)
        layers[name] = torch.stack([arr[i][idx[i]] for i in range(L)])
    new_params = dict(params)
    new_params["layers"] = layers
    new_cfg = dataclasses.replace(cfg, num_experts=keep, top_k=min(cfg.top_k, keep))
    return new_cfg, new_params


def prune_moe(cfg, params, batches, keep: int, forward_fn=None, capture_tokens: int = 128):
    """One-call Minitron expert pruning: score, then gather."""
    scores = expert_importance(cfg, params, batches, forward_fn, capture_tokens)
    return prune_experts(cfg, params, keep, scores)
