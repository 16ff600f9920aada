"""Accuracy probes: perplexity and logit divergence (port of
`utils/evaluate.py`).

`perplexity` is exp(mean next-token NLL) of any (fake-quant or plain) model
over token batches; `logit_divergence` the mean KL(plain || quantized) over
tokens, a data-efficient proxy for a format's accuracy delta.

At Llama-3.1-8B's vocabulary a [2, 2048] batch's f32 logits take 2.1 GB;
the log-softmax and the NLL run over slices of T (`T_SLICE` rows of a batch
at a time), so no whole-batch copy of the logits is made beside them. Each
batch's NLL sum is taken in f32 and added in f64, as JAX's `float(s)` does.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from ..models import llama

T_SLICE = 256  # rows of T whose [B, t, V] log-softmax is live at once


def _as_tokens(b, device) -> torch.Tensor:
    t = b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b))
    return t.to(device=device, dtype=torch.int64)


def _device(params) -> torch.device:
    return params["embed_tokens"].device


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sum over [B, T] of -log softmax(logits)[target], f32, in T slices."""
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    for s in range(0, logits.shape[1], T_SLICE):
        lp = torch.log_softmax(logits[:, s: s + T_SLICE].float(), dim=-1)
        total = total - torch.gather(lp, -1, targets[:, s: s + T_SLICE, None]).sum()
        del lp
    return total


@torch.no_grad()
def perplexity(model_cfg: llama.LlamaConfig, params: llama.Params, batches: Iterable,
               layout: Optional[llama.QuantLayout] = None, qstate: Optional[llama.QuantState] = None,
               adapters: Optional[dict] = None, forward_fn=None) -> float:
    """exp(mean next-token NLL) over the batches ([B, T] token arrays or
    tensors), on the device the params live on. `forward_fn(cfg, params,
    tokens, layout=, qstate=)` selects another family's forward (its first
    output the logits; adapters are llama-only)."""
    dev = _device(params)
    total, count = 0.0, 0
    for b in batches:
        tokens = _as_tokens(b, dev)
        if forward_fn is not None:
            logits = forward_fn(model_cfg, params, tokens[:, :-1], layout=layout, qstate=qstate)[0]
        else:
            logits = llama.forward(model_cfg, params, tokens[:, :-1], layout=layout, qstate=qstate,
                                   adapters=adapters)[0]
        total += float(_nll_sum(logits, tokens[:, 1:]))
        count += tokens[:, 1:].numel()
        del logits
    return float(np.exp(total / max(count, 1)))


def _kl_sum(ref: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Sum over [B, T] of KL(softmax(ref) || softmax(q)), f32, in T slices."""
    total = torch.zeros((), dtype=torch.float32, device=ref.device)
    for s in range(0, ref.shape[1], T_SLICE):
        lp = torch.log_softmax(ref[:, s: s + T_SLICE].float(), dim=-1)
        lq = torch.log_softmax(q[:, s: s + T_SLICE].float(), dim=-1)
        total = total + (torch.exp(lp) * (lp - lq)).sum()
        del lp, lq
    return total


@torch.no_grad()
def logit_divergence(model_cfg: llama.LlamaConfig, params: llama.Params, batches: Iterable,
                     layout: llama.QuantLayout, qstate: llama.QuantState) -> float:
    """Mean over batches of the mean over tokens of KL(plain || quantized)
    (JAX's: both forwards on the same params, the plain one unquantized)."""
    dev = _device(params)
    vals = []
    for b in batches:
        tokens = _as_tokens(b, dev)
        ref = llama.forward(model_cfg, params, tokens)[0]
        q = llama.forward(model_cfg, params, tokens, layout=layout, qstate=qstate)[0]
        vals.append(float(_kl_sum(ref, q)) / (tokens.shape[0] * tokens.shape[1]))
        del ref, q
    return float(np.mean(vals))
