"""Pipeline parallelism: a GPipe forward over a mesh axis (port of
`parallel/pipeline.py`).

The layer stack splits over the axis ("pipe"): stage s runs layers
[s L/P, (s + 1) L/P). The batch splits into M microbatches that stream
through the stages: at tick t stage s runs microbatch t - s, stage 0 embeds
its microbatch, and after each tick every stage's activations go one place
on along the ring (`mesh.ring_shift`, JAX's ppermute; what the last stage
sends to the first is never read). P + M - 1 ticks; the bubble is
(P - 1) / (P + M - 1). The last stage applies the final norm and the head
to each microbatch it finishes; its logits reach every rank through one SUM
(the others contribute zeros: JAX's psum). Embedding, norm and head
replicate. The quantized variant runs each layer through its layout and
calibrated state, as `llama.forward` does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import llama
from .mesh import Mesh, all_reduce, ring_shift


def pipeline_forward(cfg: llama.LlamaConfig, params: dict, tokens: torch.Tensor, mesh: Mesh, axis: str = "pipe",
                     num_microbatches: Optional[int] = None, layout: Optional[llama.QuantLayout] = None,
                     qstate: Optional[dict] = None) -> torch.Tensor:
    """Pipelined forward of tokens [B, T] (B divisible by the microbatch
    count, default the stage count) -> logits [B, T, V] f32, the same on
    every rank. `params` is the whole model's; each stage runs its own
    L / P layers of it."""
    lay = layout or llama.QuantLayout(sites=())
    P, stage = mesh.size(axis), mesh.index(axis)
    B, T = tokens.shape
    M = num_microbatches or P
    L = cfg.num_hidden_layers
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    if L % P:
        raise ValueError(f"{L} layers do not divide over {P} stages")
    mb, per = B // M, L // P
    dev = tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(mb, T)
    mask = llama.causal_mask(T, dev)
    layer_state = {k: v for k, v in (qstate or {}).items() if not k.startswith(llama.GLOBAL_SITES)} or None
    mine = range(stage * per, (stage + 1) * per)
    toks = tokens.reshape(M, mb, T)
    head_w = params.get("lm_head", params["embed_tokens"])
    out = torch.zeros((M, mb, T, cfg.vocab_size), dtype=torch.float32, device=dev)
    buf = torch.zeros((mb, T, cfg.hidden_size), dtype=cfg.dtype, device=dev)
    for t in range(M + P - 1):
        if stage == 0 and t < M:
            buf = params["embed_tokens"][toks[t]].to(cfg.dtype)
        idx = t - stage  # the microbatch this stage runs at tick t
        if 0 <= idx < M:
            h = buf
            for i in mine:
                lp = {k: v[i] for k, v in params["layers"].items()}
                h = llama.decoder_layer(cfg, lay, False, h, lp, llama.slice_state(layer_state, i), positions,
                                        mask)[0]
            if stage == P - 1:
                x = llama.norm(cfg, h, params["norm"])
                out[idx] = (x @ head_w.t().to(x.dtype)).float()
            buf = h
        buf = ring_shift(buf, mesh, axis)
    return all_reduce(out, mesh, axis, "sum").reshape(B, T, cfg.vocab_size)
