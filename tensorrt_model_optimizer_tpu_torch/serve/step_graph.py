"""CUDA-graph capture of the engine's fused decode steps: the counterpart of
the JAX engine's jitted, donated `decode_step` / `paged_decode_step`
dispatch (`serve/engine.py` `decode_step`).

A `StepGraph` holds one captured region: `unroll` chained greedy steps over
a cache that lives at fixed addresses and is updated in place (the port's
stand-in for JAX's buffer donation). Its first call runs the steps eagerly
on a side stream, which is that call's own result and warms every shape up
(a kernel's first launch loads its module; the GEMMs' split-K workspace,
`ops/cuda/qmm.py` `_workspace`, is per stream and reaches its final size
there), then captures the same steps on that stream. The graph holds the
workspaces it captured: a later shape that needs more room (another batch's
capture on the same stream, another engine's on a stream of the same
handle) swaps a larger one in, and the one this graph reads and writes
must not go back to the allocator while it can be replayed. Every later call
copies its inputs into the static input buffers, replays the graph and
returns a copy of the static output. A capture that fails raises: there is
no eager fallback on the card.

The kernel wrappers count their launches in Python (`launches` of each
`ops/cuda` module), which a replay does not run. The capture's own
increments (nothing launches while a stream captures) are taken back, and
each replay adds them again, so the counters count what the card ran.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.cuda import flash_gqa, kv_attention, paged_attention, qmm, qmm_wo, sparse_attention

_COUNTED = (qmm, qmm_wo, kv_attention, flash_gqa, paged_attention, sparse_attention)
_COUNTER_NAMES = ("launches", "route_launches", "prefill_route_launches")


def counters() -> dict:
    """Every kernel wrapper's launch count: (module, attribute, key or None)
    -> count."""
    out = {}
    for mod in _COUNTED:
        for attr in _COUNTER_NAMES:
            c = getattr(mod, attr, None)
            if isinstance(c, dict):
                out.update({(mod, attr, k): n for k, n in c.items()})
            elif c is not None:
                out[(mod, attr, None)] = c
    return out


def add_counts(delta: dict) -> None:
    """Add `delta` ((module, attribute, key) -> n, as `counters` gives) to
    the wrappers' launch counts."""
    for (mod, attr, key), n in delta.items():
        if not n:
            continue
        if key is None:
            setattr(mod, attr, getattr(mod, attr) + n)
        else:
            getattr(mod, attr)[key] += n


class StepGraph:
    """`fn(*inputs) -> tensor` captured once over static copies of `inputs`
    (tensors on the card). Construction runs `fn` eagerly on `stream` (the
    result is `first`), then captures it there."""

    def __init__(self, fn: Callable, inputs: tuple, stream: torch.cuda.Stream):
        self.static_in = tuple(t.clone() for t in inputs)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            first = fn(*self.static_in)
        before = counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            self.static_out = fn(*self.static_in)
        after = counters()
        self.scratch = list(qmm._workspace.values())  # kept alive while the graph is
        self.launches = {k: after[k] - before.get(k, 0) for k in after}
        add_counts({k: -n for k, n in self.launches.items()})
        torch.cuda.current_stream().wait_stream(stream)
        first.record_stream(torch.cuda.current_stream())  # handed to the caller's stream
        self.first = first

    def __call__(self, *inputs) -> torch.Tensor:
        for buf, t in zip(self.static_in, inputs):
            buf.copy_(t)
        self.graph.replay()
        add_counts(self.launches)
        return self.static_out.clone()


def tensor_key(*tensors) -> tuple:
    """What a captured graph's tensors are at: address, shape and dtype of
    each (None passes through), so that a graph is replayed only over the
    memory it captured."""
    return tuple(None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)
