"""Per-op latency profiling (port of `serve/profiling.py`, the reference's
`modelopt/torch/_deploy/profiling.py:28,111`).

`get_latency` is the end-to-end decode-step latency: each step is one call
of `Engine.decode_step` (one CUDA-graph replay on the card), timed on the
host clock around work that ends in a synchronisation. `profile_matmuls`
times each projection's quantized matmul (`engine._qlinear`) alone, at one
layer's shapes: where the decode milliseconds go, per layer type. The keys
are the JAX package's.
"""

from __future__ import annotations

import time

import torch

from ..models import llama
from ..quant.compress import layer_arrays
from . import engine as engine_mod


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, device: torch.device, iters: int = 8) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


@torch.inference_mode()
def profile_matmuls(eng: "engine_mod.Engine", batch: int = 8, iters: int = 8) -> dict:
    """Per-projection matmul latency (one layer each) on the engine's
    kernels: {name: {"kind", "shape": [out, in], "us", "us_per_model"}}."""
    cm = eng.cm
    cfg = cm.model_cfg
    shapes = llama._layer_shapes(cfg)
    out = {}
    for name in llama.PROJ_NAMES:
        o, k = shapes[name]
        arrays = layer_arrays(cm.params["layers"][name], 0)
        kind = cm.kinds.get(name, "bf16")
        x = torch.ones((batch, k), dtype=cfg.dtype, device=eng.device)
        ist = llama.slice_state((cm.qstate or {}).get(name, {}).get("input"), 0)
        dt = _time_fn(lambda: engine_mod._qlinear(x, name, kind, arrays, cm, ist, eng._ops), eng.device, iters)
        out[name] = {
            "kind": kind,
            "shape": [o, k],
            "us": round(dt * 1e6, 1),
            "us_per_model": round(dt * 1e6 * cfg.num_hidden_layers, 1),
        }
    return out


def get_latency(eng: "engine_mod.Engine", batch: int = 8, prefill: int = 128, steps: int = 8) -> dict:
    """End-to-end decode-step latency at `prefill` cached rows (an empty
    cache with pos set there, as JAX's) and the tokens/s it gives:
    {"step_ms", "tok_s", "batch"}. The first step (the graph's capture on
    the card) is left out of the timing."""
    cache = eng.init_cache(batch, prefill + steps + 8)
    cache["pos"].fill_(prefill)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=eng.device)
    tok, cache = eng.decode_step(tok, cache)
    _sync(eng.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, cache = eng.decode_step(tok, cache)
    _sync(eng.device)
    dt = (time.perf_counter() - t0) / steps
    return {
        "step_ms": round(dt * 1e3, 3),
        "tok_s": round(batch / dt, 1),
        "batch": batch,
    }
