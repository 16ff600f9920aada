"""Timers and device memory reporting (port of `utils/perf.py`)."""

from __future__ import annotations

import contextlib
import time

import torch

from . import memory


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Accumulating named wall-clock timer; a region starts and ends with
    the card synchronized, so its time covers the work it queued."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        """`block_on` is accepted for JAX's signature; the card is
        synchronized whatever it holds."""
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(
            f"{k:32s} {self.totals[k] * 1e3:10.2f} ms total  {self.totals[k] / self.counts[k] * 1e3:8.2f} ms/call "
            f"x{self.counts[k]}" for k in sorted(self.totals))


def device_memory_stats(device=None) -> dict:
    """Live / peak / limit bytes of the card (None without one)."""
    st = memory.device_memory_stats(device)
    return {k: st.get(k) for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}


def tree_bytes(tree) -> int:
    """Total bytes of the tensors of a nested dict / list / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0
