"""Device memory observability (port of `utils/memory.py`): the card's
allocator statistics (`torch.cuda.memory_stats`), a batch-size probe by
execution, and a peak tracker over a region."""

from __future__ import annotations

from typing import Optional

import torch


def device_memory_stats(device=None) -> dict:
    """One card's allocator statistics: JAX's keys "bytes_in_use",
    "peak_bytes_in_use" and "bytes_limit" (the card's total memory) beside
    `torch.cuda.memory_stats`' own; {} without a card."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device("cuda", torch.cuda.current_device()) if device is None else torch.device(device)
    st = dict(torch.cuda.memory_stats(dev))
    st["bytes_in_use"] = st.get("allocated_bytes.all.current", 0)
    st["peak_bytes_in_use"] = st.get("allocated_bytes.all.peak", 0)
    st["bytes_limit"] = torch.cuda.get_device_properties(dev).total_memory
    return st


def memory_summary() -> str:
    """One line a card: in use / peak / limit in GiB."""
    lines = []
    gib = 1024**3
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        st = device_memory_stats(f"cuda:{i}")
        lines.append(f"cuda:{i} in_use={st['bytes_in_use'] / gib:.2f}GiB peak={st['peak_bytes_in_use'] / gib:.2f}GiB "
                     f"limit={st['bytes_limit'] / gib:.2f}GiB")
    return "\n".join(lines)


def find_max_batch_size(try_fn, start: int = 1, ceiling: int = 1024) -> int:
    """The largest batch size in [1, ceiling] at which `try_fn(b)` runs
    without exhausting the card's memory (reference `dataset_utils.py:996`
    get_max_batch_size).

    `try_fn(b)` must run the real workload at batch b. Doubles from
    `start` until the first failure, then binary-searches the boundary. A
    probe fails on `torch.cuda.OutOfMemoryError`, after which the
    allocator's cache is emptied; every other error propagates. Raises
    `MemoryError` when batch 1 does not fit."""
    start = max(1, start)

    def ok(b: int) -> bool:
        try:
            try_fn(b)
            return True
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            return False

    if not ok(start):
        if start == 1 or not ok(1):
            raise MemoryError("workload does not fit at batch size 1")
        lo, hi = 1, start  # the caller's start was too optimistic
    else:
        b = start
        while b < ceiling:
            nb = min(2 * b, ceiling)
            if ok(nb):
                b = nb
            else:
                break
        if b == ceiling:
            return ceiling
        lo, hi = b, 2 * b
    while hi - lo > 1:  # invariant: ok(lo), not ok(hi)
        mid = (lo + hi) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo


class MemoryMonitor:
    """Peak and delta of the card's allocated bytes over a region (call
    `torch.cuda.reset_peak_memory_stats` first for a region's own peak)."""

    def __init__(self, device=None):
        self.device = device
        self.start: Optional[dict] = None
        self.end: Optional[dict] = None

    def __enter__(self):
        self.start = device_memory_stats(self.device)
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize(self.device)
        self.end = device_memory_stats(self.device)
        return False

    @property
    def peak_bytes(self) -> Optional[int]:
        return (self.end or {}).get("peak_bytes_in_use")

    @property
    def delta_bytes(self) -> Optional[int]:
        a = (self.start or {}).get("bytes_in_use")
        b = (self.end or {}).get("bytes_in_use")
        return (b - a) if (a is not None and b is not None) else None
