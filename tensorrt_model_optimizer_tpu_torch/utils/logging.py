"""Logging helpers (port of `utils/logging.py`): `print_rank_0` prints on
rank 0 of a `torch.distributed` group (any process when none is set up);
`atomic_print` makes one write a call under a lock."""

from __future__ import annotations

import sys
import threading

import torch

_lock = threading.Lock()


def rank() -> int:
    """This process's `torch.distributed` rank, 0 where none is set up."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def print_rank_0(*args, **kw) -> None:
    """Print on rank 0 only."""
    if rank() == 0:
        print(*args, **kw)


def atomic_print(*args, flush: bool = True, **kw) -> None:
    """Serialize prints across threads (one write a call)."""
    with _lock:
        sys.stdout.write(" ".join(str(a) for a in args) + kw.get("end", "\n"))
        if flush:
            sys.stdout.flush()
