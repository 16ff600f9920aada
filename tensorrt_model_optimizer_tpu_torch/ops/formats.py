"""Quantization format descriptors (port of `ops/formats.py`).

A format is an integer width (`num_bits: int`) or a float (E, M) pair
(`num_bits: (E, M)`), optionally block-scaled with its own scale format.
Pure Python: no tensors here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

NumBits = Union[int, tuple[int, int]]


def fp_max_representable(ebits: int, mbits: int) -> float:
    """Largest finite magnitude of an (E, M) mini-float: E5M2 is IEEE-like
    (57344), E4M3 is the OFP8 "fn" variant (448), and the MX element formats
    have no inf/nan (E2M1 -> 6, E3M2 -> 28, E2M3 -> 7.5)."""
    bias = 2 ** (ebits - 1) - 1
    if (ebits, mbits) == (5, 2):
        return float((2 - 2.0 ** (-mbits)) * 2 ** (2**ebits - 2 - bias))
    if (ebits, mbits) == (4, 3):
        return float((2 - 2.0 ** (1 - mbits)) * 2 ** (2**ebits - 1 - bias))
    if ebits == 8 and mbits == 0:
        return float(2.0 ** (255 - 127))
    emax = 2**ebits - 1 - bias
    return float((2 - 2.0 ** (-mbits) if mbits > 0 else 1.0) * 2**emax)


def fp_emax(ebits: int, mbits: int) -> int:
    """Exponent of the largest representable power of two (OCP MX `emax`)."""
    return int(math.floor(math.log2(fp_max_representable(ebits, mbits))))


def int_max_bound(num_bits: int, unsigned: bool = False, narrow_range: bool = False) -> int:
    if unsigned:
        return 2**num_bits - 1
    return 2 ** (num_bits - 1) - 1


def int_min_bound(num_bits: int, unsigned: bool = False, narrow_range: bool = False) -> int:
    if unsigned:
        return 0
    b = 2 ** (num_bits - 1) - 1
    return -b if narrow_range else -(b + 1)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Block-quantization layout: block sizes per axis plus scale format."""

    sizes: tuple[tuple[int, int], ...]  # ((axis, block_size), ...)
    scale_bits: Optional[NumBits] = None
    scale_block_sizes: Optional[tuple[tuple[int, int], ...]] = None
    dynamic: bool = False

    @staticmethod
    def from_dict(d: dict) -> "BlockSpec":
        sizes = tuple(sorted((int(k), int(v)) for k, v in d.items() if isinstance(k, int)))
        sb = d.get("scale_bits")
        if isinstance(sb, list):
            sb = tuple(sb)
        sbs = d.get("scale_block_sizes")
        if sbs is not None:
            sbs = tuple(sorted((int(k), int(v)) for k, v in sbs.items()))
        return BlockSpec(
            sizes=sizes,
            scale_bits=sb,
            scale_block_sizes=sbs,
            dynamic=bool(d.get("type") == "dynamic" or d.get("dynamic", False)),
        )


E4M3 = (4, 3)
E5M2 = (5, 2)
E2M1 = (2, 1)
E3M2 = (3, 2)
E2M3 = (2, 3)
E8M0 = (8, 0)
