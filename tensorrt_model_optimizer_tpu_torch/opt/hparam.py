"""Searchable hyperparameters (port of `opt/hparam.py`; the JAX module has
no JAX in it, the port keeps its own copy).

An Hparam is a named choice point (channel count, format, depth) with an
active value and an optional importance order: the unit that the NAS and
AutoQuantize search spaces are built from. A `SearchSpace` is a dict of
Hparams whose product enumerates the candidate configurations; `sample`
draws with a numpy Generator, as JAX's, so that both packages visit the
same candidates from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence


@dataclasses.dataclass
class Hparam:
    name: str
    choices: tuple
    active: Any = None
    # importance[i] ranks slot i (higher = kept first) for slice-style
    # hparams (channel pruning); None = order-free choices (formats)
    importance: Optional[Sequence[float]] = None

    def __post_init__(self):
        self.choices = tuple(self.choices)
        if self.active is None:
            self.active = max(self.choices) if _all_numeric(self.choices) else self.choices[0]
        if self.active not in self.choices:
            raise ValueError(f"{self.name}: active {self.active!r} not in choices")

    @property
    def is_configurable(self) -> bool:
        return len(self.choices) > 1

    def set_active(self, value) -> "Hparam":
        if value not in self.choices:
            raise ValueError(f"{self.name}: {value!r} not in {self.choices}")
        return dataclasses.replace(self, active=value)

    def top_slots(self, n: int) -> list[int]:
        """Indices of the n most important slots (slice order)."""
        if self.importance is None:
            return list(range(n))
        order = sorted(range(len(self.importance)), key=lambda i: -self.importance[i])
        return sorted(order[:n])


def _all_numeric(xs) -> bool:
    return all(isinstance(x, (int, float)) for x in xs)


class SearchSpace:
    """A named collection of Hparams (the reference's DynamicSpace)."""

    def __init__(self, hparams: dict[str, Hparam]):
        self.hparams = dict(hparams)

    def config(self) -> dict[str, Any]:
        return {k: h.active for k, h in self.hparams.items()}

    def set_config(self, config: dict[str, Any]) -> "SearchSpace":
        return SearchSpace({k: (h.set_active(config[k]) if k in config else h) for k, h in self.hparams.items()})

    def sample(self, rng) -> dict[str, Any]:
        return {k: h.choices[rng.integers(0, len(h.choices))] for k, h in self.hparams.items()}

    def size(self) -> int:
        n = 1
        for h in self.hparams.values():
            n *= len(h.choices)
        return n
