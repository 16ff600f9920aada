"""Search algorithm base and solvers (port of `opt/searcher.py`; the JAX
module has no JAX in it, the port keeps its own copy).

`BaseSearcher` standardizes the before / run / after hooks and a
checkpointable search state; `binary_search` (FastNAS's channel search) and
`evolutionary_search` (AutoNAS) are the generic engines; the selection ILP
is `quant/auto.py`'s. Both searches draw from `np.random.default_rng(seed)`
in JAX's order, so from the same scores both packages visit the same
candidates and keep the same history.

One deliberate difference: JAX's `evolutionary_search` fills its first
population with `while len(pop) < population`, so under a constraint that
no sample meets it never returns. The port raises `ValueError` after
`MAX_DRAWS` samples in that loop; a search that fills its population in
fewer draws is JAX's, draw for draw.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional

import numpy as np

MAX_DRAWS = 100_000  # samples the first population may take before the constraint is judged unmeetable


@dataclasses.dataclass
class SearchState:
    best_config: Optional[dict] = None
    best_score: float = float("inf")
    history: list = dataclasses.field(default_factory=list)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"best_config": self.best_config, "best_score": self.best_score, "history": self.history}, f)

    @staticmethod
    def load(path: str) -> "SearchState":
        with open(path) as f:
            d = json.load(f)
        return SearchState(d["best_config"], d["best_score"], d["history"])


class BaseSearcher:
    """Subclass hooks: `run_search()` (and `before_search` / `after_search`);
    `search()` runs them and saves the state to `checkpoint`, from which a
    new searcher resumes."""

    def __init__(self, checkpoint: Optional[str] = None):
        self.checkpoint = checkpoint
        self.state = SearchState.load(checkpoint) if checkpoint and os.path.exists(checkpoint) else SearchState()

    def before_search(self):
        pass

    def after_search(self):
        pass

    def run_search(self):
        raise NotImplementedError

    def search(self) -> SearchState:
        self.before_search()
        self.run_search()
        self.after_search()
        if self.checkpoint:
            self.state.save(self.checkpoint)
        return self.state


def binary_search(lo: float, hi: float, feasible: Callable[[float], bool], steps: int = 10) -> float:
    """The largest x in [lo, hi] with feasible(x), assuming monotone
    feasibility (FastNAS's channel search)."""
    best = lo
    for _ in range(steps):
        mid = (lo + hi) / 2
        if feasible(mid):
            best, lo = mid, mid
        else:
            hi = mid
    return best


def evolutionary_search(sample: Callable[[np.random.Generator], dict],
                        mutate: Callable[[dict, np.random.Generator], dict], score: Callable[[dict], float],
                        satisfies: Callable[[dict], bool], iterations: int = 50, population: int = 16,
                        seed: int = 0) -> SearchState:
    """(mu + lambda)-style evolution (AutoNAS). Raises `ValueError` when
    MAX_DRAWS samples leave the first population unfilled (JAX loops)."""
    rng = np.random.default_rng(seed)
    state = SearchState()
    pop: list[tuple[float, dict]] = []
    draws = 0
    while len(pop) < population:
        if draws == MAX_DRAWS:
            raise ValueError(f"evolutionary_search: {draws} samples met the constraint {len(pop)} times, short of a "
                             f"population of {population}; no sample may meet it")
        c = sample(rng)
        draws += 1
        if satisfies(c):
            pop.append((score(c), c))
    pop.sort(key=lambda t: t[0])
    for it in range(iterations):
        parent = pop[rng.integers(0, max(len(pop) // 2, 1))][1]
        child = mutate(dict(parent), rng)
        if not satisfies(child):
            continue
        s = score(child)
        state.history.append({"iter": it, "score": s})
        pop.append((s, child))
        pop.sort(key=lambda t: t[0])
        pop = pop[:population]
    state.best_score, state.best_config = pop[0]
    return state
