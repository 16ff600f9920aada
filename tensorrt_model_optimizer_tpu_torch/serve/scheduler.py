"""Continuous batching: request scheduler over the paged-KV engine (port of
`serve/scheduler.py`).

Host-side: a fixed batch of slots; requests join free slots, take pages from
the free list, decode together each step, leave on EOS or max-tokens and
return their pages. Block table and lengths are edited as numpy arrays and
copied to the device once per `admit` / `retire`.

One deliberate difference from the JAX package: `submit` rejects a request
whose prompt plus `max_new_tokens` cannot fit `max_pages_per_seq` pages,
where JAX's `admit` caps the page count and the engine then clamps the
overflowing writes into the last page.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import paged_cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [T] int32
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    # filled by the scheduler
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class Scheduler:
    """Slot-based continuous batching with optional prefix caching."""

    def __init__(self, max_slots: int, n_pages: int, page_size: int, max_pages_per_seq: int,
                 prefix_cache: bool = False):
        self.max_slots = max_slots
        self.page_size = page_size
        self.free_pages = list(range(1, n_pages))  # page 0 = scratch for idle slots
        self.max_pages_per_seq = max_pages_per_seq
        self.slots: list[Optional[Request]] = [None] * max_slots
        self.slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self.pending: list[Request] = []
        # Prefix caching (shared prompt pages): chained keys (prev_key,
        # page_tokens) -> page id; pages are refcounted and return to the
        # free list when the last user releases them. A prompt page is
        # immutable once FULL (decode writes land past the prompt), so
        # sharing needs no copy-on-write.
        self.prefix_cache = prefix_cache
        self.page_refs: dict[int, int] = {}
        self.prefix_map: dict = {}
        self.page_key: dict[int, object] = {}

    def _page_keys(self, prompt):
        """Chained keys of the prompt's full pages, the last token's page
        left out (the tail always prefills fresh, so the first decode write
        targets a position of the slot's own)."""
        ps = self.page_size
        key = ()
        for pi in range((len(prompt) - 1) // ps):
            key = (key, tuple(int(t) for t in prompt[pi * ps:(pi + 1) * ps]))
            yield pi, key

    def _match_prefix(self, prompt) -> list[int]:
        """Longest run of already-cached full prompt pages."""
        matched = []
        if self.prefix_cache:
            for _, key in self._page_keys(prompt):
                page = self.prefix_map.get(key)
                if page is None:
                    break
                matched.append(page)
        return matched

    def register_prefix(self, slot: int):
        """Publish the slot's freshly prefilled full prompt pages into the
        prefix map (call after prefill)."""
        if not self.prefix_cache or self.slots[slot] is None:
            return
        for pi, key in self._page_keys(self.slots[slot].prompt):
            page = self.slot_pages[slot][pi]
            if key not in self.prefix_map:
                self.prefix_map[key] = page
                self.page_key[page] = key
                self.page_refs[page] = self.page_refs.get(page, 1)

    def _pages_needed(self, req: Request) -> int:
        return (len(req.prompt) + req.max_new_tokens + self.page_size - 1) // self.page_size + 1

    def submit(self, req: Request):
        if self._pages_needed(req) > self.max_pages_per_seq:
            raise ValueError(
                f"request {req.rid}: {len(req.prompt)} prompt + {req.max_new_tokens} new tokens need "
                f"{self._pages_needed(req)} pages of {self.page_size}, max_pages_per_seq is "
                f"{self.max_pages_per_seq}")
        self.pending.append(req)

    def _alloc_pages(self, n: int) -> Optional[list[int]]:
        if len(self.free_pages) < n:
            return None
        return [self.free_pages.pop() for _ in range(n)]

    def _free_slot(self, i: int):
        for p in self.slot_pages[i]:
            if p in self.page_refs:
                self.page_refs[p] -= 1
                if self.page_refs[p] <= 0:
                    del self.page_refs[p]
                    key = self.page_key.pop(p, None)
                    if key is not None:
                        self.prefix_map.pop(key, None)
                    self.free_pages.append(p)
            else:
                self.free_pages.append(p)
        self.slot_pages[i] = []
        self.slots[i] = None

    @staticmethod
    def _tables(cache: paged_cache.PagedKV):
        return cache.block_table.cpu().numpy().copy(), cache.seq_lens.cpu().numpy().copy()

    @staticmethod
    def _set_tables(cache: paged_cache.PagedKV, bt: np.ndarray, lens: np.ndarray):
        # in place: a captured paged decode step reads these tensors
        cache.block_table.copy_(torch.from_numpy(bt))
        cache.seq_lens.copy_(torch.from_numpy(lens))

    def admit(self, cache: paged_cache.PagedKV):
        """Place pending requests into free slots; returns the cache (its
        tables updated) and the list of (slot, request) admissions needing
        prefill. A slot that shares cached prefix pages starts at their
        length."""
        admissions = []
        bt, lens = self._tables(cache)
        for i in range(self.max_slots):
            if self.slots[i] is not None or not self.pending:
                continue
            req = self.pending.pop(0)
            need = self._pages_needed(req)
            shared = self._match_prefix(req.prompt)
            pages = self._alloc_pages(need - len(shared))
            if pages is None:
                self.pending.insert(0, req)
                break
            for p in shared:
                self.page_refs[p] = self.page_refs.get(p, 0) + 1
            all_pages = shared + pages
            # fresh pages that will hold full prompt chunks start refcounted
            if self.prefix_cache:
                full = (len(req.prompt) - 1) // self.page_size
                for p in all_pages[len(shared):full]:
                    self.page_refs[p] = self.page_refs.get(p, 0) + 1
            self.slots[i] = req
            self.slot_pages[i] = all_pages
            bt[i, :] = -1
            bt[i, : len(all_pages)] = all_pages
            lens[i] = len(shared) * self.page_size
            admissions.append((i, req))
        self._set_tables(cache, bt, lens)
        return cache, admissions

    def active_mask(self) -> np.ndarray:
        return np.asarray([s is not None and not s.done for s in self.slots])

    def retire(self, cache: paged_cache.PagedKV):
        """Free slots whose requests completed; retired slots point at the
        scratch page (page 0) so their idle writes cannot corrupt reused
        pages."""
        done = [i for i, req in enumerate(self.slots) if req is not None and req.done]
        if done:
            bt, lens = self._tables(cache)
            for i in done:
                self._free_slot(i)
                bt[i, :] = 0
                lens[i] = 0
            self._set_tables(cache, bt, lens)
        return cache

    def _record(self, req: Request, t: int):
        req.output.append(t)
        if (req.eos_token is not None and t == req.eos_token) or len(req.output) >= req.max_new_tokens:
            req.done = True

    def record_tokens(self, tokens: np.ndarray):
        """Append this step's token per active slot; mark completions."""
        for i, req in enumerate(self.slots):
            if req is not None and not req.done:
                self._record(req, int(tokens[i]))

    def record_token_block(self, tokens: np.ndarray):
        """Append an unroll block [B, U] per active slot (multi-step
        scheduling): tokens past EOS / max_new are overshoot and dropped; the
        admit-time reservation (prompt + max_new + 1 page) absorbs the cache
        overshoot as long as U <= page_size."""
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            for t in tokens[i]:
                self._record(req, int(t))
                if req.done:
                    break

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(s is not None and not s.done for s in self.slots)
