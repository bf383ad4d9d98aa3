"""Page-table and free-list bookkeeping for the paged KV pool — the part of
`paddle_tpu/inference/cache.py::PagedKVCache` the fused engine uses without
a prefix cache.  Host-side numpy, no device work.

Without a prefix cache no page is shared, so a page is either free or
owned by exactly one slot.  Refcounts, the prefix trie, the rolling-hash
index, the host tier and the page store arrive with later slices.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

NULL_PAGE = 0


class PagedKVCache:
    """Free list + page tables for `num_slots` slots over `num_pages` pages
    of `page_size` tokens (page 0 reserved as the null page)."""

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 max_pages_per_slot: int):
        if page_size & (page_size - 1):
            raise ValueError(f"page_size must be a power of 2, got {page_size}")
        if num_pages < 2:
            raise ValueError("need at least one real page beyond the null page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_pages_per_slot = max_pages_per_slot
        # ascending allocation order: pop() hands out the lowest page first
        self._free = list(range(num_pages - 1, 0, -1))
        self.page_table = np.full((num_slots, max_pages_per_slot), NULL_PAGE,
                                  np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self._used: Dict[int, List[int]] = {s: [] for s in range(num_slots)}

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

    def token_capacity(self) -> int:
        """Pool capacity in tokens (the null page excluded)."""
        return (self.num_pages - 1) * self.page_size

    def allocate(self, slot: int, total_tokens: int) -> np.ndarray:
        """Reserve ceil(total_tokens / page_size) pages for `slot` and write
        them into its table row.  Returns the row (a view).  Raises
        ValueError past the slot capacity and RuntimeError when the pool is
        short (the caller waits for pages to free up)."""
        n = self.pages_needed(total_tokens)
        if n > self.max_pages_per_slot:
            raise ValueError(
                f"request footprint {total_tokens} tokens exceeds slot "
                f"capacity {self.max_pages_per_slot * self.page_size}")
        if self._used[slot]:
            raise RuntimeError(f"slot {slot} already has pages")
        if n > len(self._free):
            raise RuntimeError(f"out of KV pages: need {n}, "
                               f"free {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._used[slot] = pages
        self.page_table[slot, :] = NULL_PAGE
        self.page_table[slot, :n] = pages
        return self.page_table[slot]

    def release(self, slot: int) -> None:
        """Retire a slot: its pages go back to the free list."""
        self._free.extend(reversed(self._used[slot]))
        self._used[slot] = []
        self.page_table[slot, :] = NULL_PAGE
        self.lengths[slot] = 0

    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def check_invariants(self) -> None:
        """Raise AssertionError unless every real page is exactly one of
        {free, owned by one slot}, the null page is neither, and each table
        row lists exactly its slot's pages."""
        used = [p for pages in self._used.values() for p in pages]
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page on the free list")
        if len(set(used)) != len(used):
            raise AssertionError("page owned by two slots")
        if free & set(used):
            raise AssertionError("page both free and in use")
        if free | set(used) != set(range(1, self.num_pages)):
            raise AssertionError("page leaked out of the free/in-use "
                                 "partition (or the null page entered it)")
        for slot, pages in self._used.items():
            row = self.page_table[slot]
            if list(row[:len(pages)]) != pages or \
                    (row[len(pages):] != NULL_PAGE).any():
                raise AssertionError(f"slot {slot} table row {row.tolist()} "
                                     f"!= its pages {pages}")
