"""Page-table, free-list and prefix-index bookkeeping for the paged KV pool —
port of `paddle_tpu/inference/cache.py::PagedKVCache` without its KV tier.
Host-side numpy, no device work.

Page 0 is the null page: unreserved table entries point at it, inactive
slots write to it, and attention masking by length keeps it from being read.

Prefix cache (copy-on-write page sharing, as in vLLM): prompt pages whose KV
is complete are registered in a trie-shaped index keyed by (parent node,
token bytes), i.e. by the token content of the whole prefix up to that
page.  A later prompt sharing a page-aligned prefix maps the cached pages
read-only into its table row (refcount + 1) and prefills only the tail; a
matched partial final page is shared copy-on-write: the caller copies the
page on the device into a fresh page the new slot owns before appending to
it.  A page is freed only when its refcount returns to 0; registered pages
at refcount 0 park in an LRU of evictable prefixes and are reclaimed on
demand, so cached prefixes never deadlock the pool.

Beside the trie, every registered page indexes the prefixes of its token
content under a polynomial rolling hash, so a prompt sharing only part of
any cached page copies the matched fraction and prefills the rest.  Every
hash hit is verified against the node's token bytes before use.

Every real page is exactly one of free, in use (refcount > 0), or parked in
the LRU; every index node lives on the device (the reference's host and
disk tier and its restore plans belong to a later slice of the port).

Optimistic admission grows a slot token-granularly (`grow`); a preemption
that swaps its victim's KV to the host records the obligation in a fourth,
host-side partition (`note_swap_out`/`note_swap_in`, keyed by request id),
which `check_invariants` holds too.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

NULL_PAGE = 0


@dataclasses.dataclass
class _PrefixNode:
    """One cached page of prompt KV: `page` holds the KV of `n_tokens`
    tokens whose identity (and that of the whole preceding prefix) is pinned
    by `key = (parent node id, token bytes)`.  n_tokens == page_size for a
    full page; fewer marks a partial page, shareable only by COW.
    `partial_keys` are the rolling-hash entries this node registered,
    removed with the node so the index cannot dangle."""
    node_id: int
    key: Tuple[int, bytes]
    page: int
    n_tokens: int
    partial_keys: List[Tuple[int, int, int]] = \
        dataclasses.field(default_factory=list)


_ROOT = 0   # parent id of first-page nodes

# polynomial rolling hash over int32 token ids; every hit is verified against
# the node's token bytes, so hash quality affects lookup cost only
_HASH_BASE = 1000003
_HASH_MOD = (1 << 61) - 1

# shortest partial-page tail worth matching: a 1-token hit costs a COW page
# copy (and, in bucketed mode, the chunk-tail prefill) to save one token
_MIN_PARTIAL = 2


class PagedKVCache:
    """Page tables, free list, refcounts and prefix index for `num_slots`
    slots over `num_pages` pages of `page_size` tokens (page 0 the null
    page)."""

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
        self._ref = np.zeros((num_pages,), np.int64)
        # prefix index: key -> node; page -> node; LRU of refcount-0 nodes;
        # rolling-hash partial index (parent, j, hash) -> node over every
        # registered page's j-token content prefixes
        self._index: Dict[Tuple[int, bytes], _PrefixNode] = {}
        self._page_node: Dict[int, _PrefixNode] = {}
        self._lru: "OrderedDict[int, _PrefixNode]" = OrderedDict()
        self._partial: Dict[Tuple[int, int, int], _PrefixNode] = {}
        self._node_ids = itertools.count(1)
        self.prefix_evictions = 0
        # fourth partition: request id -> pages whose KV lives in the host
        # swap pool (the device pages themselves were released)
        self._swapped: Dict[int, int] = {}

    # ---- capacity queries -------------------------------------------------
    @property
    def num_free_pages(self) -> int:
        """Pages allocatable without evicting cached prefixes."""
        return len(self._free)

    @property
    def num_evictable_pages(self) -> int:
        """Registered prefix pages at refcount 0, reclaimable on demand."""
        return len(self._lru)

    def pages_needed(self, total_tokens: int) -> int:
        return -(-total_tokens // self.page_size)

    def can_allocate(self, total_tokens: int,
                     tokens: Optional[np.ndarray] = None) -> bool:
        """Whether a `total_tokens` footprint fits, counting evictable
        cached pages and (given the prompt `tokens`) the pages the prefix
        cache would share instead of allocating fresh."""
        n = self.pages_needed(total_tokens)
        if n > self.max_pages_per_slot:
            return False
        fresh = n
        in_lru = 0
        if tokens is not None:
            full, partial = self._match(np.asarray(tokens, np.int32))
            fresh = n - len(full)
            in_lru = sum(1 for nd in full if self._ref[nd.page] == 0)
            if partial is not None and self._ref[partial[0].page] == 0:
                in_lru += 1             # the COW source must survive the copy
        return fresh <= len(self._free) + len(self._lru) - in_lru

    def token_capacity(self) -> int:
        """Pool capacity in tokens (the null page excluded)."""
        return (self.num_pages - 1) * self.page_size

    def pages_held(self, slot: int) -> int:
        """Pages mapped into `slot`'s table row (shared and private), one of
        the victim-selection signals."""
        return len(self._used[slot])

    def slot_pages(self, slot: int) -> List[int]:
        """The slot's page ids in table-row order (a copy)."""
        return list(self._used[slot])

    @property
    def swapped_page_count(self) -> int:
        """Pages whose KV currently lives in the host swap pool."""
        return sum(self._swapped.values())

    @property
    def swapped_requests(self) -> int:
        """Requests currently parked in the host swap pool."""
        return len(self._swapped)

    def host_pool_room(self, budget_pages: int) -> int:
        """Pages of host-pool room left under `budget_pages`: the budget
        less what swap parking holds.  The reference also subtracts its KV
        tier's host pages, which the port does not have yet (0)."""
        return budget_pages - self.swapped_page_count

    def pool_pressure(self) -> float:
        """Fraction of the real pool in live use (0.0 idle .. 1.0 full)."""
        return self.pages_in_use() / max(1, self.num_pages - 1)

    # ---- prefix index -----------------------------------------------------
    def _match(self, tokens: np.ndarray
               ) -> Tuple[List[_PrefixNode],
                          Optional[Tuple[_PrefixNode, int]]]:
        """Longest cached prefix of `tokens`, capped at len(tokens) - 1 so
        at least one position is recomputed (its logits seed generation).
        Returns (full-page nodes, optional (partial node, matched tokens)
        extending them); the partial match runs over the rolling-hash
        index, so any registered page whose content starts with the
        prompt's tail is a COW hit."""
        page = self.page_size
        lp = tokens.size
        full: List[_PrefixNode] = []
        parent = _ROOT
        for i in range((lp - 1) // page):
            node = self._index.get((parent, tokens[i * page:(i + 1) * page]
                                    .tobytes()))
            if node is None:
                break
            full.append(node)
            parent = node.node_id
        base = len(full) * page
        partial = None
        h = 0
        for j in range(1, min(lp - base - 1, page - 1) + 1):
            h = (h * _HASH_BASE + int(tokens[base + j - 1]) + 1) % _HASH_MOD
            if j < _MIN_PARTIAL:
                continue
            node = self._partial.get((parent, j, h))
            if node is not None and \
                    node.key[1][:4 * j] == tokens[base:base + j].tobytes():
                partial = (node, j)     # the longest verified hit wins
        return full, partial

    def _register_partial(self, node: _PrefixNode) -> None:
        """Index every proper prefix of `node`'s token content under the
        rolling hash (the first registrant wins a colliding key)."""
        toks = np.frombuffer(node.key[1], np.int32)
        cap = node.n_tokens if node.n_tokens < self.page_size \
            else self.page_size - 1
        h = 0
        parent = node.key[0]
        for j in range(1, cap + 1):
            h = (h * _HASH_BASE + int(toks[j - 1]) + 1) % _HASH_MOD
            if j < _MIN_PARTIAL:
                continue
            k = (parent, j, h)
            if k not in self._partial:
                self._partial[k] = node
                node.partial_keys.append(k)

    def _drop_node(self, node: _PrefixNode) -> None:
        """Remove a node from every index structure (its page is not
        touched: callers manage the free list)."""
        del self._index[node.key]
        for k in node.partial_keys:
            if self._partial.get(k) is node:
                del self._partial[k]
        node.partial_keys = []
        self._page_node.pop(node.page, None)

    def register_prefix(self, slot: int, tokens: np.ndarray,
                        filled: int, upgrade: bool = False) -> None:
        """Publish `slot`'s pages whose KV is complete (the first `filled`
        of `tokens`) into the prefix index.  Idempotent: call after every
        prefill chunk; keys already indexed (pages this slot shares among
        them) are left alone, so duplicate concurrent prompts keep their
        private pages unregistered.  The final partial page is registered
        once the whole of `tokens` is in (filled == len(tokens)); the slot
        may go on appending past it, since the node claims only its first
        n_tokens.

        `upgrade=True` (finish-time registration of generated pages): a page
        this slot owns that a shorter partial node already claims (the
        prompt-time claim, which the slot has since decoded past) is
        re-keyed in place to the longer content instead of stopping the
        walk."""
        tokens = np.asarray(tokens, np.int32)
        page = self.page_size
        pages = self._used[slot]
        parent = _ROOT
        for i in range(min(filled, tokens.size) // page):
            key = (parent, tokens[i * page:(i + 1) * page].tobytes())
            node = self._index.get(key)
            if node is None:
                holder = self._page_node.get(pages[i])
                if holder is None:
                    node = _PrefixNode(next(self._node_ids), key, pages[i],
                                       page)
                    self._index[key] = node
                    self._page_node[pages[i]] = node
                    self._register_partial(node)
                elif upgrade and holder.key[0] == parent and \
                        holder.n_tokens < page and \
                        key[1].startswith(holder.key[1]):
                    node = self._upgrade_node(holder, key, page)
            if node is None:        # page already published under another key
                return
            parent = node.node_id
        rem = tokens.size % page
        if rem and filled == tokens.size:
            i = tokens.size // page
            key = (parent, tokens[i * page:].tobytes())
            if key in self._index:
                return
            holder = self._page_node.get(pages[i])
            if holder is None:
                node = _PrefixNode(next(self._node_ids), key, pages[i], rem)
                self._index[key] = node
                self._page_node[pages[i]] = node
                self._register_partial(node)
            elif upgrade and holder.key[0] == parent and \
                    holder.n_tokens < rem and \
                    key[1].startswith(holder.key[1]):
                self._upgrade_node(holder, key, rem)

    def _upgrade_node(self, node: _PrefixNode, key: Tuple[int, bytes],
                      n_tokens: int) -> _PrefixNode:
        """Re-key `node` to a longer claim over the same page.  Its id,
        page, refcount/LRU state and trie children are kept; only the
        content key and the rolling-hash entries move."""
        del self._index[node.key]
        for k in node.partial_keys:
            if self._partial.get(k) is node:
                del self._partial[k]
        node.partial_keys = []
        node.key = key
        node.n_tokens = n_tokens
        self._index[key] = node
        self._register_partial(node)
        return node

    def _evict(self, fresh_needed: int) -> None:
        """Reclaim the least recently used unreferenced prefixes until
        `fresh_needed` pages are free (or the LRU runs dry); their nodes
        leave the index."""
        while len(self._free) < fresh_needed and self._lru:
            _, node = self._lru.popitem(last=False)
            self._free.append(node.page)
            self.prefix_evictions += 1
            self._drop_node(node)

    # ---- slot lifecycle ---------------------------------------------------
    def allocate(self, slot: int, total_tokens: int) -> np.ndarray:
        """Reserve ceil(total_tokens / page_size) pages for `slot` and write
        them into its table row.  Returns the row (a view)."""
        row, _, _ = self.allocate_prefixed(slot, total_tokens, None)
        return row

    def allocate_prefixed(self, slot: int, total_tokens: int,
                          tokens: Optional[np.ndarray] = None
                          ) -> Tuple[np.ndarray, int,
                                     Optional[Tuple[int, int]]]:
        """Reserve `slot`'s footprint, sharing the longest cached prefix of
        the prompt `tokens` (when given) instead of allocating fresh pages.

        Returns (table row view, matched_tokens, cow):
        - matched_tokens: prompt tokens whose KV the slot starts with: the
          full shared pages (mapped read-only, refcount + 1) plus, when
          `cow` is set, the matched tokens of a partial page;
        - cow: (src_page, dst_page) the caller must copy on the device
          before the slot writes anything: dst is the slot's own fresh page
          at the partial boundary, src a cached page it must not mutate.

        Raises ValueError past the slot capacity and RuntimeError when the
        pool is short even after evicting (the sharing is rolled back; the
        caller waits for pages to free up)."""
        n = self.pages_needed(total_tokens)
        if n > self.max_pages_per_slot:
            raise ValueError(
                f"request footprint {total_tokens} tokens exceeds slot "
                f"capacity {self.max_pages_per_slot * self.page_size}")
        if self._used[slot]:
            raise RuntimeError(f"slot {slot} already has pages")
        full: List[_PrefixNode] = []
        partial = None
        if tokens is not None:
            full, partial = self._match(np.asarray(tokens, np.int32))
        shared = []                     # pages shared (for the rollback)
        for node in full:
            if self._ref[node.page] == 0:
                self._lru.pop(node.node_id, None)   # revive from evictable
            self._ref[node.page] += 1
            shared.append(node.page)
        pnode, pmatch = partial if partial is not None else (None, 0)
        # pin the COW source for this allocation: it must not be evicted to
        # satisfy our own fresh-page demand
        if pnode is not None and pnode.node_id in self._lru:
            self._lru.move_to_end(pnode.node_id)
            pinned = self._lru.pop(pnode.node_id)
        else:
            pinned = None
        fresh_needed = n - len(shared)
        self._evict(fresh_needed)
        if pinned is not None:
            self._lru[pinned.node_id] = pinned
        if fresh_needed > len(self._free) and pnode is not None:
            # the partial hit is a luxury the pool cannot afford: its pinned
            # source may be the very page this allocation needs.  Drop the
            # partial match (the source stays evictable) and retry
            pnode, pmatch = None, 0
            self._evict(fresh_needed)
        if fresh_needed > len(self._free):
            for p in reversed(shared):              # roll back the sharing
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    self._lru[self._page_node[p].node_id] = self._page_node[p]
            raise RuntimeError(
                f"out of KV pages: need {fresh_needed}, "
                f"free {len(self._free)}")
        fresh = [self._free.pop() for _ in range(fresh_needed)]
        for p in fresh:
            self._ref[p] = 1
        pages = shared + fresh
        self._used[slot] = pages
        self.page_table[slot, :] = NULL_PAGE
        self.page_table[slot, :n] = pages
        matched = len(shared) * self.page_size
        cow = None
        if pnode is not None:
            cow = (pnode.page, pages[len(shared)])
            matched += pmatch
        return self.page_table[slot], matched, cow

    def grow(self, slot: int, total_tokens: int) -> None:
        """Optimistic admission's token-granular growth: extend `slot`'s
        mapping to cover `total_tokens` positions, allocating fresh pages
        (evicting LRU-parked prefixes on demand) past those it holds.  A
        no-op when it already covers them.  Raises RuntimeError when the
        pool cannot supply the pages: the engine's preemption trigger."""
        n = self.pages_needed(total_tokens)
        have = len(self._used[slot])
        if n <= have:
            return
        if n > self.max_pages_per_slot:
            raise ValueError(
                f"slot {slot} growth to {total_tokens} tokens exceeds slot "
                f"capacity {self.max_pages_per_slot * self.page_size}")
        need = n - have
        self._evict(need)
        if need > len(self._free):
            raise RuntimeError(
                f"out of KV pages growing slot {slot}: need {need}, "
                f"free {len(self._free)}")
        fresh = [self._free.pop() for _ in range(need)]
        for p in fresh:
            self._ref[p] = 1
        self.page_table[slot, have:n] = fresh
        self._used[slot].extend(fresh)

    # ---- host swap pool accounting (fourth partition) ---------------------
    def note_swap_out(self, request_id: int, n_pages: int) -> None:
        """Record that `n_pages` of `request_id`'s KV now live in the host
        swap pool (its device pages are released separately)."""
        if n_pages < 1:
            raise ValueError(f"swap-out of {n_pages} pages")
        if request_id in self._swapped:
            raise RuntimeError(f"request {request_id} already swapped out")
        self._swapped[request_id] = n_pages

    def note_swap_in(self, request_id: int) -> int:
        """Clear `request_id`'s swap-pool obligation (swapped back in,
        aborted, timed out, or degraded to recompute).  Returns the pages
        released from the host pool (0 if unknown)."""
        return self._swapped.pop(request_id, 0)

    def release(self, slot: int) -> None:
        """Retire a slot: decrement its pages' refcounts; a page reaching 0
        goes back to the free list, unless it is a registered prefix, which
        parks in the LRU and stays matchable until evicted."""
        for p in reversed(self._used[slot]):
            self._ref[p] -= 1
            if self._ref[p] == 0:
                node = self._page_node.get(p)
                if node is not None:
                    self._lru[node.node_id] = node
                    self._lru.move_to_end(node.node_id)
                else:
                    self._free.append(p)
        self._used[slot] = []
        self.page_table[slot, :] = NULL_PAGE
        self.lengths[slot] = 0

    def pages_in_use(self) -> int:
        """Distinct pages with refcount > 0 (cached, unreferenced prefixes
        do not count), O(1) over the free/LRU/in-use partition."""
        return self.num_pages - 1 - len(self._free) - len(self._lru)

    def check_invariants(self) -> None:
        """Raise AssertionError unless every real page is exactly one of
        {free, in use, parked in the LRU}, the null page is none of them,
        refcounts equal the number of table rows mapping each page, each
        row lists exactly its slot's pages, every index node lives on the
        device, the partial index points only at registered nodes, and
        every host swap-pool obligation is 1..max_pages_per_slot pages."""
        if (self._ref < 0).any():
            raise AssertionError("negative refcount")
        if self._ref[NULL_PAGE] != 0:
            raise AssertionError("null page must never be refcounted")
        counts = np.zeros((self.num_pages,), np.int64)
        for pages in self._used.values():
            for p in pages:
                counts[p] += 1
        if (counts != self._ref).any():
            raise AssertionError(f"refcounts {self._ref.tolist()} != slot "
                                 f"usage {counts.tolist()}")
        free = set(self._free)
        lru = {n.page for n in self._lru.values()}
        used = {p for p in range(1, self.num_pages) if self._ref[p] > 0}
        if len(free) != len(self._free):
            raise AssertionError("duplicate page on the free list")
        if (free & lru) or (free & used) or (lru & used):
            raise AssertionError("page in more than one of free/LRU/in-use")
        if free | lru | used != set(range(1, self.num_pages)):
            raise AssertionError("page leaked out of the free/LRU/in-use "
                                 "partition")
        if self.pages_in_use() != len(used):
            raise AssertionError("O(1) pages_in_use diverged from the "
                                 "refcount scan")
        for slot, pages in self._used.items():
            row = self.page_table[slot]
            if list(row[:len(pages)]) != pages or \
                    (row[len(pages):] != NULL_PAGE).any():
                raise AssertionError(f"slot {slot} table row {row.tolist()} "
                                     f"!= its pages {pages}")
        for node in self._lru.values():
            if self._index.get(node.key) is not node:
                raise AssertionError("LRU node unregistered")
        for page, node in self._page_node.items():
            if node.page != page:
                raise AssertionError(f"page map entry {page} holds node "
                                     f"{node.node_id} of page {node.page}")
        # no tier in this port: every indexed node is a device node
        for node in self._index.values():
            if node.page <= NULL_PAGE or \
                    self._page_node.get(node.page) is not node:
                raise AssertionError(f"node {node.node_id} is not a device "
                                     f"node in the page map")
        if len(self._page_node) != len(self._index):
            raise AssertionError("page map holds a node the index forgot")
        # fourth (host-side) partition: every swap-pool obligation is a
        # positive page count a slot could hold
        for rid, n in self._swapped.items():
            if not 0 < n <= self.max_pages_per_slot:
                raise AssertionError(f"swapped request {rid} records {n} "
                                     f"pages")
        for k, node in self._partial.items():
            if self._index.get(node.key) is not node:
                raise AssertionError(f"partial-index entry {k} points at an "
                                     f"unregistered node")
            if k not in node.partial_keys:
                raise AssertionError(f"partial-index entry {k} is missing "
                                     f"from its node's keys")

    def prefix_stats(self) -> Dict[str, int]:
        return {
            "cached_pages": len(self._index),
            "evictable_pages": len(self._lru),
            "prefix_evictions": self.prefix_evictions,
        }
