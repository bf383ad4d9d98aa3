"""Page-table, free-list and prefix-index bookkeeping for the paged KV pool,
its host and disk KV tier, and the durable page store — port of
`paddle_tpu/inference/cache.py` (`PagedKVCache`, `HostKVTier`, `PageStore`,
`LocalDirStore`).  Host-side, no device work.

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

KV tier (device -> host -> disk): with a `HostKVTier` attached
(`attach_tier`), `_evict` offers retired prefix nodes to the engine's spill
callback (the "swap_out" gather, its host copy fetched after the step's
dispatch) instead of dropping them; an accepted node stays matchable with
`page = HOST_PAGE`.  A later `allocate_prefixed` whose prefix lives off the
device gives those nodes fresh pages and leaves a restore plan
(`take_restore`): the engine scatters the parked KV back with one "swap_in"
replay and `commit_restore` makes the full pages device nodes again.  The
tier's host level counts against the engine's host pool with preemption
swap parking (`host_pool_room`); over budget it cascades to the store level
(`spill_dir=` or a `PageStore`) or drops, oldest first.

Durable index: `save_tier_index`/`load_tier_index` write and merge the
store-resident part of the trie as versioned `kvindex_<tag>` blobs beside
the `kvnode_<tag>_<id>` page objects, in the reference's format, so a
restarted engine, a decode-role peer or an engine of the JAX package can
restore pages another one exported.  A corrupted, version-skewed or
partly deleted store costs a re-prefill, never a crash or a wrong match.

Every real page is exactly one of free, in use (refcount > 0), or parked in
the LRU; every index node is a device node or an off-device node the tier
holds; a pending restore plan belongs to an allocated slot.  A preemption
that swaps its victim's KV to the host records the obligation in a
host-side partition (`note_swap_out`/`note_swap_in`, keyed by request id).
`check_invariants` holds them all.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

NULL_PAGE = 0
HOST_PAGE = -1      # node.page sentinel: the KV lives in the host/disk tier


@dataclasses.dataclass
class _PrefixNode:
    """One cached page of prompt KV: `page` holds the KV of `n_tokens`
    tokens whose identity (and that of the whole preceding prefix) is pinned
    by `key = (parent node id, token bytes)`.  n_tokens == page_size for a
    full page; fewer marks a partial page, shareable only by COW.
    page == HOST_PAGE marks a node whose KV lives in the attached
    `HostKVTier`.  `partial_keys` are the rolling-hash entries this node
    registered, removed with the node so the index cannot dangle."""
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

# the serialized tier index's format version: `load_tier_index` merges only
# blobs whose version and page size match (the reference's value)
TIER_INDEX_VERSION = 1

# store object names must be unique per writer (node ids are unique per
# process only).  "pt" keeps this package's writers apart from the JAX
# package's in one process, whose counter also starts at 0; readers take
# object names verbatim from the index rows, so the formats stay one
_TIER_TAGS = itertools.count()


def lane_to_numpy(a) -> np.ndarray:
    """A page slab's lane as the store writes it: numpy passes through, a
    tensor goes to numpy, bfloat16 as its raw 2-byte pattern (`|V2`, the
    bytes the reference's npz holds for a bfloat16 lane)."""
    if isinstance(a, np.ndarray):
        return a
    a = a.contiguous()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view("V2")
    return a.numpy()


def lane_to_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A slab lane (host tensor or store numpy) as a CPU tensor of the
    pool's `dtype`; KeyError when it is of another type, which the engine
    handles as a vanished object (the request re-prefills)."""
    if isinstance(a, torch.Tensor):
        t = a
    elif dtype == torch.bfloat16 and a.dtype.itemsize == 2 and \
            a.dtype.kind not in "fiu":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        try:
            t = torch.from_numpy(np.ascontiguousarray(a))
        except TypeError as e:
            raise KeyError(f"slab lane of numpy type {a.dtype}") from e
    if t.dtype != dtype:
        raise KeyError(f"slab lane of type {t.dtype}, the pool's is {dtype}")
    return t


class PageStore:
    """Object-store-shaped durable level under the host KV tier.  The tier
    addresses content by name (``kvnode_<tag>_<id>`` page slabs,
    ``kvindex_<tag>`` index blobs); a store maps names to bytes.  A backend
    implements these six methods; the tier, the durable index and the
    handoff between engines never touch a file system themselves."""

    def put(self, name: str, data: Dict[str, np.ndarray]) -> None:
        """Store one page slab ({lane name: array}) under `name`."""
        raise NotImplementedError

    def get(self, name: str) -> Dict[str, np.ndarray]:
        """Load a page slab; KeyError, OSError or ValueError when it is
        gone or unreadable (the restore degrades)."""
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def put_blob(self, name: str, payload: bytes) -> None:
        """Store an opaque blob (index files) atomically: a reader never
        sees a torn write."""
        raise NotImplementedError

    def blobs(self, prefix: str) -> Iterable[Tuple[str, bytes]]:
        """(name, payload) of every stored blob under `prefix`."""
        raise NotImplementedError


class LocalDirStore(PageStore):
    """The default `PageStore`: one npz file a page slab and atomically
    renamed index blobs, all in one directory (the engine's `spill_dir`),
    in the reference's layout."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def put(self, name: str, data: Dict[str, np.ndarray]) -> None:
        np.savez(self._path(name + ".npz"), **data)

    def get(self, name: str) -> Dict[str, np.ndarray]:
        with np.load(self._path(name + ".npz")) as z:
            return {k: z[k] for k in z.files}

    def delete(self, name: str) -> None:
        path = self._path(name + ".npz")
        if os.path.exists(path):
            os.remove(path)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name + ".npz"))

    def put_blob(self, name: str, payload: bytes) -> None:
        # write aside, then rename: a reader sees the old blob or the new one
        path, tmp = self._path(name), self._path(name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)

    def blobs(self, prefix: str) -> Iterable[Tuple[str, bytes]]:
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for fn in names:
            if not fn.startswith(prefix) or fn.endswith(".tmp"):
                continue
            try:
                with open(self._path(fn), "rb") as f:
                    yield fn, f.read()
            except OSError:
                continue


class HostKVTier:
    """Bounded host storage for spilled prefix pages, with an optional store
    level under it.  Entries are keyed by prefix-node id and hold the
    page's slab ({lane: [L, page_size, ...]}, CPU tensors), a PENDING
    marker (gathered on the device, its host copy not fetched yet), or a
    store object name.  The budget is the owner's: `PagedKVCache.
    tier_make_room` moves the oldest host entries down or drops them, and
    the engine decides how many host pages the tier may hold."""

    _PENDING = object()

    def __init__(self, spill_dir: Optional[str] = None,
                 disk_pages: Optional[int] = None,
                 store: Optional[PageStore] = None):
        self._host: "OrderedDict[int, object]" = OrderedDict()
        # store level: node id -> object name.  _shared marks entries other
        # readers may restore (imported from another writer's index, or
        # published in ours): pop and drop forget them but keep the object
        self._disk: "OrderedDict[int, str]" = OrderedDict()
        self._shared: Set[int] = set()
        self.spill_dir = spill_dir
        self.disk_pages = disk_pages
        if store is None and spill_dir is not None:
            store = LocalDirStore(spill_dir)
        self.store = store
        self.tag = f"pt{os.getpid()}x{next(_TIER_TAGS)}"
        self.disk_spills = 0
        self.disk_restores = 0
        self.tier_drops = 0

    @property
    def pages_host(self) -> int:
        """Host-resident pages, pending gathers included (their bytes are
        committed)."""
        return len(self._host)

    @property
    def pages_disk(self) -> int:
        return len(self._disk)

    def has(self, node_id: int) -> bool:
        return node_id in self._host or node_id in self._disk

    def is_pending(self, node_id: int) -> bool:
        return self._host.get(node_id) is self._PENDING

    def add_pending(self, node_id: int) -> None:
        """Reserve a host entry for a page whose gather is in flight."""
        if self.has(node_id):
            raise RuntimeError(f"tier node {node_id} already present")
        self._host[node_id] = self._PENDING

    def fill(self, node_id: int, data: Dict[str, object]) -> None:
        """Land a pending entry's fetched slab."""
        if self._host.get(node_id) is not self._PENDING:
            raise RuntimeError(f"tier node {node_id} is not pending")
        self._host[node_id] = data

    def data(self, node_id: int) -> Dict[str, object]:
        """The node's slab: the host entry (touched as recently used), or
        read through from the store, where the entry stays.  KeyError when
        the node is unknown or its object unreadable; RuntimeError while
        its host copy is pending."""
        if node_id in self._host:
            e = self._host[node_id]
            if e is self._PENDING:
                raise RuntimeError(f"tier node {node_id} still pending d2h")
            self._host.move_to_end(node_id)
            return e
        name = self._disk[node_id]
        try:
            data = self.store.get(name)
        except (OSError, ValueError) as e:
            raise KeyError(f"tier node {node_id} store object {name!r} "
                           f"unreadable: {e}") from e
        self.disk_restores += 1
        return data

    def pop(self, node_id: int) -> None:
        """Remove an entry whose page is back on the device (a shared store
        object survives)."""
        if self._host.pop(node_id, None) is None:
            name = self._disk.pop(node_id)
            if node_id in self._shared:
                self._shared.discard(node_id)
            else:
                self.store.delete(name)

    def drop(self, node_id: int) -> None:
        """Discard an entry whose node left the index: its host bytes, and
        its store object unless shared."""
        self._host.pop(node_id, None)
        name = self._disk.pop(node_id, None)
        if name is not None and node_id not in self._shared:
            self.store.delete(name)
        self._shared.discard(node_id)
        self.tier_drops += 1

    def import_entry(self, node_id: int, name: str) -> None:
        """Attach a store object (another writer's export, an earlier
        process's spill) as a shared store-level entry of this tier."""
        if self.has(node_id):
            raise RuntimeError(f"tier node {node_id} already present")
        self._disk[node_id] = name
        self._shared.add(node_id)

    def mark_shared(self, node_ids: Iterable[int]) -> None:
        """Entries just published in an index: others may read their
        objects now, so pop and drop stop deleting them."""
        self._shared.update(nid for nid in node_ids if nid in self._disk)

    def demotable(self) -> List[int]:
        """Host node ids, oldest first, pending entries excluded."""
        return [nid for nid, e in self._host.items()
                if e is not self._PENDING]

    def to_disk(self, node_id: int) -> bool:
        """Move one host entry to the store level; False with no store (the
        caller drops the node instead)."""
        if self.store is None:
            return False
        data = self._host[node_id]
        if data is self._PENDING:
            raise RuntimeError(f"cannot demote pending tier node {node_id}")
        name = f"kvnode_{self.tag}_{node_id}"
        self.store.put(name, {k: lane_to_numpy(a) for k, a in data.items()})
        del self._host[node_id]
        self._disk[node_id] = name
        self.disk_spills += 1
        return True


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
        self._evictions_counter = None      # metrics mirror, attach_metrics
        # the KV tier (attach_tier): storage of spilled prefixes, the
        # engine's spill callback, the off-device nodes by id, and the
        # off-device part of each slot's latest match (take_restore)
        self._tier: Optional[HostKVTier] = None
        self._spill_cb: Optional[
            Callable[[List[_PrefixNode]], Set[int]]] = None
        self._tier_nodes: Dict[int, _PrefixNode] = {}
        self._restore_plan: Dict[int, List[Tuple[int, _PrefixNode, int]]] = {}
        # request id -> pages whose KV lives in the host swap pool (the
        # device pages themselves were released)
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
            # only device nodes share their page; off-device nodes are
            # restored into fresh pages
            device_full = [nd for nd in full if nd.page >= 0]
            fresh = n - len(device_full)
            in_lru = sum(1 for nd in device_full if self._ref[nd.page] == 0)
            if partial is not None and partial[0].page >= 0 and \
                    self._ref[partial[0].page] == 0:
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

    @property
    def tier_pages_host(self) -> int:
        """Spilled prefix pages on the host, pending gathers included; 0
        with no tier."""
        return 0 if self._tier is None else self._tier.pages_host

    @property
    def tier_pages_disk(self) -> int:
        return 0 if self._tier is None else self._tier.pages_disk

    def host_pool_room(self, budget_pages: int) -> int:
        """Pages of host-pool room left under `budget_pages`: the budget
        less what swap parking and the tier's host level hold (store pages
        are off the budget).  Preemption reads it before parking a victim,
        after `tier_make_room`: live work outranks cached prefixes."""
        return budget_pages - self.swapped_page_count - self.tier_pages_host

    def attach_tier(self, tier: HostKVTier,
                    spill_cb: Callable[[List[_PrefixNode]], Set[int]]
                    ) -> None:
        """Enable the KV tier: `_evict` offers retired prefix nodes to
        `spill_cb` (the engine's gather), which returns the ids it took;
        those stay in the index with their KV parked in `tier`."""
        self._tier = tier
        self._spill_cb = spill_cb

    def tier_make_room(self, n_pages: int) -> int:
        """Free up to `n_pages` of the tier's host level: the oldest host
        entries move to the store level (with a store) or leave the index.
        Pending gathers cannot move.  Returns the pages freed."""
        if self._tier is None or n_pages <= 0:
            return 0
        freed = 0
        for nid in self._tier.demotable():
            if freed >= n_pages:
                break
            node = self._tier_nodes[nid]
            if self._tier.to_disk(nid):
                self._enforce_disk_cap()
            else:
                self._drop_node(node)
            freed += 1
        return freed

    def _enforce_disk_cap(self) -> None:
        if self._tier is None or self._tier.disk_pages is None:
            return
        while self._tier.pages_disk > self._tier.disk_pages:
            nid = next(iter(self._tier._disk))
            self._drop_node(self._tier_nodes[nid])

    def tier_data(self, node: _PrefixNode) -> Dict[str, object]:
        """The parked slab of an off-device node (read from the store when
        it moved there).  KeyError and RuntimeError propagate: the engine
        degrades the restore to a re-prefill."""
        if self._tier is None:
            raise KeyError(f"no tier attached (node {node.node_id})")
        return self._tier.data(node.node_id)

    def drop_tier_nodes(self, nodes: List[_PrefixNode]) -> None:
        """Drop off-device nodes that are still indexed (a failed copy,
        vanished data): index, partial entries and tier bytes."""
        for node in nodes:
            if self._index.get(node.key) is node:
                self._drop_node(node)

    def spill_lru(self, nodes: List[_PrefixNode]) -> None:
        """Offer LRU-parked device nodes to the spill callback (an export):
        the ones it takes leave the device, their pages freed; the rest
        stay parked."""
        accepted = self._spill_cb(nodes) if nodes else set()
        for node in nodes:
            if node.node_id in accepted:
                self._lru.pop(node.node_id)
                self._free.append(node.page)
                self._park(node)

    def _park(self, node: _PrefixNode) -> None:
        """A spilled device node becomes an off-device node, pending its
        host copy (its page is the caller's)."""
        del self._page_node[node.page]
        node.page = HOST_PAGE
        self._tier_nodes[node.node_id] = node
        self._tier.add_pending(node.node_id)

    # ---- durable tier index -----------------------------------------------
    def save_tier_index(self, tag: str = "main") -> int:
        """Write the store-resident part of the index (trie topology, token
        content, object names) as ``kvindex_<tag>``, versioned, in the
        reference's format.  Only nodes whose whole ancestor chain is in
        the store are published (`_match` walks from the root); their
        objects become shared.  Returns the nodes published (0 with no
        store)."""
        tier = self._tier
        if tier is None or tier.store is None:
            return 0
        nodes = {n.node_id: n for n in self._index.values()
                 if n.page < 0 and n.node_id in tier._disk}
        ok: Dict[int, bool] = {_ROOT: True}

        def chain_ok(nid: int) -> bool:
            got = ok.get(nid)
            if got is None:
                node = nodes.get(nid)
                got = ok[nid] = node is not None and chain_ok(node.key[0])
            return got

        rows = []
        for nid in sorted(nodes):       # ids grow parent first
            node = nodes[nid]
            if not chain_ok(nid):
                continue
            rows.append({"id": nid, "parent": node.key[0],
                         "tokens": np.frombuffer(node.key[1],
                                                 np.int32).tolist(),
                         "n_tokens": node.n_tokens,
                         "name": tier._disk[nid]})
        doc = {"version": TIER_INDEX_VERSION, "page_size": self.page_size,
               "nodes": rows}
        tier.store.put_blob(f"kvindex_{tag}",
                            json.dumps(doc, sort_keys=True).encode("utf-8"))
        tier.mark_shared(r["id"] for r in rows)
        return len(rows)

    def load_tier_index(self) -> int:
        """Merge every readable ``kvindex_*`` blob of the store into the
        index: each row whose parent resolves (known here, or imported by
        an earlier row) and whose object exists becomes an off-device node
        of this cache under a fresh local id.  Corrupt, version- or
        page-size-skewed blobs, malformed rows and rows whose object is
        gone are skipped.  Idempotent.  Returns the nodes imported."""
        tier = self._tier
        if tier is None or tier.store is None:
            return 0
        imported = 0
        for _, payload in tier.store.blobs("kvindex_"):
            try:
                doc = json.loads(payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                continue
            if not isinstance(doc, dict) \
                    or doc.get("version") != TIER_INDEX_VERSION \
                    or doc.get("page_size") != self.page_size \
                    or not isinstance(doc.get("nodes"), list):
                continue
            idmap = {_ROOT: _ROOT}
            for row in doc["nodes"]:
                try:
                    rid = int(row["id"])
                    parent = int(row["parent"])
                    toks = np.asarray(row["tokens"], np.int32)
                    ntok = int(row["n_tokens"])
                    name = str(row["name"])
                except (KeyError, TypeError, ValueError):
                    continue
                if parent not in idmap or toks.ndim != 1 \
                        or toks.size != ntok \
                        or not 0 < ntok <= self.page_size:
                    continue
                key = (idmap[parent], toks.tobytes())
                known = self._index.get(key)
                if known is not None:   # cached here already, any level
                    idmap[rid] = known.node_id
                    continue
                if not tier.store.exists(name):
                    continue            # the object is gone: the chain ends
                nid = next(self._node_ids)
                node = _PrefixNode(nid, key, HOST_PAGE, ntok)
                self._index[key] = node
                self._register_partial(node)
                self._tier_nodes[nid] = node
                tier.import_entry(nid, name)
                idmap[rid] = nid
                imported += 1
        return imported

    def pool_pressure(self) -> float:
        """Fraction of the real pool in live use (0.0 idle .. 1.0 full)."""
        return self.pages_in_use() / max(1, self.num_pages - 1)

    def attach_metrics(self, registry) -> None:
        """Register page accounting on an `inference.metrics.MetricsRegistry`
        (the reference's names): pull gauges over the page partition, read
        only when the registry is scraped, and a counter mirroring
        `prefix_evictions` (the int stays authoritative for `stats()`).
        The callbacks hold the cache, never the engine."""
        self._evictions_counter = registry.counter(
            "prefix_evictions", "cached prefix pages reclaimed under pressure")
        registry.gauge("kv_pages_in_use", self.pages_in_use,
                       "pages with refcount > 0")
        registry.gauge("kv_pages_free", lambda: self.num_free_pages,
                       "pages immediately allocatable")
        registry.gauge("kv_pages_evictable", lambda: self.num_evictable_pages,
                       "refcount-0 cached prefix pages, reclaimable on demand")
        registry.gauge("prefix_cached_pages", lambda: len(self._index),
                       "pages registered in the prefix index")
        registry.gauge("kv_pages_swapped", lambda: self.swapped_page_count,
                       "pages whose KV lives in the host swap pool")
        registry.gauge("kv_tier_pages_host", lambda: self.tier_pages_host,
                       "spilled prefix pages resident in the host KV tier")
        registry.gauge("kv_tier_pages_disk", lambda: self.tier_pages_disk,
                       "spilled prefix pages serialized to the disk tier")
        # a ratio: a fleet merge folds it by max, not by sum
        registry.gauge("kv_pool_pressure", self.pool_pressure,
                       "fraction of the page pool in live use", agg="max")

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
        """Remove a node from every index structure, and an off-device
        node's tier entry (a device page is not touched: callers manage
        the free list)."""
        del self._index[node.key]
        for k in node.partial_keys:
            if self._partial.get(k) is node:
                del self._partial[k]
        node.partial_keys = []
        if node.page >= 0:
            self._page_node.pop(node.page, None)
        elif self._tier is not None:
            self._tier_nodes.pop(node.node_id, None)
            self._tier.drop(node.node_id)

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
        `fresh_needed` pages are free (or the LRU runs dry).  With a tier,
        the evicted nodes go to the spill callback in one batch: the ones
        it takes stay indexed off the device, the rest leave the index.
        Their pages are free at once: the gather is queued on the engine's
        stream before any program that could write them."""
        evicted: List[_PrefixNode] = []
        while len(self._free) < fresh_needed and self._lru:
            _, node = self._lru.popitem(last=False)
            evicted.append(node)
            self._free.append(node.page)
            self.prefix_evictions += 1
            if self._evictions_counter is not None:
                self._evictions_counter.inc()
        if not evicted:
            return
        accepted = self._spill_cb(evicted) \
            if self._spill_cb is not None else set()
        for node in evicted:
            if node.node_id in accepted:
                self._park(node)
            else:
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
          full shared pages (mapped read-only, refcount + 1), the full
          pages restored from the tier into fresh pages (`take_restore`)
          and, when `cow` is set or the tier holds the partial match, the
          matched tokens of a partial page;
        - cow: (src_page, dst_page) the caller must copy on the device
          before the slot writes anything: dst is the slot's own fresh page
          at the partial boundary, src a cached device page it must not
          mutate (an off-device partial source rides the restore plan: the
          scatter is the copy).

        When the match reaches into the tier the caller must take the
        restore plan (`take_restore`) and scatter it and `commit_restore`,
        or release the slot: `matched` counts the planned tokens.

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
        shared = []                     # device pages shared (for rollback)
        for node in full:
            if node.page < 0:
                continue                # off-device: restored, not shared
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
        # the row in chain order: a device node's shared page at its prefix
        # position, an off-device node the next fresh page (the restore
        # target), the remaining fresh pages after them
        pages: List[int] = []
        plan: List[Tuple[int, _PrefixNode, int]] = []
        fi = 0
        for node in full:
            if node.page >= 0:
                pages.append(node.page)
            else:
                pages.append(fresh[fi])
                plan.append((fresh[fi], node, self.page_size))
                fi += 1
        boundary = len(pages)
        pages.extend(fresh[fi:])
        self._used[slot] = pages
        self.page_table[slot, :] = NULL_PAGE
        self.page_table[slot, :n] = pages
        matched = boundary * self.page_size
        cow = None
        if pnode is not None:
            if pnode.page >= 0:
                cow = (pnode.page, pages[boundary])
            else:
                # an off-device partial source: the scatter into the slot's
                # boundary page is the copy; the node stays in the tier
                plan.append((pages[boundary], pnode, pmatch))
            matched += pmatch
        if plan:
            self._restore_plan[slot] = plan
        return self.page_table[slot], matched, cow

    def take_restore(self, slot: int
                     ) -> List[Tuple[int, _PrefixNode, int]]:
        """Pop the off-device part of `slot`'s latest match: [(dst_page,
        node, n_tokens)] the engine scatters from the tier into the slot's
        fresh pages (one "swap_in" replay) before the slot computes
        anything.  Empty when the match was all on the device."""
        return self._restore_plan.pop(slot, [])

    def commit_restore(self, slot: int,
                       plan: List[Tuple[int, _PrefixNode, int]]) -> None:
        """The scatter landed: full-page nodes become device nodes of their
        new page (matchable, shareable, spillable again); a partial node
        stays in the tier, since the slot appends past the matched part."""
        for dst, node, ntok in plan:
            if ntok == self.page_size and node.n_tokens == self.page_size:
                node.page = dst
                self._page_node[dst] = node
                self._tier_nodes.pop(node.node_id, None)
                self._tier.pop(node.node_id)

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
        parks in the LRU and stays matchable until evicted.  A restore plan
        the slot did not consume (an abort, a failed restore) is discarded;
        its nodes stay in the tier."""
        self._restore_plan.pop(slot, None)
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
        row lists exactly its slot's pages, every index node is a device
        node in the page map or an off-device node the tier holds (and the
        tier holds nothing else), the partial index points only at
        registered nodes, every host swap-pool obligation is
        1..max_pages_per_slot pages, and every pending restore plan belongs
        to an allocated slot, targets its pages and sources registered
        off-device nodes."""
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
            if node.page <= NULL_PAGE:
                raise AssertionError(f"off-device node {node.node_id} "
                                     f"parked in the device LRU")
        for page, node in self._page_node.items():
            if node.page != page:
                raise AssertionError(f"page map entry {page} holds node "
                                     f"{node.node_id} of page {node.page}")
        # the tier partition: an index node is a device node in the page
        # map, or an off-device node whose KV the tier holds (host, pending
        # or store), and the tier holds no entry the index forgot
        off_device = 0
        for node in self._index.values():
            if node.page > NULL_PAGE:
                if self._page_node.get(node.page) is not node:
                    raise AssertionError(f"device node {node.node_id} not "
                                         f"in the page map")
            elif node.page == HOST_PAGE:
                off_device += 1
                if self._tier is None or not self._tier.has(node.node_id):
                    raise AssertionError(f"off-device node {node.node_id} "
                                         f"has no tier entry")
                if self._tier_nodes.get(node.node_id) is not node:
                    raise AssertionError(f"off-device node {node.node_id} "
                                         f"missing from the tier nodes")
            else:
                raise AssertionError(f"node {node.node_id} on page "
                                     f"{node.page}")
        if len(self._page_node) + off_device != len(self._index):
            raise AssertionError("page map holds a node the index forgot")
        held = 0 if self._tier is None else \
            self._tier.pages_host + self._tier.pages_disk
        if held != off_device or len(self._tier_nodes) != off_device:
            raise AssertionError(f"the tier holds {held} pages and "
                                 f"{len(self._tier_nodes)} nodes, the index "
                                 f"{off_device} off-device nodes")
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
        # the restore-plan partition: a view over live state, never an
        # owner of pages or tier entries
        for slot, plan in self._restore_plan.items():
            if not self._used[slot]:
                raise AssertionError(f"restore plan pending for released "
                                     f"slot {slot}")
            row = set(self._used[slot])
            for dst, node, _ in plan:
                if dst not in row:
                    raise AssertionError(f"slot {slot} restore plan targets "
                                         f"foreign page {dst}")
                if self._index.get(node.key) is not node or node.page >= 0:
                    raise AssertionError(f"slot {slot} restore plan sources "
                                         f"node {node.node_id}, which is no "
                                         f"off-device index node")

    def prefix_stats(self) -> Dict[str, int]:
        return {
            "cached_pages": len(self._index),
            "evictable_pages": len(self._lru),
            "prefix_evictions": self.prefix_evictions,
            "tier_pages_host": self.tier_pages_host,
            "tier_pages_disk": self.tier_pages_disk,
        }
