"""Data-parallel engine fleet with affinity-aware request routing — port of
`paddle_tpu/inference/router.py`, the reference's names and semantics.

`EngineFleet` holds N `LLMEngine` replicas, each stepped by its own
background loop (the engine's serving-loop surface), and routes every
request to the replica where it is cheapest to serve:

- **prefix/tier affinity** (`router="affinity"`, the default): every
  healthy replica's prefix index is probed (`LLMEngine.probe_affinity`, a
  pure read of the trie and the rolling-hash partial index, tier-resident
  pages included) for the longest cached prefix of the prompt.  Sessions
  are sticky (ties go to the replica that served the session last), but a
  replica whose cache or tier holds strictly more of the conversation wins.
- **load**: among equal-affinity candidates, the fewest live requests
  (`queue_depth`), then the highest windowed `tokens_per_sec`.  Replicas
  whose `health()` reads `overloaded`, or whose signals cannot be read, are
  not routed to.
- **victim awareness**: low-priority requests (`priority < 0`), the first
  preemption victims under optimistic admission, go to a calm replica
  (pool pressure under `victim_pressure`, preemption churn at most
  `victim_churn` a second over 1m) when one exists.
- **load shedding**: when every replica is overloaded or unreachable the
  fleet refuses the request with `FleetOverloaded` (`retry_after_s`),
  which the front door answers with 503 and `Retry-After`.

`router="round_robin"` and `router="least_loaded"` are the A/B baselines:
round robin is what a cache-blind balancer does.

**One copy of the weights.**  The reference's replicas adopt the leader's
compiled executables (`_adopt_executables`).  Here a replica's programs are
CUDA graphs, and a graph bakes in the addresses of its own engine's pool
and buffers, so each replica captures its own: each replica's
`*_executables` stays within `analysis.registry.SERVE_PROGRAM_BUDGET`, and
replication adds no program to any replica.  What the replicas share is
the leader's parameter tensors (with `weight_dtype="int8"`, the leader's
quantized `params`: the card holds one copy of the weights) and the
process's one set of loaded kernel libraries; `_adopt_executables` checks
that a replica runs on the leader's device and parameter storage, and
`shared_executables()` reports it for the whole fleet.  The replicas'
graph memory pools stay apart: two replicas' replays interleave on the one
stream.  Every replica dispatches on the stream current when it was built
(the default stream), so their steps run one after another on the card,
and `graphs.GATE` keeps a capture in one loop clear of the others' CUDA
work.

**Disaggregated prefill/decode** (`roles="P:D"`): the replicas split into
a prefill pool and a decode pool sharing one durable tier store
(`spill_dir`).  A new prompt goes least-loaded to a prefill replica, which
prefills it, generates one token, and publishes the prompt's KV pages and
the store index (`export_prefix`); the decode replica (by affinity, sticky
per session) merges the index (`refresh_store_index`) and its admission
restores the prompt with one scatter.  A returning turn the decode replica
already holds skips the prefill hop; a shed prefill pool or an empty
export degrades to a plain decode-side submit (a local re-prefill).
Health is role-aware (`health.py`).
"""
from __future__ import annotations

import dataclasses
import re
import tempfile
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .engine import LLMEngine, RequestOutput, _later
from .metrics import FleetMetrics

ROUTER_POLICIES = ("affinity", "round_robin", "least_loaded")

# health states a request must never be routed to
_UNROUTABLE = ("overloaded", "error")


def _parse_roles(roles: str) -> Tuple[int, int]:
    """Parse a ``"P:D"`` / ``"2P:3D"`` role spec into (prefill, decode)
    replica counts (an omitted count means 1)."""
    m = re.fullmatch(r"(\d*)\s*P\s*:\s*(\d*)\s*D", str(roles).strip(), re.I)
    if not m:
        raise ValueError(f"roles must look like 'P:D' or '2P:3D', "
                         f"got {roles!r}")
    n_p = int(m.group(1)) if m.group(1) else 1
    n_d = int(m.group(2)) if m.group(2) else 1
    if n_p < 1 or n_d < 1:
        raise ValueError(f"roles needs >= 1 replica per pool, got {roles!r}")
    return n_p, n_d


class FleetOverloaded(RuntimeError):
    """Every replica is overloaded or unreachable: shed instead of queueing.
    `retry_after_s` is the client's back-off hint (HTTP `Retry-After`)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class FleetHandle:
    """A routed request: the replica that took it and its engine-local rid.
    `str(handle)` (``engine0/3``) is the id the front door exposes; `parse`
    reads it back."""
    label: str
    rid: int
    session: Optional[str] = None

    def __str__(self) -> str:
        return f"{self.label}/{self.rid}"

    @classmethod
    def parse(cls, s: str) -> "FleetHandle":
        label, _, rid = str(s).rpartition("/")
        return cls(label=label, rid=int(rid))


@dataclasses.dataclass
class ReplicaView:
    """One replica's routing signals, taken for one decision: the input of
    `rank_replicas`, so scoring is testable without engines."""
    label: str
    state: str = "ok"               # health(): ok | degraded | overloaded
    matched_tokens: int = 0         # longest cached prefix of the prompt
    tier_tokens: int = 0            # ... of which host/disk tier-resident
    depth: int = 0                  # live requests (queued+prefill+decode)
    tokens_per_sec: float = 0.0     # windowed decode throughput (10s)
    pool_pressure: float = 0.0      # fraction of KV pool in live use
    preemptions_per_sec: float = 0.0  # victim churn (1m window)
    sticky: bool = False            # served this session last


def rank_replicas(views: List[ReplicaView], *, policy: str = "affinity",
                  priority: int = 0, victim_pressure: float = 0.85,
                  victim_churn: float = 0.5) -> Optional[ReplicaView]:
    """The replica a request should land on, or None when none is
    routable.  A pure function of the views (the module docstring has the
    scoring); `round_robin` keeps state and lives on the fleet."""
    if policy not in ROUTER_POLICIES:
        raise ValueError(f"unknown router policy {policy!r}; "
                         f"expected one of {ROUTER_POLICIES}")
    usable = [v for v in views if v.state not in _UNROUTABLE]
    if not usable:
        return None
    if policy == "least_loaded":
        return min(usable, key=lambda v: (v.depth, -v.tokens_per_sec,
                                          v.label))
    if policy == "round_robin":
        raise ValueError("round_robin needs fleet state; route via "
                         "EngineFleet.select")
    # affinity: victim-aware pre-filter, then cache-weight ordering
    if priority < 0:
        calm = [v for v in usable if v.pool_pressure < victim_pressure and
                v.preemptions_per_sec <= victim_churn]
        if calm:
            usable = calm
    return max(usable, key=lambda v: (v.matched_tokens, v.sticky,
                                      -v.depth, v.tokens_per_sec,
                                      # stable last resort: lowest label
                                      tuple(-ord(c) for c in v.label)))


def _param_leaves(params, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            yield from _param_leaves(leaf, f"{prefix}{name}.")
        else:
            yield prefix + name, leaf


def _same_weights(replica: LLMEngine, leader: LLMEngine) -> bool:
    """Whether `replica` runs on `leader`'s device and parameter storage."""
    if replica.device != leader.device:
        return False
    mine = dict(_param_leaves(replica.params))
    theirs = dict(_param_leaves(leader.params))
    return mine.keys() == theirs.keys() and all(
        a.data_ptr() == theirs[k].data_ptr() and a.shape == theirs[k].shape
        and a.dtype == theirs[k].dtype for k, a in mine.items())


def _adopt_executables(replica: LLMEngine, leader: LLMEngine) -> None:
    """The reference's adoption of the leader's executables, as the port
    has it: the loaded kernel libraries are the process's anyway, and each
    replica captures its own graphs (a graph bakes in its pool's
    addresses), so what a replica adopts is the leader's weights.  Raises
    unless `replica` runs on `leader`'s device and parameter tensors (the
    same storage), which `EngineFleet` arranges by building every follower
    from the leader's `params`."""
    if not _same_weights(replica, leader):
        raise ValueError("a replica must run on the leader's device and "
                         "parameter tensors (one copy of the weights); "
                         "build it from the leader's params")


class EngineFleet:
    """N data-parallel `LLMEngine`s behind one routed submit / stream /
    abort surface.  Construct from `(params, config)` plus `engine_kwargs`
    (passed as they are to every replica; the followers take the leader's
    `params`), or from pre-built `engines`.

    `start()` starts one step() loop thread per replica, `drain()` waits
    until they are idle, `stop()` joins them; the fleet is also a context
    manager.  `fleet_metrics` holds every replica for the exposition
    (`{engine=...}` series and `llm_fleet_*` merges) and plugs into
    `ObservabilityServer(fleet=...)`.
    """

    def __init__(self, params=None, config=None, *, replicas: int = 2,
                 engines: Optional[List[LLMEngine]] = None,
                 router: str = "affinity",
                 roles: Optional[str] = None,
                 shed_retry_after_s: float = 1.0,
                 victim_pressure: float = 0.85,
                 victim_churn: float = 0.5,
                 handoff_timeout_s: float = 120.0,
                 engine_kwargs: Optional[Dict[str, object]] = None):
        if router not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {router!r}; "
                             f"expected one of {ROUTER_POLICIES}")
        self.router = router
        self.roles = roles
        self.shed_retry_after_s = float(shed_retry_after_s)
        self.victim_pressure = float(victim_pressure)
        self.victim_churn = float(victim_churn)
        self.handoff_timeout_s = float(handoff_timeout_s)
        role_list: Optional[List[Optional[str]]] = None
        if roles is not None:
            n_p, n_d = _parse_roles(roles)
            role_list = ["prefill"] * n_p + ["decode"] * n_d
        kw = dict(engine_kwargs or {})
        if kw.get("mesh") is not None or (kw.get("mp") or 1) > 1 or \
                any(e.mp > 1 for e in engines or []):
            raise _later("a fleet (or the front door) over tensor-parallel "
                         "engines", "tensor-parallel fleet/door/generate")
        if engines is None:
            if params is None or config is None:
                raise ValueError("EngineFleet needs (params, config) or "
                                 "pre-built engines=[...]")
            if role_list is not None:
                replicas = len(role_list)
                # the KV moves through the durable tier store: the tier on,
                # and every replica on the SAME store root
                kw.setdefault("kv_tier", True)
                kw.setdefault("spill_dir",
                              tempfile.mkdtemp(prefix="kvstore_"))
                kw["role"] = role_list[0]
            if replicas < 1:
                raise ValueError(f"replicas must be >= 1, got {replicas}")
            leader = LLMEngine(params, config, **kw)
            engines = [leader]
            for i in range(1, replicas):
                if role_list is not None:
                    kw["role"] = role_list[i]
                # the leader's params: with int8 weights, its quantized copy
                e = LLMEngine(leader.params, config, **kw)
                _adopt_executables(e, leader)
                engines.append(e)
        self.engines: "OrderedDict[str, LLMEngine]" = OrderedDict(
            (f"engine{i}", e) for i, e in enumerate(engines))
        # role pools (pre-built engines partition by their declared role)
        self.prefill_pool = [l for l, e in self.engines.items()
                             if e.role == "prefill"]
        self.decode_pool = [l for l, e in self.engines.items()
                            if e.role == "decode"]
        if roles is not None and not (self.prefill_pool and self.decode_pool):
            raise ValueError(
                f"roles={roles!r} needs >= 1 prefill and >= 1 decode "
                f"replica; got pools {self.prefill_pool} / "
                f"{self.decode_pool}")
        self.fleet_metrics = FleetMetrics()
        for label, eng in self.engines.items():
            self.fleet_metrics.add(label, eng)
        # the router's own state, read and written by every submitting
        # thread (the front door submits from an executor)
        self._lock = threading.Lock()
        self._sessions: Dict[str, str] = {}
        self._rr = 0
        self.shed_count = 0
        self._submitted: Dict[str, int] = {l: 0 for l in self.engines}
        # disaggregated mode: each handoff's wall (prefill submit to store
        # published and decode index refreshed), skips (warm continuation)
        # and degrades (fell back to a decode-side re-prefill)
        self.handoff_ms: List[float] = []
        self.handoff_skips = 0
        self.handoff_degrades = 0

    # ---- lifecycle --------------------------------------------------------
    def start(self, idle_wait_s: float = 0.002) -> "EngineFleet":
        for eng in self.engines.values():
            eng.start_loop(idle_wait_s)
        return self

    def stop(self, timeout: float = 30.0) -> None:
        for eng in self.engines.values():
            eng.stop_loop(timeout)

    def drain(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        for eng in self.engines.values():
            rem = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if not eng.drain(rem):
                return False
        return True

    def warm(self) -> None:
        """Build every replica's decode-side, verify and swap programs
        before any timed section (each replica its own graphs)."""
        for eng in self.engines.values():
            eng.warm_decode()
            eng.warm_spec()
            eng.warm_swap()

    def __enter__(self) -> "EngineFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- routing ----------------------------------------------------------
    def _view(self, label: str, eng: LLMEngine, prompt,
              sticky_label: Optional[str]) -> ReplicaView:
        """One replica's signals, read under its serve lock (between two of
        its steps)."""
        with eng._serve_lock:
            try:
                state = str(eng.health().get("state", "error"))
            except Exception:
                state = "error"
            v = ReplicaView(label=label, state=state,
                            sticky=(label == sticky_label))
            if state in _UNROUTABLE:
                return v
            try:
                probe = eng.probe_affinity(prompt) if prompt is not None \
                    else {"cached_tokens": 0, "tier_tokens": 0}
                v.matched_tokens = probe["cached_tokens"]
                v.tier_tokens = probe["tier_tokens"]
                v.depth = eng.queue_depth()
                v.pool_pressure = float(eng.cache.pool_pressure())
                rates = {rw.name: rw for rw in eng._rate_surface}
                v.tokens_per_sec = float(
                    rates["tokens_per_sec"].rate(10.0))
                v.preemptions_per_sec = float(
                    rates["preemptions_per_sec"].rate(60.0))
            except Exception:
                v.state = "error"
        return v

    def views(self, prompt=None, session: Optional[str] = None,
              labels: Optional[List[str]] = None) -> List[ReplicaView]:
        sticky = self._sessions.get(session) if session is not None else None
        return [self._view(label, eng, prompt, sticky)
                for label, eng in self.engines.items()
                if labels is None or label in labels]

    def select(self, prompt=None, *, session: Optional[str] = None,
               priority: int = 0, policy: Optional[str] = None,
               labels: Optional[List[str]] = None) -> str:
        """Route: the chosen replica's label, or raise `FleetOverloaded`.
        `labels` restricts the candidates (a disaggregated role pool)."""
        policy = policy or self.router
        views = self.views(
            prompt if policy == "affinity" else None, session, labels)
        if policy == "round_robin":
            usable = [v for v in views if v.state not in _UNROUTABLE]
            if usable:
                with self._lock:
                    pick = usable[self._rr % len(usable)]
                    self._rr += 1
                return pick.label
            chosen = None
        else:
            chosen = rank_replicas(views, policy=policy, priority=priority,
                                   victim_pressure=self.victim_pressure,
                                   victim_churn=self.victim_churn)
        if chosen is None:
            with self._lock:
                self.shed_count += 1
            raise FleetOverloaded(
                f"all {len(views)} replicas overloaded/unreachable "
                f"(states: {[v.state for v in views]})",
                retry_after_s=self.shed_retry_after_s)
        return chosen.label

    def _count_submit(self, label: str) -> None:
        with self._lock:
            self._submitted[label] += 1

    # ---- request surface --------------------------------------------------
    def submit(self, prompt, *, session: Optional[str] = None,
               policy: Optional[str] = None, max_new_tokens: int = 16,
               temperature: Optional[float] = None, priority: int = 0,
               deadline_s: Optional[float] = None) -> FleetHandle:
        """Route and enqueue.  Raises `FleetOverloaded` when shedding; the
        replica's `add_request` validates and rejects.  With `roles` set the
        request takes the disaggregated path (prefill-pool hop, store
        handoff, decode-pool submit)."""
        if self.roles is not None:
            return self._submit_disagg(
                prompt, session=session, max_new_tokens=max_new_tokens,
                temperature=temperature, priority=priority,
                deadline_s=deadline_s)
        label = self.select(prompt, session=session, priority=priority,
                            policy=policy)
        rid = self.engines[label].submit(
            prompt, max_new_tokens=max_new_tokens, temperature=temperature,
            priority=priority, deadline_s=deadline_s)
        if session is not None:
            self._sessions[session] = label
        self._count_submit(label)
        return FleetHandle(label=label, rid=rid, session=session)

    def _submit_disagg(self, prompt, *, session: Optional[str],
                       max_new_tokens: int, temperature: Optional[float],
                       priority: int,
                       deadline_s: Optional[float]) -> FleetHandle:
        """Disaggregated routing: the decode replica by affinity (sticky per
        session), a prefill hop only when it is cold on the prompt.  Every
        degrade point (prefill pool shed, prefill timeout, empty export)
        falls through to the plain decode-side submit, so the tokens never
        depend on the handoff.  The prefill replica's export runs from this
        thread, on that replica's stream, under its serve lock."""
        dlabel = self.select(prompt, session=session, priority=priority,
                             policy="affinity", labels=self.decode_pool)
        deng = self.engines[dlabel]
        prompt = np.asarray(prompt, np.int32)
        probe = deng.probe_affinity(prompt)
        if probe["cached_tokens"] * 2 >= prompt.size:
            # warm continuation: the decode replica already holds most of
            # the conversation, a prefill hop would only add latency
            with self._lock:
                self.handoff_skips += 1
        else:
            try:
                plabel = self.select(None, priority=priority,
                                     policy="least_loaded",
                                     labels=self.prefill_pool)
            except FleetOverloaded:
                plabel = None           # prefill pool shed: degrade
            if plabel is None:
                with self._lock:
                    self.handoff_degrades += 1
            else:
                peng = self.engines[plabel]
                t0 = time.monotonic()
                prid = peng.submit(prompt, max_new_tokens=1,
                                   temperature=temperature)
                self._count_submit(plabel)
                out = peng.result(prid, timeout=self.handoff_timeout_s)
                exp = {"pages": 0}
                if out is not None and out.finish_reason in ("stop",
                                                             "length"):
                    exp = peng.export_prefix(prompt, rid=prid)
                if exp["pages"] > 0:
                    deng.refresh_store_index()
                    self.handoff_ms.append((time.monotonic() - t0) * 1e3)
                else:
                    with self._lock:
                        self.handoff_degrades += 1
        rid = deng.submit(prompt, max_new_tokens=max_new_tokens,
                          temperature=temperature, priority=priority,
                          deadline_s=deadline_s)
        if session is not None:
            self._sessions[session] = dlabel
        self._count_submit(dlabel)
        return FleetHandle(label=dlabel, rid=rid, session=session)

    def _engine_of(self, handle: FleetHandle) -> LLMEngine:
        try:
            return self.engines[handle.label]
        except KeyError:
            raise KeyError(f"unknown replica {handle.label!r}") from None

    def abort(self, handle: FleetHandle) -> bool:
        return self._engine_of(handle).cancel(handle.rid)

    def progress(self, handle: FleetHandle) -> Dict[str, object]:
        return self._engine_of(handle).progress(handle.rid)

    def result(self, handle: FleetHandle,
               timeout: Optional[float] = None) -> Optional[RequestOutput]:
        return self._engine_of(handle).result(handle.rid, timeout)

    # ---- fleet state ------------------------------------------------------
    def health(self) -> Dict[str, object]:
        """Worst-of fleet health (the `/healthz` fold the observability
        server applies per engine)."""
        worst = {"state": "ok", "code": 0}
        per = {}
        for label, eng in self.engines.items():
            try:
                with eng._serve_lock:
                    h = eng.health()
            except Exception as exc:
                h = {"state": "error", "code": 99, "error": repr(exc)}
            per[label] = h
            if float(h.get("code", 99)) > float(worst.get("code", 0)):
                worst = dict(h)
        worst["per_engine"] = {l: {"state": h.get("state"),
                                   "code": h.get("code"),
                                   "role": self.engines[l].role}
                               for l, h in per.items()}
        return worst

    def stats(self) -> Dict[str, object]:
        """The routing plane's summary (each engine's full `stats()` stays
        on `engines[label]` and the exposition)."""
        per = {}
        for label, eng in self.engines.items():
            with eng._serve_lock:
                st = eng.stats()
            per[label] = {
                "role": st["role"],
                "queue_depth": (st["queued"] + st["prefilling"] +
                                st["running"]),
                "decode_tokens": st["decode_tokens"],
                "tokens_per_sec_10s": st["rates"]["tokens_per_sec"]["10s"],
                "kv_pool_pressure": st["kv_pool_pressure"],
                "health": st["health"],
                "submitted": self._submitted[label],
            }
        out = {"router": self.router,
               "replicas": len(self.engines),
               "sessions": len(self._sessions),
               "shed": self.shed_count,
               "per_engine": per}
        if self.roles is not None:
            ms = sorted(self.handoff_ms)

            def _pct(q: float) -> float:
                return ms[min(len(ms) - 1, int(q * len(ms)))] if ms else 0.0

            out["disagg"] = {
                "roles": self.roles,
                "prefill_pool": list(self.prefill_pool),
                "decode_pool": list(self.decode_pool),
                "handoffs": len(ms),
                "handoff_skips": self.handoff_skips,
                "handoff_degrades": self.handoff_degrades,
                "handoff_p50_ms": round(_pct(0.50), 3),
                "handoff_p99_ms": round(_pct(0.99), 3),
            }
        return out

    def check_invariants(self) -> None:
        for eng in self.engines.values():
            with eng._serve_lock:
                eng.cache.check_invariants()

    def shared_executables(self) -> bool:
        """True when every replica runs on the leader's parameter storage
        and device, and so on the process's one set of loaded kernel
        libraries.  Each replica's graphs are its own (within the
        single-engine program budget each)."""
        engines = list(self.engines.values())
        return all(_same_weights(e, engines[0]) for e in engines[1:])
