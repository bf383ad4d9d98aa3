"""Continuous-batching serving engine — port of
`paddle_tpu/inference/engine.py::LLMEngine`, fused and unfused.

Paged KV pool (`models.gpt.init_paged_cache`) + per-slot page tables
(`inference.cache.PagedKVCache`), reservation (the default) or optimistic
admission, and ONE fused program per steady-state step
(`models.gpt.serve_step_paged`): decode slots ride at valid=1, and in
chunked mode (`prefill_chunk=N`) the oldest prompt's next chunk rides the
same batch at valid=chunk tokens.  Bucketed mode
(`prefill_chunk=None`, the default) prefills a whole prompt at admission
with one `prefill_paged` pass padded to a power-of-2 bucket.  Argmax,
temperature/top-k sampling and the per-request greedy mask run on the
device; the Gumbel noise is drawn from the engine's `torch.Generator` before
each step into the step's noise input.  The host fetches only the [B, T]
int32 token buffer.  With `double_buffer=True` (default) that fetch happens
at the top of the NEXT step, so the device computes while the host
schedules.

Prefix cache (`prefix_cache=True`, the default, as in the reference):
admission matches the prompt against the cache's prefix index in the same
call that reserves its pages (`PagedKVCache.allocate_prefixed`).  Matched
full pages are mapped read-only into the slot's table row; a match ending
inside a cached page is copied on the device into the slot's own page (the
"copy" program, dispatched before anything writes the slot), and only the
uncached tail is prefilled.  A hit never takes the one-shot bucketed
prefill: its tail goes through the chunk program, which in fused bucketed
mode is as wide as the largest bucket and runs before the fused step.
Pages are registered in the index as their KV lands (after each chunk and
each one-shot prefill) and, when a request finishes, once more over its
generated tokens (`register_prefix(upgrade=True)`), so a returning
session's whole conversation is a hit.  Every program runs on one stream in
dispatch order, which is what makes registering a chunk's pages before the
fused step that writes them safe.

Each program (the fused step; the unfused decode and chunk programs; the
COW copy; one one-shot prefill per bucket, "prefill:<bucket>"; the swap
gather and scatter) is a `graphs.StepProgram`: its inputs are staged into
static buffers and, on the card, a dispatch is ONE `CUDAGraph.replay()`
(the reference's one jitted executable a step).  The bucket programs share
one graph memory pool: they never run at once.  `warm_decode()` builds the
decode-side program on inert inputs; any other program is built at its
first dispatch, on inert inputs that touch only the null page.  `stats()`
counts the programs under the reference's keys (`decode_executables`, ...,
held within `analysis.registry.SERVE_PROGRAM_BUDGET`) beside
`graph_replays`.

`fuse=False` is the reference's three-program step, the A/B baseline of the
fused one: each iteration advances the oldest mid-prefill prompt by one
chunk through `prefill_chunk_paged` (chunked mode, and prefix-hit tails in
bucketed mode), then runs one `decode_step_paged` over every decoding slot
(mid-prefill slots get null table rows, so their KV writes land on the null
page); both fetch their token before the step returns (no double
buffering).

Quantized serving, as the reference's: `weight_dtype="int8"` quantizes the
serving matmul weights once at init (`quantization.quantize_serving_params`,
dequantized one layer at a time inside the step programs), `kv_dtype="int8"`
makes the pool int8 with per-token scale lanes, which the paged kernels'
int8 lanes dequantize on read.  Neither adds a program.

Speculative decoding (`spec_len=K > 0`, as the reference's): before each
decode iteration a `DraftProposer` (default `inference.spec.NgramProposer`,
prompt-lookup self-drafting over the slot's own history) guesses up to K
tokens for each greedy slot, capped at its remaining budget so the draft's
KV writes stay inside its reservation.  Fused, a drafted slot rides the
one fused program (`_fused_T = max(K + 1, chunk)` rows) at valid = 1 +
draft, and the program returns its tokens and the on-device greedy
longest-prefix accept count as one `[B, T + 1]` int32 buffer, so the
step's one host fetch stays one copy.  Unfused, greedy slots ride the
"verify" program (`verify_step_paged` + argmax, acceptance on the host)
and sampled slots the decode program in the same iteration: 2
decode-side programs, outside the default budget, as in the reference.
A slot emits its accepted draft and the bonus token; rejected candidates
roll back as the length that does not advance (their stale KV lies in the
slot's own pages, overwritten before it is read).  A slot whose drafts
are rejected `spec_backoff_window` verify events in a row stops drafting.

Overload, as the reference's: `admission="optimistic"` admits on the
prompt footprint only (less a small global watermark while anything is
active) and grows each running slot's pages token by token before every
dispatch (`PagedKVCache.grow`).  A failed growth preempts victims (lowest
`priority` first, then most pages held, least progress, youngest) until
it fits: `preempt="recompute"` releases the victim and re-queues it at the
head, to be replayed as prompt + banked generation (through the prefix
cache); `preempt="swap"` first gathers its pages with the "swap_out"
program into a buffer the host fetches after the step's dispatch (each
victim its own pinned buffer, its copy queued right after its own gather,
so two victims of one step never share one), and a resume scatters them
back with the "swap_in" program: no prefill replay.  Both programs are
`StepProgram`s (`swap_executables`, at most 2).  Every page move runs after
the step-top harvest, when no fused step is in flight, and every program
runs on one stream in dispatch order, so a victim's gather is queued
before any later step writes its released pages.  The host pool holds at
most `swap_pool_pages` pages; a victim that does not fit is recomputed,
and a request whose worst case could never park is rejected at intake.
`add_request(deadline_s=)` retires overdue work as "timeout" wherever it
is, on the injectable `clock`; `fault_plan` (`inference.faults.FaultPlan`)
forces pool pressure, failing swap copies (degraded to recompute, the one
fallback) and clock skew.

KV tier, as the reference's (`kv_tier=True`, the default; it needs the
prefix cache and `swap_pool_pages > 0`): prefix pages the LRU evicts spill
device -> host instead of being dropped.  `_evict` hands them to
`_spill_prefix_nodes`, which gathers them with the "swap_out" program (one
replay per `max_pages_per_slot` pages, each copied into a pinned buffer of
its own, fetched after the step's dispatch), so spills add no program.  A
prompt whose match reaches into the tier gets fresh pages and its parked KV
staged into the "swap_in" program: one replay restores the whole match, no
prefill.  The host level shares `swap_pool_pages` with preemption parking;
over it the oldest entries move to a store level (`spill_dir=`, or any
`page_store=`: one npz a page, in the reference's format) or drop,
`spill_disk_pages` capping the store.  `export_prefix` publishes a
conversation's pages and a `kvindex_*` blob to the store, and an engine on
the same store (a restarted one, a `role="decode"` peer, or the JAX
package's) merges it at init or with `refresh_store_index` and restores
from it.  A failed spill copy drops the pages; a failed restore copy, or a
store object that is gone or does not fit the pool, re-prefills.

Observability, as the reference's, all host state (no program sees it, and
a stream with tracing on is the stream with tracing off): every counter
lives in `engine.metrics`, an `inference.metrics.MetricsRegistry`
(namespace "llm_engine", the reference's metric names; `to_prometheus()`,
`snapshot()`), whose clock (`clock=`, default `time.perf_counter`) stamps
everything.  Each request's lifecycle (`RequestOutput.metrics`: queue time,
TTFT, TPOT, e2e) feeds latency histograms with exemplars and the SLO
account; with `request_tracing=True` (the default) each request also keeps
an event timeline (`RequestOutput.trace`, `export_request_trace`), the
last `trace_retention` of them after retirement.  `step()` appends one v2
record to a ring of `trace_ring` (`step_trace()`) and samples the windowed
rates; `health()` folds rates, SLO burn, pool pressure and steady-state
recompiles (a decode-side program built after the first busy step) against
`analysis.registry.SERVE_SLO`.  `trace(dir)` writes the host-phase spans
(`ENGINE_SPANS`), the step timeline, a metrics snapshot and, with
`device=True`, a `torch.profiler` device trace; `debug_bundle()` is the
postmortem snapshot.  Every registry callback that reads the engine holds
it through a weak reference, so a dropped engine (its pool, its graphs)
is freed without the cycle collector.  `predicted_step_ms` is None: the
static roofline model is not ported.

Serving loop, as the reference's (`start_loop`, `submit`, `cancel`,
`progress`, `result`, `drain`, `queue_depth`, `stop_loop`): one background
thread steps the engine while other threads (a fleet's router, the HTTP
door) submit, stream and abort; every entry takes `_serve_lock` (an
`RLock`, so single-threaded callers keep driving `step()` directly).  The
engine is pinned to the CUDA stream current on its device when it was
built: every stage, replay and host copy it makes runs there, whichever
thread dispatches it, so a dispatch from another thread (`export_prefix`
from a fleet's router) stays in order with the loop's steps.  Each step
and each dispatch outside a step holds `graphs.GATE` shared, so a program
that another engine captures meanwhile sees no CUDA work of this one.

Tensor parallelism, as the reference's (`mp=N`, or `mesh=` a
`parallel.tp.ServingMesh`; `mp=N` builds `serving_mesh(N)` on the engine's
device kind, gloo on the CPU, NCCL on N cards): rank 0 is this engine and
holds all host state (page tables, lengths, refcounts, the prefix trie,
the tier), unchanged; each worker rank holds its shard of the weights
(`parallel.hybrid.shard_params`, cut from the tree given, int8-quantized
first when asked) and of the pool, KVH/mp heads of every page (and of the
int8 scale lanes).  Every step program is mirrored: each worker builds,
stages and runs its own copy in the order rank 0 does (`StepProgram`'s
`mirror`), and draws the sampled lane's noise from a generator seeded like
rank 0's, keeping its vocab columns.  Host copies of the pool (the swap
pair, tier spills and restores, `export_prefix`) use one host slab of the
full `[.., page, KVH, hd]` layout that every rank fills or reads its heads
of, so the host tier and the store keep the mp=1 format.  On the card a
gloo mesh runs the programs eagerly (`_eager=True`, asked for: gloo cannot
be captured); an NCCL mesh captures them, collectives included.
`kv_pool_bytes()` is rank 0's shard.  Fleets and the front door over mp
engines raise `NotImplementedError`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..analysis.registry import SERVE_SLO
from ..models import gpt as gpt_mod
from ..parallel.hybrid import shard_params
from ..parallel.tp import EngineLink, ServingMesh, head_slice, serving_mesh
from ..profiler import profiler as _prof
from ..quantization.serving import (kv_page_bytes, normalize_quant_dtype,
                                    quantize_serving_params)
from .cache import HostKVTier, PagedKVCache, lane_to_tensor
from .faults import FaultInjected, FaultPlan
from .graphs import GATE, StepProgram
from .health import HEALTH_CODES, burn_rate, evaluate_engine_health
from .metrics import MetricsRegistry
from .spec import NgramProposer
from .tracing import RequestTrace

# measured-step EWMA smoothing (the reference's): about the last 10 busy
# steps dominate
_EWMA_ALPHA = 0.2


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request.  temperature=None inherits the engine's
    sampling mode; 0.0 forces the greedy pick for this request.  eq=False:
    numpy prompts have no scalar truth value."""
    prompt: np.ndarray
    max_new_tokens: int = 16
    request_id: int = -1
    t_enqueue: float = 0.0
    temperature: Optional[float] = None
    priority: int = 0               # preemption order: lowest goes first
    deadline: Optional[float] = None    # absolute engine-clock instant


@dataclasses.dataclass
class RequestMetrics:
    """The lifecycle of one request on the engine clock (the reference's
    record): a large `queue_s` is admission pressure, a large `ttft_s`
    with a small `queue_s` prefill cost, a large `tpot_s` decode
    contention.  Stages a request never reached stay None."""
    t_enqueue: float
    t_admit: Optional[float] = None         # popped from the queue into a slot
    t_first_token: Optional[float] = None   # joined the decode set
    t_finish: Optional[float] = None        # retired
    queue_s: Optional[float] = None         # t_admit - t_enqueue
    ttft_s: Optional[float] = None          # t_first_token - t_enqueue
    tpot_s: Optional[float] = None          # decode time per token after first
    e2e_s: Optional[float] = None           # t_finish - t_enqueue
    cached_tokens: int = 0                  # prompt tokens from prefix cache
    n_generated: int = 0
    preemptions: int = 0                    # times this request was preempted


@dataclasses.dataclass
class RequestOutput:
    request_id: int
    prompt: np.ndarray
    token_ids: List[int]            # generated tokens (prompt excluded)
    finish_reason: str              # "stop" | "length" | "abort" |
                                    # "timeout" | "rejected"
    cached_tokens: int = 0          # prompt tokens from the prefix cache
    ttft_s: Optional[float] = None
    metrics: Optional[RequestMetrics] = None    # the lifecycle record
    trace: Optional[RequestTrace] = None        # the event timeline (None
                                                # with tracing off)

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generated."""
        return np.concatenate([np.asarray(self.prompt, np.int64),
                               np.asarray(self.token_ids, np.int64)])


@dataclasses.dataclass
class _Running:
    request: Request
    slot: int
    generated: List[int]
    cached_tokens: int = 0
    ttft_s: Optional[float] = None
    greedy: bool = True
    spec_zero_streak: int = 0       # verify events in a row accepting 0
    spec_off: bool = False          # backed off: no more drafts


@dataclasses.dataclass
class _Prefilling:
    """A slot whose prompt KV is still landing: `filled` tokens of `prompt`
    are in pages (prefix-cache hits and completed chunks).  `prompt` is the
    effective prompt: for a recompute resume, the request's prompt + the
    generation it had banked (`prior`), replayed as one longer prompt;
    `ttft`, `spec_off` and `streak` carry its state from before the
    preemption back into the decode set."""
    request: Request
    slot: int
    filled: int
    cached_tokens: int
    prompt: np.ndarray
    prior: Optional[List[int]] = None
    ttft: Optional[float] = None
    spec_off: bool = False
    streak: int = 0

    def resume_state(self) -> Dict[str, object]:
        """`_start_decoding`'s keywords once the prompt is in."""
        return dict(prompt_len=self.prompt.size, prior=self.prior,
                    ttft=self.ttft, spec_off=self.spec_off,
                    streak=self.streak)


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out = []
    b = lo
    while b <= hi:
        out.append(b)
        b *= 2
    return out


def _later(what: str, item: str):
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP Queue 1: "
        f"{item})")


class _NullSpan:
    """Stands in for `profiler.RecordEvent` when nothing records: a span
    off costs one flag read and an empty context manager."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()

# The host-phase spans `trace()` records (the reference's names): admit
# covers prefix matching, reservation and the synchronous bucketed prefill;
# a dispatch span ends when the program is queued, the sync and accept spans
# hold the wait for the device result.  engine.fused.dispatch is the fused
# step; decode, verify and prefill dispatch are the unfused programs
# (prefill.dispatch also the bucketed one-shot prefill and prefix-hit tails).
ENGINE_SPANS = (
    "engine.step",
    "engine.admit",
    "engine.prefill.dispatch",
    "engine.spec.propose",
    "engine.fused.dispatch",
    "engine.verify.dispatch",
    "engine.spec.accept",
    "engine.decode.dispatch",
    "engine.sample.sync",
    "engine.swap.d2h",
    "engine.swap.h2d",
)


# the port's counters beside the reference's (each program's dispatches):
# plain, reset with the registry, beside "tier_stage_ms"
_PORT_COUNTERS = ("fused_dispatches", "decode_dispatches", "chunk_dispatches",
                  "verify_dispatches", "prefill_dispatches",
                  "swap_out_dispatches", "swap_in_dispatches")


def _reading(counter) -> Callable[[], float]:
    """A rate window's reading: the counter's value (it holds the counter,
    not the engine)."""
    return lambda: counter.value


def _weak_call(obj, fn: Callable):
    """A zero-argument callback `fn(obj)` that holds `obj` through a weak
    reference (0.0 once it is gone): the registry's gauges must not keep
    their engine alive."""
    ref = weakref.ref(obj)

    def call():
        o = ref()
        return 0.0 if o is None else fn(o)
    return call


class LLMEngine:
    """Continuous-batching engine over the functional GPT core, on
    `device` (None: the CUDA card, raising without one).  `params` must
    already lie on that device (`models.gpt.init_params` or
    `models.convert.params_from_numpy`).  `_eager=True` runs the step
    programs without CUDA graphs on the card (a comparison switch for the
    card tests and `chip_smoke.py`; the reference has no such engine)."""

    def __init__(self, params, config: gpt_mod.GPTConfig, *,
                 num_slots: int = 4, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 prefill_chunk=None,
                 prefix_cache: bool = True,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 spec_len: int = 0,
                 draft_proposer=None,
                 spec_backoff_window: int = 8,
                 fuse: bool = True,
                 double_buffer: Optional[bool] = None,
                 admission: str = "reservation",
                 preempt: str = "recompute",
                 swap_pool_pages: Optional[int] = None,
                 kv_tier: bool = True,
                 spill_dir: Optional[str] = None,
                 spill_disk_pages: Optional[int] = None,
                 page_store=None,
                 role: Optional[str] = None,
                 fault_plan=None,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 mesh=None, mp: Optional[int] = None,
                 seed: int = 0,
                 clock=None,
                 trace_ring: int = 512,
                 request_tracing: bool = True,
                 trace_retention: Optional[int] = 4096,
                 device=None, _eager: bool = False):
        self.weight_dtype = normalize_quant_dtype(weight_dtype,
                                                  "weight_dtype")
        self.kv_dtype = normalize_quant_dtype(kv_dtype, "kv_dtype")
        if mesh is not None and not isinstance(mesh, ServingMesh):
            raise TypeError(f"mesh must be a parallel.tp.ServingMesh (rank "
                            f"0 of a serving mesh), got {type(mesh).__name__}")
        if mesh is not None and mp is not None and mp != mesh.mp:
            raise ValueError(f"mp={mp} but the mesh has mp={mesh.mp}")
        self.mp = int(mesh.mp if mesh is not None else (mp or 1))
        if self.mp > 1:
            # before any worker starts (reference rules and messages)
            if config.num_heads % self.mp or config.kv_heads % self.mp:
                raise ValueError(
                    f"mp={self.mp} must divide num_heads "
                    f"({config.num_heads}) and kv_heads ({config.kv_heads})")
            if config.vocab_size % self.mp:
                raise ValueError(
                    f"mp={self.mp} must divide vocab_size "
                    f"({config.vocab_size}): the embedding and head shard "
                    f"over the vocab axis")
        if trace_ring < 1:
            raise ValueError(f"trace_ring must be >= 1, got {trace_ring}")
        if trace_retention is not None and trace_retention < 0:
            raise ValueError(f"trace_retention must be >= 0 or None "
                             f"(unbounded), got {trace_retention}")
        if admission not in ("reservation", "optimistic"):
            raise ValueError(f"admission must be 'reservation' or "
                             f"'optimistic', got {admission!r}")
        if preempt not in ("recompute", "swap"):
            raise ValueError(f"preempt must be 'recompute' or 'swap', "
                             f"got {preempt!r}")
        if role not in (None, "prefill", "decode"):
            raise ValueError(f"role must be 'prefill', 'decode' or None, "
                             f"got {role!r}")

        self.device = gpt_mod.resolve_device(device)
        table = params["wte_q" if "wte_q" in params else "wte"]
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        if self.weight_dtype == "int8" and "wte_q" not in params:
            # once, on the device (dequant rides inside the step programs);
            # params already quantized (a fleet's leader's) are taken as
            # they are, so replicas share one copy
            with GATE.shared():
                params = quantize_serving_params(params, config)
        self.config = config
        self.mesh = None
        self._link = None
        own_mesh = None
        if self.mp > 1:
            if mesh is None:
                mesh = own_mesh = serving_mesh(
                    self.mp, [self.device] * self.mp
                    if self.device.type == "cpu" else None)
            if mesh.devices[0] != self.device:
                raise ValueError(f"the mesh's rank 0 is on {mesh.devices[0]}, "
                                 f"the engine on {self.device}")
            if mesh.backend == "gloo" and self.device.type == "cuda" and \
                    not _eager:
                raise ValueError(
                    "a CUDA graph cannot capture gloo collectives: an mp "
                    "engine on a gloo mesh runs its programs eagerly; pass "
                    "_eager=True, or use an NCCL mesh (one card a rank)")
            self.mesh = mesh
        self.params = params if self.mesh is None else \
            shard_params(params, config, self.mp, 0)
        self.eos_token_id = eos_token_id
        max_model_len = max_model_len or config.max_seq_len
        if max_model_len % page_size:
            raise ValueError("max_model_len must be a multiple of page_size")
        if not config.use_rope and max_model_len > config.max_seq_len:
            raise ValueError(
                f"max_model_len {max_model_len} exceeds max_seq_len "
                f"{config.max_seq_len} (learned positions)")
        self.max_model_len = max_model_len
        max_pages_per_slot = max_model_len // page_size
        if num_pages is None:
            # default: half the dense footprint (+ the null page)
            num_pages = max(2, num_slots * max_pages_per_slot // 2 + 1)
        if prefill_buckets is None:
            prefill_buckets = _pow2_buckets(page_size, max_model_len)
            if not prefill_buckets or prefill_buckets[-1] != max_model_len:
                prefill_buckets.append(max_model_len)
        self.buckets = sorted(prefill_buckets)
        for b in self.buckets:
            if b % page_size or b > max_model_len:
                raise ValueError(f"bucket {b} incompatible with page_size "
                                 f"{page_size} / max_model_len {max_model_len}")
        if spec_len < 0:
            raise ValueError(f"spec_len must be >= 0, got {spec_len}")
        if prefill_chunk == "auto":
            # the reference's rule: the verify lane's width with spec on
            # (no padding of decode rows), one page per chunk without
            prefill_chunk = min(spec_len + 1 if spec_len else page_size,
                                max_model_len)
        if prefill_chunk is not None and \
                not 1 <= prefill_chunk <= max_model_len:
            raise ValueError(f"prefill_chunk {prefill_chunk} outside "
                             f"[1, {max_model_len}]")
        self.prefill_chunk = prefill_chunk
        self.chunked = prefill_chunk is not None
        # the chunk program's width: in bucketed mode it serves prefix-hit
        # tails, which the largest bucket bounds
        self._chunk = prefill_chunk if self.chunked else self.buckets[-1]
        self.prefix_cache = bool(prefix_cache)
        if spec_len and spec_len + 1 > max_model_len:
            raise ValueError(f"spec_len {spec_len} + 1 exceeds max_model_len")
        self.spec_len = spec_len
        self.proposer = (draft_proposer or NgramProposer()) if spec_len \
            else draft_proposer
        if spec_backoff_window < 0:
            raise ValueError(f"spec_backoff_window must be >= 0, got "
                             f"{spec_backoff_window}")
        self.spec_backoff_window = spec_backoff_window
        self.fused = bool(fuse)
        # the unfused programs fetch their tokens at once (reference rule)
        self.double_buffer = self.fused and \
            (True if double_buffer is None else bool(double_buffer))
        # the fused program's token width: the widest lane that rides it,
        # K + 1 verify rows or the chunk
        self._fused_T = max(spec_len + 1, prefill_chunk if self.chunked
                            else 1)
        self.admission = admission
        self.optimistic = admission == "optimistic"
        self.preempt = preempt
        self._faults = fault_plan or FaultPlan()
        self.cache = PagedKVCache(num_pages, page_size, num_slots,
                                  max_pages_per_slot)
        # the host pool bound, in pages (the reference's default: what the
        # device pool holds)
        self.swap_pool_pages = (num_pages - 1) if swap_pool_pages is None \
            else int(swap_pool_pages)
        if self.swap_pool_pages < 0:
            raise ValueError(
                f"swap_pool_pages must be >= 0, got {swap_pool_pages}")
        # the KV tier needs the prefix index (its keys) and host-pool room.
        # A role changes nothing here: every engine keeps every program, so
        # a handoff that fails can re-prefill locally
        self.kv_tier = bool(kv_tier) and self.prefix_cache and \
            self.swap_pool_pages > 0
        self.spill_dir = spill_dir if self.kv_tier else None
        self.role = role
        self._store_restored_nodes = 0
        if self.kv_tier:
            # the cache calls back through a weak reference: a cycle would
            # keep a dropped engine, its pool and its graphs, alive until
            # the cycle collector runs, maybe in another engine's capture
            spill = weakref.WeakMethod(self._spill_prefix_nodes)
            self.cache.attach_tier(
                HostKVTier(spill_dir=self.spill_dir,
                           disk_pages=spill_disk_pages, store=page_store),
                lambda nodes: spill()(nodes))
            # what an earlier process or a prefill peer published
            self._store_restored_nodes = self.cache.load_tier_index()
        # optimistic admission's global free-page headroom (~1% of the pool)
        self._watermark = max(1, (num_pages - 1) // 100)
        # the stream every dispatch of this engine runs on (the one current
        # on the device now: the default stream, unless the caller set one)
        self._stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        with self._on_device():
            self._pool = gpt_mod.init_paged_cache(
                config, num_pages, page_size, device=self.device,
                kv_dtype=self.kv_dtype, mp=self.mp)
        self._queue: deque = deque()
        self._running: Dict[int, _Running] = {}
        self._prefilling: Dict[int, _Prefilling] = {}   # slot -> state, FIFO
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self._ids = itertools.count()
        self._outputs: Dict[int, RequestOutput] = {}
        self._sample = bool(temperature and temperature > 0.0)
        self._temperature = temperature
        self._sampling = (self._sample, temperature, top_k)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._capture = not _eager
        if self.mesh is not None:
            # every worker makes its part of this engine: its weight shard
            # (sent one rank at a time), pool shard and generator
            with GATE.shared():
                eid = self.mesh.attach(
                    lambda r: shard_params(params, config, self.mp, r),
                    {"config": config, "sampling": self._sampling,
                     "capture": self._capture, "num_pages": num_pages,
                     "page_size": page_size, "kv_dtype": self.kv_dtype,
                     "seed": seed})
            self._link = EngineLink(self.mesh, eid)
            # the workers drop their part with the engine (and a mesh the
            # engine built closes)
            weakref.finalize(self, _release_link, self._link, own_mesh)
        self._programs: Dict[str, StepProgram] = {}
        self._bucket_pool = None        # graph memory pool of the buckets
        # the un-synced result of the last fused dispatch (double_buffer),
        # and the requests an abort-time harvest finished (returned by the
        # next step())
        self._inflight: Optional[Dict[str, object]] = None
        self._orphan_finished: List[RequestOutput] = []
        # overload state: rid -> resume record ("recompute": the banked
        # generation; "swap": also the parked KV, in pinned host buffers
        # behind an event until fetched); the swap records whose fetch waits
        # for the step's dispatch; whether any deadline is live
        self._preempted: Dict[int, Dict[str, object]] = {}
        self._pending_d2h: List[Dict[str, object]] = []
        self._has_deadlines = False
        self._init_observability(clock, trace_ring, request_tracing,
                                 trace_retention)
        # the serving loop's lock (the engine is single-threaded: the loop's
        # step() and other threads' submit/cancel/probe/result take it), its
        # condition (intake wakes the loop, each step wakes waiters), thread
        # and stop flag, and the error that ended the loop
        self._serve_lock = threading.RLock()
        self._serve_cond = threading.Condition(self._serve_lock)
        self._serve_thread: Optional[threading.Thread] = None
        self._serve_stop = False
        self._serve_error: Optional[BaseException] = None

    def _init_observability(self, clock, trace_ring: int,
                            request_tracing: bool,
                            trace_retention: Optional[int]) -> None:
        """The reference's observability state (`LLMEngine.__init__`): the
        metrics registry and its counters, gauges, histograms and rate
        windows under the reference's names, the request lifecycles and
        timelines, the step-trace ring.  Host state only.  Gauges that read
        the engine hold it weakly; rate windows read their counters."""
        m = MetricsRegistry(namespace="llm_engine",
                            clock=clock or time.perf_counter)
        self.metrics = m
        self._now = m.now
        c = m.counter
        self._decode_iters = c("decode_iterations",
                               "decode-side engine iterations")
        self._decode_tokens = c("decode_tokens",
                                "tokens emitted by decode/verify")
        self._prefill_chunks = c("prefill_chunks", "chunk-prefill dispatches")
        self._prefilled_tokens = c("prefilled_tokens",
                                   "prompt tokens actually computed")
        self._prefix_cached_tokens = c(
            "prefix_cached_tokens", "prompt tokens served from the cache")
        self._prefix_hit_requests = c(
            "prefix_hit_requests", "requests admitted with a prefix hit")
        self._cow_copies = c("cow_page_copies", "copy-on-write page copies")
        self._verify_steps = c("verify_steps", "verify-program dispatches")
        self._spec_events = c("spec_events",
                              "per-slot verify events carrying a draft")
        self._spec_drafted = c("spec_drafted_tokens",
                               "drafted tokens offered to verify")
        self._spec_accepted = c("spec_accepted_tokens",
                                "drafted tokens accepted")
        self._spec_emitted = c("spec_emitted_tokens",
                               "accepted + bonus tokens emitted")
        self._spec_backoffs = c(
            "spec_backoffs", "slots that stopped drafting (adaptive back-off)")
        self._finished_requests = c("finished_requests",
                                    "requests retired by stop/length")
        self._aborted_requests = c("aborted_requests",
                                   "requests retired by abort()")
        self._preemptions = c(
            "preemptions", "running requests evicted under pool pressure")
        self._preempt_swaps = c(
            "preempt_swaps", "preemptions whose KV swap-out d2h completed")
        self._preempt_recomputes = c(
            "preempt_recomputes",
            "preemptions resolved by recompute (incl. degraded swaps)")
        self._swapped_pages_c = c("swapped_pages",
                                  "KV pages delivered to the host swap pool")
        self._swap_ms_c = c("swap_ms",
                            "milliseconds spent in swap d2h/h2d copies")
        self._recomputed_tokens = c(
            "recomputed_tokens",
            "prompt tokens re-prefilled because of preemption")
        self._timeouts = c("timeouts", "requests retired by deadline expiry")
        self._rejected_requests = c(
            "rejected_requests",
            "requests rejected at intake (footprint can never fit)")
        self._intake_swap_rejects = c(
            "intake_swap_rejects",
            "intake rejections because the worst-case footprint exceeds the "
            "host swap pool (the request could never be parked)")
        self._tier_spills = c(
            "kv_tier_spills",
            "evicted prefix pages delivered to the host KV tier (counted "
            "at d2h success, like swapped_pages)")
        self._tier_restores = c(
            "kv_tier_restores",
            "tier restore scatters (one per admission resuming >= 1 page "
            "from the host/disk tier)")
        self._tier_restored_tokens = c(
            "kv_tier_restored_tokens",
            "prompt tokens restored from the KV tier instead of re-prefilled")
        self._partial_hits = c(
            "partial_page_hits",
            "admissions whose prefix match ended inside a cached page "
            "(rolling-hash partial index: COW copy or tier scatter of the "
            "matched fraction)")
        self._handoff_exports = c(
            "kv_handoff_exports",
            "finished prompts exported to the shared tier store for a "
            "decode-role peer")
        self._handoff_pages = c("kv_handoff_pages",
                                "KV pages published to the store by exports")
        self._handoff_tokens = c(
            "kv_handoff_tokens",
            "prompt tokens whose KV a decode peer can restore instead of "
            "re-prefilling")
        # the SLO account: every retired deadline-bearing request is in the
        # attainment denominator (timeouts and aborts are misses there),
        # while the latency histograms see stop/length retirements only
        self._deadline_requests = c(
            "deadline_requests",
            "retired requests that carried a deadline (attainment "
            "denominator — timeouts/aborts/rejects included)")
        self._deadline_met = c(
            "deadline_met",
            "deadline-bearing requests that finished (stop/length) on time")
        self._goodput_prio: Dict[int, object] = {}
        self._h_queue = m.histogram("queue_time_seconds",
                                    help="enqueue -> admission into a slot")
        self._h_ttft = m.histogram("ttft_seconds",
                                   help="enqueue -> first generated token")
        self._h_tpot = m.histogram(
            "tpot_seconds", help="decode seconds per token after the first")
        self._h_e2e = m.histogram("e2e_latency_seconds",
                                  help="enqueue -> finish (stop/length only)")
        self._h_step = m.histogram("step_seconds",
                                   help="wall time of one engine step()")
        m.gauge("queued", _weak_call(self, lambda e: len(e._queue)),
                "requests waiting")
        m.gauge("prefilling", _weak_call(self, lambda e: len(e._prefilling)),
                "slots mid-prefill")
        m.gauge("running", _weak_call(self, lambda e: len(e._running)),
                "slots decoding")
        m.gauge("kv_pool_bytes", _weak_call(self, LLMEngine.kv_pool_bytes),
                "at-rest bytes of the device KV page pool (all lanes)")
        self.cache.attach_metrics(m)
        self._admitted_requests = c(
            "admitted_requests",
            "requests popped into a slot (recompute resumes included)")
        # windowed rates over the counters, sampled once a step
        self._rw_tokens = m.rate_window(
            "tokens_per_sec", _reading(self._decode_tokens),
            help="decode tokens emitted per second")
        self._rw_admits = m.rate_window(
            "admits_per_sec", _reading(self._admitted_requests),
            help="requests admitted per second")
        self._rw_preemptions = m.rate_window(
            "preemptions_per_sec", _reading(self._preemptions),
            help="running requests preempted per second")
        self._rw_timeouts = m.rate_window(
            "timeouts_per_sec", _reading(self._timeouts),
            help="requests retired by deadline expiry per second")
        self._rw_rejects = m.rate_window(
            "rejects_per_sec", _reading(self._rejected_requests),
            help="requests rejected at intake per second")
        self._rate_surface = (self._rw_tokens, self._rw_admits,
                              self._rw_preemptions, self._rw_timeouts,
                              self._rw_rejects)
        # burn-rate inputs: windowed deltas of the SLO account
        self._rw_deadline_req = m.rate_window(
            "deadline_requests_window",
            _reading(self._deadline_requests), expose=False)
        self._rw_deadline_met = m.rate_window(
            "deadline_met_window",
            _reading(self._deadline_met), expose=False)
        for lbl, w in self._rw_deadline_req.windows:
            if lbl in (SERVE_SLO["burn_window_fast"],
                       SERVE_SLO["burn_window_slow"]):
                m.gauge(f"slo_burn_rate_{lbl}",
                        _weak_call(self, lambda e, w=w: e._burn_rate(w)),
                        f"deadline-attainment burn over the trailing {lbl} "
                        f"(1.0 = consuming the error budget exactly as fast "
                        f"as the SLO allows)", agg="max")
        # the live roofline: no static prediction here (None), the measured
        # EWMA fed by busy steps
        self._predicted_ms: Optional[float] = None
        self._measured_ewma_ms: Optional[float] = None
        self._drift_violation = False
        self._exec_baseline: Optional[int] = None
        self._roofline_alerts = c(
            "roofline_drift_alerts",
            "transitions of roofline_drift out of the declared band")
        self._ss_recompiles = c(
            "steady_state_recompiles",
            "decode-side executable-count growth observed after warm")
        m.gauge("measured_step_ms",
                _weak_call(self, lambda e: e._measured_ewma_ms or 0.0),
                "EWMA wall time of busy engine steps (harvest to harvest)",
                agg="max")
        m.gauge("roofline_drift",
                _weak_call(self, LLMEngine._roofline_drift),
                "measured_step_ms / predicted_step_ms (0 until both exist)",
                agg="max")
        m.gauge("engine_health", _weak_call(self, LLMEngine._health_code),
                "health state code: 0 ok, 1 degraded, 2 overloaded "
                "(fleet merge folds worst-of, not sum)", agg="max")
        self._lifecycles: Dict[int, RequestMetrics] = {}
        # per-request timelines: live ones move to RequestOutput.trace at
        # retirement, where the last `trace_retention` of them stay
        self._req_tracing = bool(request_tracing)
        self._traces: Dict[int, RequestTrace] = {}
        self._trace_retention = trace_retention
        self._retired_traced: deque = deque()
        self._step_idx = 0
        self._step_trace: deque = deque(maxlen=trace_ring)
        self._tracing = False
        self._step_dispatches = 0
        self._step_sync_s = 0.0
        self._step_preempted = 0
        self._step_slots = {"decode": 0, "verify": 0, "chunk": 0}
        self.reset_counters()

    def reset_counters(self) -> None:
        """Zero the counters, histograms and rate windows (not the programs
        or the cache's content), as the reference's: benches call it after
        warm-up.  The step-trace ring and `engine_steps` restart at zero,
        the proposer's telemetry, the measured-step EWMA and the recompile
        baseline re-seed; request timelines (live and retired) are request
        state and survive, and a `trace()` window's host spans live in the
        profiler's buffer, which this never touches.  Every rate ring is
        seeded with (now, 0), so a young window reads events since the
        reset over the time since it."""
        self.metrics.reset()
        self.cache.prefix_evictions = 0
        tier = self.cache._tier
        if tier is not None:
            tier.disk_spills = 0
            tier.disk_restores = 0
            tier.tier_drops = 0
        getattr(self.proposer, "reset_stats", lambda: None)()
        self._step_idx = 0
        self._step_trace.clear()
        self._measured_ewma_ms = None
        self._drift_violation = False
        self._exec_baseline = None
        self._port_c = {**dict.fromkeys(_PORT_COUNTERS, 0),
                        "tier_stage_ms": 0.0}
        self.metrics.sample_rates()

    # ---- request intake ---------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 16,
                    temperature: Optional[float] = None,
                    priority: int = 0,
                    deadline_s: Optional[float] = None) -> int:
        """Enqueue one request; same validation as the reference.  A request
        whose worst-case footprint (prompt + max_new_tokens) exceeds the
        whole pool is rejected at once (finish_reason="rejected"), and so,
        under optimistic admission with swap preemption, is one that could
        never park in the host swap pool.  `priority` orders preemption
        victims (lowest first); past `deadline_s` seconds of the engine
        clock the request is retired as "timeout" wherever it is."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if temperature is not None and temperature < 0.0:
            raise ValueError(f"temperature must be >= 0.0, got {temperature}")
        if temperature is not None and temperature > 0.0:
            if not self._sample:
                raise ValueError(
                    "engine built greedy (temperature=0.0) cannot serve "
                    "sampled requests; construct it with temperature > 0")
            if temperature != self._temperature:
                raise ValueError(
                    f"per-request temperature {temperature} != engine "
                    f"temperature {self._temperature}; only the greedy path "
                    f"(temperature=0.0) overrides per request")
        if not self.chunked and prompt.size > self.buckets[-1]:
            raise ValueError(f"prompt length {prompt.size} exceeds largest "
                             f"prefill bucket {self.buckets[-1]}")
        total = prompt.size + max_new_tokens
        if total > self.max_model_len:
            raise ValueError(f"prompt + max_new_tokens = {total} exceeds "
                             f"max_model_len {self.max_model_len}")
        if deadline_s is not None and deadline_s <= 0.0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        rid = next(self._ids)
        t = self._now()
        deadline = None if deadline_s is None else t + deadline_s
        req = Request(prompt, max_new_tokens, rid, t, temperature, priority,
                      deadline)
        self._lifecycles[rid] = RequestMetrics(t_enqueue=t)
        if self._req_tracing:
            tr = RequestTrace(rid)
            tr.event(t, "enqueue", prompt_len=int(prompt.size),
                     max_new_tokens=int(max_new_tokens),
                     priority=int(priority), deadline_s=deadline_s)
            self._traces[rid] = tr
        need = self.cache.pages_needed(total)
        if need > self.cache.num_pages - 1:
            self._rejected_requests.inc()
            self._finish_output(req, [], "rejected", 0, None)
            # anchor the reject in the rate rings at its time (intake runs
            # outside step(), whose sampling would miss it)
            self.metrics.sample_rates(force=True)
            return rid
        if self.optimistic and self.preempt == "swap" and \
                self.swap_pool_pages > 0 and need > self.swap_pool_pages:
            # every admitted request may be preempted: one that could never
            # park, even in an empty host pool, would degrade every swap of
            # it to recompute
            self._intake_swap_rejects.inc()
            self._rejected_requests.inc()
            self._finish_output(req, [], "rejected", 0, None)
            self.metrics.sample_rates(force=True)
            return rid
        if deadline is not None:
            self._has_deadlines = True
        self._queue.append(req)
        return rid

    def _req_greedy(self, req: Request) -> bool:
        t = req.temperature
        return (not self._sample) if t is None else t <= 0.0

    def _finish_output(self, req: Request, token_ids: List[int], reason: str,
                       cached: int, ttft: Optional[float]) -> RequestOutput:
        """Close the request's lifecycle record and publish its output.  The
        latency histograms see stop/length retirements only (an abort's or a
        timeout's wall time measures the client or the deadline); every
        retirement gets its record, its counter ("rejected" is counted at
        intake), its place in the SLO account and, traced, its finish
        event."""
        rid = req.request_id
        lc = self._lifecycles.pop(rid, None)
        if lc is not None:
            lc.t_finish = self._now()
            lc.e2e_s = lc.t_finish - lc.t_enqueue
            lc.cached_tokens = cached
            lc.n_generated = len(token_ids)
            if lc.t_first_token is not None and len(token_ids) > 1:
                lc.tpot_s = (lc.t_finish - lc.t_first_token) / \
                    (len(token_ids) - 1)
            if reason == "abort":
                self._aborted_requests.inc()
            elif reason == "timeout":
                self._timeouts.inc()
            elif reason != "rejected":
                self._finished_requests.inc()
                ex = self._exemplar(rid)
                self._h_e2e.observe(lc.e2e_s, exemplar=ex)
                if lc.tpot_s is not None:
                    self._h_tpot.observe(lc.tpot_s, exemplar=ex)
            # attainment: every retired deadline-bearing request counts, an
            # on-time stop/length finish is met; goodput credits the final
            # output's tokens to the request's priority class
            if req.deadline is not None:
                self._deadline_requests.inc()
                if reason in ("stop", "length") and \
                        lc.t_finish <= req.deadline:
                    self._deadline_met.inc()
            if reason in ("stop", "length") and token_ids:
                prio = int(req.priority)
                c = self._goodput_prio.get(prio)
                if c is None:
                    c = self.metrics.counter(
                        f"goodput_tokens_priority_{prio}",
                        f"final-output tokens from priority-{prio} requests")
                    self._goodput_prio[prio] = c
                c.inc(len(token_ids))
        self._tev(rid, "finish", reason=reason, n_generated=len(token_ids))
        out = RequestOutput(rid, req.prompt, token_ids, reason, cached, ttft,
                            lc, self._traces.pop(rid, None))
        self._outputs[rid] = out
        if out.trace is not None and self._trace_retention is not None:
            # past the cap the oldest retired timeline goes (its output
            # keeps its tokens and metrics)
            self._retired_traced.append(rid)
            while len(self._retired_traced) > self._trace_retention:
                old = self._outputs.get(self._retired_traced.popleft())
                if old is not None:
                    old.trace = None
        return out

    def _span(self, name: str):
        """A profiler span for one host phase, real only while a trace
        records (`trace()` or a user `Profiler`)."""
        if self._tracing or _prof.is_recording():
            return _prof.RecordEvent(name)
        return _NULL_SPAN

    # ---- per-request tracing ----------------------------------------------
    def _tev(self, rid: int, name: str, **attrs) -> None:
        """Stamp one event on a live request's timeline (a no-op with
        tracing off or for a finished id)."""
        tr = self._traces.get(rid)
        if tr is not None:
            tr.event(self._now(), name, **attrs)

    def _exemplar(self, rid: int) -> Optional[Dict[str, str]]:
        """The exemplar labels binding a histogram observation to its
        request (None with tracing off)."""
        if not self._req_tracing:
            return None
        return {"request_id": str(rid), "trace": f"/requests/{rid}"}

    def _trace_for(self, rid: int) -> Optional[RequestTrace]:
        """A request's timeline, live or riding its RequestOutput."""
        tr = self._traces.get(rid)
        if tr is None:
            out = self._outputs.get(rid)
            tr = out.trace if out is not None else None
        return tr

    def export_request_trace(self, rid: int) -> Optional[Dict[str, object]]:
        """The chrome-trace span tree of one request's timeline (live, or
        retired within the last `trace_retention`), or None when the id is
        unknown, tracing is off, or the timeline aged out."""
        tr = self._trace_for(rid)
        return None if tr is None else tr.to_chrome()

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"no bucket for prompt length {n}")

    def _noise(self, rows: int) -> torch.Tensor:
        """Gumbel noise for one pick, from the engine's generator: [rows, V],
        or rank 0's vocab columns of it under mp."""
        return draw_noise(self.config, self._generator, self.device, rows,
                          self.mesh)

    # ---- step programs ----------------------------------------------------
    @contextlib.contextmanager
    def _on_device(self):
        """Device work of this engine from any thread: `GATE` held shared
        and the engine's stream current."""
        with GATE.shared():
            if self._stream is None:
                yield
            else:
                with torch.cuda.stream(self._stream):
                    yield

    def _program(self, role: str) -> StepProgram:
        """The program of `role`, made at first use (built at its first
        staging): "fused", the unfused "decode" and "verify", the "chunk"
        program, the COW "copy", the one-shot prefill of one bucket,
        "prefill:<bucket>", or the preemption swap's gather "swap_out" and
        scatter "swap_in"."""
        prog = self._programs.get(role)
        if prog is not None:
            return prog
        mgr, c = self.cache, self.config
        B, P = mgr.num_slots, mgr.max_pages_per_slot
        i32 = torch.int32
        kind, _, bucket = role.partition(":")
        mempool = None
        fed = ("noise",)
        if kind == "fused":
            rows, T = B, self._fused_T
            inputs = {"tokens": ((B, T), i32, 0),
                      "table": ((B, P), i32, 0),
                      "q_offset": ((B,), i32, 0), "valid": ((B,), i32, 1)}
        elif kind == "decode":
            rows = B
            inputs = {"tokens": ((B,), i32, 0), "table": ((B, P), i32, 0),
                      "lengths": ((B,), i32, 0)}
        elif kind == "verify":          # greedy only: no mask, no noise
            rows = 0
            inputs = {"tokens": ((B, self.spec_len + 1), i32, 0),
                      "table": ((B, P), i32, 0),
                      "q_offset": ((B,), i32, 0), "valid": ((B,), i32, 1)}
        elif kind == "chunk":
            rows = 1
            inputs = {"tokens": ((1, self._chunk), i32, 0),
                      "table": ((1, P), i32, 0),
                      "q_offset": ((1,), i32, 0), "valid": ((1,), i32, 1)}
        elif kind == "prefill":
            rows, width = 1, int(bucket)
            inputs = {"ids": ((1, width), i32, 0),
                      "pages": ((1, width // mgr.page_size), i32, 0),
                      "length": ((1,), i32, 1)}
            if self._capture and self.device.type == "cuda":
                if self._bucket_pool is None:
                    self._bucket_pool = torch.cuda.graph_pool_handle()
                mempool = self._bucket_pool
        elif kind == "swap_out":        # its output: the pool's leaves
            rows = 0
            inputs = {"ids": ((P,), i32, 0)}
        elif kind == "swap_in":         # the leaves staged from the host
            rows = 0
            inputs = {"ids": ((P,), i32, 0)}
            for n, a in self._pool.items():
                inputs[n] = ((a.shape[0], P) + tuple(a.shape[2:]), a.dtype, 0)
            fed = tuple(self._pool)
        else:                           # "copy": page src -> page dst
            rows = 0
            inputs = {"src": ((1,), i32, 0), "dst": ((1,), i32, 0)}
        if rows:
            inputs["greedy"] = ((rows,), torch.bool, False)
            if self._sample:
                # the rank's vocab columns under mp
                inputs["noise"] = ((rows, c.vocab_size // self.mp), c.dtype,
                                   0.0)
        # the body holds params, pool and config, never the engine, so the
        # graphs go with the engine
        body = functools.partial(_BODIES[kind], self.params, c, self._pool,
                                 self._sampling, self.mesh)
        if self._link is not None:
            self._link.declare(role, {"kind": kind, "inputs": inputs,
                                      "fed": fed,
                                      "bucket_pool": kind == "prefill"})
        prog = StepProgram(role, body, inputs, self.device,
                           capture=self._capture, device_fed=fed,
                           mempool=mempool, fetch=kind != "swap_out",
                           mirror=self._link,
                           capture_mode=_capture_mode(self.mesh))
        self._programs[role] = prog
        return prog

    def _dispatch(self, role: str, **values) -> StepProgram:
        """Stage one dispatch's inputs (and its noise) and run it."""
        prog = self._program(role)
        if "noise" in prog.inputs:
            values["noise"] = self._noise(prog.inputs["greedy"].shape[0])
        if self.mesh is not None and role == "swap_in":
            # the workers stage their kv heads of the full-layout host slab
            full = {n: _shared(values[n]) for n in self._pool}
            self._link.payload = {"feed": full}
            heads = self._heads
            values.update({n: t[:, :, :, heads] for n, t in full.items()})
        prog.stage(**values)
        prog.run()
        return prog

    def warm_decode(self) -> None:
        """Build the decode-side program (the fused step, or the unfused
        decode program) on inert inputs, every table row on the null page:
        on the card its warm-up run and its graph capture.  Reference name
        and contract; here the generator is not drawn from, so sampled
        streams do not change."""
        with self._on_device():
            self._program("fused" if self.fused else "decode").build()

    def warm_swap(self) -> None:
        """Build the swap gather and scatter programs on inert inputs (every
        page id the null page), as the reference's `warm_swap` compiles
        them, so a first preemption or spill does not pay the build.  A
        no-op unless the engine can reach them (optimistic admission with
        preempt="swap", or the KV tier)."""
        if (self.optimistic and self.preempt == "swap") or self.kv_tier:
            with self._on_device():
                self._program("swap_out").build()
                self._program("swap_in").build()

    def warm_spec(self) -> None:
        """Build the unfused verify program on inert inputs (reference name
        and contract).  A no-op when fused, where drafts ride the one fused
        program, and with spec off."""
        if self.spec_len and not self.fused:
            with self._on_device():
                self._program("verify").build()

    # ---- scheduler --------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        """One engine iteration: harvest the previous fused dispatch
        (double-buffered mode), admit queued requests into free slots
        (prefix match, page reservation, COW copy), then, fused: stage at
        most one prefill chunk (chunked mode) or advance one prefix-hit tail
        through the chunk program (bucketed mode), and dispatch ONE fused
        program over every decode slot and the chunk.  Unfused: one chunk
        program, then one decode program.  Under optimistic admission the
        running slots grow their pages just before the dispatch, preempting
        victims where the pool runs short; swapped victims' host copies are
        waited for after it.  Deadlines expire right after the harvest.
        Returns the requests that finished this iteration (and those an
        `abort` harvest finished).

        Each iteration appends one v2 record to the step-trace ring
        (`step_trace()`, the reference's keys): what the step dispatched
        (decode-batch occupancy, per-lane slot counts, dispatches, the wait
        for the harvest, the chunk, verify dispatches, tokens emitted,
        victims) and the page pool it left; and samples the rate windows
        (forced on a step that retired or preempted a request).

        Holds the serve lock, and `GATE` shared on the engine's stream."""
        with self._serve_lock, self._on_device():
            return self._step()

    def _step(self) -> List[RequestOutput]:
        finished: List[RequestOutput] = self._orphan_finished
        self._orphan_finished = []
        t0 = self._now()
        tok0 = self._decode_tokens.value
        ver0 = self._verify_steps.value
        chunk0 = self._prefill_chunks.value
        self._step_dispatches = 0
        self._step_sync_s = 0.0
        self._step_preempted = 0
        self._step_slots = {"decode": 0, "verify": 0, "chunk": 0}
        with self._span("engine.step"):
            self._harvest(finished)     # step n-1's tokens land first
            if self._has_deadlines:
                # bookkeeping is exact here: nothing is in flight
                self._expire_deadlines(finished)
            with self._span("engine.admit"):
                self._admit(finished)
            if self.fused:
                if self.chunked:
                    chunk_job = self._stage_chunk()
                else:
                    self._prefill_tick(finished)    # prefix-hit tails
                    chunk_job = None
                if self._running or chunk_job is not None:
                    self._fused_iter(chunk_job, finished)
            else:
                self._prefill_tick(finished)
                if self._running:
                    self._decode_iter(finished)
            # the batch that dispatched (a preemption's victims left first)
            decode_batch = self._step_slots["decode"] + \
                self._step_slots["verify"]
            if self._pending_d2h:
                # the swapped victims' host copies, behind the dispatch
                self._drain_swap_d2h()
        dur = self._now() - t0
        self._h_step.observe(dur)
        if self._step_dispatches:
            # busy steps only: an idle or admission-only step measures the
            # scheduler, not the serving step
            self._note_steady_state(dur)
        self.metrics.sample_rates(
            force=bool(finished) or self._step_preempted > 0)
        self._step_idx += 1
        mgr = self.cache
        self._step_trace.append({
            "v": 2,
            "step": self._step_idx,
            "t": t0,
            "dur_s": dur,
            "queued": len(self._queue),
            "prefilling": len(self._prefilling),
            "running": len(self._running),
            "decode_batch": decode_batch,
            "chunk": self._prefill_chunks.value > chunk0,
            "verify_dispatches": self._verify_steps.value - ver0,
            "tokens_emitted": self._decode_tokens.value - tok0,
            "finished": len(finished),
            "pages_in_use": mgr.pages_in_use(),
            "pages_free": mgr.num_free_pages,
            "pages_evictable": mgr.num_evictable_pages,
            "fused": self.fused,
            # decode-path dispatches (fused, decode, verify, chunk; not the
            # one-shot bucketed prefill)
            "dispatches": self._step_dispatches,
            # the wait for device results inside engine.sample.sync
            "sync_ms": self._step_sync_s * 1e3,
            "slots": dict(self._step_slots),
            "preempted": self._step_preempted,
            "pool_pressure": round(mgr.pool_pressure(), 4),
        })
        return finished

    def step_trace(self) -> List[Dict[str, object]]:
        """The per-step timeline ring, oldest first (at most `trace_ring`
        records; cleared by `reset_counters()`)."""
        return list(self._step_trace)

    def _sync(self, prog: StepProgram) -> np.ndarray:
        """A program's result on the host, waited for inside the
        engine.sample.sync span and counted in the step's `sync_ms`."""
        t_sync = self._now()
        with self._span("engine.sample.sync"):
            out = prog.result()
        self._step_sync_s += self._now() - t_sync
        return out

    def _admit(self, finished: List[RequestOutput]) -> None:
        """Admit queued requests into free slots, head first.  A swapped
        victim resumes by one scatter (`_swap_in`).  Otherwise the prompt
        (for a recompute resume: prompt + banked generation) is matched
        against the prefix cache in the call that reserves its pages:
        reservation admission reserves prompt + max_new_tokens, optimistic
        the prompt alone, and holds a fresh request back while anything is
        active and the free pages would fall below the watermark.  A match
        that reaches into the KV tier is restored by one scatter
        (`_tier_restore`); a restore that fails drops the nodes it needed,
        and the prompt is matched again without them.  A hit copies its
        matched partial page (COW) and goes to the prefill queue with its
        matched tokens filled; a miss in bucketed mode is prefilled at once
        by its bucket's program."""
        mgr = self.cache
        while self._queue and self._free_slots:
            req = self._queue[0]
            rid = req.request_id
            slot = self._free_slots[-1]
            rec = self._preempted.get(rid)
            if rec is not None and rec["kind"] == "swap":
                if self._swap_in(req, rec, slot):
                    self._queue.popleft()
                    self._free_slots.pop()
                    continue
                if rec["kind"] == "swap":
                    break               # no pages yet: wait at the head
                continue                # degraded to recompute: retry now
            prior = list(rec["generated"]) if rec is not None else None
            prompt = np.concatenate(
                [req.prompt, np.asarray(prior, np.int32)]) if prior \
                else req.prompt
            lp = prompt.size
            remaining = req.max_new_tokens - len(prior or ())
            total = lp if self.optimistic else lp + remaining
            if self.optimistic and rec is None and \
                    (self._running or self._prefilling) and \
                    mgr.pages_needed(lp) + self._watermark > \
                    mgr.num_free_pages + mgr.num_evictable_pages:
                break       # keep headroom for the running slots' growth
            tokens = prompt if self.prefix_cache else None
            alloc, restored = None, ()
            while True:
                try:
                    # the prefix match and the reservation in one call (a
                    # failed attempt rolls its sharing back)
                    alloc = mgr.allocate_prefixed(slot, total, tokens)
                except RuntimeError:    # out of KV pages
                    alloc = None
                    break
                plan = mgr.take_restore(slot)
                if not plan:
                    break
                if self._tier_restore(slot, plan, rid):
                    restored = plan
                    break
                mgr.release(slot)       # degraded: match again without it
            if alloc is None:
                if not self._running and not self._prefilling and \
                        mgr.pages_in_use() == 0:
                    raise ValueError(
                        f"request {rid} needs {mgr.pages_needed(total)} "
                        f"pages but the pool only has {mgr.num_pages - 1}")
                break                   # wait for pages to free up
            row, matched, cow = alloc
            self._queue.popleft()
            self._free_slots.pop()
            lc = self._lifecycles.get(rid)
            if lc is not None and lc.t_admit is None:
                lc.t_admit = self._now()
                lc.queue_s = lc.t_admit - lc.t_enqueue
                self._h_queue.observe(lc.queue_s,
                                      exemplar=self._exemplar(rid))
                lc.cached_tokens = matched
            self._admitted_requests.inc()
            self._tev(rid, "admit", slot=slot, prefix_hit_tokens=int(matched),
                      cow=cow is not None, resume=rec is not None)
            resume = {}
            cached = matched
            if rec is not None:
                del self._preempted[rid]
                self._recomputed_tokens.inc(lp - matched)
                cached = rec["cached_tokens"]
                resume = dict(prior=prior, ttft=rec["ttft"],
                              spec_off=rec["spec_off"], streak=rec["streak"])
            if cow is not None:
                # the matched partial page is shared: copy it into the
                # slot's own page before anything is appended to it
                src, dst = cow
                self._dispatch("copy", src=src, dst=dst)
                self._cow_copies.inc()
            if cow is not None or any(ntok < mgr.page_size
                                      for _, _, ntok in restored):
                # the match ended inside a cached page (a COW copy, or the
                # tier scatter of the matched part)
                self._partial_hits.inc()
            if matched:
                self._prefix_cached_tokens.inc(matched)
                self._prefix_hit_requests.inc()
            if self.chunked or matched:
                self._prefilling[slot] = _Prefilling(req, slot, matched,
                                                     cached, prompt, **resume)
                continue
            # one-shot bucketed prefill, synchronous at admission
            bucket = self._bucket_for(lp)
            self._tev(rid, "prefill", n=int(lp), bucket=int(bucket))
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :lp] = prompt
            with self._span("engine.prefill.dispatch"):
                prog = self._dispatch(
                    f"prefill:{bucket}", ids=ids,
                    pages=row[:bucket // mgr.page_size][None, :], length=lp,
                    greedy=self._req_greedy(req))
            self._port_c["prefill_dispatches"] += 1
            self._prefilled_tokens.inc(lp)
            if self.prefix_cache:
                mgr.register_prefix(slot, prompt, lp)
            first = int(self._sync(prog)[0])
            self._start_decoding(req, slot, first, cached, finished,
                                 prompt_len=lp, **resume)

    def _prefill_tick(self, finished: List[RequestOutput]) -> None:
        """Advance the oldest mid-prefill prompt by ONE chunk through the
        standalone chunk program: the unfused engine's chunks, and the
        prefix-hit tails of bucketed mode (fused or not), one call each.
        The chunk that completes the prompt picks its first token and joins
        the decode set."""
        if not self._prefilling:
            return
        slot, st = next(iter(self._prefilling.items()))
        req = st.request
        lp, C = st.prompt.size, self._chunk
        n = min(C, lp - st.filled)
        self._tev(req.request_id, "prefill_chunk", q_offset=int(st.filled),
                  n=int(n))
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = st.prompt[st.filled:st.filled + n]
        # every chunk picks (and draws noise), as the reference's chunk
        # program does; only the last chunk's token is used
        with self._span("engine.prefill.dispatch"):
            prog = self._dispatch(
                "chunk", tokens=ids,
                table=self.cache.page_table[slot][None, :],
                q_offset=st.filled, valid=n, greedy=self._req_greedy(req))
        self._step_dispatches += 1
        self._step_slots["chunk"] += 1
        self._port_c["chunk_dispatches"] += 1
        self._prefill_chunks.inc()
        self._prefilled_tokens.inc(n)
        st.filled += n
        if self.prefix_cache:
            self.cache.register_prefix(slot, st.prompt, st.filled)
        if st.filled == lp:
            del self._prefilling[slot]
            self._start_decoding(req, slot, int(self._sync(prog)[0]),
                                 st.cached_tokens, finished,
                                 **st.resume_state())

    def _decode_iter(self, finished: List[RequestOutput]) -> None:
        """Unfused decode iteration: when any greedy slot has a draft, the
        greedy slots ride the verify program (undrafted ones at valid=1)
        and the sampled slots the decode program in the same iteration;
        otherwise every running slot rides one `decode_step_paged`
        dispatch.  Growth (optimistic admission) runs first and may preempt
        slots, whose drafts go with them."""
        if self.spec_len:
            with self._span("engine.spec.propose"):
                drafts = self._propose_drafts()
        else:
            drafts = {}
        self._grow_running(drafts)
        if not self._running:
            return                      # every slot was preempted
        self._decode_iters.inc()
        if drafts:
            self._verify_iter(drafts, finished)
            rest = [s for s, seq in self._running.items() if not seq.greedy]
        else:
            rest = list(self._running)
        if rest:
            self._vanilla_decode_iter(rest, finished)

    def _propose_drafts(self) -> Dict[int, np.ndarray]:
        """Up to spec_len draft tokens for each greedy slot that has not
        backed off, capped at the slot's remaining budget so the draft's
        KV writes stay inside its reservation (prompt + max_new_tokens).
        Only the proposer's `max_lookback` tail of prompt + generated is
        built, so a slot's host work does not grow with its length."""
        drafts: Dict[int, np.ndarray] = {}
        win = getattr(self.proposer, "max_lookback", 0)
        for slot, seq in self._running.items():
            if not seq.greedy or seq.spec_off:
                continue        # acceptance needs the argmax; backed off
            cap = min(self.spec_len,
                      seq.request.max_new_tokens - len(seq.generated))
            if cap < 1:
                continue
            if win:
                gen = np.asarray(seq.generated[-win:], np.int32)
                head = seq.request.prompt[-(win - gen.size):] \
                    if gen.size < win else seq.request.prompt[:0]
                ctx = np.concatenate([head, gen])
            else:
                ctx = np.concatenate([seq.request.prompt,
                                      np.asarray(seq.generated, np.int32)])
            d = self.proposer.propose(ctx, cap)
            if d is not None and len(d):
                drafts[slot] = np.asarray(d, np.int32).reshape(-1)[:cap]
        return drafts

    def _verify_iter(self, drafts: Dict[int, np.ndarray],
                     finished: List[RequestOutput]) -> None:
        """Unfused: score spec_len + 1 positions of every greedy slot in
        one verify dispatch, then emit each slot's longest drafted prefix
        the argmax agrees with plus the bonus token after it.  Free,
        mid-prefill and sampled slots get null table rows (their KV goes to
        the null page)."""
        mgr = self.cache
        B, T = mgr.num_slots, self.spec_len + 1
        tokens = np.zeros((B, T), np.int32)
        valid = np.ones((B,), np.int32)
        qoff = np.zeros((B,), np.int32)
        table = mgr.page_table.copy()
        active = []
        for slot in range(B):
            seq = self._running.get(slot)
            if seq is None or not seq.greedy:
                table[slot, :] = 0
                continue
            active.append(slot)
            tokens[slot, 0] = seq.generated[-1]
            d = drafts.get(slot)
            if d is not None:
                tokens[slot, 1:1 + d.size] = d
                valid[slot] = 1 + d.size
            qoff[slot] = mgr.lengths[slot]
        with self._span("engine.verify.dispatch"):
            prog = self._dispatch("verify", tokens=tokens, table=table,
                                  q_offset=qoff, valid=valid)
        self._step_dispatches += 1
        self._step_slots["verify"] += len(active)
        self._port_c["verify_dispatches"] += 1
        preds = self._sync(prog)
        self._verify_steps.inc()
        with self._span("engine.spec.accept"):
            for slot in active:
                seq = self._running[slot]
                d = drafts.get(slot)
                nd = 0 if d is None else d.size
                a = 0
                while a < nd and int(d[a]) == int(preds[slot, a]):
                    a += 1          # greedy longest-prefix acceptance
                emitted = [int(x) for x in d[:a]] if nd else []
                emitted.append(int(preds[slot, a]))        # bonus token
                if self._emit_slot(seq, slot, emitted, finished, nd, a):
                    del self._running[slot]

    def _vanilla_decode_iter(self, slots: List[int],
                             finished: List[RequestOutput]) -> None:
        mgr = self.cache
        tokens = np.zeros((mgr.num_slots,), np.int32)
        greedy = np.zeros((mgr.num_slots,), bool)
        for slot in slots:
            seq = self._running[slot]
            tokens[slot] = seq.generated[-1]
            greedy[slot] = seq.greedy
        # mid-prefill slots and running slots outside `slots` must look
        # inactive: a null table row routes their (garbage) KV write to the
        # null page instead of a position inside the slot's real pages
        table = mgr.page_table.copy()
        for slot in range(mgr.num_slots):
            if slot in self._prefilling or \
                    (slot in self._running and slot not in slots):
                table[slot, :] = 0
        with self._span("engine.decode.dispatch"):
            prog = self._dispatch("decode", tokens=tokens, table=table,
                                  lengths=mgr.lengths, greedy=greedy)
        self._step_dispatches += 1
        self._step_slots["decode"] += len(slots)
        self._port_c["decode_dispatches"] += 1
        self._decode_tokens.inc(len(slots))
        nxt = self._sync(prog)
        for slot in slots:
            seq = self._running[slot]
            mgr.lengths[slot] += 1          # the token just fed is cached
            seq.generated.append(int(nxt[slot]))
            if self._maybe_finish(seq, finished):
                del self._running[slot]

    def _stage_chunk(self) -> Optional[Dict[str, object]]:
        """Chunked mode: describe the oldest mid-prefill slot's next chunk
        for the fused batch and register its pages (the fused step that
        writes them is dispatched before any later program could read
        them).  A chunk that completes its prompt leaves `_prefilling` now
        and joins the decode set at harvest, when its first token is
        known."""
        if not self._prefilling:
            return None
        slot, st = next(iter(self._prefilling.items()))
        lp = st.prompt.size
        n = min(self.prefill_chunk, lp - st.filled)
        job = {"slot": slot, "n": n, "q_offset": st.filled, "st": st,
               "done": st.filled + n == lp}
        self._tev(st.request.request_id, "prefill_chunk",
                  q_offset=int(st.filled), n=int(n))
        st.filled += n
        self._prefill_chunks.inc()
        self._prefilled_tokens.inc(n)
        if self.prefix_cache:
            self.cache.register_prefix(slot, st.prompt, st.filled)
        if job["done"]:
            del self._prefilling[slot]
        return job

    def _fused_iter(self, chunk_job: Optional[Dict[str, object]],
                    finished: List[RequestOutput]) -> None:
        """Build and dispatch the fused program: running slots decode at
        valid=1, drafted (greedy) slots at valid=1+draft with the draft in
        tokens[slot, 1:], the staged chunk at valid=chunk tokens, every
        other slot gets a null table row (its KV goes to the null page).
        Growth (optimistic admission) runs before the batch is built and may
        preempt slots, whose drafts go with them."""
        mgr = self.cache
        B, T = mgr.num_slots, self._fused_T
        if self.spec_len and self._running:
            with self._span("engine.spec.propose"):
                drafts = self._propose_drafts()
        else:
            drafts = {}
        self._grow_running(drafts)
        if not self._running and chunk_job is None:
            return                      # every slot was preempted
        if self._running:
            self._decode_iters.inc()
        tokens = np.zeros((B, T), np.int32)
        valid = np.ones((B,), np.int32)
        qoff = np.zeros((B,), np.int32)
        greedy = np.zeros((B,), bool)
        table = mgr.page_table.copy()
        slots: List[int] = []
        chunk_slot = chunk_job["slot"] if chunk_job is not None else None
        for slot in range(B):
            seq = self._running.get(slot)
            if seq is not None:
                slots.append(slot)
                tokens[slot, 0] = seq.generated[-1]
                qoff[slot] = mgr.lengths[slot]
                greedy[slot] = seq.greedy
                d = drafts.get(slot)
                if d is not None:
                    tokens[slot, 1:1 + d.size] = d
                    valid[slot] = 1 + d.size
            elif slot == chunk_slot:
                st, n, q0 = chunk_job["st"], chunk_job["n"], \
                    chunk_job["q_offset"]
                tokens[slot, :n] = st.prompt[q0:q0 + n]
                valid[slot] = n
                qoff[slot] = q0
                greedy[slot] = self._req_greedy(st.request)
            else:
                table[slot, :] = 0          # inactive: KV to the null page
        with self._span("engine.fused.dispatch"):
            prog = self._dispatch("fused", tokens=tokens, table=table,
                                  q_offset=qoff, valid=valid, greedy=greedy)
        self._step_dispatches += 1
        self._step_slots["verify"] += len(drafts)
        self._step_slots["decode"] += len(slots) - len(drafts)
        self._step_slots["chunk"] += int(chunk_job is not None)
        self._port_c["fused_dispatches"] += 1
        if drafts:
            # the dispatch carried a draft: it is this step's verify
            self._verify_steps.inc()
        inflight = {"prog": prog, "slots": slots, "drafts": drafts,
                    "chunk": chunk_job}
        if self.double_buffer:
            self._inflight = inflight
        else:
            self._harvest(finished, inflight)

    def _harvest(self, finished: List[RequestOutput],
                 inflight: Optional[Dict[str, object]] = None) -> None:
        """Fetch the [B, T + 1] buffer of a fused dispatch, the tokens and
        the accept count of each slot (the step's only device->host
        transfer, waited for on an event), emit each running slot's
        accepted draft and bonus token (or its one decoded token), move a
        completed chunk's slot into the decode set, retire finishers."""
        inf = inflight if inflight is not None else self._inflight
        if inflight is None:
            self._inflight = None
        if inf is None:
            return
        out = self._sync(inf["prog"])           # waits for the device result
        accept = out[:, -1]
        with self._span("engine.spec.accept"):
            for slot in inf["slots"]:
                seq = self._running[slot]
                d = inf["drafts"].get(slot)
                # accepted drafts equal the predictions they matched: the
                # run is out[:a] and the bonus out[a]
                a = int(accept[slot])
                emitted = [int(x) for x in out[slot, :a + 1]]
                if self._emit_slot(seq, slot, emitted, finished,
                                   0 if d is None else d.size, a):
                    del self._running[slot]
            cj = inf["chunk"]
            if cj is not None and cj["done"]:
                st = cj["st"]
                self._start_decoding(st.request, cj["slot"],
                                     int(out[cj["slot"], cj["n"] - 1]),
                                     st.cached_tokens, finished,
                                     **st.resume_state())

    def _emit_slot(self, seq: _Running, slot: int, emitted: List[int],
                   finished: List[RequestOutput], nd: int = 0,
                   a: int = 0) -> bool:
        """Apply one slot's emission: budget truncation, EOS cut, length
        advance (a rejected candidate's KV above the new length is stale,
        inside the slot's own pages), and, for a slot that drafted nd
        tokens and had a accepted, the spec counters and the zero-accept
        back-off streak.  Retire the slot if it finished.  The one copy the
        fused harvest and the unfused verify share.  Returns True when the
        caller must drop the slot from the running set."""
        room = seq.request.max_new_tokens - len(seq.generated)
        emitted = emitted[:room]
        if self.eos_token_id is not None and self.eos_token_id in emitted:
            emitted = emitted[:emitted.index(self.eos_token_id) + 1]
        self.cache.lengths[slot] += len(emitted)
        seq.generated.extend(emitted)
        self._decode_tokens.inc(len(emitted))
        if nd:
            self._spec_events.inc()
            self._spec_drafted.inc(nd)
            self._spec_accepted.inc(a)
            self._spec_emitted.inc(len(emitted))
            self._tev(seq.request.request_id, "spec_verify", drafted=int(nd),
                      accepted=int(a), emitted=len(emitted))
            if a:
                seq.spec_zero_streak = 0
            else:
                seq.spec_zero_streak += 1
                if self.spec_backoff_window and not seq.spec_off and \
                        seq.spec_zero_streak >= self.spec_backoff_window:
                    seq.spec_off = True
                    self._spec_backoffs.inc()
        return self._maybe_finish(seq, finished)

    def _start_decoding(self, req: Request, slot: int, first: int,
                        cached: int, finished: List[RequestOutput],
                        prompt_len: Optional[int] = None,
                        prior: Optional[List[int]] = None,
                        ttft: Optional[float] = None,
                        spec_off: bool = False, streak: int = 0) -> None:
        """Prompt fully in pages + first token picked: join the decode set.
        A recompute resume passes its effective prompt length and `prior`
        tokens, which `first` continues; its TTFT and back-off state carry
        over from before the preemption."""
        self.cache.lengths[slot] = \
            req.prompt.size if prompt_len is None else prompt_len
        now = self._now()
        if prior:
            generated = list(prior) + [first]
        else:
            generated = [first]
            ttft = now - req.t_enqueue
            lc = self._lifecycles.get(req.request_id)
            if lc is not None:
                lc.t_first_token = now
                lc.ttft_s = ttft
            self._h_ttft.observe(ttft,
                                 exemplar=self._exemplar(req.request_id))
            self._tev(req.request_id, "first_token")
        seq = _Running(req, slot, generated, cached, ttft,
                       self._req_greedy(req), streak, spec_off)
        if not self._maybe_finish(seq, finished):
            self._running[slot] = seq

    def _maybe_finish(self, seq: _Running,
                      finished: List[RequestOutput]) -> bool:
        reason = None
        if self.eos_token_id is not None and \
                seq.generated[-1] == self.eos_token_id:
            reason = "stop"
        elif len(seq.generated) >= seq.request.max_new_tokens:
            reason = "length"
        if reason is None:
            return False
        if self.prefix_cache:
            # finish-time registration: publish the generated pages beside
            # the prompt's before the slot releases, so a returning
            # session's last reply is a hit.  `lengths[slot]` counts the
            # positions whose KV landed (prompt + generated, less the last
            # token, whose KV is never computed)
            kvlen = int(self.cache.lengths[seq.slot])
            conv = np.concatenate([
                np.asarray(seq.request.prompt, np.int32),
                np.asarray(seq.generated, np.int32)])[:kvlen]
            self.cache.register_prefix(seq.slot, conv, kvlen, upgrade=True)
        self.cache.release(seq.slot)
        self._free_slots.append(seq.slot)
        finished.append(self._finish_output(seq.request, seq.generated,
                                            reason, seq.cached_tokens,
                                            seq.ttft_s))
        return True

    # ---- oversubscription: growth, preemption, swap, deadlines ------------
    def _grow_running(self, drafts: Dict[int, np.ndarray]) -> None:
        """Optimistic admission's pre-dispatch pass: every running slot must
        own pages for the positions this dispatch writes (its last token's
        KV at `lengths`, and one a drafted token).  A failed growth preempts
        victims until it fits, the growing slot among them.  Runs after the
        step-top harvest, so no fused step is in flight while pages move.
        `drafts` loses the slots that were preempted.  Reservation admission
        has every footprint reserved already."""
        if not self.optimistic or not self._running:
            return
        forced = self._faults.pool_pressure(self._step_idx)
        for slot in list(self._running):
            while slot in self._running:
                d = drafts.get(slot)
                need = int(self.cache.lengths[slot]) + 1 + \
                    (d.size if d is not None else 0)
                try:
                    if forced:
                        forced = False
                        raise RuntimeError("fault-injected pool pressure")
                    self.cache.grow(slot, need)
                    break
                except RuntimeError:
                    # the growing slot is a candidate too; alone it always
                    # fits (intake rejects a footprint past the pool)
                    self._tev(self._running[slot].request.request_id,
                              "grow_fail", need_tokens=int(need))
                    self._preempt_slot(self._pick_victim())
        for slot in list(drafts):
            if slot not in self._running:
                del drafts[slot]

    def _pick_victim(self) -> int:
        """The next victim among the running slots: lowest priority, then
        most pages held, least progress, youngest."""
        return min(
            self._running.items(),
            key=lambda kv: (kv[1].request.priority,
                            -self.cache.pages_held(kv[0]),
                            len(kv[1].generated) /
                            kv[1].request.max_new_tokens,
                            -kv[1].request.request_id))[0]

    def _preempt_slot(self, slot: int) -> None:
        """Evict one running slot: bank its generation, park its KV in the
        host pool (swap mode, room permitting) or leave it to recompute,
        release its pages and re-queue it at the head."""
        seq = self._running.pop(slot)
        req = seq.request
        rid = req.request_id
        mgr = self.cache
        self._preemptions.inc()
        self._step_preempted += 1
        rec: Dict[str, object] = {
            "rid": rid, "kind": "recompute",
            "generated": list(seq.generated),
            "cached_tokens": seq.cached_tokens, "ttft": seq.ttft_s,
            "spec_off": seq.spec_off, "streak": seq.spec_zero_streak,
        }
        L = int(mgr.lengths[slot])
        n = mgr.pages_needed(L)
        room = -1
        if self.preempt == "swap":
            # live victims outrank cached prefixes in the host pool: move
            # tier pages down (or drop them) before giving up
            room = mgr.host_pool_room(self.swap_pool_pages)
            if n > room:
                room += mgr.tier_make_room(n - room)
        if self.preempt == "swap" and n <= room:
            # gather the pages now, before they go to a new owner; the wait
            # for their host copy comes after the step's dispatch.  The swap
            # counters move only once the copy has landed
            rec.update(kind="swap", L=L, n=n,
                       **self._swap_out(mgr.slot_pages(slot)[:n]))
            mgr.note_swap_out(rid, n)
            self._pending_d2h.append(rec)
        else:
            self._preempt_recomputes.inc()
        self._tev(rid, "preempt", kind=rec["kind"], pages=int(n),
                  progress=len(seq.generated))
        self._preempted[rid] = rec
        lc = self._lifecycles.get(rid)
        if lc is not None:
            lc.preemptions += 1
        mgr.release(slot)
        self._free_slots.append(slot)
        self._queue.appendleft(req)

    def _swap_out(self, pages: List[int]) -> Dict[str, object]:
        """One "swap_out" replay over `pages` (padded with the null page),
        then the copy of their real rows into pinned host buffers of this
        victim's own, queued on the same stream right after the replay (the
        next replay overwrites the program's output), and an event behind
        it.  Returns the record's "data", "event" and "fetched"."""
        mgr = self.cache
        n = len(pages)
        ids = np.zeros((mgr.max_pages_per_slot,), np.int32)
        ids[:n] = pages
        if self.mesh is not None:
            return self._swap_out_mp(ids, n)
        out = self._dispatch("swap_out", ids=ids).out
        self._port_c["swap_out_dispatches"] += 1
        pin = self.device.type == "cuda"
        data = {}
        for name, a in out.items():
            host = torch.empty((a.shape[0], n) + tuple(a.shape[2:]),
                               dtype=a.dtype, pin_memory=pin)
            host.copy_(a[:, :n], non_blocking=True)
            data[name] = host
        event = None
        if pin:
            event = torch.cuda.Event()
            event.record()
        return {"data": data, "event": event, "fetched": False}

    @property
    def _heads(self) -> slice:
        """Rank 0's kv heads of the full pool layout."""
        return head_slice(self.mesh, self.config.kv_heads)

    def _full_leaf_shape(self, name: str, pages: int) -> tuple:
        """A pool leaf's host shape over `pages` pages, every kv head."""
        a = self._pool[name]
        shape = [a.shape[0], pages] + list(a.shape[2:])
        shape[3] *= self.mp
        return tuple(shape)

    def _swap_out_mp(self, ids, n: int) -> Dict[str, object]:
        """`_swap_out` under mp: every rank copies its kv heads of the
        gathered pages into one shared host slab a leaf, of the full
        layout; the workers answer when their copies are done, so the
        record is complete on return (no event)."""
        data = {name: torch.empty(self._full_leaf_shape(name, n),
                                  dtype=a.dtype).share_memory_()
                for name, a in self._pool.items()}
        self._link.payload = {"into": data, "n": n}
        out = self._dispatch("swap_out", ids=ids).out
        self._port_c["swap_out_dispatches"] += 1
        heads = self._heads
        for name, a in out.items():
            data[name][:, :, :, heads].copy_(a[:, :n])
        self._link.collect()
        return {"data": data, "event": None, "fetched": False}

    def _materialize_swap(self, rec: Dict[str, object]) -> None:
        """Wait for a swap record's host copy (idempotent; on its event, not
        a stream sync) and count it delivered.  Raises FaultInjected under
        an injected d2h failure: the caller degrades it to recompute."""
        if rec["fetched"]:
            return
        self._faults.d2h()
        t0 = self._now()
        with self._span("engine.swap.d2h"):
            if rec["event"] is not None:
                rec["event"].synchronize()
        self._swap_ms_c.inc((self._now() - t0) * 1e3)
        rec["fetched"] = True
        self._swapped_pages_c.inc(rec["n"])
        self._preempt_swaps.inc()
        self._tev(rec["rid"], "swap_out", pages=int(rec["n"]))

    def _degrade_to_recompute(self, rec: Dict[str, object]) -> None:
        """A swap whose copy failed becomes a recompute: the parked KV and
        its host-pool obligation go, the banked generation stays."""
        rec["kind"] = "recompute"
        rec.pop("data", None)
        rec.pop("event", None)
        self.cache.note_swap_in(rec["rid"])
        self._preempt_recomputes.inc()
        self._tev(rec["rid"], "swap_degrade")

    def _drain_swap_d2h(self) -> None:
        """Wait for the host copies of the step's swap-outs and spills,
        after its dispatch, so they overlap the device's work."""
        while self._pending_d2h:
            rec = self._pending_d2h.pop()
            if rec["kind"] == "spill":
                if not rec["fetched"]:
                    try:
                        self._materialize_spill(rec)
                    except FaultInjected:
                        self._degrade_spill_to_drop(rec)
                continue
            if rec["kind"] != "swap" or rec["fetched"]:
                continue            # consumed, degraded or dropped already
            try:
                self._materialize_swap(rec)
            except FaultInjected:
                self._degrade_to_recompute(rec)

    # ---- KV tier: prefix spill, restore, export ----------------------------
    def _spill_prefix_nodes(self, nodes) -> set:
        """`PagedKVCache._evict`'s spill callback: gather the evicted pages
        with "swap_out" replays of `max_pages_per_slot` pages each, each
        copied into a pinned buffer of its own whose wait comes after the
        step's dispatch.  Room comes from the host pool, made by moving tier
        pages down first; the newest nodes go first.  Returns the ids
        taken (the cache drops the rest)."""
        mgr = self.cache
        room = mgr.host_pool_room(self.swap_pool_pages)
        if room < len(nodes):
            room += mgr.tier_make_room(len(nodes) - room)
        if room <= 0:
            return set()
        accept = nodes[-room:] if room < len(nodes) else nodes
        P = mgr.max_pages_per_slot
        for i in range(0, len(accept), P):
            chunk = accept[i:i + P]
            rec = self._swap_out([nd.page for nd in chunk])
            rec.update(kind="spill", nodes=list(chunk))
            self._pending_d2h.append(rec)
        return {nd.node_id for nd in accept}

    def _materialize_spill(self, rec: Dict[str, object]) -> None:
        """Wait for a spill record's host copy and land each still-pending
        node as its own contiguous [L, page, ...] slab a leaf.  Raises
        FaultInjected under an injected d2h failure: the caller drops the
        nodes."""
        if rec["fetched"]:
            return
        self._faults.d2h()
        t0 = self._now()
        with self._span("engine.swap.d2h"):
            if rec["event"] is not None:
                rec["event"].synchronize()
        self._swap_ms_c.inc((self._now() - t0) * 1e3)
        rec["fetched"] = True
        tier = self.cache._tier
        landed = 0
        for i, node in enumerate(rec["nodes"]):
            if tier.is_pending(node.node_id):
                tier.fill(node.node_id, {name: a[:, i].contiguous()
                                         for name, a in rec["data"].items()})
                landed += 1
        self._tier_spills.inc(landed)
        rec.pop("data")

    def _degrade_spill_to_drop(self, rec: Dict[str, object]) -> None:
        """A spill whose copy failed drops its still-pending nodes: their
        pages are free already, so a later match re-prefills."""
        rec["fetched"] = True
        rec.pop("data", None)
        tier = self.cache._tier
        self.cache.drop_tier_nodes([nd for nd in rec["nodes"]
                                    if tier.is_pending(nd.node_id)])

    def _flush_pending_spills(self) -> None:
        """Land every spill fetch now (a restore or an export needs the
        bytes); swap records keep their wait after the dispatch."""
        rest: List[Dict[str, object]] = []
        for rec in self._pending_d2h:
            if rec["kind"] == "spill":
                if not rec["fetched"]:
                    try:
                        self._materialize_spill(rec)
                    except FaultInjected:
                        self._degrade_spill_to_drop(rec)
            else:
                rest.append(rec)
        self._pending_d2h = rest

    def _tier_restore(self, slot: int, plan, rid: int) -> bool:
        """Scatter a match's parked KV into `slot`'s fresh pages: only the
        plan's slabs are staged into the "swap_in" program, and one replay
        writes every leaf; then the restored full pages are device prefix
        pages again (`commit_restore`).  False when it degraded (a failed
        copy, a store object gone or of another type or shape than the
        pool's): the plan's nodes are dropped, and the caller matches the
        prompt again."""
        mgr = self.cache
        tier = mgr._tier
        if any(tier.is_pending(node.node_id) for _, node, _ in plan):
            self._flush_pending_spills()
        nodes = [node for _, node, _ in plan]
        try:
            datas = [mgr.tier_data(node) for node in nodes]
            self._faults.h2d()
            t0 = self._now()
            staged = self._stack_slabs(datas)
        except (KeyError, RuntimeError):
            # FaultInjected is a RuntimeError; data that vanished or does
            # not fit degrades the same way
            mgr.drop_tier_nodes(nodes)
            return False
        ids = np.zeros((mgr.max_pages_per_slot,), np.int32)
        ids[:len(plan)] = [dst for dst, _, _ in plan]
        with self._span("engine.swap.h2d"):
            self._dispatch("swap_in", ids=ids, **staged)
        ms = (self._now() - t0) * 1e3
        self._port_c["swap_in_dispatches"] += 1
        self._swap_ms_c.inc(ms)
        self._port_c["tier_stage_ms"] += ms
        mgr.commit_restore(slot, plan)
        tokens = sum(n for _, _, n in plan)
        self._tier_restores.inc()
        self._tier_restored_tokens.inc(tokens)
        self._tev(rid, "tier_restore", slot=slot, pages=len(plan),
                  tokens=int(tokens))
        return True

    def _stack_slabs(self, datas) -> Dict[str, torch.Tensor]:
        """The plan's slabs as the "swap_in" program's leading corner:
        {leaf: [L, k, page, ...]} on the host.  KeyError when a slab's
        leaves, types or shapes are not the pool's."""
        staged = {}
        for d in datas:
            if set(d) != set(self._pool):
                raise KeyError(f"slab leaves {sorted(d)}, the pool's "
                               f"{sorted(self._pool)}")
        for name, leaf in self._pool.items():
            full = self._full_leaf_shape(name, 1)
            want = full[:1] + full[2:]
            lanes = [lane_to_tensor(d[name], leaf.dtype) for d in datas]
            for t in lanes:
                if tuple(t.shape) != want:
                    raise KeyError(f"slab {name} of shape {tuple(t.shape)}, "
                                   f"the pool's {want}")
            staged[name] = torch.stack(lanes, dim=1)
        return staged

    def export_prefix(self, tokens, rid: Optional[int] = None
                      ) -> Dict[str, int]:
        """The prefill side of a handoff: publish the cached KV chain of
        `tokens` to the store, so an engine on it (a decode-role peer, a
        restarted engine) restores it with one scatter.  The chain's
        LRU-parked device pages spill through the usual gather, the copies
        land, host entries move to the store, and this engine's index blob
        is written again.  Returns {"pages", "tokens", "index_nodes"}, all
        0 with no store or nothing to export (the peer then re-prefills).
        With `rid`, an export that published pages stamps "handoff" on that
        request's timeline (retired by now: it rides its output).  Takes the
        serve lock; its gathers run on the engine's stream, in order with
        the loop's steps, from whatever thread calls it."""
        with self._serve_lock, self._on_device():
            return self._export_prefix(tokens, rid)

    def _export_prefix(self, tokens, rid: Optional[int]) -> Dict[str, int]:
        out = {"pages": 0, "tokens": 0, "index_nodes": 0}
        mgr = self.cache
        tier = mgr._tier
        if not self.kv_tier or tier.store is None:
            return out
        full, partial = mgr._match(np.asarray(tokens, np.int32).reshape(-1))
        chain = list(full) + ([partial[0]] if partial else [])
        if not chain:
            return out
        mgr.spill_lru([nd for nd in chain
                       if nd.page >= 0 and nd.node_id in mgr._lru])
        self._flush_pending_spills()
        for nd in chain:
            if nd.page >= 0 or tier.is_pending(nd.node_id):
                continue                # on the device / the spill failed
            if nd.node_id in tier._host:
                tier.to_disk(nd.node_id)
            if nd.node_id in tier._disk:
                out["pages"] += 1
                out["tokens"] += nd.n_tokens
        out["index_nodes"] = mgr.save_tier_index(tag=tier.tag)
        if out["pages"]:
            self._handoff_exports.inc()
            self._handoff_pages.inc(out["pages"])
            self._handoff_tokens.inc(out["tokens"])
            tr = self._trace_for(rid) if rid is not None else None
            if tr is not None:
                tr.event(self._now(), "handoff", pages=int(out["pages"]),
                         tokens=int(out["tokens"]))
        return out

    def refresh_store_index(self) -> int:
        """The decode side of a handoff: merge the store's index blobs
        again, so the next admission can restore what a prefill peer just
        exported.  Idempotent.  Returns the nodes newly imported."""
        if not self.kv_tier:
            return 0
        with self._serve_lock:
            n = self.cache.load_tier_index()
        self._store_restored_nodes += n
        return n

    def _drop_preempted(self, rid: int) -> Optional[Dict[str, object]]:
        """Remove a resume record on abort or timeout, clearing its host
        swap-pool obligation; returns it (its banked generation feeds the
        output) or None."""
        rec = self._preempted.pop(rid, None)
        if rec is None:
            return None
        if rec["kind"] == "swap":
            self.cache.note_swap_in(rid)
            rec["kind"] = "dropped"     # _drain_swap_d2h skips it
        return rec

    def _swap_in(self, req: Request, rec: Dict[str, object],
                 slot: int) -> bool:
        """Restore a swapped victim into `slot`: fresh pages for its parked
        footprint, its KV staged from its pinned buffers into the "swap_in"
        program and scattered in one replay (every leaf, an int8 pool's
        scales too); it rejoins the decode set with no prefill replay.
        False when it must wait for pages, or was degraded to recompute
        (the caller looks at the record again)."""
        rid = req.request_id
        mgr = self.cache
        try:
            self._materialize_swap(rec)
        except FaultInjected:
            self._degrade_to_recompute(rec)
            return False
        try:
            mgr.allocate(slot, rec["L"])
        except RuntimeError:            # no pages yet: stay queued
            return False
        try:
            self._faults.h2d()
        except FaultInjected:
            mgr.release(slot)
            self._degrade_to_recompute(rec)
            return False
        n = rec["n"]
        ids = np.zeros((mgr.max_pages_per_slot,), np.int32)
        ids[:n] = mgr.slot_pages(slot)[:n]
        t0 = self._now()
        with self._span("engine.swap.h2d"):
            self._dispatch("swap_in", ids=ids, **rec["data"])
        self._port_c["swap_in_dispatches"] += 1
        self._swap_ms_c.inc((self._now() - t0) * 1e3)
        mgr.note_swap_in(rid)
        del self._preempted[rid]
        self._tev(rid, "swap_in", slot=slot, pages=int(n))
        mgr.lengths[slot] = rec["L"]
        self._running[slot] = _Running(
            req, slot, list(rec["generated"]), rec["cached_tokens"],
            rec["ttft"], self._req_greedy(req), rec["streak"],
            rec["spec_off"])
        return True

    def _expire_deadlines(self, finished: List[RequestOutput]) -> None:
        """Retire every request past its deadline, wherever it is (queued
        or swapped, prefilling, decoding), as "timeout", with the tokens it
        had produced.  Runs right after the step-top harvest; injected
        clock skew shifts only this reading.  Re-derives `_has_deadlines`,
        so the scan stops once no deadline is live."""
        now = self._now() + self._faults.skew()
        live = False
        for i in range(len(self._queue) - 1, -1, -1):
            req = self._queue[i]
            if req.deadline is not None and now >= req.deadline:
                del self._queue[i]
                rec = self._drop_preempted(req.request_id)
                finished.append(self._finish_output(
                    req, list(rec["generated"]) if rec is not None else [],
                    "timeout", rec["cached_tokens"] if rec is not None else 0,
                    rec["ttft"] if rec is not None else None))
            elif req.deadline is not None:
                live = True
        for slot, st in list(self._prefilling.items()):
            req = st.request
            if req.deadline is not None and now >= req.deadline:
                del self._prefilling[slot]
                self.cache.release(slot)
                self._free_slots.append(slot)
                finished.append(self._finish_output(
                    req, list(st.prior or []), "timeout", st.cached_tokens,
                    st.ttft))
            elif req.deadline is not None:
                live = True
        for slot, seq in list(self._running.items()):
            req = seq.request
            if req.deadline is not None and now >= req.deadline:
                del self._running[slot]
                self.cache.release(slot)
                self._free_slots.append(slot)
                finished.append(self._finish_output(
                    req, seq.generated, "timeout", seq.cached_tokens,
                    seq.ttft_s))
            elif req.deadline is not None:
                live = True
        self._has_deadlines = live

    def abort(self, request_id: int) -> bool:
        """Cancel a queued (preempted ones too), mid-prefill or running
        request and release its pages, or its host swap-pool obligation, at
        once (shared prefix pages are only dereferenced).  The request lands
        in the outputs with finish_reason "abort" and the tokens it had
        produced (a preempted request's banked generation too).  Returns
        False when the id is unknown or already finished.  Under double
        buffering the in-flight fused step is harvested first, so the abort
        sees exact bookkeeping; requests that harvest finishes are returned
        by the next step()."""
        with self._on_device():
            return self._abort(request_id)

    def _abort(self, request_id: int) -> bool:
        if self._inflight is not None:
            self._harvest(self._orphan_finished)
        for i, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[i]      # by index: prompts have no __eq__
                rec = self._drop_preempted(request_id)
                if rec is not None:
                    self._finish_output(req, list(rec["generated"]), "abort",
                                        rec["cached_tokens"], rec["ttft"])
                else:
                    self._finish_output(req, [], "abort", 0, None)
                return True
        for slot, st in list(self._prefilling.items()):
            if st.request.request_id == request_id:
                del self._prefilling[slot]
                self.cache.release(slot)
                self._free_slots.append(slot)
                # a recompute resume mid-replay keeps its banked generation
                self._finish_output(st.request, list(st.prior or []),
                                    "abort", st.cached_tokens, st.ttft)
                return True
        for slot, seq in list(self._running.items()):
            if seq.request.request_id == request_id:
                del self._running[slot]
                self.cache.release(slot)
                self._free_slots.append(slot)
                self._finish_output(seq.request, seq.generated, "abort",
                                    seq.cached_tokens, seq.ttft_s)
                return True
        return False

    def probe_affinity(self, tokens) -> Dict[str, int]:
        """Router probe: the longest cached prefix of `tokens` this engine
        holds, in tokens, and the part of it in the KV tier (a hit there is
        restored by one scatter).  A pure read: no LRU touch, no COW, no
        refcount.  Takes the serve lock."""
        if not self.prefix_cache:
            return {"cached_tokens": 0, "tier_tokens": 0}
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        with self._serve_lock:
            full, partial = self.cache._match(tokens)
        page = self.cache.page_size
        matched = len(full) * page
        tier = sum(page for n in full if n.page < 0)
        if partial is not None:
            node, j = partial
            matched += j
            if node.page < 0:
                tier += j
        return {"cached_tokens": int(matched), "tier_tokens": int(tier)}

    def run(self) -> Dict[int, RequestOutput]:
        """Step until every request completes; {request_id: output}."""
        while self.has_work:
            self.step()
        return dict(self._outputs)

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._running or self._prefilling or
                    self._inflight is not None or self._orphan_finished)

    @property
    def outputs(self) -> Dict[int, RequestOutput]:
        return dict(self._outputs)

    # ---- serving loop (a fleet's replica, the HTTP door) -------------------
    def start_loop(self, idle_wait_s: float = 0.002) -> None:
        """Start the background step() loop (idempotent).  Idle, it waits on
        the serve condition, which submit() and cancel() notify, and looks
        at `has_work` again every `idle_wait_s`."""
        with self._serve_lock:
            if self._serve_thread is not None and \
                    self._serve_thread.is_alive():
                return
            self._serve_stop = False
            self._serve_error = None
            self._serve_thread = threading.Thread(
                target=self._serve_loop, args=(float(idle_wait_s),),
                name="llm-serve-loop", daemon=True)
            self._serve_thread.start()

    def stop_loop(self, timeout: float = 30.0) -> None:
        """Stop the loop thread (idempotent).  Queued work stays queued:
        drain() first to finish it."""
        with self._serve_cond:
            self._serve_stop = True
            self._serve_cond.notify_all()
        t = self._serve_thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._serve_thread = None

    @property
    def loop_running(self) -> bool:
        t = self._serve_thread
        return t is not None and t.is_alive()

    def _serve_loop(self, idle_wait_s: float) -> None:
        while True:
            with self._serve_cond:
                if self._serve_stop:
                    return
                if not self.has_work:
                    self._serve_cond.wait(idle_wait_s)
                    continue
                try:
                    self.step()
                except BaseException as exc:    # noqa: BLE001 -- raised
                    self._serve_error = exc     # to result()/drain()
                    self._serve_cond.notify_all()
                    return
                self._serve_cond.notify_all()
            # between two steps, let a thread waiting for the lock (a
            # stream's progress, a router's probe) take it: a lock released
            # and taken back at once would starve it until the engine idles
            time.sleep(0)

    def _check_loop(self) -> None:
        if self._serve_error is not None:
            raise RuntimeError("serve loop died") from self._serve_error

    def submit(self, prompt, **kwargs) -> int:
        """add_request() from any thread: enqueue under the serve lock and
        wake the loop.  add_request's signature, validation and
        rejections."""
        with self._serve_cond:
            self._check_loop()
            rid = self.add_request(prompt, **kwargs)
            self._serve_cond.notify_all()
            return rid

    def cancel(self, request_id: int) -> bool:
        """abort() from any thread (a client that hung up): its pages are
        freed at once."""
        with self._serve_cond:
            ok = self.abort(request_id)
            if ok:
                self._serve_cond.notify_all()
            return ok

    def progress(self, request_id: int) -> Dict[str, object]:
        """A streaming snapshot: the tokens a request has produced so far,
        whether it finished (then `output` is its RequestOutput).  Under
        double buffering it may lag the device by the step in flight; it
        is exact at the finish."""
        with self._serve_lock:
            out = self._outputs.get(request_id)
            if out is not None:
                return {"known": True, "finished": True,
                        "token_ids": list(out.token_ids), "output": out}
            for seq in self._running.values():
                if seq.request.request_id == request_id:
                    return {"known": True, "finished": False,
                            "token_ids": list(seq.generated), "output": None}
            for st in self._prefilling.values():
                if st.request.request_id == request_id:
                    return {"known": True, "finished": False,
                            "token_ids": list(st.prior or []),
                            "output": None}
            rec = self._preempted.get(request_id)
            if rec is not None:
                return {"known": True, "finished": False,
                        "token_ids": list(rec.get("generated") or []),
                        "output": None}
            for req in self._queue:
                if req.request_id == request_id:
                    return {"known": True, "finished": False,
                            "token_ids": [], "output": None}
            return {"known": False, "finished": False,
                    "token_ids": [], "output": None}

    def result(self, request_id: int,
               timeout: Optional[float] = None) -> Optional[RequestOutput]:
        """Wait until `request_id` finishes (None after `timeout`).  With the
        loop running this waits on its steps; without it, the caller's
        thread drives step() itself."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._serve_cond:
            while True:
                out = self._outputs.get(request_id)
                if out is not None:
                    return out
                self._check_loop()
                if not self.loop_running:
                    if not self.has_work:
                        return None
                    self.step()
                    continue
                rem = 0.5 if deadline is None \
                    else deadline - time.monotonic()
                if rem <= 0.0:
                    return None
                self._serve_cond.wait(rem)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until the engine is idle (False after `timeout`)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._serve_cond:
            while self.has_work:
                self._check_loop()
                if not self.loop_running:
                    self.step()
                    continue
                rem = 0.5 if deadline is None \
                    else deadline - time.monotonic()
                if rem <= 0.0:
                    return False
                self._serve_cond.wait(rem)
            return True

    def queue_depth(self) -> int:
        """Live requests (queued, prefilling, decoding): the router's load
        signal."""
        with self._serve_lock:
            return (len(self._queue) + len(self._prefilling) +
                    len(self._running))

    def stats(self) -> Dict[str, object]:
        """The reference's flat dict (every key of its `stats()`, the same
        meaning), plus the port's: `fused_dispatches`, `decode_dispatches`,
        `chunk_dispatches`, `verify_dispatches`, `prefill_dispatches`,
        `swap_out_dispatches`, `swap_in_dispatches` (each program's
        dispatches), `graph_replays`, `tier_stage_ms` (the restores' share
        of `swap_ms`), `admitted_requests`, the tier and handoff counters
        at the top level (`tier_spills`, `tier_restores`,
        `tier_restored_tokens`, `partial_page_hits`, `handoff_exports`,
        `handoff_pages`, `handoff_tokens`), `fuse`, `prefix_cache` and
        `device`.  Programs count as the reference's executables do: each
        built program 1 (on the card, its captured graph).  Prefill counts
        each bucket's one-shot program and the chunk program where it is
        standalone (unfused, or the prefix-hit tails of fused bucketed
        mode); copy counts the COW copy; verify the unfused verify program;
        swap the gather and the scatter (preemption swaps and KV-tier
        spills and restores share them).  A health evaluation that raises
        gives an "error" health entry instead of failing the whole dict.
        Host reads only: no device tensor is read."""
        built = {r for r, p in self._programs.items() if p.built}
        cached = self._prefix_cached_tokens.value
        computed = self._prefilled_tokens.value
        events = self._spec_events.value
        try:
            health = self.health()
        except Exception as e:
            health = {"state": "error", "code": max(HEALTH_CODES.values()),
                      "reasons": [f"health evaluation failed: "
                                  f"{type(e).__name__}: {e}"],
                      "burn_rates": {}}
        tier = self._tier_stats()
        return {
            "decode_executables": int(("fused" if self.fused else "decode")
                                      in built),
            "verify_executables": int("verify" in built),
            "prefill_executables": sum(r.startswith("prefill:")
                                       for r in built) + int("chunk" in built),
            "copy_executables": int("copy" in built),
            "swap_executables": int("swap_out" in built) +
                                int("swap_in" in built),
            "graph_replays": sum(p.replays for p in self._programs.values()),
            **self._port_c,
            "buckets": list(self.buckets),
            "prefill_chunk": self.prefill_chunk,
            "spec_len": self.spec_len,
            "mp": self.mp,
            "role": self.role,
            "engine_steps": self._step_idx,
            "decode_iterations": self._decode_iters.value,
            "decode_tokens": self._decode_tokens.value,
            "verify_steps": self._verify_steps.value,
            "spec_events": events,
            "spec_drafted_tokens": self._spec_drafted.value,
            "spec_accepted_tokens": self._spec_accepted.value,
            "spec_emitted_tokens": self._spec_emitted.value,
            "spec_backoffs": self._spec_backoffs.value,
            # tokens emitted per verify event that carried a draft
            "accepted_per_step": self._spec_emitted.value / events
                                 if events else 0.0,
            "prefill_chunks": self._prefill_chunks.value,
            "prefilled_tokens": computed,
            "prefix_cached_tokens": cached,
            "prefix_hit_requests": self._prefix_hit_requests.value,
            "prefix_hit_rate": cached / (cached + computed)
                               if cached + computed else 0.0,
            "cow_page_copies": self._cow_copies.value,
            "fuse": self.fused,
            "prefix_cache": self.prefix_cache,
            "device": str(self.device),
            "pages_in_use": self.cache.pages_in_use(),
            "pages_free": self.cache.num_free_pages,
            "pages_evictable": self.cache.num_evictable_pages,
            "prefix_evictions": self.cache.prefix_evictions,
            "kv_token_capacity": self.cache.token_capacity(),
            "dense_token_footprint": self.cache.num_slots * self.max_model_len,
            "queued": len(self._queue),
            "prefilling": len(self._prefilling),
            "running": len(self._running),
            "admitted_requests": self._admitted_requests.value,
            "finished_requests": self._finished_requests.value,
            "aborted_requests": self._aborted_requests.value,
            "admission": self.admission,
            "preempt": self.preempt,
            "preemptions": self._preemptions.value,
            "preempt_swaps": self._preempt_swaps.value,
            "preempt_recomputes": self._preempt_recomputes.value,
            "swapped_pages": self._swapped_pages_c.value,
            "swap_ms": self._swap_ms_c.value,
            "recomputed_tokens": self._recomputed_tokens.value,
            "timeouts": self._timeouts.value,
            "rejected_requests": self._rejected_requests.value,
            "intake_swap_rejects": self._intake_swap_rejects.value,
            "swapped": self.cache.swapped_requests,
            "kv_pages_swapped": self.cache.swapped_page_count,
            "kv_pool_pressure": round(self.cache.pool_pressure(), 4),
            "kv_tier": tier,
            "tier_spills": tier["spills"],
            "tier_restores": tier["restores"],
            "tier_restored_tokens": tier["restored_tokens"],
            "partial_page_hits": tier["partial_page_hits"],
            "handoff_exports": tier["handoff_exports"],
            "handoff_pages": tier["handoff_pages"],
            "handoff_tokens": tier["handoff_tokens"],
            # the quantization knobs (None: full precision) and the pool's
            # at-rest bytes the capacity math is about
            "weight_dtype": self.weight_dtype,
            "kv_dtype": self.kv_dtype,
            "kv_pool_bytes": self.kv_pool_bytes(),
            # deadline attainment over every retired deadline-bearing
            # request, and final-output tokens by priority class
            "slo": {
                "deadline_requests": self._deadline_requests.value,
                "deadline_met": self._deadline_met.value,
                "deadline_attainment":
                    self._deadline_met.value / self._deadline_requests.value
                    if self._deadline_requests.value else None,
                "goodput_tokens_by_priority":
                    {p: c.value
                     for p, c in sorted(self._goodput_prio.items())},
            },
            "rates": {rw.name: rw.rates() for rw in self._rate_surface},
            "health": {
                "state": health["state"],
                "code": health["code"],
                "reasons": health["reasons"],
                "burn_rates": health["burn_rates"],
            },
            "roofline": {
                "predicted_step_ms": self._predicted_ms,
                "measured_step_ms": self._measured_ewma_ms,
                "drift": self._roofline_drift() or None,
                "drift_alerts": self._roofline_alerts.value,
                "steady_state_recompiles": self._ss_recompiles.value,
            },
            # the lifecycle histograms, seconds
            "latency": {
                "queue_s": self._h_queue.summary(),
                "ttft_s": self._h_ttft.summary(),
                "tpot_s": self._h_tpot.summary(),
                "e2e_s": self._h_e2e.summary(),
                "step_s": self._h_step.summary(),
            },
        }

    def _tier_stats(self) -> Dict[str, object]:
        """stats()' "kv_tier" dict, the reference's keys."""
        tier = self.cache._tier
        return {
            "enabled": self.kv_tier, "spill_dir": self.spill_dir,
            "pages_host": self.cache.tier_pages_host,
            "pages_disk": self.cache.tier_pages_disk,
            "spills": self._tier_spills.value,
            "restores": self._tier_restores.value,
            "restored_tokens": self._tier_restored_tokens.value,
            "partial_page_hits": self._partial_hits.value,
            "disk_spills": 0 if tier is None else tier.disk_spills,
            "disk_restores": 0 if tier is None else tier.disk_restores,
            "tier_drops": 0 if tier is None else tier.tier_drops,
            "store": tier is not None and tier.store is not None,
            "handoff_exports": self._handoff_exports.value,
            "handoff_pages": self._handoff_pages.value,
            "handoff_tokens": self._handoff_tokens.value,
            "store_nodes_restored": self._store_restored_nodes,
        }

    # ---- health and the perf signals ---------------------------------------
    @property
    def predicted_step_ms(self) -> Optional[float]:
        """The reference's static roofline prediction of the decode-side
        step.  None: its cost model is not ported, so the drift gauge reads
        0 and no drift alert fires, as on an unwarmed reference engine."""
        return self._predicted_ms

    def _roofline_drift(self) -> float:
        """measured_step_ms EWMA / predicted ms; 0.0 until both exist."""
        if not self._predicted_ms or not self._measured_ewma_ms:
            return 0.0
        return self._measured_ewma_ms / self._predicted_ms

    def _decode_side_programs(self) -> int:
        """The decode-side programs built (the fused step, or the unfused
        decode program): the counterpart of the reference's executable
        cache size of its decode function."""
        prog = self._programs.get("fused" if self.fused else "decode")
        return int(prog is not None and prog.built)

    def _note_steady_state(self, dur_s: float) -> None:
        """A busy step's perf signals: the measured-step EWMA, the
        drift-band alert (transitions into violation), and the steady-state
        recompile anomaly: decode-side programs built after the first busy
        step since the last reset fixed the baseline (on the card, a graph
        captured after warm-up)."""
        ms = dur_s * 1e3
        self._measured_ewma_ms = ms if self._measured_ewma_ms is None else \
            _EWMA_ALPHA * ms + (1.0 - _EWMA_ALPHA) * self._measured_ewma_ms
        n = self._decode_side_programs()
        if self._exec_baseline is None:
            self._exec_baseline = n
        elif n > self._exec_baseline:
            self._ss_recompiles.inc(n - self._exec_baseline)
            self._exec_baseline = n
        drift = self._roofline_drift()
        lo, hi = SERVE_SLO["roofline_drift_band"]
        bad = bool(drift) and not (lo <= drift <= hi)
        if bad and not self._drift_violation:
            self._roofline_alerts.inc()
        self._drift_violation = bad

    def _burn_rate(self, window_s: float) -> float:
        """Deadline-attainment burn over one window (`health.burn_rate`)."""
        return burn_rate(self._rw_deadline_req, self._rw_deadline_met,
                         window_s, SERVE_SLO["deadline_attainment_target"])

    def health(self) -> Dict[str, object]:
        """The health report (state, code, per-signal detail, reasons)
        against `analysis.registry.SERVE_SLO`, from host state only (see
        `inference.health`); `stats()["health"]` carries the compact
        part."""
        return evaluate_engine_health(self)

    def _health_code(self) -> float:
        """The `engine_health` gauge: 0 ok, 1 degraded, 2 overloaded; an
        evaluation that raises reads as the worst state."""
        try:
            return float(self.health()["code"])
        except Exception:
            return float(max(HEALTH_CODES.values()))

    # ---- trace windows and the postmortem bundle ---------------------------
    @contextlib.contextmanager
    def trace(self, dir_name: str, device: bool = True):
        """A serving trace window into `dir_name`: ``host_trace.json`` (the
        engine's host-phase spans, `ENGINE_SPANS`, as chrome tracing),
        ``step_timeline.json`` (the step ring at exit), ``metrics.json``
        (`metrics.snapshot()` and the proposer's telemetry) and, with
        `device=True`, ``device/`` (a `torch.profiler` chrome trace of the
        window: the CUDA kernels on the card, the spans beside them).
        Inside a user `Profiler` that is already recording, the window
        rides it (the outer buffer and recording go on) and
        ``host_trace.json`` holds everything recorded so far.  No program
        changes: the spans wrap host code."""
        os.makedirs(dir_name, exist_ok=True)
        prof = None
        if not _prof.is_recording():
            prof = _prof.Profiler(timer_only=not device,
                                  log_dir=os.path.join(dir_name, "device"))
            prof.start()
        self._tracing = True
        try:
            yield prof
        finally:
            self._tracing = False
            if prof is not None:
                prof.stop()     # the event buffer survives stop()
            _prof.dump_chrome_trace(os.path.join(dir_name,
                                                 "host_trace.json"))
            with open(os.path.join(dir_name, "step_timeline.json"), "w") as f:
                json.dump(self.step_trace(), f)
            snap = self.metrics.snapshot()
            snap["proposer"] = getattr(self.proposer, "stats", dict)()
            with open(os.path.join(dir_name, "metrics.json"), "w") as f:
                json.dump(snap, f)

    def _request_states(self, finished_limit: int = 64
                        ) -> Dict[str, Dict[str, object]]:
        """Every live request (queued, preempted ones too; prefilling;
        running) and the last `finished_limit` retired ones, with their
        scheduler coordinates and timelines, keyed by request id string."""
        def base(req, state, **extra):
            tr = self._trace_for(req.request_id)
            d = {"state": state, "prompt_len": int(req.prompt.size),
                 "max_new_tokens": int(req.max_new_tokens),
                 "priority": int(req.priority),
                 "deadline": req.deadline,
                 "events": list(tr.events) if tr is not None else []}
            d.update(extra)
            return d

        out: Dict[str, Dict[str, object]] = {}
        for req in list(self._queue):
            rec = self._preempted.get(req.request_id)
            out[str(req.request_id)] = base(
                req, "queued",
                preempted_kind=None if rec is None else rec["kind"],
                banked_tokens=0 if rec is None else len(rec["generated"]))
        for slot, st in list(self._prefilling.items()):
            out[str(st.request.request_id)] = base(
                st.request, "prefilling", slot=slot, filled=int(st.filled),
                effective_prompt_len=int(st.prompt.size))
        for slot, seq in list(self._running.items()):
            out[str(seq.request.request_id)] = base(
                seq.request, "running", slot=slot,
                n_generated=len(seq.generated),
                kv_len=int(self.cache.lengths[slot]),
                spec_off=seq.spec_off)
        recent = list(itertools.islice(reversed(self._outputs),
                                       finished_limit))
        for rid in reversed(recent):
            o = self._outputs[rid]
            out[str(rid)] = {
                "state": "finished", "finish_reason": o.finish_reason,
                "prompt_len": int(np.asarray(o.prompt).size),
                "n_generated": len(o.token_ids),
                "cached_tokens": int(o.cached_tokens),
                "events": list(o.trace.events) if o.trace is not None else [],
            }
        return out

    def debug_bundle(self, finished_limit: int = 64) -> Dict[str, object]:
        """The postmortem snapshot (the reference's keys): configuration,
        page levels, request states with their timelines, the step ring,
        `stats()` and a metrics snapshot, all plain JSON.  Host state only:
        safe to call mid-flight or after a step raised."""
        mgr = self.cache
        return {
            "version": 1,
            "t": self._now(),
            "engine": {
                "num_slots": mgr.num_slots, "page_size": mgr.page_size,
                "num_pages": mgr.num_pages,
                "max_model_len": self.max_model_len,
                "prefill_chunk": self.prefill_chunk,
                "spec_len": self.spec_len, "fused": self.fused,
                "double_buffer": self.double_buffer,
                "admission": self.admission, "preempt": self.preempt,
                "kv_tier": self.kv_tier, "spill_dir": self.spill_dir,
                "mp": self.mp, "weight_dtype": self.weight_dtype,
                "kv_dtype": self.kv_dtype,
                "request_tracing": self._req_tracing,
                "inflight": self._inflight is not None,
                "device": str(self.device),
            },
            "pool": {
                "pages_in_use": mgr.pages_in_use(),
                "pages_free": mgr.num_free_pages,
                "pages_evictable": mgr.num_evictable_pages,
                "kv_pages_swapped": mgr.swapped_page_count,
                "swapped_requests": mgr.swapped_requests,
                "pool_pressure": round(mgr.pool_pressure(), 4),
                "kv_pool_bytes": self.kv_pool_bytes(),
                "swap_pool_pages": self.swap_pool_pages,
                "kv_tier_pages_host": mgr.tier_pages_host,
                "kv_tier_pages_disk": mgr.tier_pages_disk,
            },
            "requests": self._request_states(finished_limit),
            "step_trace": self.step_trace(),
            "stats": self.stats(),
            "metrics": self.metrics.snapshot(),
        }

    def dump_debug_bundle(self, dir_name: str,
                          finished_limit: int = 64) -> str:
        """Write `debug_bundle()` to ``<dir_name>/debug_bundle.json``;
        returns the path."""
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(dir_name, "debug_bundle.json")
        with open(path, "w") as f:
            json.dump(self.debug_bundle(finished_limit), f)
        return path

    def host_pool_bytes(self) -> int:
        """Worst-case host memory of the swap pool: `swap_pool_pages` times
        one page's bytes across all layers and leaves (an int8 pool parks
        int8 pages and their scales)."""
        return self.swap_pool_pages * kv_page_bytes(
            self.config, self.cache.page_size, self.kv_dtype)

    def swap_pool_bytes(self) -> int:
        """The reference's older name for `host_pool_bytes`."""
        return self.host_pool_bytes()

    def kv_pool_bytes(self) -> int:
        """At-rest bytes of the device KV pool, every leaf (the scale lanes
        of an int8 pool too); under mp, rank 0's shard (each rank holds
        as much)."""
        return sum(t.numel() * t.element_size() for t in self._pool.values())

    def rank_pool_bytes(self) -> List[int]:
        """Every rank's `kv_pool_bytes`, rank 0 first (the workers'
        asked)."""
        rest = self._link.worker_query("pool_bytes") if self._link else []
        return [self.kv_pool_bytes()] + rest

    def rank_replays(self) -> List[int]:
        """Every rank's graph replays (`stats()["graph_replays"]` on rank
        0), rank 0 first."""
        rest = self._link.worker_query("replays") if self._link else []
        return [sum(p.replays for p in self._programs.values())] + rest


def draw_noise(config, generator, device, rows: int, mesh=None):
    """One pick's Gumbel noise [rows, V] from `generator`, or a rank's vocab
    columns of it under `mesh` (every rank draws the full width, so the
    ranks' generators stay in step and their columns are the mp=1
    noise)."""
    noise = gpt_mod.gumbel_noise((rows, config.vocab_size), config.dtype,
                                 generator, device)
    if mesh is None:
        return noise
    return noise[:, mesh.vocab_slice(config.vocab_size)]


def _capture_mode(mesh) -> str:
    """A program's capture error mode: "thread_local" where it captures
    NCCL collectives (see `graphs.capture`), else "global"."""
    return "thread_local" if mesh is not None and mesh.backend == "nccl" \
        else "global"


def _shared(t: torch.Tensor) -> torch.Tensor:
    """`t` in shared host memory (moved there if it is not)."""
    return t if t.is_shared() else t.contiguous().share_memory_()


def _release_link(link, mesh) -> None:
    """An mp engine's finalizer: the workers drop its part, and a mesh the
    engine built closes."""
    link.drop()
    if mesh is not None:
        mesh.close()


def pick_tokens(logits, greedy, noise, sampling, mesh=None) -> torch.Tensor:
    """[B, V] logits -> [B] int32 on the device: argmax, or the Gumbel pick
    under `noise` [B, V] with the greedy mask routing temperature=0.0
    requests to the argmax.  sampling: (sample, temperature, top_k).
    Under `mesh` the logits and the noise are the rank's vocab columns."""
    sample, temperature, top_k = sampling
    if not sample:
        return gpt_mod.sharded_argmax(logits, mesh)
    ids = gpt_mod.sample_token(logits, None, sample=True,
                               temperature=temperature, top_k=top_k,
                               noise=noise, mesh=mesh)
    return torch.where(greedy, gpt_mod.sharded_argmax(logits, mesh), ids)


# the programs' bodies: (params, config, pool, sampling, mesh) bound by the
# engine (a worker binds its own), the static inputs by name


def _fused_body(params, config, pool, sampling, mesh, tokens, table,
                q_offset, valid, greedy, noise=None):
    """[B, T + 1] int32: the step's tokens, then each slot's accept count
    (one output, so one host copy)."""
    sample, temperature, top_k = sampling
    out, accept, _ = gpt_mod.serve_step_paged(
        params, tokens, pool, table, q_offset, valid, config, greedy=greedy,
        sample=sample, temperature=temperature, top_k=top_k, mesh=mesh,
        noise=noise)
    return torch.cat([out, accept[:, None]], dim=1)


def _decode_body(params, config, pool, sampling, mesh, tokens, table,
                 lengths, greedy, noise=None):
    logits, _ = gpt_mod.decode_step_paged(params, tokens, pool, table,
                                          lengths, config, mesh=mesh)
    return pick_tokens(logits, greedy, noise, sampling, mesh)


def _verify_body(params, config, pool, sampling, mesh, tokens, table,
                 q_offset, valid):
    """Greedy only: the argmax at every position, [B, T] int32."""
    logits, _ = gpt_mod.verify_step_paged(params, tokens, pool, table,
                                          q_offset, valid, config, mesh=mesh)
    return gpt_mod.sharded_argmax(logits, mesh)


def _chunk_body(params, config, pool, sampling, mesh, tokens, table,
                q_offset, valid, greedy, noise=None):
    logits, _ = gpt_mod.prefill_chunk_paged(params, tokens, config, pool,
                                            table, q_offset, valid,
                                            mesh=mesh)
    return pick_tokens(logits, greedy, noise, sampling, mesh)


def _prefill_body(params, config, pool, sampling, mesh, ids, pages, length,
                  greedy, noise=None):
    logits, _ = gpt_mod.prefill_paged(params, ids, config, pool, pages,
                                      length, mesh=mesh)
    return pick_tokens(logits, greedy, noise, sampling, mesh)


def _copy_body(params, config, pool, sampling, mesh, src, dst):
    """COW page copy: page `src` into page `dst` in every leaf of the pool
    (k and v, and the scale lanes of an int8 pool), in place."""
    src, dst = src.long(), dst.long()
    for leaf in pool.values():
        leaf.index_copy_(1, dst, leaf.index_select(1, src))


def _swap_out_body(params, config, pool, sampling, mesh, ids):
    """The victim's pages, every leaf, [L, max_pages, ...] each."""
    return gpt_mod.swap_out_pages(pool, ids)


def _swap_in_body(params, config, pool, sampling, mesh, ids, **data):
    """The parked pages back into the pool, every leaf, in place."""
    gpt_mod.swap_in_pages(pool, ids, data)


_BODIES = {"fused": _fused_body, "decode": _decode_body,
           "verify": _verify_body, "chunk": _chunk_body,
           "prefill": _prefill_body, "copy": _copy_body,
           "swap_out": _swap_out_body, "swap_in": _swap_in_body}
