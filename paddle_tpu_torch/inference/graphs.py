"""The serving engine's step programs as CUDA graphs — the port's
counterpart of the reference's one jitted executable per step
(`jax.jit(fused_impl, donate_argnums=(2,))` in `LLMEngine.__init__`).

A `StepProgram` is one step body at one fixed shape.  It owns a static
device buffer for each input (tokens, page table, offsets, greedy mask,
noise), a host staging buffer beside each (pinned on the card), and the
body's output with a pinned host copy.  `stage` writes every input each
call: numpy arrays through the staging buffers (`copy_(...,
non_blocking=True)`, ordered on the stream before the step), device tensors
(the sampling noise) by a device copy.  `run` dispatches the step and
queues its output's copy to the host; `result` waits for that copy on an
event, not a stream sync.  The pool and the parameters are used in place.

`build` (called by the first `stage`) runs the body once eagerly on inert
inputs (every table row on the null page, which it may write, in every
leaf of the pool: k and v, and the scale lanes of an int8 pool).  On the card
that run goes on a side stream and builds the kernels and everything their
wrappers cache (RMSNorm's shared-memory attribute and occupancy, the paged
kernels' split counters, cuBLAS's handle and workspace); then the body is
captured on the same stream into a `torch.cuda.CUDAGraph`, and every `run`
is one `replay()`.  A failed capture or replay raises: nothing falls back to
the eager step.  The cycle collector is off during a capture: freeing
another graph there would invalidate it.  With `capture=False`, and always
on the CPU, `run` calls the body eagerly over the same static buffers.  A
program built in the middle of serving (the COW copy, a new prefill
bucket) warms up and captures behind everything queued on the current
stream, and the current stream waits for it before the program's first
run.  `mempool` (a `torch.cuda.graph_pool_handle()`) lets programs that
never run at once share one graph memory pool; a program's output is
copied to the host right after its replay, before another program of the
pool runs.  A body that returns None (the COW copy) has no output to
fetch, nor does one built with `fetch=False` (the swap gather, whose
output is a dict of pool leaves the engine copies to the host itself,
one pinned buffer a victim or a spill).
A `device_fed` input may be staged from a smaller tensor, which fills its
leading corner (the swap scatter's pages, from a victim's pinned host
buffer of its real pages).

The kernel wrappers count launches in Python, so each replay adds the counts
its capture made (`incubate.kernels.add_counts`), and the build takes back
its own: counts after a graph run equal the eager run's on the same
traffic.  The graph keeps alive the split counters it baked in
(`paged_attention.split_counters`), should a later eager call on the side
stream replace them.  Dropping the program releases the graph and its pool.

Several engines in one process (a fleet's replicas, each stepped by a loop
thread of its own) share the device, and a capture must see no other CUDA
work: `torch.cuda.graph` captures in the global mode, where another
thread's allocation or synchronising call fails that call or the capture,
and two captures on one side stream would interleave.  So `GATE`, a
process-wide reader-writer gate, orders them: `build` holds it exclusively
(warm-up, capture and the collector switch), while every engine step and
every dispatch an engine makes outside a step holds it shared
(`CaptureGate.shared`).  A build reached inside a step (a lazy capture: a
new bucket, the COW copy, the swap pair at a first spill) gives up its own
thread's shared hold for the exclusive one and takes it back after.
Captures are rare (one per program per engine), so in steady state only
shared holds are taken, and those never wait on each other.  Each engine
stream gets a side stream of its own, so graphs replayed on different
streams never share the split counters they baked in.

Under tensor-parallel serving a program on rank 0 has a `mirror` (the
engine's link to its `parallel.tp.ServingMesh`): `build` tells every
worker to build its own copy of the program before rank 0 builds, and
`run` sends the staged host inputs, before rank 0 runs, to the workers,
which stage them into their copies and run them.  The bodies' collectives
then meet in the same order on every rank, the warm-up's and (under NCCL)
the captured ones; a worker draws the sampled lane's noise itself.
Several engines may share one mesh (a fleet's replicas), each stepped by
its own thread, so the span from the workers' message through rank 0's
own run (its replay enqueues, or its eager body runs, its collectives)
holds the mesh's lock (`mirror.lock`), and so does a build, inside its
exclusive hold of `GATE`: two steps that interleaved there would meet
each other's collectives, a hang or a wrong sum under NCCL.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ..incubate import kernels as K
from ..incubate.kernels.paged_attention import split_counters

class CaptureGate:
    """A reader-writer gate between graph captures (exclusive) and the
    engines' device work (shared).  Both holds are reentrant in a thread.
    A thread that asks for the exclusive hold while it holds shared ones
    gives them up while it waits and takes them back when it leaves (a
    capture inside a step).  A waiting capture goes before new shared
    holders, so busy loops cannot starve it; a thread that already holds
    the gate shared never waits for a nested shared hold."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers: Dict[int, int] = {}  # thread -> shared holds
        self._writer = None                 # the thread holding it exclusively
        self._depth = 0                     # its nested exclusive holds
        self._waiting = 0                   # threads waiting to take it so

    @contextlib.contextmanager
    def shared(self) -> Iterator[None]:
        me = threading.get_ident()
        with self._cond:
            n = self._readers.get(me, 0)
            if not n and self._writer != me:
                while self._writer is not None or self._waiting:
                    self._cond.wait()
            self._readers[me] = n + 1
        try:
            yield
        finally:
            with self._cond:
                n = self._readers.pop(me) - 1
                if n:
                    self._readers[me] = n
                else:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self) -> Iterator[None]:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                held = None
                self._depth += 1
            else:
                held = self._readers.pop(me, 0)
                if held:
                    self._cond.notify_all()
                self._waiting += 1
                while self._writer is not None or self._readers:
                    self._cond.wait()
                self._waiting -= 1
                self._writer, self._depth = me, 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if not self._depth:
                    self._writer = None
                    if held:
                        self._readers[me] = held
                    self._cond.notify_all()

    def holds(self) -> Tuple[int, bool]:
        """This thread's (shared holds, whether it holds it exclusively)."""
        me = threading.get_ident()
        with self._cond:
            return self._readers.get(me, 0), self._writer == me


# one gate a process: a capture excludes CUDA work on every device
GATE = CaptureGate()

_side_streams: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}


def side_stream(device, stream=None) -> "torch.cuda.Stream":
    """The stream every program dispatched on `stream` (default: the
    current stream of `device`) warms up and captures on."""
    index = torch.cuda._get_device_index(device, optional=True)
    if stream is None:
        stream = torch.cuda.current_stream(index)
    key = (index, stream.cuda_stream)
    s = _side_streams.get(key)
    if s is None:
        s = _side_streams[key] = torch.cuda.Stream(index)
    return s


def capture(fn: Callable[[], object], device, mempool=None,
            mode: str = "global"):
    """Run `fn()` once eagerly on the side stream of the current stream
    (it builds the kernels and whatever their wrappers cache), then capture
    it on that stream into a `torch.cuda.CUDAGraph`.  The caller holds
    `GATE` exclusively and takes back the launch counts the two runs made.
    `mode` is the capture's error mode: "global" (any thread's unsafe CUDA
    call fails the capture), or "thread_local" for a program whose NCCL
    collectives are captured (the process group's watchdog thread polls
    the events of earlier collectives; `GATE` still keeps other engines
    out).  Returns (graph, the captured call's output, the launch counts
    one replay adds, the split counters the graph baked in)."""
    cur = torch.cuda.current_stream(device)
    side = side_stream(device, cur)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
        mid = K.counts()
        graph = torch.cuda.CUDAGraph()
        # no cycle collection in the capture: freeing another graph there
        # invalidates it
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=mempool, stream=side,
                                  capture_error_mode=mode):
                out = fn()
        finally:
            if collecting:
                gc.enable()
    cur.wait_stream(side)
    after = K.counts()
    delta = {k: after[k] - mid[k] for k in after if after[k] != mid[k]}
    return graph, out, delta, split_counters(device, side)


class StepProgram:
    """One step body `body(**inputs) -> out` over static input buffers.
    `inputs`: {name: (shape, dtype, inert value)}; those named in
    `device_fed` are staged from device tensors and get no host buffer."""

    def __init__(self, name: str, body: Callable[..., torch.Tensor],
                 inputs: Dict[str, Tuple[tuple, torch.dtype, object]],
                 device: torch.device, capture: bool = True,
                 device_fed: Tuple[str, ...] = (), mempool=None,
                 fetch: bool = True, mirror=None,
                 capture_mode: str = "global"):
        self.name = name
        self.capture_mode = capture_mode
        self.mirror = mirror
        self._mirrored: Dict[str, np.ndarray] = {}
        self.device = device
        self.capture = capture and device.type == "cuda"
        self.mempool = mempool
        self.fetch = fetch
        self._body = body
        self._inert = {n: v for n, (_, _, v) in inputs.items()}
        self.inputs = {n: torch.empty(shape, dtype=dtype, device=device)
                       for n, (shape, dtype, _) in inputs.items()}
        pin = device.type == "cuda"
        self._host = {n: torch.empty(shape, dtype=dtype, pin_memory=pin)
                      for n, (shape, dtype, _) in inputs.items()
                      if n not in device_fed}
        self._host_np = {n: t.numpy() for n, t in self._host.items()}
        self.graph = None
        self.out = None
        self._host_out = None
        self.built = False
        self.replays = 0
        self.build_s = None         # the warm-up and capture's wall seconds
        self._delta: Dict = {}
        self._keep = None           # split counters the graph baked in
        # events (card only): the last staging copies ran; the last output
        # copy ran.  Re-recorded each step; a never-recorded one is done.
        self._staged = torch.cuda.Event() if pin else None
        self._fetched = torch.cuda.Event() if pin else None
        self._fresh = False         # staged since the last run

    def build(self) -> None:
        """Warm up on inert inputs, then capture (on the card), holding
        `GATE` exclusively.  Idempotent."""
        if self.built:
            return
        with GATE.exclusive():
            if not self.built:
                if self.mirror is None:
                    self._build()
                    return
                with self.mirror.lock:
                    self.mirror.build(self.name)
                    self._build()

    def _build(self) -> None:
        t0 = time.perf_counter()
        before = K.counts()
        for n, t in self.inputs.items():
            t.fill_(self._inert[n])
        if self.capture:
            self.graph, self.out, self._delta, self._keep = capture(
                lambda: self._body(**self.inputs), self.device, self.mempool,
                self.capture_mode)
        else:
            self.out = self._body(**self.inputs)
        K.add_counts({k: before[k] - n for k, n in K.counts().items()})
        if self.out is not None and self.fetch:
            self._host_out = torch.empty(
                self.out.shape, dtype=self.out.dtype,
                pin_memory=self.device.type == "cuda")
        self.built = True
        self.build_s = time.perf_counter() - t0

    def stage(self, **values) -> None:
        """Write every input for the next `run`: numpy-like values through
        the host staging buffers, the `device_fed` ones by a copy into the
        buffer's leading corner of the value's shape."""
        if set(values) != set(self.inputs):
            raise ValueError(f"{self.name}: stage every input "
                             f"{sorted(self.inputs)}, got {sorted(values)}")
        self.build()
        if self._staged is not None:
            # the last staging copies must have read the host buffers
            self._staged.synchronize()
        for n, v in values.items():
            if n not in self._host:
                dst = self.inputs[n]
                if tuple(v.shape) != tuple(dst.shape):
                    dst = dst[tuple(slice(0, k) for k in v.shape)]
                dst.copy_(v, non_blocking=True)
                continue
            self._host_np[n][...] = v
            self.inputs[n].copy_(self._host[n], non_blocking=True)
            if self.mirror is not None:
                self._mirrored[n] = self._host_np[n].copy()
        if self._staged is not None:
            self._staged.record()
        self._fresh = True

    def run(self) -> torch.Tensor:
        """One step over the staged inputs: a graph replay on the card (or
        the eager body), then the output's copy to the host is queued.
        Returns the device output (overwritten by the next run), or
        None.  Without `fetch`, no copy is queued."""
        if not self._fresh:
            raise RuntimeError(f"{self.name}: stage the inputs before each "
                               f"run")
        self._fresh = False
        if self.mirror is None:
            self._run()
        else:
            with self.mirror.lock:
                self.mirror.run(self.name, self._mirrored)
                self._run()
        if self._host_out is None:
            return self.out
        self._host_out.copy_(self.out, non_blocking=True)
        if self._fetched is not None:
            self._fetched.record()
        return self.out

    def _run(self) -> None:
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            K.add_counts(self._delta)
        else:
            self.out = self._body(**self.inputs)

    def result(self) -> np.ndarray:
        """The last run's output on the host (waits for its copy)."""
        if self._fetched is not None:
            self._fetched.synchronize()
        return self._host_out.numpy().copy()
