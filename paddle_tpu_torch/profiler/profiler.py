"""Profiler — port of `paddle_tpu/profiler/profiler.py`, its host-span half
and the device capture.

Host spans are recorded by this module into one bounded buffer and exported
as chrome-tracing JSON (`dump_chrome_trace`, `export_chrome_tracing`).
`RecordEvent` also opens a `torch.profiler.record_function` scope, so a span
lands in the device trace beside the kernels it launched.  The device
capture is a `torch.profiler.profile` over the CPU and, where a card is
present, CUDA activities (the reference starts `jax.profiler.start_trace`);
`Profiler.stop()` exports it as a chrome trace into `log_dir`.  On a
machine with a CUDA device a capture that fails to start raises: only a
machine without one degrades to host spans alone, so a trace taken on the
card never silently lacks its device half.  `timer.py` (`Benchmark`) is not
ported yet.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from enum import Enum
from typing import Callable, Iterable, Optional

import torch


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class _HostEvent:
    __slots__ = ("name", "start", "end", "tid")

    def __init__(self, name, start, end, tid):
        self.name = name
        self.start = start
        self.end = end
        self.tid = tid


# Host-span buffer cap: recording is a ring over the newest spans, like the
# serving engine's step-trace ring — a trace window left open over a soak run
# must not grow host memory without bound (~10 engine spans per serving step).
HOST_EVENT_CAP = 1_000_000

_events = deque(maxlen=HOST_EVENT_CAP)
_recording = False


def is_recording() -> bool:
    """Whether a Profiler is currently collecting host spans — callers with
    spans on a hot path (the serving engine's per-step phases) gate span
    construction on this instead of paying RecordEvent setup every step."""
    return _recording


class RecordEvent:
    """Span annotation (reference `RecordEvent`); also opens a
    `torch.profiler.record_function` scope, so the span appears in the
    device trace of a `torch.profiler` capture."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None
        self._scope = None

    def begin(self):
        self._t0 = time.perf_counter_ns()
        self._scope = torch.profiler.record_function(self.name)
        self._scope.__enter__()

    def end(self):
        if self._scope is not None:
            self._scope.__exit__(None, None, None)
            self._scope = None
        if _recording and self._t0 is not None:
            _events.append(_HostEvent(self.name, self._t0,
                                      time.perf_counter_ns(),
                                      threading.get_ident()))

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def make_scheduler(closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        period = closed + ready + record
        if repeat > 0 and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD
    return scheduler


def dump_chrome_trace(fname: str) -> None:
    """Serialize the host spans recorded so far (the module event buffer) as
    chrome-tracing JSON — usable mid-recording, so a capture window nested
    inside a longer-running Profiler can snapshot without stopping it."""
    traceEvents = [{
        "name": e.name, "ph": "X", "ts": e.start / 1000.0,
        "dur": (e.end - e.start) / 1000.0, "pid": 0, "tid": e.tid,
    } for e in _events]
    with open(fname, "w") as f:
        json.dump({"traceEvents": traceEvents}, f)


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        fname = os.path.join(dir_name, f"{worker_name or 'worker'}_trace.json")
        prof._export_chrome(fname)
        print(f"[profiler] chrome trace written to {fname}")
    return handler


def load_profiler_result(filename: str):
    with open(filename) as f:
        return json.load(f)


class Profiler:
    """Host spans, and (unless `timer_only`) a `torch.profiler` device
    capture written to `log_dir` as `torchtrace_<seconds>.json` at `stop()`
    (the path is `device_trace_path` after it)."""

    def __init__(self, targets: Optional[Iterable] = None, scheduler=None,
                 on_trace_ready=None, record_shapes=False,
                 profile_memory=False, timer_only=False, emit_nvtx=False,
                 custom_device_types=None, with_flops=False,
                 log_dir="profiler_log"):
        if callable(scheduler):
            self._scheduler = scheduler
        elif scheduler:
            self._scheduler = make_scheduler(*scheduler)
        else:
            self._scheduler = lambda step: ProfilerState.RECORD
        self._on_trace_ready = on_trace_ready
        self._step = 0
        self._timer_only = timer_only
        self._log_dir = log_dir
        self._record_shapes = record_shapes
        self._profile_memory = profile_memory
        self._torch_prof = None
        self.device_trace_path: Optional[str] = None
        self._state = ProfilerState.CLOSED

    def _start_device_capture(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts,
                                      record_shapes=self._record_shapes,
                                      profile_memory=self._profile_memory)
        prof.__enter__()
        self._torch_prof = prof

    def start(self):
        global _recording, _events
        _events = deque(maxlen=HOST_EVENT_CAP)
        _recording = True
        self._state = self._scheduler(self._step)
        self.device_trace_path = None
        if not self._timer_only:
            if torch.cuda.is_available():
                # on the card the device half is the point of the capture
                self._start_device_capture()
            else:
                try:
                    self._start_device_capture()
                # no CUDA device: a failed CPU capture leaves host spans only
                except Exception:
                    self._torch_prof = None

    def stop(self):
        global _recording
        _recording = False
        prof, self._torch_prof = self._torch_prof, None
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(self._log_dir, exist_ok=True)
            path = os.path.join(self._log_dir,
                                f"torchtrace_{int(time.time())}.json")
            prof.export_chrome_trace(path)
            self.device_trace_path = path
        if self._on_trace_ready:
            self._on_trace_ready(self)

    def step(self, num_samples=None):
        self._step += 1
        self._state = self._scheduler(self._step)

    def step_info(self, unit=None):
        return f"step {self._step}"

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def _export_chrome(self, fname):
        dump_chrome_trace(fname)

    def export(self, path, format="json"):
        self._export_chrome(path)

    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True,
                thread_sep=False, time_unit="ms"):
        from collections import defaultdict
        agg = defaultdict(lambda: [0, 0.0])
        for e in _events:
            agg[e.name][0] += 1
            agg[e.name][1] += (e.end - e.start) / 1e6
        lines = [f"{'name':40s} {'calls':>8s} {'total(ms)':>12s}"]
        for name, (calls, total) in sorted(agg.items(),
                                           key=lambda kv: -kv[1][1]):
            lines.append(f"{name[:40]:40s} {calls:8d} {total:12.3f}")
        table = "\n".join(lines)
        print(table)
        return table
