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
the eager step.  With `capture=False`, and always on the CPU, `run` calls
the body eagerly over the same static buffers.

The kernel wrappers count launches in Python, so each replay adds the counts
its capture made (`incubate.kernels.add_counts`), and the build takes back
its own: counts after a graph run equal the eager run's on the same
traffic.  The graph keeps alive the split counters it baked in
(`paged_attention.split_counters`), should a later eager call on the side
stream replace them.  Dropping the program releases the graph and its pool.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..incubate import kernels as K
from ..incubate.kernels.paged_attention import split_counters

_side_streams: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device) -> "torch.cuda.Stream":
    """The stream every program on `device` warms up and captures on."""
    index = torch.cuda._get_device_index(device, optional=True)
    s = _side_streams.get(index)
    if s is None:
        s = _side_streams[index] = torch.cuda.Stream(index)
    return s


class StepProgram:
    """One step body `body(**inputs) -> out` over static input buffers.
    `inputs`: {name: (shape, dtype, inert value)}; those named in
    `device_fed` are staged from device tensors and get no host buffer."""

    def __init__(self, name: str, body: Callable[..., torch.Tensor],
                 inputs: Dict[str, Tuple[tuple, torch.dtype, object]],
                 device: torch.device, capture: bool = True,
                 device_fed: Tuple[str, ...] = ()):
        self.name = name
        self.device = device
        self.capture = capture and device.type == "cuda"
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
        self._delta: Dict = {}
        self._keep = None           # split counters the graph baked in
        # events (card only): the last staging copies ran; the last output
        # copy ran.  Re-recorded each step; a never-recorded one is done.
        self._staged = torch.cuda.Event() if pin else None
        self._fetched = torch.cuda.Event() if pin else None
        self._fresh = False         # staged since the last run

    def build(self) -> None:
        """Warm up on inert inputs, then capture (on the card).  Idempotent."""
        if self.built:
            return
        before = K.counts()
        for n, t in self.inputs.items():
            t.fill_(self._inert[n])
        if self.capture:
            cur = torch.cuda.current_stream(self.device)
            side = side_stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self._body(**self.inputs)
                mid = K.counts()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side):
                    out = self._body(**self.inputs)
            cur.wait_stream(side)
            after = K.counts()
            self._delta = {k: after[k] - mid[k] for k in after
                           if after[k] != mid[k]}
            self._keep = split_counters(self.device, side)
            self.graph, self.out = graph, out
        else:
            self.out = self._body(**self.inputs)
        K.add_counts({k: before[k] - n for k, n in K.counts().items()})
        self._host_out = torch.empty(self.out.shape, dtype=self.out.dtype,
                                     pin_memory=self.device.type == "cuda")
        self.built = True

    def stage(self, **values) -> None:
        """Write every input for the next `run`: numpy-like values through
        the host staging buffers, the `device_fed` ones by a device copy."""
        if set(values) != set(self.inputs):
            raise ValueError(f"{self.name}: stage every input "
                             f"{sorted(self.inputs)}, got {sorted(values)}")
        self.build()
        if self._staged is not None:
            # the last staging copies must have read the host buffers
            self._staged.synchronize()
        for n, v in values.items():
            if n not in self._host:
                self.inputs[n].copy_(v)
                continue
            self._host_np[n][...] = v
            self.inputs[n].copy_(self._host[n], non_blocking=True)
        if self._staged is not None:
            self._staged.record()
        self._fresh = True

    def run(self) -> torch.Tensor:
        """One step over the staged inputs: a graph replay on the card (or
        the eager body), then the output's copy to the host is queued.
        Returns the device output (overwritten by the next run)."""
        if not self._fresh:
            raise RuntimeError(f"{self.name}: stage the inputs before each "
                               f"run")
        self._fresh = False
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            K.add_counts(self._delta)
        else:
            self.out = self._body(**self.inputs)
        self._host_out.copy_(self.out, non_blocking=True)
        if self._fetched is not None:
            self._fetched.record()
        return self.out

    def result(self) -> np.ndarray:
        """The last run's output on the host (waits for its copy)."""
        if self._fetched is not None:
            self._fetched.synchronize()
        return self._host_out.numpy().copy()
