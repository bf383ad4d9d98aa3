"""Fault injection for the serving engine's overload machinery — the
port's own copy of `paddle_tpu/inference/faults.py` (plain Python, no
framework).

Preemption, KV swapping and deadline expiry are exactly the code paths that
never fire under a healthy CPU-smoke load — and exactly the ones that corrupt
page accounting when they are wrong.  `FaultPlan` is the injectable chaos
plan tests hand to `LLMEngine(fault_plan=...)` to force those paths
deterministically:

- **pool pressure** (`pressure_steps`): at each listed engine step, the first
  optimistic-admission page-growth attempt is treated as out-of-pages, forcing
  a preemption even when the pool has room — the trigger for
  preempt-mid-verify / preempt-mid-chunk-prefill interleavings.
- **failing copies** (`fail_d2h` / `fail_h2d`): the next N swap-out
  device->host materializations / swap-in host->device restores raise
  `FaultInjected`; the engine must degrade the victim to recompute with zero
  leaked pages (and zero leaked host copies).
- **clock skew** (`skew_s`): added to the engine clock ONLY when deadlines
  are evaluated — a monotonic-clock jump (NTP step, VM migration) must at
  worst expire requests early with clean `finish_reason="timeout"`
  accounting, never wedge or leak.

The plan is mutable state (consumed injections are spent); build a fresh one
per engine.  Production engines run with the inert default plan — every hook
is a cheap attribute read returning falsy.

The reference's health plane rides the same hooks (forced pressure drives
its preemption rate, skew its deadline timeouts); the port's health plane
is a later slice (ROADMAP Queue 1: metrics, tracing and health).
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet, Iterable


class FaultInjected(RuntimeError):
    """Raised by injected d2h/h2d copy failures — the ONLY exception the
    engine's swap fallback catches (a real transfer failure must propagate)."""


@dataclasses.dataclass
class FaultPlan:
    """A deterministic chaos plan for one engine instance.  All fields
    default to inert; see module docstring for semantics."""
    pressure_steps: Iterable[int] = ()
    fail_d2h: int = 0
    fail_h2d: int = 0
    skew_s: float = 0.0

    def __post_init__(self):
        self._pressure: FrozenSet[int] = frozenset(self.pressure_steps)
        self._fired_pressure: set = set()
        self._d2h_left = int(self.fail_d2h)
        self._h2d_left = int(self.fail_h2d)

    def pool_pressure(self, step: int) -> bool:
        """True at most ONCE per listed step: the engine treats the first
        growth attempt of that step as a failed allocation."""
        if step in self._pressure and step not in self._fired_pressure:
            self._fired_pressure.add(step)
            return True
        return False

    def d2h(self) -> None:
        """Called before each swap-out materialization; raises while the
        injected d2h failure budget lasts."""
        if self._d2h_left > 0:
            self._d2h_left -= 1
            raise FaultInjected("injected swap-out d2h copy failure")

    def h2d(self) -> None:
        """Called before each swap-in restore dispatch; raises while the
        injected h2d failure budget lasts."""
        if self._h2d_left > 0:
            self._h2d_left -= 1
            raise FaultInjected("injected swap-in h2d copy failure")

    def skew(self) -> float:
        """Clock skew applied to deadline evaluation only."""
        return self.skew_s
