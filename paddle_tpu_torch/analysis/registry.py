"""The serving program budget — port of `SERVE_PROGRAM_BUDGET` in
`paddle_tpu/analysis/registry.py`, its keys and values copied.

The reference runs a fixed set of executables whatever the traffic: the
decode side is one fused program (vanilla decode, verify and the
interleaved prefill chunk ride it), the prefill budget covers the cold paths
(one-shot bucketed prefill, and the chunk program where it exists), plus
one COW page copy and the swap gather and scatter.  The port's programs are
its CUDA graphs, one per fixed shape: the step programs, the COW copy and
each bucket's one-shot prefill; `LLMEngine.stats()` counts them under the
reference's keys, and `program_counts` folds those into the budget's.

`SERVE_SLO`, the serving SLO and health thresholds, is the reference's dict
copied with its values and comments; `inference.health` folds the engine's
signals against it.
"""
from __future__ import annotations

from typing import Dict, Tuple

SERVE_PROGRAM_BUDGET: Dict[str, int] = {
    "decode_side_executables": 1,   # THE fused serve_step_paged program
    "prefill_executables": 2,
    "copy_executables": 1,
    "swap_executables": 2,          # preemption swap-out gather + swap-in
    "total_executables": 6,
}

# The budget of each rank under tensor-parallel serving (the reference's
# `SERVE_PROGRAM_BUDGET_MP`, its values copied): the step programs are
# partitioned, not forked, so every rank keeps mp=1's counts (a worker
# builds exactly the programs rank 0 builds).
SERVE_PROGRAM_BUDGET_MP: Dict[str, int] = {
    "decode_side_executables": 1,
    "prefill_executables": 2,
    "copy_executables": 1,
    "swap_executables": 2,
    "total_executables": 6,
}


def program_counts(stats: Dict[str, object]) -> Dict[str, int]:
    """An engine's `stats()` under the budget's keys (decode side: decode
    plus verify programs), as the reference's program-count check sums
    them."""
    got = {"decode_side_executables": stats["decode_executables"] +
           stats["verify_executables"],
           "prefill_executables": stats["prefill_executables"],
           "copy_executables": stats["copy_executables"],
           "swap_executables": stats["swap_executables"]}
    got["total_executables"] = sum(got.values())
    return got


def over_budget(stats: Dict[str, object]) -> Dict[str, Tuple[int, int]]:
    """{key: (count, bound)} for each budget key the engine exceeds (an
    engine with `stats()["mp"] > 1` against `SERVE_PROGRAM_BUDGET_MP`)."""
    budget = SERVE_PROGRAM_BUDGET_MP if stats.get("mp", 1) > 1 \
        else SERVE_PROGRAM_BUDGET
    return {k: (n, budget[k]) for k, n in program_counts(stats).items()
            if n > budget[k]}


# ---------------------------------------------------------------------------
# serving SLO + health thresholds (consumed by inference/health.py)
# ---------------------------------------------------------------------------

# The engine's health evaluation folds the live signal plane — multi-window
# SLO burn rates, pool pressure, admission saturation (timeout/reject rates),
# preemption rate, steady-state recompile anomalies — into ONE
# ok/degraded/overloaded state with per-signal reasons, against the targets
# declared HERE (and only here: the /healthz probe, stats()["health"], the
# `engine_health` gauge and the health tests all read this dict).  The
# numbers are the audit/CPU-smoke config's yardstick, same convention as
# SERVE_RESOURCE_BUDGET; a real deployment re-declares them for its traffic.
SERVE_SLO: Dict[str, object] = {
    # deadline-attainment target: the SLO the burn rates measure against.
    # Burn = (windowed miss fraction) / (1 - target): burn 1.0 consumes the
    # error budget exactly as fast as allowed, >1 is on track to violate.
    "deadline_attainment_target": 0.99,
    # latency bounds on the engine-side lifecycle histograms (p99, ms):
    # crossing one degrades health (the engine still serves; a router should
    # prefer other replicas).  Sized for the CPU-smoke/audit config — a cold
    # compile inside a first request's TTFT legitimately trips it.
    "ttft_p99_ms": 2000.0,
    "tpot_p99_ms": 500.0,
    # device KV pool pressure (pages in use / usable pages) at or above this
    # fraction degrades health: admission is about to stall and preemption
    # is imminent — the router should stop sending work here first.
    "pressure_ceiling": 0.95,
    # multi-window burn: page only when the FAST window burns hot while the
    # SLOW window confirms it is not a blip (the classic two-window rule).
    # Labels index inference.metrics.RATE_WINDOWS.
    "burn_window_fast": "1m",
    "burn_window_slow": "5m",
    "burn_degraded": 1.0,       # either window at 1.0 = budget-speed burn
    "burn_overloaded": 10.0,    # fast >= 10 x budget AND slow confirming
    # preemption churn (preemptions/s over the fast 10s window): sustained
    # preemption means live tokens exceed pool capacity — degraded at the
    # first trickle, overloaded when victims are evicted every second.
    "preempt_rate_degraded": 0.1,
    "preempt_rate_overloaded": 1.0,
    # admission saturation: ANY deadline timeout or intake rejection inside
    # the fast 10s window degrades; timeouts at or above this rate mean the
    # engine is shedding load faster than it serves — overloaded.
    "timeout_rate_overloaded": 1.0,
    # acceptable band for measured/predicted step time (the live roofline
    # drift gauge).  Wide because it must hold on CPU-smoke hosts where
    # dispatch overhead dominates; on TPU the ratio sits near 1 and a
    # tighter operational band belongs in the deployment's alert config.
    # Excursions count alert TRANSITIONS (roofline_drift_alerts counter),
    # they do not fold into engine_health (a slow host is not an overload).
    "roofline_drift_band": (0.02, 50.0),
}
