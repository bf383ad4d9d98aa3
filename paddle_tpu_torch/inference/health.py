"""Engine health: fold the live signal plane into one routable state —
port of `paddle_tpu/inference/health.py`, copied whole over the port's own
copy of `SERVE_SLO` (`analysis.registry`).  It reads the engine's internals
by the reference's names, which the port's `LLMEngine` keeps.

A load balancer does not read 40 gauges, it reads ONE health state per
replica and the reasons behind it.  `evaluate_engine_health()` turns the
windowed rates (`inference.metrics.RateWindow`), the SLO burn rates, the
pool-pressure gauge, admission-saturation rates and the steady-state
recompile anomaly counter into

    {"state": "ok" | "degraded" | "overloaded",
     "code": 0 | 1 | 2,
     "reasons": [<one line per non-ok signal>],
     "signals": {<per-signal state + value + threshold>},
     "burn_rates": {<window label>: <burn>}}

against the targets declared ONCE in `analysis.registry.SERVE_SLO`.  The obs
server's ``GET /healthz`` serves this report with 200/503 semantics
(overloaded — or an evaluation that cannot run at all — is 503, so a probe
takes the replica out of rotation; degraded still serves traffic and stays
200 with the state in the body), the ``engine_health`` gauge exposes the
numeric code (fleet merge folds it worst-of via ``agg="max"``), and
``stats()["health"]`` carries the compact state+reasons pair.

Signal semantics (every threshold from SERVE_SLO; each signal is evaluated
independently and the overall state is the WORST signal):

- **slo_burn** — multi-window deadline-attainment burn: the in-window miss
  fraction over the error budget ``1 - deadline_attainment_target``.  Either
  window at or above `burn_degraded` degrades; the fast window at or above
  `burn_overloaded` WITH the slow window confirming (>= `burn_degraded`)
  overloads — the classic two-window rule that ignores blips.  Windows with
  no deadline-bearing retirements burn 0.0 (no data is not an outage).
- **ttft_p99 / tpot_p99** — the lifecycle histograms' p99 against the
  declared bounds; degraded only (slow is not down).
- **pool_pressure** — the live pages-in-use fraction at or above
  `pressure_ceiling`; degraded only (pressure with consequences shows up in
  the preemption/timeout signals below).
- **preemption** — preemptions/s over the fast ~10s window: degraded at
  `preempt_rate_degraded`, overloaded at `preempt_rate_overloaded` (the
  FaultPlan pressure-injection tests drive exactly this path).
- **admission** — saturation at the front door: any timeout or intake
  rejection inside the fast window degrades; timeouts/s at or above
  `timeout_rate_overloaded` overloads (the engine sheds load as fast as it
  serves — clock-skew injection drives this deterministically).
- **recompiles** — `steady_state_recompiles` > 0 degrades: a fixed-shape
  engine that recompiles after warm is silently paying seconds per step.

All inputs are host-side reads (counters, rate rings, page accounting) — no
device sync, no dispatch, no compiled-program change.
"""
from __future__ import annotations

from typing import Dict, List

from ..analysis.registry import SERVE_SLO

# ordered severities; the numeric code is what the engine_health gauge
# exposes and FleetMetrics max-folds (worst-of, never sum)
HEALTH_STATES = ("ok", "degraded", "overloaded")
HEALTH_CODES: Dict[str, int] = {s: i for i, s in enumerate(HEALTH_STATES)}


def burn_rate(req_window, met_window, window_s: float,
              target: float) -> float:
    """Deadline-attainment burn over one window: in-window miss fraction
    over the error budget.  `req_window`/`met_window` are the RateWindows
    over the `deadline_requests` / `deadline_met` counters — sampled at the
    same instants, so their references share timestamps and the elapsed
    time cancels exactly (the ratio of deltas IS the miss fraction)."""
    req = req_window.delta(window_s)
    if req <= 0.0:
        return 0.0                      # no deadline traffic: nothing burns
    miss = max(0.0, req - met_window.delta(window_s)) / req
    budget = 1.0 - float(target)
    if budget <= 0.0:                   # target 1.0: any miss is infinite burn
        return 0.0 if miss == 0.0 else float("inf")
    return miss / budget


def evaluate_engine_health(engine, slo: Dict[str, object] = None
                           ) -> Dict[str, object]:
    """The health report (module docstring) for one engine, read entirely
    from host state.  `slo` overrides `SERVE_SLO` (tests tighten single
    thresholds without re-declaring the whole contract)."""
    cfg = dict(SERVE_SLO)
    if slo:
        cfg.update(slo)
    signals: Dict[str, Dict[str, object]] = {}
    reasons: List[str] = []

    def note(name: str, state: str, reason: str, **detail):
        signals[name] = {"state": state, **detail}
        if state != "ok":
            reasons.append(f"{name}: {reason}")

    # ---- SLO burn (multi-window deadline attainment) ----------------------
    windows = engine._rw_deadline_req.windows
    fast_lbl = str(cfg["burn_window_fast"])
    slow_lbl = str(cfg["burn_window_slow"])
    target = float(cfg["deadline_attainment_target"])
    burns = {lbl: burn_rate(engine._rw_deadline_req, engine._rw_deadline_met,
                            w, target) for lbl, w in windows}
    bf, bs = burns[fast_lbl], burns[slow_lbl]
    deg, over = float(cfg["burn_degraded"]), float(cfg["burn_overloaded"])
    if bf >= over and bs >= deg:
        state = "overloaded"
    elif bf >= deg or bs >= deg:
        state = "degraded"
    else:
        state = "ok"
    note("slo_burn", state,
         f"deadline-attainment burn {bf:.2f}x budget over {fast_lbl} "
         f"({bs:.2f}x over {slow_lbl}; target {target})",
         fast=bf, slow=bs, window_fast=fast_lbl, window_slow=slow_lbl,
         target=target)

    # ---- latency bounds (p99 vs the declared SLO) -------------------------
    # role-aware (disaggregated fleets): a prefill replica's only latency
    # product is TTFT and a decode replica's is TPOT — holding a pool to the
    # OTHER pool's bound would shed on a signal it cannot influence
    role = getattr(engine, "role", None)
    lat_signals = (("ttft_p99", engine._h_ttft, "ttft_p99_ms"),
                   ("tpot_p99", engine._h_tpot, "tpot_p99_ms"))
    if role == "prefill":
        lat_signals = lat_signals[:1]
    elif role == "decode":
        lat_signals = lat_signals[1:]
    for name, hist, key in lat_signals:
        bound = float(cfg[key])
        p99_ms = hist.percentile(99.0) * 1e3 if hist.count else 0.0
        note(name, "degraded" if p99_ms > bound else "ok",
             f"{p99_ms:.1f} ms exceeds the {bound:.0f} ms SLO bound",
             value_ms=p99_ms, bound_ms=bound)

    # ---- pool pressure ----------------------------------------------------
    ceiling = float(cfg["pressure_ceiling"])
    pressure = engine.cache.pool_pressure()
    note("pool_pressure", "degraded" if pressure >= ceiling else "ok",
         f"{pressure:.3f} at or above the {ceiling} ceiling",
         value=pressure, ceiling=ceiling)

    # ---- preemption churn (fast ~10s window) ------------------------------
    fast_s = engine._rw_preemptions.windows[0][1]
    fast_name = engine._rw_preemptions.windows[0][0]
    preempt_rate = engine._rw_preemptions.rate(fast_s)
    p_deg = float(cfg["preempt_rate_degraded"])
    p_over = float(cfg["preempt_rate_overloaded"])
    if preempt_rate >= p_over:
        state = "overloaded"
    elif preempt_rate >= p_deg:
        state = "degraded"
    else:
        state = "ok"
    note("preemption", state,
         f"{preempt_rate:.3f} preemptions/s over {fast_name} "
         f"(degraded >= {p_deg}, overloaded >= {p_over})",
         rate=preempt_rate, window=fast_name)

    # ---- admission saturation (timeouts + intake rejects) -----------------
    timeout_rate = engine._rw_timeouts.rate(fast_s)
    reject_rate = engine._rw_rejects.rate(fast_s)
    t_over = float(cfg["timeout_rate_overloaded"])
    if timeout_rate >= t_over:
        state = "overloaded"
    elif timeout_rate > 0.0 or reject_rate > 0.0:
        state = "degraded"
    else:
        state = "ok"
    note("admission", state,
         f"{timeout_rate:.3f} timeouts/s + {reject_rate:.3f} rejects/s over "
         f"{fast_name} (overloaded >= {t_over} timeouts/s)",
         timeouts_per_sec=timeout_rate, rejects_per_sec=reject_rate,
         window=fast_name)

    # ---- steady-state recompile anomaly -----------------------------------
    recompiles = engine._ss_recompiles.value
    note("recompiles", "degraded" if recompiles else "ok",
         f"{recompiles} decode-side recompiles after warm (fixed-shape "
         f"engines must never recompile in steady state)",
         count=recompiles)

    worst = max(signals.values(), key=lambda s: HEALTH_CODES[s["state"]])
    state = worst["state"]
    return {"state": state, "code": HEALTH_CODES[state], "reasons": reasons,
            "role": role, "signals": signals, "burn_rates": burns,
            "t": engine._now()}
