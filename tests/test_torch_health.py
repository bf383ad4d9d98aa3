"""The port's health fold, windowed rates, trace windows, debug bundle and
release of a dropped engine, on the CPU.

The rates and health cases are twins of the reference's
(`tests/test_observability.py`): the reference engine (never warmed) and
the port's, on the same `gpt_tiny(64)` weights, each on a `FakeClock` of the
same schedule, must give exactly equal `stats()["rates"]` and `health()`
at every instant the reference's test reads them (and everything else
`test_torch_observability.assert_same_observations` holds).  The
recompile half of `test_roofline_drift_and_recompile_anomaly` is the
port's own: its decode-side programs are CUDA graphs, so a recompile is a
decode-side program built after the first busy step.  `predicted_step_ms`
stays None (the reference's cost model is not ported), so the drift gauge
reads 0 and no drift alert fires.

The trace windows, the schema guard of `tools/check_metrics.py` and the
debug bundle run on the port alone, against the reference's names and key
sets; a program built inside a `trace()` window and a `device=True`
window (a `torch.profiler` capture of the CPU here) are the port's own
cases.  A dropped engine must be freed with the cycle collector off.
"""
import gc
import glob
import json
import os
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu_torch.analysis.registry import SERVE_SLO
from paddle_tpu_torch.inference.engine import ENGINE_SPANS, LLMEngine
from paddle_tpu_torch.inference.faults import FaultPlan
from paddle_tpu_torch.inference.health import HEALTH_CODES
from paddle_tpu_torch.inference.metrics import FleetMetrics
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.profiler import Profiler, RecordEvent, is_recording
from paddle_tpu_torch.profiler import profiler as prof_mod
from test_torch_observability import (FakeClock,
                                      drain, lockstep, make_engine, streams,
                                      tiny)  # noqa: F401  (fixture)
from tools import check_metrics as cm


@pytest.fixture(scope="module")
def port_params():
    cfg = TG.gpt_tiny(64)
    return cfg, TG.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _port(port_params, **kw):
    cfg, params = port_params
    base = dict(num_slots=2, page_size=8, max_model_len=64)
    base.update(kw)
    return LLMEngine(params, cfg, device="cpu", **base)


# ---------------------------------------------------------------------------
# rates and health: twins of the reference's cases
# ---------------------------------------------------------------------------

def test_engine_rates_exact_under_fake_clock(tiny):
    """Young windows read events since the reset over the time since it;
    idle decay to 0.0; the reset restarts the rings: at every read the
    port's rates equal the reference's and the reference's golden values."""
    def scenario(eng, clk):
        reads = []
        eng.add_request(np.arange(5, dtype=np.int32), max_new_tokens=4)
        drain(eng, clk, 1.0)
        reads.append((clk.t, eng.stats()))
        clk.t += 400.0
        reads.append((clk.t, eng.stats()))
        eng.reset_counters()
        t_reset = clk.t
        eng.add_request(np.arange(3, dtype=np.int32), max_new_tokens=2)
        drain(eng, clk, 2.0)
        reads.append((t_reset, eng.stats()))
        return reads
    runs = lockstep(tiny, scenario, t0=50.0, num_slots=2, page_size=8,
                    max_model_len=64, double_buffer=False)
    got, want = runs["port"][2], runs["reference"][2]
    for (_, g), (_, w) in zip(got, want):
        assert g["rates"] == w["rates"]
        assert g["health"] == w["health"]
    (t1, st), (_, idle), (t_reset, post) = got
    tokens, elapsed = st["decode_tokens"], t1 - 50.0
    for w in ("10s", "1m", "5m"):
        assert st["rates"]["tokens_per_sec"][w] == \
            pytest.approx(tokens / elapsed)
    assert st["rates"]["admits_per_sec"]["5m"] == pytest.approx(1 / elapsed)
    assert idle["rates"]["tokens_per_sec"]["5m"] == 0.0
    eng, clk = runs["port"][:2]
    assert post["rates"]["tokens_per_sec"]["5m"] == \
        pytest.approx(post["decode_tokens"] / (clk.t - t_reset))
    assert eng.metrics.snapshot()["gauges"]["tokens_per_sec_10s"] == \
        pytest.approx(post["rates"]["tokens_per_sec"]["10s"])


def test_slo_burn_rates_and_health_under_clock_skew(tiny):
    """No deadline traffic burns 0; on-time finishes burn 0; FaultPlan clock
    skew forcing a timeout burns 100x on both windows: overloaded with
    slo_burn named, the admission signal firing too; aging out recovers
    to ok.  Every health report equal to the reference's."""
    def on_time(eng, clk):
        reads = [eng.health()]
        eng.add_request(np.arange(5, dtype=np.int32), max_new_tokens=3,
                        deadline_s=1000.0)
        clk.t = 11.0
        drain(eng, clk, 0.0)
        return reads + [eng.health()]

    def skewed(eng, clk):
        late = eng.add_request(np.arange(5, dtype=np.int32),
                               max_new_tokens=3, deadline_s=5.0)
        clk.t += 1.0
        eng.step()
        clk.t += 1.0
        eng.step()
        reads = [eng.health(), eng._health_code()]
        clk.t += 400.0
        return late, reads + [eng.health()]
    geo = dict(num_slots=2, page_size=8, num_pages=17, max_model_len=64,
               double_buffer=False)
    runs = lockstep(tiny, on_time, t0=10.0, **geo)
    assert runs["port"][2] == runs["reference"][2]
    before, after = runs["port"][2]
    assert before["state"] == after["state"] == "ok"
    assert after["burn_rates"]["1m"] == 0.0
    runs = lockstep(tiny, skewed, t0=10.0, fault=dict(skew_s=10_000.0),
                    **geo)
    assert runs["port"][2] == runs["reference"][2]
    late, (h, code, recovered) = runs["port"][2]
    assert runs["port"][0]._outputs[late].finish_reason == "timeout"
    assert h["burn_rates"]["1m"] == pytest.approx(100.0)
    assert h["state"] == "overloaded" and code == 2.0
    assert h["signals"]["slo_burn"]["state"] == "overloaded"
    assert any(r.startswith("slo_burn") for r in h["reasons"])
    assert h["signals"]["admission"]["state"] != "ok"
    assert recovered["burn_rates"] == {"10s": 0.0, "1m": 0.0, "5m": 0.0}
    assert recovered["state"] == "ok" and recovered["reasons"] == []


def test_health_overloaded_under_forced_pressure(tiny):
    """The engine half of the reference's /healthz round trip: forced pool
    pressure preempts three times inside about a second, health goes
    overloaded on the preemption signal and the `engine_health` gauge
    reads 2 (a fleet merge keeps the worst); the burst aging out recovers
    it; a wrecked signal plane gives an "error" health entry in stats()
    and the worst gauge code, and the debug bundle still assembles."""
    def scenario(eng, clk):
        eng.add_request(np.arange(4, dtype=np.int32), max_new_tokens=20,
                        priority=0)
        eng.add_request(np.arange(4, 6, dtype=np.int32), max_new_tokens=20,
                        priority=1)
        steps = 0
        while eng.has_work and eng.stats()["preemptions"] < 3 and \
                steps < 100:
            clk.t += 0.1
            eng.step()
            steps += 1
        return eng.health(), eng.metrics.snapshot()["gauges"]
    runs = lockstep(tiny, scenario, t0=0.0,
                    fault=dict(pressure_steps=(2, 3, 4, 5, 6, 7)),
                    num_slots=2, page_size=8, max_model_len=64,
                    prefill_chunk=8, admission="optimistic",
                    preempt="recompute", double_buffer=False)
    assert runs["port"][2] == runs["reference"][2]
    eng, clk, (h, gauges) = runs["port"]
    assert eng.stats()["rates"]["preemptions_per_sec"]["10s"] >= 1.0
    assert h["state"] == "overloaded"
    assert h["signals"]["preemption"]["state"] == "overloaded"
    assert any(r.startswith("preemption") for r in h["reasons"])
    assert gauges["engine_health"] == HEALTH_CODES["overloaded"]
    healthy = make_engine(tiny, "port", clk, num_slots=1, page_size=8,
                          max_model_len=64)
    fleet = FleetMetrics().add("sick", eng).add("fine", healthy)
    assert fleet.merged().get("engine_health").value == 2.0
    ref, ref_clk = runs["reference"][:2]
    clk.t += 400.0
    ref_clk.t += 400.0
    assert eng.health()["state"] == "ok"
    assert eng.health() == ref.health()
    rw = eng._rw_preemptions
    eng._rw_preemptions = None                  # wreck it
    st = eng.stats()
    assert st["health"]["state"] == "error"
    assert "health evaluation failed" in st["health"]["reasons"][0]
    assert eng._health_code() == float(max(HEALTH_CODES.values()))
    assert "requests" in eng.debug_bundle()
    eng._rw_preemptions = rw
    drain(eng, clk, 0.1)


def test_recompile_anomaly_and_no_roofline_prediction(tiny, port_params):
    """`predicted_step_ms` is None and stays so through warm-up; the drift
    gauge reads 0 and no band excursion alerts.  An unwarmed unfused
    chunked engine whose first busy step is a chunk alone builds its
    decode program after the baseline: one steady-state recompile, health
    degraded on "recompiles", equal to the reference engine's; a warmed
    engine counts none; the reset re-seeds the baseline."""
    def scenario(eng, clk):
        eng.add_request(np.arange(20, dtype=np.int32), max_new_tokens=4)
        drain(eng, clk, 0.5)
        return eng.health()
    runs = lockstep(tiny, scenario, fuse=False, prefill_chunk=8, num_slots=2,
                    page_size=8, max_model_len=64)
    eng, _, h = runs["port"]
    assert eng.stats()["roofline"]["steady_state_recompiles"] == 1
    assert h["signals"]["recompiles"]["state"] == "degraded"
    assert any(r.startswith("recompiles") for r in h["reasons"])
    eng.reset_counters()
    assert eng.stats()["roofline"]["steady_state_recompiles"] == 0
    assert eng.stats()["roofline"]["measured_step_ms"] is None

    warm = _port(port_params, fuse=False, prefill_chunk=8)
    warm.warm_decode()
    assert warm.predicted_step_ms is None
    warm.add_request(np.arange(20, dtype=np.int32), max_new_tokens=4)
    warm.run()
    ro = warm.stats()["roofline"]
    assert ro["steady_state_recompiles"] == 0
    assert ro["predicted_step_ms"] is None and ro["drift"] is None
    assert ro["measured_step_ms"] > 0           # real clock: busy steps fed it
    assert warm.metrics.snapshot()["gauges"]["roofline_drift"] == 0.0
    saved = SERVE_SLO["roofline_drift_band"]
    try:
        SERVE_SLO["roofline_drift_band"] = (1e-9, 1e-8)
        warm._note_steady_state(0.001)
        assert warm.stats()["roofline"]["drift_alerts"] == 0
    finally:
        SERVE_SLO["roofline_drift_band"] = saved
    # decode-side growth after the baseline counts, as the reference's
    # executable-cache growth does
    n = [1]
    warm._decode_side_programs = lambda: n[0]
    warm._exec_baseline = None
    warm._note_steady_state(0.001)
    n[0] = 3
    warm._note_steady_state(0.001)
    assert warm._ss_recompiles.value == 2
    assert warm.health()["state"] != "ok"


def test_metrics_schema_guard_on_the_port(port_params):
    """The schema half of `tools/check_metrics.py` on the port's engine:
    its stats(), rates, health, roofline, tier and SLO keys, the registry's
    counters, gauges and histograms, a parsing exposition and an exemplar
    that resolves; observability adds no decode-side program."""
    eng = _port(port_params, prefill_chunk=16, spec_len=3, num_pages=9)
    rng = np.random.RandomState(0)
    rids = [eng.add_request(rng.randint(0, 256, (n,)).astype(np.int32),
                            max_new_tokens=5, deadline_s=60.0)
            for n in (6, 20, 33, 9)]
    for _ in range(3):
        eng.step()
    eng.abort(rids[-1])
    eng.run()
    st = eng.stats()
    assert cm.REQUIRED_STATS_KEYS <= set(st)
    assert cm.REQUIRED_LATENCY_KEYS <= set(st["latency"])
    assert cm.REQUIRED_SLO_KEYS <= set(st["slo"])
    assert set(cm.RATE_FAMILIES) <= set(st["rates"])
    for fam in cm.RATE_FAMILIES:
        assert set(cm.RATE_WINDOW_LABELS) <= set(st["rates"][fam])
    assert cm.REQUIRED_HEALTH_KEYS <= set(st["health"])
    assert st["health"]["state"] in cm.HEALTH_STATES
    assert cm.REQUIRED_ROOFLINE_KEYS <= set(st["roofline"])
    assert cm.REQUIRED_KV_TIER_KEYS <= set(st["kv_tier"])
    snap = eng.metrics.snapshot()
    for section, required in (("counters", cm.REQUIRED_COUNTERS),
                              ("gauges", cm.REQUIRED_GAUGES),
                              ("histograms", cm.REQUIRED_HISTOGRAMS)):
        assert required <= set(snap[section]), section
    json.dumps(snap)
    errors = []
    cm.check_exposition(eng.metrics.to_prometheus(), errors)
    assert cm.check_exemplar_roundtrip(eng, errors) is not None
    assert not errors, errors
    assert st["decode_executables"] + st["verify_executables"] == 1


# ---------------------------------------------------------------------------
# trace windows
# ---------------------------------------------------------------------------

def test_chrome_trace_and_step_timeline(port_params, tmp_path):
    """trace(dir) writes a chrome trace of the engine's host-phase spans
    (the reference's names), the step ring and a metrics snapshot with the
    proposer's telemetry; spans exist only inside the window."""
    eng = _port(port_params, prefill_chunk=16, spec_len=3, num_pages=9,
                seed=3)
    td = tmp_path / "trace"
    with eng.trace(str(td), device=False) as prof:
        assert prof is not None and is_recording()
        rng = np.random.RandomState(9)
        for n in (5, 18, 30):
            eng.add_request(np.tile(rng.randint(0, 256, (3,)), n // 3 + 1)
                            [:n].astype(np.int32), max_new_tokens=4)
        eng.run()
    assert not is_recording()
    host = json.loads((td / "host_trace.json").read_text())
    names = {e["name"] for e in host["traceEvents"]}
    assert {"engine.step", "engine.admit", "engine.fused.dispatch",
            "engine.spec.propose", "engine.spec.accept",
            "engine.sample.sync"} <= names <= set(ENGINE_SPANS)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in host["traceEvents"])
    timeline = json.loads((td / "step_timeline.json").read_text())
    assert timeline == eng.step_trace()
    for key in ("v", "step", "t", "dur_s", "decode_batch", "chunk",
                "verify_dispatches", "tokens_emitted", "pages_in_use",
                "pages_free", "pages_evictable", "queued", "running",
                "prefilling", "fused", "dispatches", "sync_ms", "slots",
                "preempted", "pool_pressure", "finished"):
        assert key in timeline[-1]
    assert all(r["dispatches"] <= 1 for r in timeline)
    snap = json.loads((td / "metrics.json").read_text())
    assert snap["counters"]["decode_tokens"] > 0
    assert snap["proposer"]["propose_calls"] > 0
    assert not (td / "device").exists()
    n_events = len(prof_mod._events)
    eng.add_request(np.arange(4, dtype=np.int32), max_new_tokens=2)
    eng.run()
    assert len(prof_mod._events) == n_events    # no spans outside a window


def test_trace_rides_outer_profiler(port_params, tmp_path):
    eng = _port(port_params)
    with Profiler(timer_only=True):
        with RecordEvent("outer.before"):
            pass
        with eng.trace(str(tmp_path / "t"), device=False) as prof:
            assert prof is None                 # rides the outer one
            eng.add_request(np.arange(4, dtype=np.int32), max_new_tokens=2)
            eng.run()
        assert is_recording()
        with RecordEvent("outer.after"):
            pass
        names = {e.name for e in prof_mod._events}
        assert {"outer.before", "engine.step", "outer.after"} <= names
    host = json.loads((tmp_path / "t" / "host_trace.json").read_text())
    snap_names = {e["name"] for e in host["traceEvents"]}
    assert {"engine.step", "outer.before"} <= snap_names


def test_reset_counters_mid_trace_window(port_params, tmp_path):
    """A reset inside a window keeps the chrome export whole, clears
    exemplars with their counts, and the window's step timeline holds the
    records after it; later exemplars resolve."""
    eng = _port(port_params)
    td = tmp_path / "trace"
    with eng.trace(str(td), device=False):
        eng.add_request(np.arange(5, dtype=np.int32), max_new_tokens=3)
        eng.run()
        _, ex = cm.parse_prometheus_full(
            eng.metrics.to_prometheus(exemplars=True))
        assert ex
        eng.reset_counters()
        _, ex = cm.parse_prometheus_full(
            eng.metrics.to_prometheus(exemplars=True))
        assert not ex
        rid2 = eng.add_request(np.arange(7, dtype=np.int32), max_new_tokens=3)
        eng.run()
    host = json.loads((td / "host_trace.json").read_text())
    assert host["traceEvents"]
    timeline = json.loads((td / "step_timeline.json").read_text())
    assert timeline and timeline[0]["step"] == 1
    _, ex = cm.parse_prometheus_full(eng.metrics.to_prometheus(exemplars=True))
    assert {int(lbl["request_id"]) for lbl, _ in ex.values()} == {rid2}
    assert eng.export_request_trace(rid2)["traceEvents"]


@pytest.mark.parametrize("mode", ["fused", "unfused"])
def test_program_built_inside_a_trace_window(port_params, tmp_path, mode):
    """An engine that was never warmed builds its programs inside a
    trace() window (device=False): the stream and the program counts equal
    those of the same traffic served outside any window."""
    kw = dict(prefill_chunk=8) if mode == "fused" else dict(fuse=False)
    outs, counts = [], []
    for traced in (True, False):
        eng = _port(port_params, **kw)
        for n in (5, 12):
            eng.add_request(np.arange(n, dtype=np.int32) + 3,
                            max_new_tokens=6)
        if traced:
            with eng.trace(str(tmp_path / mode), device=False):
                eng.run()
        else:
            eng.run()
        outs.append(streams(eng))
        st = eng.stats()
        counts.append({k: st[k] for k in st if k.endswith("_executables")})
    assert outs[0] == outs[1] and counts[0] == counts[1]
    assert counts[0]["decode_executables"] == 1


def test_device_window_writes_a_torch_profiler_trace(port_params, tmp_path):
    """device=True: `device/` holds a torch.profiler chrome trace of the
    window (the CPU's activity here) in which the engine's spans appear as
    user annotations."""
    eng = _port(port_params, prefill_chunk=8)
    eng.warm_decode()
    with eng.trace(str(tmp_path / "w"), device=True) as prof:
        eng.add_request(np.arange(9, dtype=np.int32), max_new_tokens=4)
        eng.run()
    (path,) = glob.glob(str(tmp_path / "w" / "device" / "*.json"))
    assert prof.device_trace_path == path
    events = json.loads(open(path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"engine.step", "engine.fused.dispatch"} <= names
    assert os.path.exists(tmp_path / "w" / "host_trace.json")


# ---------------------------------------------------------------------------
# the postmortem bundle and release
# ---------------------------------------------------------------------------

def test_debug_bundle_valid_after_forced_fault_crash(tiny, tmp_path):
    """A hard fault escapes step() mid-flight on both engines at the same
    point; the port's `dump_debug_bundle` still writes a schema-complete
    JSON postmortem whose request states, timelines, step ring and pool
    levels equal the reference's bundle."""
    def hard(plan_cls):
        class _HardFault(plan_cls):
            def d2h(self):
                raise RuntimeError("hard d2h crash")
        return _HardFault(pressure_steps=(3,))
    from paddle_tpu.inference.faults import FaultPlan as RefFaultPlan

    def scenario(eng, clk):
        rng = np.random.RandomState(7)
        for n in (5, 9, 14, 20, 6, 11):
            eng.add_request(rng.randint(0, 256, (n,)).astype(np.int32),
                            max_new_tokens=24)
        with pytest.raises(RuntimeError, match="hard d2h crash"):
            drain(eng, clk, 0.5)
        return eng.debug_bundle()
    bundles = {}
    for which, plan in (("reference", RefFaultPlan), ("port", FaultPlan)):
        clk = FakeClock(100.0)
        eng = make_engine(tiny, which, clk, num_slots=6, page_size=8,
                          num_pages=9, max_model_len=64, prefill_chunk=8,
                          admission="optimistic", preempt="swap")
        eng._faults = hard(plan)
        bundles[which] = (eng, scenario(eng, clk))
    eng, bundle = bundles["port"]
    ref_bundle = bundles["reference"][1]
    for key in ("requests", "step_trace", "pool", "t", "version"):
        assert bundle[key] == ref_bundle[key], key
    assert bundle["metrics"] == ref_bundle["metrics"]
    path = eng.dump_debug_bundle(str(tmp_path / "bundle"))
    with open(path) as f:
        on_disk = json.load(f)
    assert cm.REQUIRED_DEBUG_BUNDLE_KEYS <= set(on_disk)
    assert on_disk["engine"]["request_tracing"] is True
    assert {r["state"] for r in on_disk["requests"].values()} <= \
        {"queued", "prefilling", "running", "finished"}
    assert any(r["events"] for r in on_disk["requests"].values())
    assert on_disk["metrics"]["counters"]["preemptions"] >= 1
    assert "slo" in on_disk["stats"]


@pytest.mark.parametrize("window", [False, True], ids=["plain", "traced"])
def test_dropped_engine_is_freed_without_the_collector(port_params, tmp_path,
                                                       window):
    """Every registry callback holds the engine weakly: an engine with
    tracing on, stepped (inside a trace window too), is freed at `del`
    with the cycle collector off, and a registry that outlives it reads
    its engine gauges as 0."""
    gc.collect()
    eng = _port(port_params, prefill_chunk=8, spec_len=2,
                admission="optimistic", preempt="swap",
                fault_plan=FaultPlan(pressure_steps=(2,)))
    for n in (5, 11):
        eng.add_request(np.arange(n, dtype=np.int32), max_new_tokens=6)
    if window:
        with eng.trace(str(tmp_path / "w"), device=False):
            eng.run()
    else:
        eng.run()
    reg = eng.metrics
    assert eng.stats()["preemptions"] >= 1
    ref = weakref.ref(eng)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert ref() is None, gc.get_referrers(ref())
    finally:
        if collecting:
            gc.enable()
    gauges = reg.snapshot()["gauges"]
    assert gauges["queued"] == 0 and gauges["engine_health"] == 0.0
