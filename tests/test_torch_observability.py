"""The port's metrics, request lifecycles, timelines and step records vs
the JAX reference's, on the CPU.

Two halves.  The unit twins feed the same inputs to both packages' classes
(`inference.metrics`, `inference.tracing`, the n-gram proposer's
telemetry) and hold their snapshots, summaries, expositions and chrome
trees equal, as the reference's `tests/test_observability.py` checks its
own.  The engine twins drive the reference engine (never warmed) and the
port's on the same `gpt_tiny(64)` weights (fp32, bridged through numpy)
under one `FakeClock` schedule each, and hold exactly equal: every
request's output (tokens, finish reason, `RequestOutput.metrics`, its
timeline: names, order, times, attributes), `step_trace()` (every v2
key), `stats()`'s `latency`, `slo`, `rates`, `health` and `roofline`,
`health()`, `metrics.snapshot()` and the Prometheus text with exemplars,
in the fused chunked, fused bucketed, unfused and speculative modes, across
swap and recompute preemption, a timeout, an abort, a rejection, a tier
restore and an `export_prefix(rid=)` handoff.  In each of those modes a
third engine, the port's with `request_tracing=False`, serves the same
traffic, whose streams must be the same.

The health fold, rates, trace windows and the debug bundle are in
`tests/test_torch_health.py`.  The reference's
`test_stats_execs_fallback_attribute_error_only` tests jit cache
attributes the port has no counterpart of; the bench and tool cases wait
for the serving bench.  The reference's two obs-server cases run on both
packages' `ObservabilityServer` over loopback sockets, each over engines on
one `FakeClock` schedule: every route answers the same status, and the
exposition, health and request-trace bodies are equal.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest

from paddle_tpu.inference import metrics as ref_metrics
from paddle_tpu.inference import spec as ref_spec
from paddle_tpu.inference import tracing as ref_tracing
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.inference.faults import FaultPlan as RefFaultPlan
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.inference import metrics as port_metrics
from paddle_tpu_torch.inference import spec as port_spec
from paddle_tpu_torch.inference import tracing as port_tracing
from paddle_tpu_torch.inference.engine import ENGINE_SPANS, LLMEngine
from paddle_tpu_torch.inference.faults import FaultPlan
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from tools.check_metrics import (check_exposition, parse_prometheus,
                                 parse_prometheus_full)
from torch_threads import one_torch_thread  # noqa: F401

MODULES = {"reference": ref_metrics, "port": port_metrics}
MAX_STEPS = 500         # a scheduler fault must fail a test, not hang it


# ---------------------------------------------------------------------------
# unit twins: the same inputs through both packages' classes
# ---------------------------------------------------------------------------

def _twin(build):
    """`build(metrics_module)` on both packages; the results must be equal.
    Returns the port's."""
    got = {name: build(mod) for name, mod in MODULES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def test_log_buckets_geometric_cover():
    edges = _twin(lambda M: M.log_buckets(0.001, 1.0, per_decade=3))
    assert edges[0] == pytest.approx(0.001) and edges[-1] >= 1.0
    for lo, hi in ((0.0, 1.0), (1.0, 0.5)):
        with pytest.raises(ValueError):
            port_metrics.log_buckets(lo, hi)
    assert _twin(lambda M: M.log_buckets(1e-4, 100.0)) == \
        port_metrics.log_buckets(1e-4, 100.0)


def _hist_state(h):
    return (list(h.counts), h.overflow, h.count, h.sum, h.min, h.max,
            [h.percentile(p) for p in (0, 1, 50, 90, 99, 100)], h.summary())


@pytest.mark.parametrize("case", ["edges", "interpolation", "overflow"])
def test_histogram_twins(case):
    """The reference's three histogram tests' inputs: le-semantics edges,
    in-bucket interpolation, overflow and the observed-envelope clamp."""
    def build(M):
        if case == "edges":
            h = M.Histogram("x", buckets=[1.0, 2.0, 4.0, 8.0])
            for v in (1.0, 1.5, 2.0, 2.0001, 9.0):
                h.observe(v)
            return _hist_state(h)
        if case == "interpolation":
            h = M.Histogram("x", buckets=[1.0, 2.0, 4.0])
            for v in [1.0] * 5 + [4.0] * 5:
                h.observe(v)
            return _hist_state(h)
        h = M.Histogram("x", buckets=[1.0, 2.0])
        h.observe(100.0)
        h.observe(1.5)
        g = M.Histogram("y", buckets=[0.001, 100.0])
        g.observe(50.0)
        return (_hist_state(h), _hist_state(g),
                _hist_state(M.Histogram("z", buckets=[1.0])))
    state = _twin(build)
    if case == "edges":
        assert state[:2] == ([1, 2, 1, 0], 1)
    elif case == "interpolation":
        assert state[6][2:5] == pytest.approx([1.0, 3.6, 3.96])
    else:
        assert state[0][6][4] == 100.0 and state[1][6][1] == 50.0
    with pytest.raises(ValueError):
        port_metrics.Histogram("x", buckets=[1.0]).percentile(101)


def test_counter_monotone_and_registry_dedup():
    def build(M):
        reg = M.MetricsRegistry(namespace="t")
        c = reg.counter("events")
        c.inc()
        c.inc(3)
        assert reg.counter("events") is c
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(TypeError):
            reg.gauge("events")
        g = reg.gauge("level", lambda: 7)
        with pytest.raises(ValueError):
            g.set(3.0)
        reg.histogram("lat", buckets=[1.0, 2.0]).observe(1.5)
        before = (reg.snapshot(), reg.to_prometheus())
        reg.reset()
        return before, reg.snapshot(), reg.to_prometheus()
    before, after, _ = _twin(build)
    assert before[0]["counters"]["events"] == 4
    assert after["counters"]["events"] == 0
    assert after["gauges"]["level"] == 7


def test_registry_clock_injection_and_snapshot_json():
    def build(M):
        t = [41.5]
        reg = M.MetricsRegistry(clock=lambda: t[0])
        reads = [reg.now()]
        t[0] = 43.25
        reads.append(reg.now())
        reg.counter("c").inc(2)
        reg.histogram("h", buckets=[1.0]).observe(0.5)
        return reads, json.loads(json.dumps(reg.snapshot()))
    reads, snap = _twin(build)
    assert reads == [41.5, 43.25]
    assert snap["counters"]["c"] == 2 and snap["histograms"]["h"]["count"] == 1


def test_prometheus_exposition_parses():
    def build(M):
        reg = M.MetricsRegistry(namespace="llm_engine")
        reg.counter("decode_tokens", "tokens").inc(7)
        reg.gauge("queued", lambda: 3, "depth")
        h = reg.histogram("ttft_seconds", buckets=[0.1, 1.0, 10.0],
                          help="ttft")
        for v in (0.05, 0.5, 0.5, 20.0):
            h.observe(v, exemplar={"request_id": str(int(v * 100))})
        return (reg.to_prometheus(), reg.to_prometheus(openmetrics=True),
                reg.to_prometheus(exemplars=True))
    for text in _twin(build):
        errors = []
        check_exposition(text, errors)
        assert not errors, errors
    samples = parse_prometheus(_twin(build)[0])
    assert samples["llm_engine_decode_tokens_total"][0][1] == 7
    buckets = dict(samples["llm_engine_ttft_seconds_bucket"])
    assert buckets['{le="1"}'] == 3 and buckets['{le="+Inf"}'] == 4


def test_registry_merge_counter_histogram_goldens():
    def build(M):
        a, b = M.MetricsRegistry(namespace="m"), \
            M.MetricsRegistry(namespace="m")
        a.counter("c").inc(3)
        b.counter("c").inc(4)
        b.counter("only_b").inc(5)
        a.gauge("g").set(2.0)
        b.gauge("g").set(0.5)
        a.gauge("pressure", agg="max").set(0.3)
        b.gauge("pressure", agg="max").set(0.7)
        ha = a.histogram("h", buckets=[1.0, 2.0])
        hb = b.histogram("h", buckets=[1.0, 2.0])
        ha.observe(0.5, exemplar={"request_id": "1"})
        ha.observe(1.5)
        hb.observe(1.7, exemplar={"request_id": "9"})
        hb.observe(9.0)
        agg = M.MetricsRegistry(namespace="m").merge(a).merge(b)
        h = agg.get("h")
        empty = M.MetricsRegistry(namespace="m")
        return (agg.snapshot(), agg.to_prometheus(exemplars=True),
                list(h.exemplars),
                empty.merge(M.MetricsRegistry(namespace="m")).snapshot(),
                M.MetricsRegistry(namespace="m").merge(a).snapshot()
                == a.snapshot())
    snap, _, exemplars, _, identity = _twin(build)
    assert snap["counters"] == {"c": 7, "only_b": 5}
    assert snap["gauges"]["pressure"] == pytest.approx(0.7)
    assert exemplars[1] == ({"request_id": "9"}, 1.7) and identity


def test_exemplar_label_escape_roundtrip():
    tricky = 'back\\slash "quote" bs-n\\nreal\nnewline'

    def build(M):
        reg = M.MetricsRegistry()
        reg.histogram("h", buckets=[1.0]).observe(0.5, exemplar={"v": tricky})
        return reg.to_prometheus(exemplars=True)
    _, exemplars = parse_prometheus_full(_twin(build))
    (labels, value), = exemplars.values()
    assert labels == {"v": tricky} and value == 0.5


def test_registry_merge_conflicts_raise():
    for M in MODULES.values():
        a = M.MetricsRegistry()
        a.histogram("h", buckets=[1.0, 2.0]).observe(0.5)
        bad_edges = M.MetricsRegistry()
        bad_edges.histogram("h", buckets=[1.0, 3.0])
        with pytest.raises(ValueError, match="bucket edges differ"):
            bad_edges.merge(a)
        bad_type = M.MetricsRegistry()
        bad_type.gauge("h").set(1.0)
        with pytest.raises(TypeError):
            bad_type.merge(a)
        live = M.MetricsRegistry()
        live.gauge("g", lambda: 7)
        src = M.MetricsRegistry()
        src.gauge("g").set(1.0)
        with pytest.raises(ValueError):
            live.merge(src)
        assert M.MetricsRegistry().merge(live).get("g").value == 7


def test_fleet_metrics_exposition_and_snapshot():
    def build(M):
        r0 = M.MetricsRegistry(namespace="llm_engine")
        r1 = M.MetricsRegistry(namespace="llm_engine")
        r0.counter("decode_tokens").inc(10)
        r1.counter("decode_tokens").inc(32)
        r1.counter("only_e1").inc(2)
        r0.histogram("ttft_seconds", buckets=[0.1, 1.0]).observe(
            0.05, exemplar={"request_id": "3", "trace": "/requests/3"})
        r1.histogram("ttft_seconds", buckets=[0.1, 1.0]).observe(0.5)
        fleet = M.FleetMetrics().add("e0", r0).add("e1", r1)
        return (fleet.to_prometheus(exemplars=True), fleet.to_prometheus(),
                fleet.snapshot())
    text, plain, snap = _twin(build)
    errs = []
    check_exposition(text, errs)
    assert not errs, errs
    samples = parse_prometheus(text)
    assert samples["llm_fleet_decode_tokens_total"][0][1] == 42
    assert 'trace="/requests/3?engine=e0"' in text and " # {" not in plain
    assert snap["fleet"]["counters"]["decode_tokens"] == 42
    with pytest.raises(TypeError):
        port_metrics.FleetMetrics().add("x", object())


@pytest.mark.parametrize("case", ["golden", "reset_and_pruning"])
def test_rate_window_twins(case):
    """The reference's two RateWindow tests' schedules, read after every
    move on both packages."""
    def build(M):
        t, v = [0.0], [0]
        reads = []
        if case == "golden":
            rw = M.RateWindow("r", lambda: v[0], lambda: t[0],
                              (("10s", 10.0), ("1m", 60.0)),
                              min_interval_s=0.0)
            reads.append(rw.rate(10.0))
            for tt, vv in ((0.0, 0), (5.0, 50), (8.0, 80)):
                t[0], v[0] = tt, vv
                reads += [rw.rate(10.0), rw.delta(10.0)]
                rw.sample()
            for tt in (16.0, 100.0):
                t[0] = tt
                reads += [rw.rate(10.0), rw.rate(60.0), rw.rates()]
            return reads
        rw = M.RateWindow("r", lambda: v[0], lambda: t[0], (("10s", 10.0),),
                          min_interval_s=0.0)
        for tt, vv in ((0.0, 0), (5.0, 50), (5.0, 3), (7.0, 13), (7.0, 0)):
            t[0], v[0] = tt, vv
            reads.append(rw.rate(10.0))
            rw.sample()
            reads.append(list(rw._samples))
        for i in range(1, 8):
            t[0], v[0] = 7.0 + 2.0 * i, 10 * i
            rw.sample()
        reads.append(list(rw._samples))
        rw3 = M.RateWindow("f", lambda: v[0], lambda: t[0], (("10s", 10.0),),
                           min_interval_s=1.0)
        for tt, vv, force in ((100.0, 0, False), (100.2, 2, True),
                              (100.4, 4, True), (100.6, 6, True),
                              (100.8, 6, False)):
            t[0], v[0] = tt, vv
            rw3.sample(force=force)
            reads.append(list(rw3._samples))
        t[0] = 200.0
        reads.append(rw3.rate(10.0))
        reg = M.MetricsRegistry(clock=lambda: t[0])
        c = reg.counter("events")
        rw2 = reg.rate_window("events_per_sec", lambda: c.value,
                              (("10s", 10.0),), min_interval_s=0.0)
        assert reg.rate_window("events_per_sec", lambda: -1) is rw2
        reg.sample_rates()
        c.inc(40)
        t[0] += 4.0
        reads += [reg.snapshot(), reg.to_prometheus()]
        reg.reset()
        reads.append(list(rw2._samples))
        return reads
    reads = _twin(build)
    if case == "golden":
        assert reads[-1] == {"10s": 0.0, "1m": 0.0}
    else:
        assert reads[-3]["gauges"]["events_per_sec_10s"] == \
            pytest.approx(10.0)
    with pytest.raises(ValueError):
        port_metrics.RateWindow("bad", lambda: 0, lambda: 0.0, (("w", -1.0),))


def test_health_gauge_fleet_merge_worst_of():
    def build(M):
        a, b = M.MetricsRegistry(namespace="llm_engine"), \
            M.MetricsRegistry(namespace="llm_engine")
        a.gauge("engine_health", agg="max").set(1.0)
        b.gauge("engine_health", agg="max").set(2.0)
        fleet = M.FleetMetrics().add("e0", a).add("e1", b)
        return fleet.merged().get("engine_health").value, fleet.snapshot()
    value, snap = _twin(build)
    assert value == 2.0 and snap["engines"]["e0"]["gauges"][
        "engine_health"] == 1.0


def test_request_trace_chrome_export_phases():
    def build(T):
        tr = T.RequestTrace(7)
        tr.event(1.0, "enqueue", prompt_len=4)
        tr.event(2.0, "admit", slot=0)
        tr.event(3.0, "first_token")
        tr.event(5.0, "finish", reason="stop", n_generated=2)
        tr2 = T.RequestTrace(8)
        tr2.event(1.0, "enqueue")
        tr2.event(2.0, "finish", reason="abort")
        return (tr.events, tr.to_chrome(), tr2.to_chrome(),
                T.RequestTrace(9).to_chrome(), T.REQUEST_EVENTS)
    got = {n: build(T) for n, T in (("reference", ref_tracing),
                                     ("port", port_tracing))}
    assert got["port"] == got["reference"]
    _, tree, tree2, empty, _ = got["port"]
    spans = {e["name"]: e for e in tree["traceEvents"] if e["ph"] == "X"}
    assert spans["request/7"]["dur"] == pytest.approx(4e6)
    assert spans["decode"]["ts"] == pytest.approx(2e6)
    assert {e["name"] for e in tree2["traceEvents"] if e["ph"] == "X"} == \
        {"request/8", "queued"}
    assert empty == {"traceEvents": [], "displayTimeUnit": "ms"}


def test_ngram_proposer_telemetry():
    def build(S):
        p = S.NgramProposer(max_ngram=2)
        hit = p.propose(np.array([5, 6, 7, 5, 6], np.int32), 2)
        miss = p.propose(np.arange(8, dtype=np.int32), 2)
        st = p.stats()
        p.reset_stats()
        return (None if hit is None else list(hit), miss, st, p.stats())
    got = {n: build(S) for n, S in (("reference", ref_spec),
                                     ("port", port_spec))}
    assert got["port"] == got["reference"]
    assert got["port"][2]["propose_calls"] == 2
    assert got["port"][3]["propose_calls"] == 0


# ---------------------------------------------------------------------------
# engine twins: one FakeClock schedule, the reference and the port
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, port params)."""
    cfg = G.gpt_tiny(64)
    params = G.init_params(cfg, jax.random.key(0))
    tcfg = TG.gpt_tiny(64)
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    return cfg, params, tcfg, tparams


def make_engine(tiny, which, clock, fault=None, **kw):
    """One engine of the pair on the shared weights: "reference", "port",
    or "port_untraced" (the port with `request_tracing=False`).  `fault`
    is a FaultPlan's keywords (each engine gets a plan of its own)."""
    cfg, params, tcfg, tparams = tiny
    if which == "reference":
        if fault is not None:
            kw["fault_plan"] = RefFaultPlan(**fault)
        return JaxEngine(params, cfg, clock=clock, **kw)
    if fault is not None:
        kw["fault_plan"] = FaultPlan(**fault)
    if which == "port_untraced":
        kw["request_tracing"] = False
    return LLMEngine(tparams, tcfg, device="cpu", clock=clock, **kw)


def drain(eng, clk, dt):
    """step() until idle, the clock moving `dt` before each step."""
    for _ in range(MAX_STEPS):
        if not eng.has_work:
            return
        clk.t += dt
        eng.step()
    raise AssertionError("engine did not drain")


def lockstep(tiny, scenario, t0=100.0, fault=None, untraced=False, **kw):
    """Run `scenario(eng, clk) -> result` on the reference, the port and
    (with `untraced`: the modes' cases) the untraced port, each on its own
    FakeClock from `t0`.  Holds everything the clocks stamp exactly equal between the
    reference and the port, and the untraced port's streams equal to the
    port's.  Returns {name: (engine, clock, result)}."""
    runs = {}
    for which in ("reference", "port") + (("port_untraced",)
                                          if untraced else ()):
        clk = FakeClock(t0)
        eng = make_engine(tiny, which, clk, fault=fault, **kw)
        runs[which] = (eng, clk, scenario(eng, clk))
    ref, eng = runs["reference"][0], runs["port"][0]
    assert_same_observations(ref, eng)
    if untraced:
        bare = runs["port_untraced"][0]
        assert streams(bare) == streams(eng)
        assert all(o.trace is None for o in bare._outputs.values())
        assert all(bare.export_request_trace(r) is None
                   for r in range(len(eng._outputs) + 1))
        _, exemplars = parse_prometheus_full(
            bare.metrics.to_prometheus(exemplars=True))
        assert not exemplars
    return runs


def streams(eng):
    return {rid: (list(o.token_ids), o.finish_reason)
            for rid, o in eng._outputs.items()}


# stats() keys the port adds to the reference's
PORT_STATS_KEYS = frozenset({
    "fused_dispatches", "decode_dispatches", "chunk_dispatches",
    "verify_dispatches", "prefill_dispatches", "swap_out_dispatches",
    "swap_in_dispatches", "tier_stage_ms", "graph_replays",
    "admitted_requests", "tier_spills", "tier_restores",
    "tier_restored_tokens", "partial_page_hits", "handoff_exports",
    "handoff_pages", "handoff_tokens", "fuse", "prefix_cache", "device"})


def assert_same_observations(ref, eng):
    """Everything the engines observe, exactly equal: outputs (lifecycle
    records and timelines too), the step ring, health, the stats blocks
    and keys, the registry's snapshot and exposition."""
    assert streams(eng) == streams(ref)
    for rid, want in ref._outputs.items():
        got = eng._outputs[rid]
        assert got.cached_tokens == want.cached_tokens, rid
        assert got.ttft_s == want.ttft_s, rid
        assert (got.metrics is None) == (want.metrics is None), rid
        if want.metrics is not None:
            assert dataclasses.asdict(got.metrics) == \
                dataclasses.asdict(want.metrics), rid
        assert (got.trace is None) == (want.trace is None), rid
        if want.trace is not None:
            assert got.trace.events == want.trace.events, rid
            assert eng.export_request_trace(rid) == \
                ref.export_request_trace(rid)
    assert eng.step_trace() == ref.step_trace()
    assert eng.health() == ref.health()
    rs, ps = ref.stats(), eng.stats()
    assert set(rs) <= set(ps)
    assert set(ps) - set(rs) == PORT_STATS_KEYS
    for k in ("latency", "slo", "rates", "health", "roofline", "mp",
              "dense_token_footprint", "kv_token_capacity", "engine_steps"):
        assert ps[k] == rs[k], (k, ps[k], rs[k])
    # each engine of a pair spills to a directory of its own
    assert {**ps["kv_tier"], "spill_dir": None} == \
        {**rs["kv_tier"], "spill_dir": None}
    assert ps["roofline"]["predicted_step_ms"] is None
    assert eng.metrics.snapshot() == ref.metrics.snapshot()
    for kw in ({}, {"exemplars": True}, {"openmetrics": True}):
        assert eng.metrics.to_prometheus(**kw) == \
            ref.metrics.to_prometheus(**kw), kw


def _prompts(vocab, seed=0):
    """A repeating prompt (drafts hit), one sharing its first 13 tokens
    (a partial-page prefix hit: a COW copy), and two of their own."""
    rng = np.random.RandomState(seed)
    rep = np.tile(rng.randint(0, vocab, (4,)), 5).astype(np.int32)
    cow = np.concatenate([rep[:13], rng.randint(0, vocab, (5,))]) \
        .astype(np.int32)
    return [rep, cow, rng.randint(0, vocab, (9,)).astype(np.int32),
            rng.randint(0, vocab, (11,)).astype(np.int32)]


MODES = {
    "fused_chunked": dict(prefill_chunk=8),
    "fused_bucketed": dict(),
    "unfused": dict(fuse=False, prefill_chunk=8),
    "spec_fused": dict(prefill_chunk=8, spec_len=3),
    "spec_unfused": dict(fuse=False, spec_len=3),
}


def _mixed_traffic(eng, clk):
    """Staggered arrivals at two priorities, a prefix hit, a deadline that
    is met, and an abort of a running request."""
    vocab = eng.config.vocab_size
    p = _prompts(vocab)
    rids = [eng.add_request(p[0], max_new_tokens=8, priority=1)]
    clk.t += 0.5
    rids.append(eng.add_request(p[2], max_new_tokens=6, deadline_s=500.0))
    for _ in range(3):
        clk.t += 0.25
        eng.step()
    rids.append(eng.add_request(p[1], max_new_tokens=6))
    rids.append(eng.add_request(p[3], max_new_tokens=12))
    for _ in range(4):
        clk.t += 0.25
        eng.step()
    eng.abort(rids[-1])
    drain(eng, clk, 0.25)
    return rids


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_twins_serving_modes(tiny, mode):
    """Fused chunked and bucketed, unfused, spec fused and unfused: every
    observation equal to the reference's under one clock schedule."""
    runs = lockstep(tiny, _mixed_traffic, untraced=True, num_slots=2,
                    page_size=8, max_model_len=64, **MODES[mode])
    eng, _, rids = runs["port"]
    outs = eng._outputs
    assert outs[rids[-1]].finish_reason == "abort"
    assert outs[rids[2]].cached_tokens > 0         # the prefix hit
    names = [e["name"] for e in outs[rids[0]].trace.events]
    assert names[0] == "enqueue" and names[-1] == "finish"
    if MODES[mode].get("spec_len"):
        assert "spec_verify" in names
    st = eng.stats()
    assert st["slo"]["deadline_met"] == 1
    assert st["latency"]["e2e_s"]["count"] == 3    # the abort is excluded
    assert st["kv_token_capacity"] < st["dense_token_footprint"]


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_timeline_exact_across_preempt_resume(tiny, mode):
    """The reference's forced preempt/resume cycle: a swap victim restores
    in place (preempt -> swap_out -> swap_in, one admit), a recompute
    victim re-enters through a second admit(resume=True); equal to the
    reference's stamp for stamp."""
    def scenario(eng, clk):
        lo = eng.add_request(np.arange(4, dtype=np.int32),
                             max_new_tokens=20, priority=0)
        hi = eng.add_request(np.arange(4, 6, dtype=np.int32),
                             max_new_tokens=20, priority=1)
        drain(eng, clk, 1.0)
        return lo, hi
    runs = lockstep(tiny, scenario, fault=dict(pressure_steps=(4,)),
                    untraced=True, num_slots=2, page_size=8,
                    max_model_len=64, prefill_chunk=8,
                    admission="optimistic", preempt=mode)
    eng, _, (lo, hi) = runs["port"]
    ev = eng._outputs[lo].trace.events
    names = [e["name"] for e in ev]
    assert ev[names.index("preempt")]["kind"] == mode
    assert eng._outputs[lo].metrics.preemptions == 1
    if mode == "swap":
        assert names.index("preempt") < names.index("swap_out") \
            < names.index("swap_in")
        assert names.count("admit") == 1
    else:
        assert names.count("admit") == 2
    assert "preempt" not in [e["name"] for e in eng._outputs[hi].trace.events]


def test_timeline_and_slo_across_timeout_abort_and_reject(tiny):
    """A deadline met, a deadline missed (finish(reason=timeout) stamped at
    the expiry scan), a queued abort and an intake rejection: the SLO
    account, goodput by priority and the latency histograms (which exclude
    all three) equal to the reference's."""
    def scenario(eng, clk):
        ok = eng.add_request(np.arange(5, dtype=np.int32), max_new_tokens=3,
                             priority=1, deadline_s=1000.0)
        clk.t = 11.0
        drain(eng, clk, 0.0)
        late = eng.add_request(np.arange(7, dtype=np.int32),
                               max_new_tokens=20, deadline_s=5.0)
        big = eng.add_request(np.arange(30, dtype=np.int32),
                              max_new_tokens=20)
        eng.step()
        queued = eng.add_request(np.arange(3, dtype=np.int32),
                                 max_new_tokens=2)
        queued2 = eng.add_request(np.arange(6, dtype=np.int32),
                                  max_new_tokens=2)
        eng.abort(queued2)
        clk.t = 40.0
        eng.step()
        drain(eng, clk, 0.5)
        return ok, late, big, queued
    runs = lockstep(tiny, scenario, t0=10.0, untraced=True, num_slots=1,
                    page_size=8, num_pages=5, max_model_len=64,
                    double_buffer=False)
    eng, _, (ok, late, big, queued) = runs["port"]
    reasons = {r: eng._outputs[r].finish_reason for r in (ok, late, big)}
    assert reasons == {ok: "length", late: "timeout", big: "rejected"}
    fin = eng._outputs[late].trace.events[-1]
    assert fin["name"] == "finish" and fin["t"] == 40.0
    slo = eng.stats()["slo"]
    assert slo["deadline_requests"] == 2 and slo["deadline_met"] == 1
    assert slo["goodput_tokens_by_priority"][1] == 3


def test_tier_restore_and_handoff_timelines(tiny, tmp_path):
    """A returning session whose prefix the LRU spilled restores from the
    host tier ("tier_restore" on its timeline), and `export_prefix(rid=)`
    stamps "handoff" on the retired request's trace, as the reference's
    do."""
    def scenario(eng, clk):
        rng = np.random.RandomState(7)
        vocab = eng.config.vocab_size
        shared = rng.randint(0, vocab, (20,)).astype(np.int32)
        r1 = eng.add_request(shared, max_new_tokens=5)
        drain(eng, clk, 0.5)
        for _ in range(4):
            eng.add_request(rng.randint(0, vocab, (30,)).astype(np.int32),
                            max_new_tokens=4)
        drain(eng, clk, 0.5)
        t2 = np.concatenate([shared,
                             np.asarray(eng._outputs[r1].token_ids,
                                        np.int32),
                             rng.randint(0, vocab, (4,)).astype(np.int32)])
        r2 = eng.add_request(t2, max_new_tokens=5)
        drain(eng, clk, 0.5)
        clk.t += 1.0
        conv = np.concatenate([t2, np.asarray(eng._outputs[r2].token_ids,
                                              np.int32)])
        return r2, eng.export_prefix(conv, rid=r2)
    dirs = iter(("ref", "port", "bare"))
    runs = {}
    for which in ("reference", "port", "port_untraced"):
        clk = FakeClock(100.0)
        eng = make_engine(tiny, which, clk, num_slots=2, page_size=8,
                          num_pages=9, max_model_len=64, prefill_chunk=16,
                          seed=3, swap_pool_pages=64,
                          spill_dir=str(tmp_path / next(dirs)))
        runs[which] = (eng, clk, scenario(eng, clk))
    ref, eng = runs["reference"][0], runs["port"][0]
    assert_same_observations(ref, eng)
    assert streams(runs["port_untraced"][0]) == streams(eng)
    r2, exported = runs["port"][2]
    assert exported == runs["reference"][2][1] and exported["pages"] > 0
    names = [e["name"] for e in eng._outputs[r2].trace.events]
    assert "tier_restore" in names and names[-1] == "handoff"
    assert eng.stats()["kv_tier"]["restores"] >= 1


def test_stats_keyset_is_the_references_and_the_ports():
    """The reference's frozen key set (its `GOLDEN_STATS_KEYS`, `mp` and
    `dense_token_footprint` included) and every later addition are in the
    port's `stats()`, whose other keys are the port's, listed by name; the
    latency summaries have the reference's keys."""
    from test_observability import GOLDEN_STATS_KEYS, NEW_STATS_KEYS
    cfg = TG.gpt_tiny(64)
    import torch
    params = TG.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = LLMEngine(params, cfg, device="cpu", num_slots=2, page_size=8,
                    max_model_len=64)
    keys = set(eng.stats())
    assert keys == GOLDEN_STATS_KEYS | NEW_STATS_KEYS | PORT_STATS_KEYS
    st = eng.stats()
    assert st["mp"] == 1 and st["dense_token_footprint"] == 2 * 64
    assert set(st["latency"]) == {"queue_s", "ttft_s", "tpot_s", "e2e_s",
                                  "step_s"}
    for summ in st["latency"].values():
        assert set(summ) == {"count", "sum", "mean", "min", "max", "p50",
                             "p90", "p99"}


def test_trace_spans_are_the_references():
    from paddle_tpu.inference.engine import ENGINE_SPANS as REF_SPANS
    assert ENGINE_SPANS == REF_SPANS


# ---------------------------------------------------------------------------
# the reference's engine cases, each as a twin
# ---------------------------------------------------------------------------

def test_request_lifecycle_fake_clock(tiny):
    """Queue time, TTFT, TPOT and e2e land where the clock was set, in the
    record and the histograms (the reference's numbers), and equal the
    reference's."""
    def scenario(eng, clk):
        rid = eng.add_request(np.arange(5, dtype=np.int32), max_new_tokens=3)
        clk.t = 12.0
        assert eng.step() == []
        clk.t = 15.5
        return rid, eng.step()
    runs = lockstep(tiny, scenario, t0=10.0, num_slots=2, page_size=8,
                    max_model_len=64, double_buffer=False)
    eng, _, (rid, outs) = runs["port"]
    assert [o.request_id for o in outs] == [rid]
    m = outs[0].metrics
    assert (m.t_enqueue, m.t_admit, m.t_first_token, m.t_finish) == \
        (10.0, 12.0, 12.0, 15.5)
    assert m.queue_s == pytest.approx(2.0) and m.ttft_s == outs[0].ttft_s
    assert m.tpot_s == pytest.approx(1.75) and m.n_generated == 3
    lat = eng.stats()["latency"]
    assert lat["queue_s"]["sum"] == pytest.approx(2.0)
    assert lat["e2e_s"]["sum"] == pytest.approx(5.5)


def test_lifecycle_covers_abort_and_prefix_hit(tiny):
    def scenario(eng, clk):
        prompt = (np.arange(20, dtype=np.int32) * 7 + 1) % 256
        eng.add_request(prompt, max_new_tokens=4)
        drain(eng, clk, 0.0)
        rid2 = eng.add_request(prompt, max_new_tokens=4)
        drain(eng, clk, 0.0)
        blocker = eng.add_request(prompt[:9], max_new_tokens=40)
        clk.t = 101.0
        waiting = eng.add_request(prompt[:5], max_new_tokens=4)
        eng.step()
        clk.t = 103.0
        assert eng.abort(waiting) and eng.abort(blocker)
        drain(eng, clk, 0.0)
        return rid2, waiting
    runs = lockstep(tiny, scenario, num_slots=1, page_size=8, num_pages=17,
                    max_model_len=64, prefill_chunk=8)
    eng, _, (rid2, waiting) = runs["port"]
    out2, out = eng._outputs[rid2], eng._outputs[waiting]
    assert out2.metrics.cached_tokens == out2.cached_tokens > 0
    assert out.finish_reason == "abort" and out.metrics.t_admit is None
    assert out.metrics.e2e_s == pytest.approx(2.0)
    assert eng.stats()["aborted_requests"] == 2


def test_counters_monotonic_across_abort_and_eviction(tiny):
    """No registry counter decreases while the engine churns through prefix
    hits, LRU eviction and a mid-flight abort (read after every step), and
    the port's counters equal the reference's after it."""
    def scenario(eng, clk):
        rng = np.random.RandomState(5)
        vocab = eng.config.vocab_size
        shared = rng.randint(0, vocab, (20,)).astype(np.int32)
        rids = []
        for i in range(8):
            if i % 3 == 0:
                tail = rng.randint(0, vocab, (i,)).astype(np.int32)
                prompt = np.concatenate([shared, tail]) if i else shared
            else:
                prompt = rng.randint(0, vocab, (int(rng.randint(4, 40)),)) \
                    .astype(np.int32)
            rids.append(eng.add_request(prompt, max_new_tokens=6))
        prev = eng.metrics.snapshot()["counters"]
        steps = 0
        while eng.has_work:
            clk.t += 0.1
            eng.step()
            steps += 1
            if steps == 3:
                assert eng.abort(rids[-1])
            cur = eng.metrics.snapshot()["counters"]
            for k, v in cur.items():
                assert v >= prev.get(k, 0), (k, prev.get(k, 0), v)
            prev = cur
        return prev
    runs = lockstep(tiny, scenario, num_slots=2, page_size=8, num_pages=9,
                    max_model_len=64, prefill_chunk=16, spec_len=3, seed=3)
    eng, _, last = runs["port"]
    st = eng.stats()
    assert st["prefix_evictions"] >= 1
    assert st["prefix_evictions"] == last["prefix_evictions"]
    assert st["spec_events"] > 0 and st["aborted_requests"] >= 1
    assert st["accepted_per_step"] == pytest.approx(
        st["spec_emitted_tokens"] / st["spec_events"])
    eng.cache.check_invariants()


def test_step_trace_ring_bounded(tiny):
    def scenario(eng, clk):
        eng.add_request(np.arange(3, dtype=np.int32), max_new_tokens=10)
        drain(eng, clk, 0.5)
    runs = lockstep(tiny, scenario, num_slots=1, page_size=8,
                    max_model_len=64, trace_ring=4)
    eng = runs["port"][0]
    trace = eng.step_trace()
    assert len(trace) == 4 and trace[-1]["step"] > 4
    eng.reset_counters()
    runs["reference"][0].reset_counters()
    assert eng.step_trace() == [] and eng.stats()["decode_tokens"] == 0
    assert_same_observations(runs["reference"][0], eng)


def test_exemplar_roundtrip_exposition_to_request(tiny):
    """Every exemplar of the port's exposition carries the request handle
    and resolves through `export_request_trace` to that request's span
    tree; the bare and the OpenMetrics dialects follow the reference's."""
    def scenario(eng, clk):
        rid = eng.add_request(np.arange(6, dtype=np.int32), max_new_tokens=3)
        clk.t = 6.0
        drain(eng, clk, 0.0)
        return rid
    runs = lockstep(tiny, scenario, t0=5.0, num_slots=2, page_size=8,
                    max_model_len=64)
    eng, _, rid = runs["port"]
    text = eng.metrics.to_prometheus(exemplars=True)
    errs = []
    check_exposition(text, errs)
    assert not errs, errs
    _, exemplars = parse_prometheus_full(text)
    assert exemplars
    for (name, _), (lbls, _v) in exemplars.items():
        assert name.endswith("_bucket")
        assert lbls["trace"] == f'/requests/{lbls["request_id"]}'
        assert eng.export_request_trace(int(lbls["request_id"]))[
            "traceEvents"]
    tnames = {e["name"] for e in eng.export_request_trace(rid)["traceEvents"]}
    assert {f"request/{rid}", "queued", "prefill", "decode", "enqueue",
            "finish"} <= tnames
    assert " # {" not in eng.metrics.to_prometheus()
    assert " # {" in eng.metrics.to_prometheus(openmetrics=True)


def test_trace_retention_bounds_retired_timelines(tiny):
    def scenario(eng, clk):
        rids = [eng.add_request(np.arange(4 + i, dtype=np.int32),
                                max_new_tokens=2) for i in range(3)]
        drain(eng, clk, 0.5)
        return rids
    runs = lockstep(tiny, scenario, num_slots=2, page_size=8,
                    max_model_len=64, trace_retention=2)
    eng, _, rids = runs["port"]
    assert eng.export_request_trace(rids[0]) is None
    assert eng._outputs[rids[0]].trace is None
    assert len(eng._outputs[rids[0]].token_ids) >= 1
    assert all(eng.export_request_trace(r) for r in rids[1:])
    runs = lockstep(tiny, scenario, num_slots=2, page_size=8,
                    max_model_len=64, trace_retention=None)
    eng, _, rids = runs["port"]
    assert all(eng.export_request_trace(r) is not None for r in rids)
    for bad in (dict(trace_retention=-1), dict(trace_ring=0)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            make_engine(tiny, "port", FakeClock(), num_slots=1, page_size=8,
                        max_model_len=64, **bad)


def test_request_tracing_off_strips_surface(tiny):
    """request_tracing=False on both packages: no timelines, no
    `export_request_trace`, no exemplars, every histogram still observing;
    and the two untraced engines' observations are equal too."""
    def scenario(eng, clk):
        rid = eng.add_request(np.arange(6, dtype=np.int32), max_new_tokens=3)
        drain(eng, clk, 0.5)
        return rid
    runs = lockstep(tiny, scenario, num_slots=2, page_size=8,
                    max_model_len=64, request_tracing=False)
    eng, _, rid = runs["port"]
    assert eng._outputs[rid].trace is None
    assert eng.export_request_trace(rid) is None
    samples, exemplars = parse_prometheus_full(
        eng.metrics.to_prometheus(exemplars=True))
    assert not exemplars
    assert samples["llm_engine_ttft_seconds_count"][0][1] == 1


# ---------------------------------------------------------------------------
# the HTTP observability server, both packages over loopback
# ---------------------------------------------------------------------------

def _http_get(url, accept=None):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _servers():
    from paddle_tpu.inference.obs_server import ObservabilityServer as Ref
    from paddle_tpu_torch.inference.obs_server import ObservabilityServer
    return {"reference": Ref, "port": ObservabilityServer}


def test_obs_server_endpoint_smoke(tiny):
    """All five routes of each package's server over its engine: the
    OpenMetrics and plain expositions, `/stats` (the reference's keys and
    SLO block), `/requests/<rid>` (404 unknown, 400 malformed), `/debug`,
    `/healthz` and the 404 route list; the port's bodies equal the
    reference's where the clock decides them, and `close()` takes the
    listener down."""
    import urllib.error

    from tools.check_metrics import REQUIRED_DEBUG_BUNDLE_KEYS
    got = {}
    for which, cls in _servers().items():
        clk = FakeClock(100.0)
        eng = make_engine(tiny, which, clk, num_slots=2, page_size=8,
                          max_model_len=64)
        rid = eng.add_request(np.arange(6, dtype=np.int32), max_new_tokens=3)
        drain(eng, clk, 0.5)
        with cls(eng) as srv:
            assert srv.port > 0 and srv.url.startswith("http://127.0.0.1:")
            code, om = _http_get(srv.url + "/metrics",
                                 accept="application/openmetrics-text")
            assert code == 200 and om.endswith("# EOF\n")
            errs = []
            check_exposition(om, errs)
            assert not errs, errs
            assert parse_prometheus_full(om)[1]     # exemplars on the wire
            code, plain = _http_get(srv.url + "/metrics")
            assert code == 200 and " # {" not in plain
            assert "# EOF" not in plain
            check_exposition(plain, errs)
            assert not errs, errs
            code, st = _http_get(srv.url + "/stats")
            st = json.loads(st)
            assert code == 200 and "slo" in st
            code, tree = _http_get(srv.url + f"/requests/{rid}")
            assert code == 200 and json.loads(tree)["traceEvents"]
            codes = [_http_get(srv.url + path)[0] for path in
                     ("/requests/424242", "/requests/nope", "/nosuch")]
            code, health = _http_get(srv.url + "/healthz")
            health = json.loads(health)
            assert code == 200 and health["state"] in ("ok", "degraded")
            _, routes = _http_get(srv.url + "/nosuch")
            code, bundle = _http_get(srv.url + "/debug")
            assert code == 200
            assert REQUIRED_DEBUG_BUNDLE_KEYS <= set(json.loads(bundle))
            url = srv.url
        with pytest.raises((ConnectionError, urllib.error.URLError)):
            _http_get(url + "/healthz")
        got[which] = dict(om=om, plain=plain, tree=json.loads(tree),
                          codes=codes, health=health,
                          routes=json.loads(routes)["routes"],
                          slo=st["slo"], stat_keys=set(st))
    ref, port = got["reference"], got["port"]
    assert port["codes"] == ref["codes"] == [404, 400, 404]
    assert set(port["routes"]) == set(ref["routes"]) == {
        "/metrics", "/stats", "/requests/<rid>", "/debug", "/healthz"}
    assert ref["stat_keys"] <= port["stat_keys"]
    for key in ("om", "plain", "tree", "health", "slo"):
        assert port[key] == ref[key], key


def test_obs_server_fleet_mode(tiny):
    """Fleet mode on both packages: members under engine labels beside
    `llm_fleet_*` totals (the same text), `/stats` and `/debug` keyed by
    member, `?engine=` scoping of a request id both members know, 300
    with the candidate handles for the bare id; a server over an engine
    and a fleet at once, or over neither, is refused."""
    got = {}
    for which, cls in _servers().items():
        M = MODULES[which]
        engines = []
        for n in (7, 5):
            clk = FakeClock(100.0)
            e = make_engine(tiny, which, clk, num_slots=1, page_size=8,
                            max_model_len=64)
            rid = e.add_request(np.arange(n, dtype=np.int32),
                                max_new_tokens=2)
            drain(e, clk, 0.5)
            engines.append(e)
        assert rid == 0
        fleet = M.FleetMetrics().add("e0", engines[0]).add("e1", engines[1])
        r = {}
        with cls(fleet=fleet) as srv:
            code, text = _http_get(srv.url + "/metrics",
                                   accept="application/openmetrics-text")
            assert code == 200
            assert 'engine="e0"' in text and 'engine="e1"' in text
            assert "llm_fleet_" in text
            assert f'trace="/requests/{rid}?engine=e1"' in text
            r["text"] = text

            def prompt_len(path):
                code, tree = _http_get(srv.url + path)
                assert code == 200
                enq = [e for e in json.loads(tree)["traceEvents"]
                       if e["name"] == "enqueue"]
                return enq[0]["args"]["prompt_len"]
            r["scoped"] = [prompt_len(f"/requests/{rid}?engine={lb}")
                           for lb in ("e1", "e0")]
            code, body = _http_get(srv.url + f"/requests/{rid}")
            r["bare"] = (code, json.loads(body))
            r["nosuch"] = _http_get(srv.url +
                                    f"/requests/{rid}?engine=nosuch")[0]
            code, st = _http_get(srv.url + "/stats")
            st = json.loads(st)
            r["stats"] = (code, sorted(st), st["e1"]["finished_requests"])
            code, dbg = _http_get(srv.url + "/debug")
            r["debug"] = (code, sorted(json.loads(dbg)))
        with pytest.raises(ValueError):
            cls(engines[0], fleet=fleet)
        with pytest.raises(ValueError):
            cls()
        got[which] = r
    ref, port = got["reference"], got["port"]
    assert port == ref
    assert port["scoped"] == [5, 7]
    assert port["bare"][0] == 300 and port["bare"][1]["engines"] == ["e0",
                                                                     "e1"]
    assert "/requests/0?engine=e1" in port["bare"][1]["handles"]
    assert port["nosuch"] == 404
    assert port["stats"] == (200, ["e0", "e1"], 1)
    assert port["debug"] == (200, ["e0", "e1"])
