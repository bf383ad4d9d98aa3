"""The port's oversubscribed serving vs the JAX reference, on the CPU.

Case by case the twin of `tests/test_overload.py`, at its sizes
(`gpt_tiny(64)`, page 8, fp32, its prompts, pools and `FaultPlan`s): each
scenario runs on the reference engine (built with `kv_tier=False`, as the
reference's test builds it, and never warmed) and on the port's, also
built with `kv_tier=False`, on the same
`init_params` weights bridged through numpy.  Both must give the same
streams and finish reasons, and the same overload counters
(`OVERLOAD_STATS`); the streams must also equal the undisturbed run's where
the reference's test asks it, and `check_invariants` (the four partitions)
must hold after every step.

Beside the reference's cases: a forced double preemption in one step
(swap mode, two victims whose KV each lands in a host buffer of its own),
and preemption in the middle of verify with `spec_len=2`, fused and
unfused, where the preempted slots' drafts are pruned.

Each output's `RequestOutput.metrics` (its preemption count, tokens and
cached tokens) equals the reference's; a swapped slot's KV right after its
swap-in, and every cached page at the end, equal the reference's
(`torch_kv_parity`).  `test_bench_oversubscribe_completes_with_parity`
waits for ROADMAP Queue 1 item 10 (the serving bench).
"""
import jax
import numpy as np
import pytest

from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.inference.faults import FaultPlan as RefFaultPlan
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.inference.cache import PagedKVCache
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.faults import FaultInjected, FaultPlan
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from torch_kv_parity import (assert_same_kv, assert_same_swap_ins,
                             capture_swap_ins)

# the counters the port must report as the reference does
OVERLOAD_STATS = ("preemptions", "preempt_swaps", "preempt_recomputes",
                  "recomputed_tokens", "swapped_pages", "timeouts",
                  "rejected_requests", "intake_swap_rejects",
                  "pages_in_use", "swapped", "kv_pages_swapped",
                  "decode_executables", "verify_executables",
                  "prefill_executables", "copy_executables",
                  "swap_executables")
MAX_STEPS = 2000        # a scheduler fault must fail a test, not hang it


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, port params)."""
    cfg = G.gpt_tiny(64)
    params = G.init_params(cfg, jax.random.key(0))
    tcfg = TG.gpt_tiny(64)
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    return cfg, params, tcfg, tparams


def _prompts(vocab, n=6, lo=4, hi=9, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (int(rng.randint(lo, hi)),))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def reference(tiny):
    """The undisturbed run (big pool, reservation admission) on the
    reference engine: the token oracle every preempted run must match."""
    cfg, params, _, _ = tiny
    prompts = _prompts(cfg.vocab_size)
    eng = JaxEngine(params, cfg, num_slots=6, page_size=8, max_model_len=64,
                    prefill_chunk=8, kv_tier=False)
    rids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
    outs = eng.run()
    return prompts, [list(outs[r].token_ids) for r in rids]


def _makers(tiny):
    """{"reference": make, "port": make}: make(**kw) builds that engine on
    the shared weights; `fault_plan` is given as FaultPlan's keywords, so
    each engine gets its own (a plan is spent as it fires)."""
    cfg, params, tcfg, tparams = tiny

    swap_ins = {"reference": [], "port": []}

    def ref(fault=None, **kw):
        if fault is not None:
            kw["fault_plan"] = RefFaultPlan(**fault)
        eng = JaxEngine(params, cfg, kv_tier=False, **kw)
        swap_ins["reference"].append(capture_swap_ins(eng))
        return eng

    def port(fault=None, **kw):
        if fault is not None:
            kw["fault_plan"] = FaultPlan(**fault)
        eng = LLMEngine(tparams, tcfg, device="cpu", kv_tier=False, **kw)
        swap_ins["port"].append(capture_swap_ins(eng))
        return eng

    return {"reference": ref, "port": port}, swap_ins


def _both(tiny, scenario):
    """Run `scenario(make) -> (engine, rids)` on the reference and on the
    port; hold streams, finish reasons and the overload counters equal,
    each swapped slot's KV right after its swap-in equal to the
    reference's, and every cached page at the end (recompute resumes'
    re-prefilled pages among them).  Returns the port's (engine, rids)."""
    makers, swap_ins = _makers(tiny)
    runs = {name: scenario(make) for name, make in makers.items()}
    (ref, rrids), (eng, rids) = runs["reference"], runs["port"]
    assert len(rrids) == len(rids)
    for a, b in zip(rrids, rids):
        want, got = ref._outputs[a], eng._outputs[b]
        assert list(got.token_ids) == list(want.token_ids), \
            f"request {b}: port {got.token_ids}, reference {want.token_ids}"
        assert got.finish_reason == want.finish_reason
        for k in ("preemptions", "n_generated", "cached_tokens"):
            assert getattr(got.metrics, k) == getattr(want.metrics, k), \
                (b, k)
    rs, ps = ref.stats(), eng.stats()
    for k in OVERLOAD_STATS:
        assert ps[k] == rs[k], (k, ps[k], rs[k])
    assert ps["admission"] == rs["admission"]
    assert ps["preempt"] == rs["preempt"]
    # the engines each scenario built, in order: their swap-ins
    assert len(swap_ins["port"]) == len(swap_ins["reference"])
    for got, want in zip(swap_ins["port"], swap_ins["reference"]):
        assert_same_swap_ins(want, got)
    assert_same_kv(ref, eng)
    return eng, rids


def _drain_checked(eng):
    """step() to completion, the cache's invariants after every step."""
    for _ in range(MAX_STEPS):
        if not eng.has_work:
            break
        eng.step()
        eng.cache.check_invariants()
    assert not eng.has_work, "engine did not drain"
    st = eng.stats()
    assert st["pages_in_use"] == 0 and st["swapped"] == 0
    return st


def _serve(make, prompts, max_new, **kw):
    eng = make(**kw)
    rids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    _drain_checked(eng)
    return eng, rids


def _assert_parity(eng, rids, ref_tokens):
    for rid, ref in zip(rids, ref_tokens):
        out = eng._outputs[rid]
        assert out.finish_reason in ("stop", "length")
        assert list(out.token_ids) == ref, \
            f"request {rid} diverged under preemption"


POOL = dict(num_slots=6, page_size=8, num_pages=9, max_model_len=64)


# ---------------------------------------------------------------------------
# optimistic admission + token-granular growth
# ---------------------------------------------------------------------------

def test_optimistic_admission_beats_reservation_concurrency(tiny, reference):
    """Reservation fits two 4-page worst-case footprints into an 8-page
    pool; optimistic admission runs several slots off live tokens."""
    prompts, ref_tokens = reference
    peaks = {}

    def scenario(admission):
        def run(make):
            eng = make(prefill_chunk=8, admission=admission, **POOL)
            rids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
            peak = 0
            while eng.has_work:
                eng.step()
                peak = max(peak, eng.stats()["running"])
                eng.cache.check_invariants()
            peaks[(admission, type(eng).__module__)] = peak
            return eng, rids
        return run

    for admission in ("reservation", "optimistic"):
        eng, rids = _both(tiny, scenario(admission))
        _assert_parity(eng, rids, ref_tokens)
    port, ref = LLMEngine.__module__, JaxEngine.__module__
    for admission in ("reservation", "optimistic"):
        assert peaks[(admission, port)] == peaks[(admission, ref)]
    assert peaks[("reservation", port)] <= 2
    assert peaks[("optimistic", port)] >= 4


def test_optimistic_admits_watermark_sized_footprint_when_idle(tiny):
    """A prompt whose footprint sits within the watermark of the whole pool
    is admitted on an idle engine, not held behind the watermark."""
    def scenario(make):
        eng = make(num_slots=2, page_size=8, num_pages=5, max_model_len=64,
                   prefill_chunk=8, admission="optimistic")
        # 30 + 2 = 32 tokens = all 4 real pages: feasible, zero slack
        rid = eng.add_request(np.arange(30, dtype=np.int32),
                              max_new_tokens=2)
        _drain_checked(eng)
        return eng, [rid]

    eng, (rid,) = _both(tiny, scenario)
    assert eng._outputs[rid].finish_reason in ("stop", "length")


def test_optimistic_growth_tracks_live_tokens(tiny):
    """A lone decoding slot grows page by page: admission took only the
    prompt's footprint."""
    held = {}

    def scenario(make):
        eng = make(num_slots=2, page_size=8, max_model_len=64,
                   prefill_chunk=8, admission="optimistic")
        rid = eng.add_request(np.arange(6, dtype=np.int32),
                              max_new_tokens=40)
        h = []
        while eng.has_work:
            eng.step()
            h.append(eng.cache.pages_held(0))
            eng.cache.check_invariants()
        held[type(eng).__module__] = h
        return eng, [rid]

    eng, (rid,) = _both(tiny, scenario)
    h = held[LLMEngine.__module__]
    assert h == held[JaxEngine.__module__]
    assert h[0] == 1                        # prompt footprint only
    assert max(h) >= 5                      # grew with the 40-token decode
    assert eng._outputs[rid].finish_reason == "length"


# ---------------------------------------------------------------------------
# preemption: recompute and swap, parity and zero leaks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preempt", ["recompute", "swap"])
def test_preemption_parity_and_no_leaks(tiny, reference, preempt):
    prompts, ref_tokens = reference
    eng, rids = _both(tiny, lambda make: _serve(
        make, prompts, 24, prefill_chunk=8, admission="optimistic",
        preempt=preempt, **POOL))
    st = eng.stats()
    assert st["preemptions"] > 0
    if preempt == "swap":
        assert st["preempt_swaps"] > 0 and st["swapped_pages"] > 0
        assert st["swap_executables"] == 2
        assert st["swap_ms"] >= 0.0
        assert st["swap_out_dispatches"] == st["preemptions"] - \
            st["preempt_recomputes"]
        assert st["swap_in_dispatches"] == st["preempt_swaps"]
    else:
        assert st["preempt_recomputes"] == st["preemptions"]
        assert st["recomputed_tokens"] > 0
        assert st["swap_executables"] == 0
    _assert_parity(eng, rids, ref_tokens)
    assert sum(eng._outputs[r].metrics.preemptions for r in rids) == \
        st["preemptions"]


def test_swap_pool_exhaustion_degrades_to_recompute(tiny, reference):
    """swap_pool_pages=0 leaves no host room: every preemption falls back
    to recompute, and no swap program is built."""
    prompts, ref_tokens = reference
    eng, rids = _both(tiny, lambda make: _serve(
        make, prompts, 24, prefill_chunk=8, admission="optimistic",
        preempt="swap", swap_pool_pages=0, **POOL))
    st = eng.stats()
    assert st["preemptions"] > 0
    assert st["preempt_swaps"] == 0 and st["swapped_pages"] == 0
    assert st["preempt_recomputes"] == st["preemptions"]
    assert st["swap_executables"] == 0
    _assert_parity(eng, rids, ref_tokens)


def test_victim_selection_prefers_low_priority(tiny):
    """Under forced pressure the priority-0 request is evicted, never the
    priority-1 request."""
    preempted = {}

    def scenario(make):
        eng = make(num_slots=2, page_size=8, max_model_len=64,
                   prefill_chunk=8, admission="optimistic",
                   fault=dict(pressure_steps=(4,)))
        lo = eng.add_request(np.arange(4, dtype=np.int32),
                             max_new_tokens=20, priority=0)
        hi = eng.add_request(np.arange(4, 6, dtype=np.int32),
                             max_new_tokens=20, priority=1)
        seen = set()
        while eng.has_work:
            eng.step()
            seen |= set(eng._preempted)
            eng.cache.check_invariants()
        preempted[type(eng).__module__] = seen
        return eng, [lo, hi]

    eng, (lo, hi) = _both(tiny, scenario)
    seen = preempted[LLMEngine.__module__]
    assert seen == preempted[JaxEngine.__module__]
    assert lo in seen and hi not in seen
    for rid in (lo, hi):
        assert eng._outputs[rid].finish_reason == "length"


@pytest.mark.parametrize("mode", ["bucketed", "unfused"])
def test_preemption_on_legacy_paths(tiny, reference, mode):
    """Growth and preemption on the bucketed one-shot prefill (a recompute
    resume replays its longer prompt through the bucket ladder) and on the
    fuse=False step (growth before the decode and verify dispatches)."""
    prompts, ref_tokens = reference
    kw = dict(prefill_chunk=None) if mode == "bucketed" \
        else dict(prefill_chunk=8, fuse=False)
    eng, rids = _both(tiny, lambda make: _serve(
        make, prompts, 24, admission="optimistic", **POOL, **kw))
    assert eng.stats()["preemptions"] > 0
    _assert_parity(eng, rids, ref_tokens)


# ---------------------------------------------------------------------------
# fault injection: forced pressure mid-verify and mid-chunk, failing copies
# ---------------------------------------------------------------------------

def _spec_prompts(vocab):
    rng = np.random.RandomState(3)
    # repetitive prompts, so the n-gram proposer drafts
    base = rng.randint(0, vocab, (4,)).astype(np.int32)
    return [np.tile(base, 3)[:10 + i] for i in range(4)]


@pytest.fixture(scope="module")
def spec_reference(tiny):
    """The undisturbed vanilla-greedy streams of `_spec_prompts`."""
    cfg, params, _, _ = tiny
    eng = JaxEngine(params, cfg, num_slots=4, page_size=8, max_model_len=64,
                    prefill_chunk=8, kv_tier=False)
    rids = [eng.add_request(p, max_new_tokens=20)
            for p in _spec_prompts(cfg.vocab_size)]
    outs = eng.run()
    return [list(outs[r].token_ids) for r in rids]


@pytest.mark.parametrize("spec_len,fuse", [(3, True), (2, True), (2, False)],
                         ids=["k3_fused", "k2_fused", "k2_unfused"])
def test_forced_pressure_mid_verify_keeps_spec_parity(tiny, spec_reference,
                                                      spec_len, fuse):
    """Preemption in steps whose slots carry drafts: a victim's draft goes
    with it (pruned from the dispatch), and its replay still reproduces the
    vanilla greedy stream.  k3_fused is the reference's case; the spec_len
    2 cases add the unfused verify program."""
    cfg = tiny[0]
    prompts = _spec_prompts(cfg.vocab_size)
    eng, rids = _both(tiny, lambda make: _serve(
        make, prompts, 20, num_slots=4, page_size=8, max_model_len=64,
        prefill_chunk=8, spec_len=spec_len, fuse=fuse,
        admission="optimistic", fault=dict(pressure_steps=(3, 5, 7))))
    st = eng.stats()
    assert st["preemptions"] >= 1
    assert st["spec_events"] > 0, "verify lane never exercised"
    _assert_parity(eng, rids, spec_reference)


def test_forced_pressure_mid_chunk_prefill(tiny):
    """Preemption while another slot is mid-chunk-prefill: the prefilling
    slot keeps its prompt pages, victims come from the decode set, and
    everyone finishes with exact tokens."""
    cfg, params, _, _ = tiny
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 6, 40, 7)]     # the 40-token prompt chunks 5x
    base = JaxEngine(params, cfg, num_slots=4, page_size=8, max_model_len=64,
                     prefill_chunk=8, kv_tier=False)
    rr = [base.add_request(p, max_new_tokens=16) for p in prompts]
    base_outs = base.run()
    ref_tokens = [list(base_outs[r].token_ids) for r in rr]
    saw = {}

    def scenario(make):
        eng = make(num_slots=4, page_size=8, max_model_len=64,
                   prefill_chunk=8, admission="optimistic",
                   fault=dict(pressure_steps=(2, 3, 4, 5, 6)))
        rids = [eng.add_request(p, max_new_tokens=16) for p in prompts]
        hit = False
        while eng.has_work:
            pre = eng.stats()["preemptions"]
            eng.step()
            st = eng.stats()
            if st["preemptions"] > pre and st["prefilling"] > 0:
                hit = True
            eng.cache.check_invariants()
        saw[type(eng).__module__] = hit
        return eng, rids

    eng, rids = _both(tiny, scenario)
    assert eng.stats()["preemptions"] >= 1
    assert saw[LLMEngine.__module__] and saw[JaxEngine.__module__], \
        "no preemption landed while a chunk prefill was in progress"
    _assert_parity(eng, rids, ref_tokens)


@pytest.mark.parametrize("kw", [dict(fail_d2h=2), dict(fail_h2d=2)],
                         ids=["d2h", "h2d"])
def test_swap_copy_failures_degrade_cleanly(tiny, reference, kw):
    """Injected d2h and h2d copy failures turn swaps into recomputes: the
    host obligation is cleared, pages balance, tokens unchanged."""
    prompts, ref_tokens = reference
    eng, rids = _both(tiny, lambda make: _serve(
        make, prompts, 24, prefill_chunk=8, admission="optimistic",
        preempt="swap", fault=kw, **POOL))
    st = eng.stats()
    assert st["preemptions"] > 0
    assert st["preempt_recomputes"] > 0, "no swap ever degraded"
    if "fail_d2h" in kw:
        # a failed d2h never delivered KV to the host pool
        assert st["preempt_swaps"] + st["preempt_recomputes"] == \
            st["preemptions"]
    else:
        # an h2d failure degrades a swap that had delivered
        assert st["preempt_swaps"] + st["preempt_recomputes"] >= \
            st["preemptions"]
    _assert_parity(eng, rids, ref_tokens)


def test_swap_then_abort_releases_host_pool(tiny, reference):
    prompts, _ = reference
    aborted = {}

    def scenario(make):
        eng = make(prefill_chunk=8, admission="optimistic", preempt="swap",
                   **POOL)
        rids = [eng.add_request(p, max_new_tokens=24) for p in prompts]
        rid = None
        while eng.has_work:
            eng.step()
            eng.cache.check_invariants()
            if rid is None:
                swapped = [r for r, rec in eng._preempted.items()
                           if rec["kind"] == "swap"]
                if swapped:
                    assert eng.abort(swapped[0])
                    rid = swapped[0]
                    eng.cache.check_invariants()
        aborted[type(eng).__module__] = rid
        return eng, rids

    eng, rids = _both(tiny, scenario)
    rid = aborted[LLMEngine.__module__]
    assert rid is not None, "no request was ever swapped out"
    assert rid == aborted[JaxEngine.__module__]
    out = eng._outputs[rid]
    assert out.finish_reason == "abort"
    assert len(out.token_ids) > 0           # banked generation survives abort
    assert eng.cache.swapped_page_count == 0
    assert eng.stats()["pages_in_use"] == 0


def test_abort_during_recompute_replay_keeps_banked_tokens(tiny):
    """abort() of a preempted request mid-replay (prefilling again, with
    `prior` tokens banked) publishes those tokens and its original TTFT."""
    caught = {}

    def scenario(make):
        # prefix_cache=False: with the cache the victim's own pages match
        # again and the replay ends inside one step
        eng = make(num_slots=2, page_size=8, max_model_len=64,
                   prefill_chunk=4, admission="optimistic",
                   prefix_cache=False, fault=dict(pressure_steps=(5,)))
        rids = [eng.add_request(np.arange(8 + i, dtype=np.int32),
                                max_new_tokens=24) for i in range(2)]
        rid = None
        while eng.has_work:
            eng.step()
            eng.cache.check_invariants()
            if rid is None:
                resumed = [st for st in eng._prefilling.values() if st.prior]
                if resumed:
                    st = resumed[0]
                    banked = list(st.prior)
                    assert eng.abort(st.request.request_id)
                    rid = st.request.request_id
                    out = eng._outputs[rid]
                    assert out.finish_reason == "abort"
                    assert list(out.token_ids) == banked
                    assert out.ttft_s is not None
                    eng.cache.check_invariants()
        caught[type(eng).__module__] = rid
        return eng, rids

    eng, _ = _both(tiny, scenario)
    assert caught[LLMEngine.__module__] is not None, \
        "no preempted request was caught mid-replay"
    assert caught[LLMEngine.__module__] == caught[JaxEngine.__module__]
    assert eng.stats()["pages_in_use"] == 0


# ---------------------------------------------------------------------------
# deadlines + clock skew
# ---------------------------------------------------------------------------

def test_deadline_timeout_queued_and_running(tiny):
    """Both requests time out, the queued one before its first token; the
    timeouts stay out of the e2e latency histogram, as the reference's
    test holds."""
    def scenario(make):
        t = [0.0]
        eng = make(num_slots=1, page_size=8, num_pages=9, max_model_len=64,
                   prefill_chunk=8, clock=lambda: t[0])
        slow = eng.add_request(np.arange(4, dtype=np.int32),
                               max_new_tokens=40, deadline_s=5.0)
        queued = eng.add_request(np.arange(6, dtype=np.int32),
                                 max_new_tokens=4, deadline_s=3.0)
        while eng.has_work:
            eng.step()
            t[0] += 1.0
            eng.cache.check_invariants()
        return eng, [slow, queued]

    eng, (slow, queued) = _both(tiny, scenario)
    outs = eng._outputs
    assert outs[slow].finish_reason == "timeout"
    assert outs[queued].finish_reason == "timeout"
    assert outs[queued].ttft_s is None      # never reached a first token
    assert outs[queued].metrics.t_first_token is None
    assert len(outs[slow].token_ids) > 0    # partial generation published
    st = eng.stats()
    assert st["timeouts"] == 2
    assert st["finished_requests"] == 0
    assert st["pages_in_use"] == 0
    assert st["latency"]["e2e_s"]["count"] == 0


def test_deadline_during_swap(tiny):
    """A deadline that expires while the request's KV sits in the host
    swap pool: the obligation is dropped, the reason is timeout."""
    jumped = {}

    def scenario(make):
        t = [0.0]
        eng = make(num_slots=2, page_size=8, max_model_len=64,
                   prefill_chunk=8, admission="optimistic", preempt="swap",
                   fault=dict(pressure_steps=(4,)), clock=lambda: t[0])
        rids = [eng.add_request(np.arange(4 + i, dtype=np.int32),
                                max_new_tokens=24, deadline_s=100.0)
                for i in range(2)]
        jump = False
        while eng.has_work:
            eng.step()
            t[0] += 1.0
            eng.cache.check_invariants()
            if not jump and eng.stats()["swapped"] > 0:
                t[0] += 1000.0          # expire everything, swapped included
                jump = True
        jumped[type(eng).__module__] = jump
        return eng, rids

    eng, rids = _both(tiny, scenario)
    assert jumped[LLMEngine.__module__], \
        "no request was swapped before the deadline jump"
    assert any(eng._outputs[r].finish_reason == "timeout" for r in rids)
    assert eng.cache.swapped_page_count == 0
    assert eng.stats()["pages_in_use"] == 0
    eng.cache.check_invariants()


def test_clock_skew_expires_early_but_cleanly(tiny):
    def scenario(make):
        t = [0.0]
        eng = make(num_slots=2, page_size=8, max_model_len=64,
                   prefill_chunk=8, fault=dict(skew_s=1e6),
                   clock=lambda: t[0])
        rid = eng.add_request(np.arange(4, dtype=np.int32),
                              max_new_tokens=20, deadline_s=50.0)
        ok = eng.add_request(np.arange(5, dtype=np.int32), max_new_tokens=4)
        while eng.has_work:
            eng.step()
            t[0] += 0.01
            eng.cache.check_invariants()
        return eng, [rid, ok]

    eng, (rid, ok) = _both(tiny, scenario)
    # the skewed clock expired the deadlined request at its first step; the
    # deadline-free request is untouched by skew
    assert eng._outputs[rid].finish_reason == "timeout"
    assert eng._outputs[ok].finish_reason in ("stop", "length")
    assert eng.stats()["pages_in_use"] == 0


# ---------------------------------------------------------------------------
# fail-fast rejection
# ---------------------------------------------------------------------------

def test_impossible_footprint_rejected_without_wedging(tiny):
    def scenario(make):
        eng = make(num_slots=2, page_size=8, num_pages=3,
                   max_model_len=64)   # 2 real pages = 16 tokens
        big = eng.add_request(np.zeros((20,), np.int32), max_new_tokens=8)
        out = eng._outputs[big]
        assert out.finish_reason == "rejected" and out.token_ids == []
        assert eng.stats()["rejected_requests"] == 1
        assert eng.stats()["queued"] == 0   # never entered the queue
        # the queue head is not wedged: a feasible request behind it runs
        ok = eng.add_request(np.zeros((6,), np.int32), max_new_tokens=4)
        _drain_checked(eng)
        return eng, [big, ok]

    eng, (_, ok) = _both(tiny, scenario)
    assert eng._outputs[ok].finish_reason in ("stop", "length")


def test_rejection_applies_under_optimistic_too(tiny):
    def scenario(make):
        eng = make(num_slots=2, page_size=8, num_pages=3, max_model_len=64,
                   admission="optimistic")
        # the prompt alone fits, its worst case (24 tokens = 3 pages) never
        rid = eng.add_request(np.zeros((4,), np.int32), max_new_tokens=20)
        return eng, [rid]

    eng, (rid,) = _both(tiny, scenario)
    assert eng._outputs[rid].finish_reason == "rejected"


def test_intake_swap_reject_and_host_pool_bytes(tiny):
    """The reference's swap-pool intake gate (`test_intake_swap_reject` of
    its quantized tests): a footprint that fits the device pool but could
    never park in a 2-page host pool is rejected; a parkable one runs."""
    def scenario(make):
        eng = make(num_slots=2, page_size=8, max_model_len=64,
                   admission="optimistic", preempt="swap", swap_pool_pages=2)
        rid = eng.add_request(np.arange(8, dtype=np.int32),
                              max_new_tokens=32)    # 5 pages
        rid2 = eng.add_request(np.arange(4, dtype=np.int32),
                               max_new_tokens=8)
        _drain_checked(eng)
        return eng, [rid, rid2]

    eng, (rid, rid2) = _both(tiny, scenario)
    assert eng._outputs[rid].finish_reason == "rejected"
    assert eng._outputs[rid2].finish_reason == "length"
    st = eng.stats()
    assert st["intake_swap_rejects"] == 1 and st["rejected_requests"] == 1
    cfg, params = tiny[:2]
    ref = JaxEngine(params, cfg, num_slots=2, page_size=8, max_model_len=64,
                    admission="optimistic", preempt="swap",
                    swap_pool_pages=2, kv_tier=False)
    assert eng.host_pool_bytes() == eng.swap_pool_bytes() == \
        ref.host_pool_bytes()


# ---------------------------------------------------------------------------
# a forced double preemption: two swap victims in one growth pass
# ---------------------------------------------------------------------------

def test_double_swap_preemption_in_one_step(tiny):
    """Four 8- and 16-token prompts fill all but one page of a 7-page pool;
    at their first decode step every slot crosses a page boundary.  The
    first growth takes the last free page, the second fails and preempts
    the first low-priority victim (the most pages), whose 2 pages cover
    two growths; the fourth fails again and preempts the second victim.
    Each victim's KV lands in a host buffer of its own, and both resume by
    swap-in with the undisturbed streams."""
    cfg, params, _, _ = tiny
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (8, 8, 16, 16)]
    base = JaxEngine(params, cfg, num_slots=4, page_size=8, max_model_len=64,
                     kv_tier=False)
    rr = [base.add_request(p, max_new_tokens=12) for p in prompts]
    base_outs = base.run()
    ref_tokens = [list(base_outs[r].token_ids) for r in rr]
    doubles = {}

    def scenario(make):
        eng = make(num_slots=4, page_size=8, num_pages=8, max_model_len=64,
                   admission="optimistic", preempt="swap")
        eng.warm_swap()
        rids = [eng.add_request(p, max_new_tokens=12,
                                priority=-1 if i < 2 else 0)
                for i, p in enumerate(prompts)]
        steps = []
        while eng.has_work:
            pre, parked = dict(eng.stats()), set(eng._preempted)
            eng.step()
            st = eng.stats()
            eng.cache.check_invariants()
            if st["preemptions"] - pre["preemptions"] >= 2:
                steps.append((st["preempt_swaps"] - pre["preempt_swaps"],
                              st["swapped"]))
                if isinstance(eng, LLMEngine) and len(steps) == 1:
                    recs = [r for rid, r in eng._preempted.items()
                            if rid not in parked and r["kind"] == "swap"]
                    assert len(recs) == 2
                    a, b = (r["data"]["k"] for r in recs)
                    assert a.data_ptr() != b.data_ptr()
                    assert a.shape[1] == recs[0]["n"]   # real pages only
        doubles[type(eng).__module__] = steps
        return eng, rids

    eng, rids = _both(tiny, scenario)
    steps = doubles[LLMEngine.__module__]
    assert steps == doubles[JaxEngine.__module__]
    assert steps and steps[0] == (2, 2), steps
    st = eng.stats()
    assert st["preempt_swaps"] == st["preemptions"] >= 2
    assert st["swap_executables"] == 2
    _assert_parity(eng, rids, ref_tokens)


# ---------------------------------------------------------------------------
# cache-level unit coverage, and the fault plan
# ---------------------------------------------------------------------------

def test_cache_grow_and_swap_partition_unit():
    mgr = PagedKVCache(num_pages=8, page_size=4, num_slots=2,
                       max_pages_per_slot=4)
    mgr.allocate(0, 4)                      # 1 page
    assert mgr.pages_held(0) == 1
    mgr.grow(0, 5)                          # crosses into page 2
    assert mgr.pages_held(0) == 2
    mgr.grow(0, 5)                          # idempotent
    assert mgr.pages_held(0) == 2
    assert mgr.slot_pages(0) == list(mgr.page_table[0, :2])
    mgr.check_invariants()
    with pytest.raises(ValueError, match="slot capacity"):
        mgr.grow(0, 17)
    mgr.note_swap_out(7, 2)
    assert mgr.swapped_page_count == 2 and mgr.swapped_requests == 1
    assert mgr.host_pool_room(5) == 3
    with pytest.raises(RuntimeError, match="already swapped"):
        mgr.note_swap_out(7, 1)
    mgr.check_invariants()
    assert mgr.note_swap_in(7) == 2
    assert mgr.swapped_page_count == 0
    mgr.release(0)
    mgr.check_invariants()
    # growth exhausts the pool -> RuntimeError (the preemption trigger):
    # slot 1 holds 4 of the 7 real pages, slot 0 one; growing slot 0 to 4
    # pages needs 3 fresh pages but only 2 remain
    mgr.allocate(1, 16)
    mgr.allocate(0, 4)
    assert mgr.pool_pressure() == pytest.approx(5 / 7)
    with pytest.raises(RuntimeError, match="out of KV pages"):
        mgr.grow(0, 16)
    mgr._swapped[9] = 5                     # past a slot's capacity
    with pytest.raises(AssertionError, match="swapped request 9"):
        mgr.check_invariants()


def test_fault_plan_unit():
    plan = FaultPlan(pressure_steps=(2,), fail_d2h=1, skew_s=3.0)
    assert not plan.pool_pressure(1)
    assert plan.pool_pressure(2)
    assert not plan.pool_pressure(2)        # fires once per listed step
    with pytest.raises(FaultInjected):
        plan.d2h()
    plan.d2h()                              # budget spent: no-op
    plan.h2d()                              # never armed: no-op
    assert plan.skew() == 3.0


def test_swap_programs_round_trip_every_leaf(tiny):
    """`swap_out_pages`/`swap_in_pages` over an fp and an int8 pool: a
    gather of real pages scattered into other pages restores every leaf
    bitwise (the int8 pool's scale lanes too); the padding rows land on the
    null page only."""
    import torch
    _, _, tcfg, _ = tiny
    for kv in (None, "int8"):
        pool = TG.init_paged_cache(tcfg, 9, 8, device="cpu", kv_dtype=kv)
        g = torch.Generator().manual_seed(0)
        for a in pool.values():
            a.copy_((torch.randn(a.shape, generator=g) * 50).to(a.dtype))
        before = {n: a.clone() for n, a in pool.items()}
        ids = torch.tensor([3, 5, 0, 0], dtype=torch.int32)
        data = TG.swap_out_pages(pool, ids)
        assert set(data) == set(pool)       # 4 leaves on an int8 pool
        dst = torch.tensor([6, 7, 0, 0], dtype=torch.int32)
        TG.swap_in_pages(pool, dst, data)
        for n, a in pool.items():
            assert torch.equal(a[:, 6], before[n][:, 3])
            assert torch.equal(a[:, 7], before[n][:, 5])
            assert torch.equal(a[:, 1:6], before[n][:, 1:6])
            assert torch.equal(a[:, 8], before[n][:, 8])
