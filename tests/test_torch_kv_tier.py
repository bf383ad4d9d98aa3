"""The port's KV tier vs the JAX reference, on the CPU.

Case by case the twin of `tests/test_kv_tier.py`, at its sizes
(`gpt_tiny(64)`, page 8, nine pages, fp32, its sessions, pools and
`FaultPlan`s): each scenario runs on the reference engine (never warmed)
and on the port's, on the same `init_params` weights bridged through numpy.
Streams must equal the reference's and, where the reference's test asks
it, the `kv_tier=False` re-prefill's; the tier counters (`TIER_STATS`)
must equal the reference's; every cached prefix page, on the device, on
the host or in the store, must hold the reference's KV for its tokens
(float32, 1e-4: greedy streams of a random tiny model barely depend on
which KV a restore put back, so the pages are compared themselves);
`check_invariants` (the tier and restore-plan partitions among them) must
hold after every step of the port; each restore is one "swap_in" replay.

Beside the reference's cases: `probe_affinity`'s `tier_tokens` on a tier
hit against the reference's value.

Left for later slices: `test_bench_multi_turn_tier_acceptance` and
`test_check_bench_v1_rows_still_parse` drive `bench_serve` and
`tools/check_bench`, which wait for ROADMAP Queue 1 item 10 (the serving
bench).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.inference.cache import PagedKVCache as RefCache
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.inference.faults import FaultPlan as RefFaultPlan
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.inference.cache import PagedKVCache
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.faults import FaultPlan
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from torch_kv_parity import assert_same_kv

# the tier counters the port must report as the reference does
TIER_STATS = ("spills", "restores", "restored_tokens", "partial_page_hits",
              "disk_spills", "disk_restores", "tier_drops", "pages_host",
              "pages_disk", "enabled")
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


def _engine(tiny, port, fault=None, **kw):
    """The reference's `_engine` geometry on either framework; `fault` is
    a FaultPlan's keywords (each engine gets a plan of its own)."""
    cfg, params, tcfg, tparams = tiny
    base = dict(num_slots=2, page_size=8, num_pages=9, max_model_len=64,
                prefill_chunk=16, seed=3, swap_pool_pages=64)
    base.update(kw)
    if port:
        if fault is not None:
            base["fault_plan"] = FaultPlan(**fault)
        return LLMEngine(tparams, tcfg, device="cpu", **base)
    if fault is not None:
        base["fault_plan"] = RefFaultPlan(**fault)
    return JaxEngine(params, cfg, **base)


def _run(eng):
    """run() to completion; on the port, `check_invariants` after every
    step."""
    if isinstance(eng, JaxEngine):
        return eng.run()
    for _ in range(MAX_STEPS):
        if not eng.has_work:
            break
        eng.step()
        eng.cache.check_invariants()
    assert not eng.has_work, "engine did not drain"
    return eng._outputs


def _session_stream(eng, rng_seed=7, churn=6):
    """The reference's: turn 1 of a session, churn that evicts its pages,
    then the returning turn (prompt + reply + fresh tokens).  Returns
    ({rid: output}, returning-turn output)."""
    rng = np.random.RandomState(rng_seed)
    vocab = eng.config.vocab_size
    shared = rng.randint(0, vocab, (20,)).astype(np.int32)
    outs = {}
    r1 = eng.add_request(shared, max_new_tokens=5)
    outs.update(_run(eng))
    for _ in range(churn):
        eng.add_request(rng.randint(0, vocab, (30,)).astype(np.int32),
                        max_new_tokens=4)
    outs.update(_run(eng))
    t2 = np.concatenate([shared, np.asarray(outs[r1].token_ids, np.int32),
                         rng.randint(0, vocab, (4,)).astype(np.int32)])
    r2 = eng.add_request(t2, max_new_tokens=5)
    outs.update(_run(eng))
    return outs, outs[r2]


def _streams(outs):
    return [list(outs[r].token_ids) for r in sorted(outs)]


def _assert_tier_parity(ref, eng):
    """The tier counters, `swapped_pages`, the prefill counters and the
    swap program count equal; one "swap_in" replay a restore (and one a
    preemption swap-in).  Returns the port's stats()."""
    rs, ps = ref.stats(), eng.stats()
    for k in TIER_STATS:
        assert ps["kv_tier"][k] == rs["kv_tier"][k], \
            (k, ps["kv_tier"][k], rs["kv_tier"][k])
    for k in ("swapped_pages", "prefilled_tokens", "prefix_cached_tokens",
              "swap_executables"):
        assert ps[k] == rs[k], (k, ps[k], rs[k])
    assert ps["swap_in_dispatches"] == ps["kv_tier"]["restores"] + \
        ps["preempt_swaps"]
    assert_same_kv(ref, eng)
    return ps


@pytest.fixture(scope="module")
def reprefill(tiny):
    """The reference's `kv_tier=False` session: the re-prefill baseline."""
    eng = _engine(tiny, False, kv_tier=False)
    outs, _ = _session_stream(eng)
    return _streams(outs), eng.stats()


def _both_sessions(tiny, **kw):
    """The session on the reference and on the port with the same knobs;
    streams equal.  Returns (reference engine, port engine, port's
    returning-turn output)."""
    ref = _engine(tiny, False, **kw)
    ref_outs, _ = _session_stream(ref)
    eng = _engine(tiny, True, **{k: v for k, v in kw.items()
                                 if k != "spill_dir"},
                  **({"spill_dir": kw["spill_dir"] + "_port"}
                     if "spill_dir" in kw else {}))
    outs, ret = _session_stream(eng)
    assert _streams(outs) == _streams(ref_outs)
    return ref, eng, ret


# ---------------------------------------------------------------------------
# resumed from the host: parity and counters
# ---------------------------------------------------------------------------

def test_host_restore_parity_and_counters(tiny, reprefill):
    """A returning session whose pages the LRU evicted restores from the
    host tier with one scatter: streams equal the reference's, the
    re-prefill's and `generate`'s; the counters equal the reference's."""
    cfg, params = tiny[:2]
    ref, eng, ret = _both_sessions(tiny)
    outs = eng._outputs
    assert _streams(outs) == reprefill[0]
    want = G.generate(params, jnp.asarray(ret.prompt)[None], cfg,
                      max_new_tokens=5)
    np.testing.assert_array_equal(ret.tokens, np.asarray(want[0]))
    st = _assert_tier_parity(ref, eng)
    base = _engine(tiny, True, kv_tier=False)
    base_outs, _ = _session_stream(base)
    assert _streams(base_outs) == reprefill[0]
    base_st = base.stats()
    assert st["kv_tier"]["enabled"] and not base_st["kv_tier"]["enabled"]
    assert st["kv_tier"]["spills"] > 0
    assert st["kv_tier"]["restores"] >= 1
    assert st["kv_tier"]["restored_tokens"] >= 16     # >= 2 full pages
    assert base_st["kv_tier"]["spills"] == 0
    assert base_st["prefilled_tokens"] == reprefill[1]["prefilled_tokens"]
    assert st["prefilled_tokens"] < base_st["prefilled_tokens"]
    assert st["swap_executables"] <= 2
    assert st["decode_executables"] + st["verify_executables"] == 1
    assert eng.cache.swapped_page_count == 0


def test_restore_from_spill_dir_parity(tiny, reprefill, tmp_path):
    """A tight host budget with `spill_dir`: tier pages cascade to the
    store and restore from there, with the re-prefill's streams."""
    ref, eng, _ = _both_sessions(tiny, swap_pool_pages=6,
                                 spill_dir=str(tmp_path / "s"))
    assert _streams(eng._outputs) == reprefill[0]
    st = _assert_tier_parity(ref, eng)
    assert st["kv_tier"]["disk_spills"] > 0
    assert st["kv_tier"]["restores"] >= 1
    assert st["kv_tier"]["pages_host"] <= 6


def test_eviction_cascade_to_drop_no_leaks(tiny, tmp_path):
    """device -> host -> disk -> drop under a capped store: every level's
    accounting exact after every step, dropped objects deleted, counters
    equal to the reference's."""
    engines = [_engine(tiny, port, swap_pool_pages=4,
                       spill_dir=str(tmp_path / name), spill_disk_pages=3)
               for port, name in ((False, "ref"), (True, "port"))]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 64, (30,)).astype(np.int32)
               for _ in range(10)]
    outs = []
    for eng in engines:
        for p in prompts:
            eng.add_request(p, max_new_tokens=4)
            _run(eng)
        outs.append(_streams(eng._outputs))
    ref, eng = engines
    assert outs[0] == outs[1]
    st = _assert_tier_parity(ref, eng)["kv_tier"]
    assert st["pages_host"] <= 4 and st["pages_disk"] <= 3
    assert st["disk_spills"] > 0 and st["tier_drops"] > 0
    assert len(os.listdir(str(tmp_path / "port"))) == \
        eng.cache.tier_pages_disk


@pytest.mark.parametrize("kw", [dict(kv_tier=False), dict(prefix_cache=False),
                                dict(swap_pool_pages=0)],
                         ids=lambda d: next(iter(d)))
def test_no_tier_when_disabled_or_unbudgeted(tiny, kw):
    """kv_tier=False, prefix_cache=False and swap_pool_pages=0 each leave
    the tier off: evictions drop, as the reference's."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 64, (30,)).astype(np.int32) for _ in range(4)]
    engines = [_engine(tiny, port, **kw) for port in (False, True)]
    for eng in engines:
        assert not eng.kv_tier
        for p in prompts:
            eng.add_request(p, max_new_tokens=3)
        _run(eng)
    ref, eng = engines
    assert _streams(eng._outputs) == _streams(ref._outputs)
    st = _assert_tier_parity(ref, eng)["kv_tier"]
    assert st["spills"] == 0 and st["pages_host"] == 0


# ---------------------------------------------------------------------------
# the rolling-hash partial-page index
# ---------------------------------------------------------------------------

def test_rolling_hash_partial_tail_of_full_page():
    """A prompt sharing only part of a cached full page COW-copies the
    matched fraction, on both caches alike."""
    got = []
    for cls in (RefCache, PagedKVCache):
        mgr = cls(num_pages=16, page_size=4, num_slots=4,
                  max_pages_per_slot=8)
        tok = np.arange(12, dtype=np.int32)
        mgr.allocate_prefixed(0, 12, tok)
        mgr.register_prefix(0, tok, 12)
        div = np.concatenate([tok[:6], np.full(4, 77, np.int32)])
        _, m, cow = mgr.allocate_prefixed(1, 12, div)
        assert m == 6 and cow is not None
        assert cow[0] == mgr.slot_pages(0)[1]
        bad = np.concatenate([tok[:4], np.full(3, 9, np.int32)])
        _, m2, cow2 = mgr.allocate_prefixed(2, 8, bad)
        assert m2 == 4 and cow2 is None
        mgr.check_invariants()
        got.append((m, cow, m2, [mgr.slot_pages(s) for s in range(3)]))
    assert got[0] == got[1]


def test_rolling_hash_engine_parity(tiny):
    """A request sharing part of a cached page: streams equal the
    reference's and `generate`'s, 12 cached tokens, a partial hit."""
    cfg, params = tiny[:2]
    rng = np.random.RandomState(5)
    donor = rng.randint(0, cfg.vocab_size, (24,)).astype(np.int32)
    probe = np.concatenate([donor[:12], rng.randint(0, cfg.vocab_size, (6,))
                            .astype(np.int32)])
    engines = [_engine(tiny, port) for port in (False, True)]
    for eng in engines:
        eng.add_request(donor, max_new_tokens=3)
        _run(eng)
        rid = eng.add_request(probe, max_new_tokens=5)
        _run(eng)
        assert eng._outputs[rid].cached_tokens == 12
    ref, eng = engines
    want = G.generate(params, jnp.asarray(probe)[None], cfg,
                      max_new_tokens=5)
    np.testing.assert_array_equal(eng._outputs[rid].tokens,
                                  np.asarray(want[0]))
    assert _streams(eng._outputs) == _streams(ref._outputs)
    st = _assert_tier_parity(ref, eng)
    assert st["kv_tier"]["partial_page_hits"] >= 1


# ---------------------------------------------------------------------------
# degrades: spill -> drop, restore -> re-prefill
# ---------------------------------------------------------------------------

def test_fail_d2h_degrades_spill_to_drop(tiny, reprefill):
    """Every spill copy fails: the nodes drop, no restore, the re-prefill's
    streams, nothing left in the tier."""
    ref, eng, _ = _both_sessions(tiny, fault=dict(fail_d2h=1000))
    assert _streams(eng._outputs) == reprefill[0]
    st = _assert_tier_parity(ref, eng)["kv_tier"]
    assert st["spills"] == 0 and st["restores"] == 0
    assert st["pages_host"] == 0 and st["pages_disk"] == 0


def test_fail_h2d_degrades_restore_to_reprefill(tiny, reprefill):
    """Spills land, every restore copy fails: the matched nodes drop and
    the request re-prefills, with the re-prefill's streams."""
    ref, eng, _ = _both_sessions(tiny, fault=dict(fail_h2d=1000))
    assert _streams(eng._outputs) == reprefill[0]
    st = _assert_tier_parity(ref, eng)
    assert st["kv_tier"]["spills"] > 0
    assert st["kv_tier"]["restores"] == 0
    assert st["kv_tier"]["restored_tokens"] == 0
    assert st["swap_in_dispatches"] == 0
    assert eng.cache.swapped_page_count == 0


# ---------------------------------------------------------------------------
# the host pool: room and reclamation for live victims
# ---------------------------------------------------------------------------

def test_host_pool_room_counts_tier_pages(tiny):
    """Spilled pages take the budget swap parking takes; `tier_make_room`
    frees room (drops, with no store) as the reference's does."""
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 64, (30,)).astype(np.int32) for _ in range(5)]
    got = []
    for port in (False, True):
        eng = _engine(tiny, port, swap_pool_pages=8)
        for p in prompts:
            eng.add_request(p, max_new_tokens=3)
            _run(eng)
        mgr = eng.cache
        held = mgr.tier_pages_host
        assert held > 0
        assert mgr.host_pool_room(8) == 8 - held
        assert mgr.tier_make_room(2) == 2
        assert mgr.host_pool_room(8) == 8 - held + 2
        mgr.check_invariants()
        got.append((held, _streams(eng._outputs), eng.stats()["kv_tier"]))
    assert got[0] == got[1]


def test_preemption_swap_reclaims_tier_room(tiny):
    """preempt="swap" with the host pool full of spilled prefixes: the
    victims still park (live work evicts cached prefixes), with the
    reference's streams and counters."""
    cfg = tiny[0]
    prompts = [np.arange(i * 7, i * 7 + 20, dtype=np.int32) % cfg.vocab_size
               for i in range(6)]
    engines = [_engine(tiny, port, num_slots=6, prefill_chunk=8,
                       admission="optimistic", preempt="swap",
                       swap_pool_pages=8) for port in (False, True)]
    for eng in engines:
        for p in prompts:
            eng.add_request(p.astype(np.int32), max_new_tokens=24)
        _run(eng)
    ref, eng = engines
    assert _streams(eng._outputs) == _streams(ref._outputs)
    st = _assert_tier_parity(ref, eng)
    for k in ("preemptions", "preempt_swaps", "preempt_recomputes"):
        assert st[k] == ref.stats()[k], k
    assert st["preemptions"] > 0 and st["preempt_swaps"] > 0
    assert eng.cache.swapped_page_count == 0


# ---------------------------------------------------------------------------
# the router probe on a tier hit
# ---------------------------------------------------------------------------

def test_probe_affinity_reports_tier_tokens(tiny):
    """`probe_affinity` splits a match into cached and tier tokens as the
    reference's does: a returning session whose pages spilled reports its
    tier part, a device-only match 0, and probing moves nothing."""
    rng = np.random.RandomState(7)
    shared = rng.randint(0, 64, (20,)).astype(np.int32)
    churn = [rng.randint(0, 64, (30,)).astype(np.int32) for _ in range(6)]
    got = []
    for port in (False, True):
        eng = _engine(tiny, port)
        rid = eng.add_request(shared, max_new_tokens=5)
        _run(eng)
        conv = np.concatenate([shared, np.asarray(eng._outputs[rid].token_ids,
                                                  np.int32), [1, 2]])
        device = eng.probe_affinity(conv)
        assert device["cached_tokens"] > 0 and device["tier_tokens"] == 0
        for p in churn:
            eng.add_request(p, max_new_tokens=4)
        _run(eng)
        tiered = eng.probe_affinity(conv)
        assert tiered["tier_tokens"] > 0
        assert tiered == eng.probe_affinity(conv)
        got.append((device, tiered))
    assert got[0] == got[1]


def test_dropped_engine_is_freed_at_once(tiny):
    """The cache reaches the engine's spill callback through a weak
    reference: a dropped engine, its pool and its programs, goes when its
    last reference does, not at the next cycle collection (which may fall
    inside another engine's graph capture and invalidate it)."""
    import gc
    import weakref
    eng = _engine(tiny, True)
    assert eng.kv_tier
    _session_stream(eng)
    assert eng.stats()["kv_tier"]["spills"] > 0
    gone = weakref.ref(eng)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert gone() is None
    finally:
        if collecting:
            gc.enable()
