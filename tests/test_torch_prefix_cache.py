"""The port's prefix cache (copy-on-write page sharing) vs the JAX reference,
on the CPU.

- `PagedKVCache`: twins of the reference's four pure-host tests
  (refcounts, partial-page COW, LRU eviction, revival), and a differential
  test: seeded random sequences of `allocate_prefixed` over prompts that
  share prefixes and partial pages, `register_prefix` at chunk boundaries,
  finish-time `register_prefix(upgrade=True)` and `release`, run on the
  reference's cache and the port's.  After every operation both give the
  same (row, matched, cow), free list, LRU order and `prefix_stats()`, and
  both pass `check_invariants()`.
- `LLMEngine(kv_tier=False)` with its default `prefix_cache=True` against
  the reference `LLMEngine(spec_len=0, kv_tier=False)` (prefix cache on,
  its default; evicted prefixes dropped; never warmed; the tier-on pairs
  are in `test_torch_kv_tier.py`) at
  `gpt_tiny` and `llama_tiny`, fp32, in all four modes (fused and unfused,
  bucketed and chunked), on traffic that admits a prompt, its extension
  and its copy together, serves a donor to completion and then its
  extension, returns to the donor's session (prompt + generated + new
  tokens: the finish-time upgrade) and fills the pool until cached
  prefixes are evicted.  Greedy streams match token for token under
  `test_torch_engine.py`'s tie rule; each request's `cached_tokens`, the
  prefix counters and every `*_executables` equal the reference's; the
  pool drains to 0 pages in use and passes `check_invariants()`.
- The same at int8 weights and KV pages (one mode, a partial COW hit)
  against the reference's int8 engine, under `test_torch_quantized.py`'s
  near-tie rule.
- Twins of the reference's `abort` test (against the reference engine's
  outputs) and of its finish-time registration probe (`probe_affinity`).
"""
import jax
import numpy as np
import pytest

from paddle_tpu.inference.cache import PagedKVCache as RefCache
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.analysis.registry import over_budget
from paddle_tpu_torch.inference.cache import PagedKVCache
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from test_torch_engine import PRESETS, _assert_greedy_parity
from test_torch_quantized import _assert_int8_parity
from torch_kv_parity import assert_same_kv
from torch_threads import one_torch_thread  # noqa: F401

GEOMETRY = dict(num_slots=3, page_size=8, max_model_len=64, num_pages=14)
MODES = {"fused_bucketed": (True, None), "fused_chunked": (True, 8),
         "unfused_bucketed": (False, None), "unfused_chunked": (False, 8)}
EQUAL_STATS = ("prefix_cached_tokens", "prefix_hit_requests",
               "cow_page_copies", "prefilled_tokens", "prefill_chunks",
               "prefix_evictions", "pages_evictable", "decode_executables",
               "verify_executables", "prefill_executables",
               "copy_executables", "swap_executables")


# ---------------------------------------------------------------------------
# PagedKVCache: the reference's pure-host tests, on the port's cache
# ---------------------------------------------------------------------------

def test_cache_shared_page_freed_only_at_refcount_zero():
    mgr = PagedKVCache(num_pages=16, page_size=4, num_slots=4,
                       max_pages_per_slot=8)
    tok = np.arange(10, dtype=np.int32)         # 2 full pages + 2-token tail
    row0, m0, cow0 = mgr.allocate_prefixed(0, 12, tok)
    assert m0 == 0 and cow0 is None             # cold cache
    mgr.register_prefix(0, tok, 10)
    row1, m1, cow1 = mgr.allocate_prefixed(1, 12, tok)
    # the match stops below len(tokens): 2 full pages, no 1-token partial
    assert m1 == 8 and cow1 is None
    np.testing.assert_array_equal(row1[:2], row0[:2])   # physically shared
    assert row1[2] != row0[2]
    assert mgr._ref[row0[0]] == 2
    free_before = mgr.num_free_pages
    mgr.release(0)
    # shared pages survive slot 0's retirement; its private page parks
    assert mgr._ref[row1[0]] == 1
    assert mgr.num_free_pages == free_before
    assert mgr.num_evictable_pages == 1
    mgr.release(1)
    assert mgr.pages_in_use() == 0
    # slot 0's chain (2 full + 1 partial) is evictable; slot 1's unregistered
    # reservation tail went straight to the free list
    assert mgr.num_evictable_pages == 3
    mgr.check_invariants()


def test_cache_partial_page_copy_on_write_match():
    mgr = PagedKVCache(num_pages=16, page_size=4, num_slots=4,
                       max_pages_per_slot=8)
    tok = np.arange(10, dtype=np.int32)
    row0, _, _ = mgr.allocate_prefixed(0, 12, tok)
    mgr.register_prefix(0, tok, 10)
    ext = np.concatenate([tok, np.asarray([99, 98, 97], np.int32)])
    row1, m1, cow1 = mgr.allocate_prefixed(1, 16, ext)
    # 2 full pages shared + the 2-token partial page matched by COW
    assert m1 == 10
    src, dst = cow1
    assert src == row0[2] and dst == row1[2]    # into slot 1's own page
    assert mgr._ref[src] == 1 and mgr._ref[dst] == 1
    # divergent partial content does not match
    div = np.concatenate([tok[:8], np.asarray([7, 7, 7], np.int32)])
    _, m2, cow2 = mgr.allocate_prefixed(2, 12, div)
    assert m2 == 8 and cow2 is None
    mgr.check_invariants()


def test_cache_lru_eviction_under_pressure():
    mgr = PagedKVCache(num_pages=8, page_size=4, num_slots=2,
                       max_pages_per_slot=8)          # 7 real pages
    a = np.arange(8, dtype=np.int32)
    b = np.arange(100, 108, dtype=np.int32)
    for slot, tok in ((0, a), (1, b)):
        mgr.allocate_prefixed(slot, 12, tok)          # 3 pages each
        mgr.register_prefix(slot, tok, 8)
        mgr.release(slot)
    assert mgr.num_free_pages == 3 and mgr.num_evictable_pages == 4
    # 6 fresh pages fit only by evicting cached prefixes, oldest (a) first
    c = np.arange(200, 224, dtype=np.int32)
    _, m, _ = mgr.allocate_prefixed(0, 24, c)
    assert m == 0 and mgr.prefix_evictions == 3
    mgr.release(0)
    _, m2, _ = mgr.allocate_prefixed(0, 12, a)
    assert m2 == 0                                  # chain a is gone
    mgr.release(0)
    mgr.check_invariants()


def test_cache_match_revives_evictable_page():
    mgr = PagedKVCache(num_pages=8, page_size=4, num_slots=2,
                       max_pages_per_slot=8)
    tok = np.arange(8, dtype=np.int32)
    mgr.allocate_prefixed(0, 8, tok)
    mgr.register_prefix(0, tok, 8)
    mgr.release(0)
    assert mgr.num_evictable_pages == 2
    ext = np.concatenate([tok, np.asarray([5], np.int32)])
    row, m, cow = mgr.allocate_prefixed(1, 12, ext)
    assert m == 8 and cow is None
    assert mgr.num_evictable_pages == 0          # revived out of the LRU
    assert mgr._ref[row[0]] == 1
    mgr.check_invariants()


# ---------------------------------------------------------------------------
# PagedKVCache: differential against the reference's
# ---------------------------------------------------------------------------

def _cache_state(mgr):
    return (list(mgr._free), list(mgr._lru),
            [n.page for n in mgr._lru.values()], mgr.page_table.tolist(),
            mgr._ref.tolist(), mgr.pages_in_use(), mgr.num_evictable_pages)


def _prompt(rng, stems, page):
    """A prompt that shares a prefix (often ending mid-page) with one of
    `stems`, over a small vocabulary so partial-page hits are common."""
    stem = stems[rng.randint(len(stems))]
    keep = rng.randint(0, stem.size + 1)
    if rng.rand() < 0.3:
        keep = (keep // page) * page            # page-aligned
    tail = rng.randint(0, 3, rng.randint(1 if keep else 2, 3 * page))
    return np.concatenate([stem[:keep], tail.astype(np.int32)])[:6 * page]


@pytest.mark.parametrize("seed", range(6))
def test_cache_operation_sequences_match_reference(seed):
    rng = np.random.RandomState(seed)
    page, slots, per_slot = 4, 4, 8
    num_pages = [12, 20, 33][seed % 3]
    ref = RefCache(num_pages, page, slots, per_slot)
    got = PagedKVCache(num_pages, page, slots, per_slot)
    stems = [rng.randint(0, 3, 6 * page).astype(np.int32) for _ in range(3)]
    live = {}                   # slot -> [prompt, filled, footprint]
    seen = {"cow": 0, "hit": 0, "evict": 0, "upgrade": 0, "full": 0}
    for _ in range(250):
        free_slots = [s for s in range(slots) if s not in live]
        op = rng.rand()
        if free_slots and (op < 0.4 or not live):
            slot = free_slots[rng.randint(len(free_slots))]
            tok = _prompt(rng, stems, page)
            total = tok.size + rng.randint(1, page * 2)
            total = min(total, page * per_slot)
            assert ref.can_allocate(total, tok) == \
                got.can_allocate(total, tok)
            res = []
            for mgr in (ref, got):
                try:
                    row, m, cow = mgr.allocate_prefixed(slot, total, tok)
                    res.append((row.tolist(), m, cow))
                except RuntimeError:
                    res.append("out of pages")
            assert res[0] == res[1]
            if res[0] == "out of pages":
                seen["full"] += 1
            else:
                live[slot] = [tok, res[0][1], total]
                seen["hit"] += res[0][1] > 0
                seen["cow"] += res[0][2] is not None
        elif op < 0.75:
            slot = list(live)[rng.randint(len(live))]
            tok, filled, total = live[slot]
            filled = min(tok.size, filled + rng.randint(1, 2 * page))
            live[slot][1] = filled
            for mgr in (ref, got):
                mgr.register_prefix(slot, tok, filled)
        else:
            slot = list(live)[rng.randint(len(live))]
            tok, filled, total = live.pop(slot)
            if filled == tok.size and rng.rand() < 0.7:
                # finish-time registration over prompt + generated tokens
                gen = rng.randint(0, 3, rng.randint(1, total - tok.size + 1))
                conv = np.concatenate([tok, gen.astype(np.int32)])
                kvlen = conv.size - 1
                for mgr in (ref, got):
                    mgr.register_prefix(slot, conv[:kvlen], kvlen,
                                        upgrade=True)
                seen["upgrade"] += 1
            for mgr in (ref, got):
                mgr.release(slot)
        assert _cache_state(ref) == _cache_state(got)
        ref_stats = ref.prefix_stats()
        assert got.prefix_stats() == {k: ref_stats[k]
                                      for k in got.prefix_stats()}
        assert ref_stats["tier_pages_host"] == ref_stats["tier_pages_disk"] \
            == 0
        ref.check_invariants()
        got.check_invariants()
    seen["evict"] = got.prefix_evictions
    # the sequence exercised every path
    assert all(seen[k] for k in ("cow", "hit", "upgrade")), seen
    if num_pages < 30:
        assert seen["evict"] and seen["full"], seen


def test_cache_invariants_catch_a_double_free():
    mgr = PagedKVCache(num_pages=9, page_size=4, num_slots=3,
                       max_pages_per_slot=4)
    tok = np.arange(10, dtype=np.int32)
    mgr.allocate_prefixed(0, 12, tok)
    mgr.register_prefix(0, tok, 10)
    mgr.allocate_prefixed(1, 12, tok)
    mgr.check_invariants()
    assert not mgr.can_allocate(17) and mgr.can_allocate(16, tok)
    mgr._free.append(mgr._used[1][0])           # a shared page freed
    with pytest.raises(AssertionError):
        mgr.check_invariants()


# ---------------------------------------------------------------------------
# LLMEngine with the prefix cache against the reference engine
# ---------------------------------------------------------------------------

def _drain(engine):
    if isinstance(engine, JaxEngine):
        engine.run()
        return
    for _ in range(400):            # a scheduler fault fails, not hangs
        if not engine.has_work:
            break
        engine.step()
    assert not engine.has_work, "engine did not drain"


def _traffic(engine, vocab, seed=7):
    """Drive the prefix-cache traffic through `engine`; returns its outputs
    and {case: request id}."""
    rng = np.random.RandomState(seed)

    def rand(n):
        return rng.randint(0, vocab, n).astype(np.int32)

    def add(prompt, n):
        return engine.add_request(prompt, max_new_tokens=n)

    rid = {}
    # a prompt (2 full pages + a 5-token partial), its extension (COW of
    # the partial page off a live donor) and its copy (rolling-hash hit)
    base = rand(21)
    rid["base"] = add(base, 5)
    rid["ext"] = add(np.concatenate([base, rand(6)]), 5)
    rid["copy"] = add(base.copy(), 5)
    _drain(engine)
    # a donor served to completion, then its extension
    donor = rand(19)
    rid["donor"] = add(donor, 5)
    _drain(engine)
    rid["donor_ext"] = add(np.concatenate([donor, rand(20)]), 4)
    _drain(engine)
    # the donor's session returns: prompt + generated + new tokens
    gen = np.asarray(engine.outputs[rid["donor"]].token_ids, np.int32) \
        if not isinstance(engine, JaxEngine) else \
        np.asarray(engine._outputs[rid["donor"]].token_ids, np.int32)
    rid["back"] = add(np.concatenate([donor, gen, rand(7)]), 4)
    _drain(engine)
    # unrelated prompts that fill the pool: cached prefixes are evicted
    for i, n in enumerate((30, 26, 28)):
        rid[f"fill{i}"] = add(rand(n), 6)
    _drain(engine)
    outs = engine.outputs if not isinstance(engine, JaxEngine) else \
        dict(engine._outputs)
    return outs, rid


# cached tokens by the page geometry (page 8).  Bucketed: the base prompt
# is prefilled and registered at admission, so its extension takes 16 full
# + 5 partial tokens and its copy stops one token short of its length;
# chunked: the three are admitted before any chunk of the base lands, so
# none hits.  Then the donor's extension takes 2 full pages + 3 of the
# partial page, and the returning session the donor's 19 + 5 - 1 = 23
# tokens whose KV landed (the finish-time upgrade of its partial page).
WANT_CACHED = {
    False: {"base": 0, "ext": 21, "copy": 20, "donor": 0, "donor_ext": 19,
            "back": 23},
    True: {"base": 0, "ext": 0, "copy": 0, "donor": 0, "donor_ext": 19,
           "back": 23}}


@pytest.fixture(scope="module")
def prefix_reference():
    """name -> (jax cfg, jax params, port cfg, port params,
    {mode: (reference outputs, request ids, reference stats)})"""
    out = {}
    for name, (jax_preset, port_preset) in PRESETS.items():
        cfg, tcfg = jax_preset(64), port_preset(64)
        params = G.init_params(cfg, jax.random.key(5))
        tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        runs = {}
        for mode, (fuse, chunk) in MODES.items():
            eng = JaxEngine(params, cfg, prefill_chunk=chunk, fuse=fuse,
                            spec_len=0, kv_tier=False, **GEOMETRY)
            assert eng.prefix_cache            # the reference's default
            outs, rid = _traffic(eng, cfg.vocab_size)
            runs[mode] = (outs, rid, eng.stats(), eng)
        out[name] = (cfg, params, tcfg, tparams, runs)
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(PRESETS))
def test_prefix_engine_matches_reference(prefix_reference, name, mode):
    cfg, params, tcfg, tparams, runs = prefix_reference[name]
    ref_outs, ref_rid, ref_st, ref_eng = runs[mode]
    fuse, chunk = MODES[mode]
    eng = LLMEngine(tparams, tcfg, prefill_chunk=chunk, fuse=fuse,
                    kv_tier=False, device="cpu", **GEOMETRY)
    assert eng.prefix_cache
    outs, rid = _traffic(eng, cfg.vocab_size)
    assert rid == ref_rid
    _assert_greedy_parity(ref_outs, outs, params, cfg)
    for case, r in rid.items():
        assert outs[r].cached_tokens == ref_outs[r].cached_tokens, case
    want = WANT_CACHED[chunk is not None]
    for case, n in want.items():
        assert outs[rid[case]].cached_tokens == n, case
    st = eng.stats()
    for k in EQUAL_STATS:
        assert st[k] == ref_st[k], (k, st[k], ref_st[k])
    assert st["prefix_hit_rate"] == pytest.approx(ref_st["prefix_hit_rate"])
    # the traffic took every path: hits, COW copies (every hit ends inside
    # a page), eviction
    hits = sum(n > 0 for n in want.values())
    assert st["prefix_hit_requests"] == st["cow_page_copies"] == hits
    assert st["prefix_evictions"] > 0 and st["copy_executables"] == 1
    assert not over_budget(st)
    assert st["pages_in_use"] == 0 and not eng.has_work
    eng.cache.check_invariants()
    # every cached page, the COW copies and partial hits' among them,
    # holds the reference's KV
    assert_same_kv(ref_eng, eng)


@pytest.fixture(scope="module")
def int8_prefix_reference():
    """(jax cfg, jax int8 params, port cfg, port fp params, reference
    outputs, request ids, reference stats) on llama_tiny."""
    from paddle_tpu.quantization import serving as RQ
    jax_preset, port_preset = PRESETS["llama_tiny"]
    cfg, tcfg = jax_preset(64), port_preset(64)
    params = G.init_params(cfg, jax.random.key(6))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    qparams = jax.tree_util.tree_map(
        jax.numpy.asarray, RQ.quantize_serving_params(np_params, cfg))
    eng = JaxEngine(params, cfg, spec_len=0, kv_tier=False,
                    weight_dtype="int8", kv_dtype="int8", **GEOMETRY)
    outs, rid = _traffic(eng, cfg.vocab_size)
    return (cfg, qparams, tcfg, params_from_numpy(np_params, tcfg, "cpu"),
            outs, rid, eng.stats())


def test_int8_prefix_engine_matches_reference(int8_prefix_reference):
    cfg, qparams, tcfg, tparams, ref_outs, ref_rid, ref_st = \
        int8_prefix_reference
    eng = LLMEngine(tparams, tcfg, weight_dtype="int8", kv_dtype="int8",
                    kv_tier=False, device="cpu", **GEOMETRY)
    outs, rid = _traffic(eng, cfg.vocab_size)
    assert rid == ref_rid
    _assert_int8_parity(ref_outs, outs, qparams, cfg)
    for case, r in rid.items():
        assert outs[r].cached_tokens == ref_outs[r].cached_tokens, case
    st = eng.stats()
    for k in EQUAL_STATS:
        assert st[k] == ref_st[k], (k, st[k], ref_st[k])
    # the COW copies moved the int8 pages with their scale lanes
    assert st["cow_page_copies"] == 4 and set(eng._pool) == {
        "k", "v", "k_scale", "v_scale"}
    assert st["pages_in_use"] == 0
    eng.cache.check_invariants()


# ---------------------------------------------------------------------------
# abort and probe_affinity
# ---------------------------------------------------------------------------

def _abort_run(engine, prompts):
    """The reference's abort scenario; returns what it observed."""
    seen = []
    r1 = engine.add_request(prompts[0], max_new_tokens=8)
    r2 = engine.add_request(prompts[1], max_new_tokens=8)
    engine.step()                               # r1 mid-prefill, r2 queued
    seen.append(engine.cache.pages_in_use() > 0)
    seen += [engine.abort(r1), engine.abort(r2), engine.abort(999)]
    seen += [engine.cache.pages_in_use(), engine.has_work]
    # aborting a decoding request frees it mid-generation
    r3 = engine.add_request(prompts[0], max_new_tokens=8)
    while not engine._running:
        engine.step()
    engine.step()
    seen.append(engine.abort(r3))
    seen.append(engine.cache.pages_in_use())
    # the freed slot still serves correctly
    r4 = engine.add_request(prompts[2], max_new_tokens=4)
    _drain(engine)
    seen.append(engine.abort(r4))               # already finished
    engine.cache.check_invariants()
    outs = engine._outputs
    return seen, {r: (outs[r].finish_reason, list(outs[r].token_ids),
                      outs[r].cached_tokens) for r in (r1, r2, r3, r4)}


@pytest.mark.parametrize("prefix_cache", [True, False],
                         ids=["prefix", "no_prefix"])
def test_abort_frees_pages_like_reference(prefix_reference, prefix_cache):
    cfg, params, tcfg, tparams, _ = prefix_reference["gpt_tiny"]
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (30, 17, 5)]
    kw = dict(num_slots=1, page_size=8, max_model_len=64, num_pages=12,
              prefill_chunk=8, prefix_cache=prefix_cache)
    ref = _abort_run(JaxEngine(params, cfg, spec_len=0, kv_tier=False, **kw),
                     prompts)
    got = _abort_run(LLMEngine(tparams, tcfg, device="cpu", kv_tier=False,
                               **kw), prompts)
    assert got == ref
    seen, outs = got
    assert seen == [True, True, True, False, 0, False, True, 0, False]
    assert [o[0] for o in outs.values()] == ["abort"] * 3 + ["length"]
    assert len(outs[2][1]) >= 1                 # partial progress reported
    # with the cache on, the re-sent prompt reuses the aborted one's pages
    assert (outs[2][2] > 0) == prefix_cache


def test_probe_affinity_sees_finish_time_registration(prefix_reference):
    cfg, params, tcfg, tparams, _ = prefix_reference["gpt_tiny"]
    kw = dict(num_slots=2, page_size=8, max_model_len=64, prefill_chunk=16,
              seed=0)
    engines = (JaxEngine(params, cfg, spec_len=0, kv_tier=False, **kw),
               LLMEngine(tparams, tcfg, device="cpu", kv_tier=False, **kw))
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, (10,)).astype(np.int32)
    more = rng.randint(0, cfg.vocab_size, (4,)).astype(np.int32)
    got = []
    for eng in engines:
        assert eng.probe_affinity(prompt)["cached_tokens"] == 0
        rid = eng.add_request(prompt, max_new_tokens=5)
        _drain(eng)
        gen = np.asarray(eng._outputs[rid].token_ids, np.int32)
        kvlen = prompt.size + gen.size - 1
        probes = [eng.probe_affinity(np.concatenate([prompt, gen]))
                  ["cached_tokens"],
                  eng.probe_affinity(prompt)["cached_tokens"],
                  eng.probe_affinity(more)["cached_tokens"]]
        lru = list(eng.cache._lru)
        eng.probe_affinity(np.concatenate([prompt, gen]))
        assert list(eng.cache._lru) == lru      # a pure read
        rid2 = eng.add_request(np.concatenate([prompt, gen, more]),
                               max_new_tokens=4)
        _drain(eng)
        got.append((gen.tolist(), probes, eng._outputs[rid2].cached_tokens,
                    list(eng._outputs[rid2].token_ids)))
        assert probes[0] == kvlen and got[-1][2] == kvlen
        eng.cache.check_invariants()
    assert got[0] == got[1]
