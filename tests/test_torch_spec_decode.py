"""The port's speculative decoding vs the JAX reference, on the CPU.

Case by case the twin of `tests/test_spec_decode.py`, at its sizes
(`gpt_tiny(64)`, page 8, fp32), each case run through the reference and
the port on the same `init_params` weights bridged through numpy:

- `NgramProposer`: the three proposer unit tests, the port's proposals
  equal to the reference's on the same histories;
- the verify lane of the paged kernel's plain version
  (`paged_prefill_attention_ref`, `paged_verify_attention`) against the
  reference's oracle and its Pallas kernel in interpret mode at q_len 5
  with valid [5, 1, 3], GQA and MQA, atol 2e-5;
- `verify_step_paged` against the reference's logits (gpt and llama,
  atol/rtol 2e-4), the valid-masked call and the re-verify over the
  rolled-back region included;
- `LLMEngine(spec_len=K)` streams and spec counters exactly equal to the
  reference engine's (both built with `kv_tier=False`, the reference
  never warmed), fused and unfused, bucketed and chunked, prefix
  cache on and off, and spec-on streams equal to spec-off streams; EOS
  inside an accepted run, a repetitive stream (`accepted_per_step` > 1),
  the refcount invariants after every step, abort mid-verify and
  mid-chunk, the greedy fast path of a sampling engine, the two back-off
  tests, and the unfused program count (decode + verify == 2).

The reference's bench and program-count tool cases wait for the port's
serving bench (ROADMAP Queue 1 item 10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.paged_attention import (
    paged_prefill_attention_pallas)
from paddle_tpu.incubate.kernels.paged_attention import (
    paged_verify_attention as ref_verify_attention)
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.inference.spec import NgramProposer as RefProposer
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.analysis.registry import over_budget
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    paged_prefill_attention_kernel, paged_prefill_attention_ref,
    paged_verify_attention)
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.spec import DraftProposer, NgramProposer
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

GEOMETRY = dict(num_slots=3, page_size=8, max_model_len=64)
FUSE = {"fused": True, "unfused": False}
# the counters the port must report as the reference does
SPEC_STATS = ("verify_steps", "spec_events", "spec_drafted_tokens",
              "spec_accepted_tokens", "spec_emitted_tokens", "spec_backoffs",
              "accepted_per_step", "spec_len", "decode_iterations",
              "decode_tokens", "decode_executables", "verify_executables")


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, port params): the reference's
    `gpt_tiny(64)` at `init_params(key(0))`."""
    cfg, tcfg = G.gpt_tiny(64), TG.gpt_tiny(64)
    params = G.init_params(cfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, "cpu")
    return cfg, params, tcfg, tparams


def _engines(tiny, **kw):
    """A reference engine and the port's on the same weights and knobs
    (both without the KV tier when the prefix cache is on, as the
    reference's tests build theirs)."""
    cfg, params, tcfg, tparams = tiny
    tier = {"kv_tier": False} if kw.get("prefix_cache", True) else {}
    return (JaxEngine(params, cfg, **tier, **kw),
            LLMEngine(tparams, tcfg, device="cpu", **tier, **kw))


def _port(tiny, **kw):
    """The port's engine alone."""
    return LLMEngine(tiny[3], tiny[2], device="cpu", **kw)


def _serve(eng, prompts, max_new, **kw):
    """[output] in submission order."""
    rids = [eng.add_request(p, max_new_tokens=max_new, **kw)
            for p in prompts]
    if isinstance(eng, JaxEngine):
        outs = eng.run()
    else:
        # bounded: a scheduler fault must fail the test, not hang it
        for _ in range(sum(p.size for p in prompts) + len(prompts) *
                       max_new + 10):
            if not eng.has_work:
                break
            eng.step()
        assert not eng.has_work, "engine did not drain"
        outs = eng.outputs
    return [outs[r] for r in rids]


def _assert_same(ref, got):
    """Streams token for token and finish reasons equal."""
    assert [o.token_ids for o in got] == [list(o.token_ids) for o in ref]
    assert [o.finish_reason for o in got] == [o.finish_reason for o in ref]


def _assert_spec_stats(ref_eng, eng):
    rs, st = ref_eng.stats(), eng.stats()
    assert {k: st[k] for k in SPEC_STATS} == {k: rs[k] for k in SPEC_STATS}


# ---------------------------------------------------------------------------
# n-gram proposer (pure host)
# ---------------------------------------------------------------------------

def _proposals(kw, ctx, max_tokens):
    """(reference, port) proposals of a fresh proposer on one history."""
    ctx = np.asarray(ctx)
    return RefProposer(**kw).propose(ctx, max_tokens), \
        NgramProposer(**kw).propose(ctx, max_tokens)


def _assert_proposes(kw, ctx, max_tokens, want):
    ref, got = _proposals(kw, ctx, max_tokens)
    if want is None:
        assert ref is None and got is None
        return
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == ref.dtype == np.int32


def test_ngram_proposer_matches_most_recent_occurrence():
    ctx = [9, 1, 2, 3, 7, 1, 2, 3, 5, 1, 2, 3]
    kw = dict(max_ngram=3, min_ngram=1)
    _assert_proposes(kw, ctx, 4, [5, 1, 2, 3])
    _assert_proposes(kw, ctx, 2, [5, 1])


def test_ngram_proposer_prefers_longer_ngrams():
    ctx = [1, 2, 3, 8, 0, 0, 3, 9, 2, 3]
    _assert_proposes(dict(max_ngram=3, min_ngram=1), ctx, 1, [8])
    _assert_proposes(dict(max_ngram=3, min_ngram=3), ctx, 4, None)


def test_ngram_proposer_self_loop_and_edges():
    _assert_proposes({}, [7] * 6, 4, [7, 7, 7])
    _assert_proposes({}, [7, 7, 7], 4, [7])
    _assert_proposes({}, [1, 2, 3, 4], 4, None)
    _assert_proposes({}, [5], 4, None)
    _assert_proposes({}, [5, 5], 0, None)
    far = np.concatenate([[3, 1, 4], np.arange(10, 30), [3, 1, 4]])
    _assert_proposes(dict(max_lookback=6), far, 4, None)
    _assert_proposes(dict(max_lookback=far.size), far, 2, [10, 11])
    for kw in (dict(max_ngram=2, min_ngram=3), dict(max_lookback=1)):
        with pytest.raises(ValueError):
            NgramProposer(**kw)
    # the telemetry hooks count as the reference's do
    ref, got = RefProposer(), NgramProposer()
    for p in (ref, got):
        for ctx in ([7] * 6, [1, 2, 3, 4], [9, 1, 2, 3, 7, 1, 2, 3]):
            p.propose(np.asarray(ctx), 4)
    assert got.stats() == ref.stats()
    got.reset_stats()
    assert got.stats()["propose_calls"] == 0
    assert isinstance(got, DraftProposer)


# ---------------------------------------------------------------------------
# the verify lane and the verify step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvh", [2, 1], ids=["gqa", "mqa"])
def test_verify_lane_matches_reference_qlen_gt1(kvh):
    """q_offset = lengths, per-slot valid with the no-draft edge (valid
    1): the plain version and the verify entry against the reference's
    oracle and its Pallas kernel in interpret mode, valid rows only."""
    rng = np.random.RandomState(0)
    B, T, H, hd, page, P, mp = 3, 5, 4, 64, 8, 9, 4
    q = rng.randn(B, T, H, hd).astype(np.float32)
    k = rng.randn(P, page, kvh, hd).astype(np.float32)
    v = rng.randn(P, page, kvh, hd).astype(np.float32)
    tbl = np.zeros((B, mp), np.int32)
    tbl[0, :3] = [1, 2, 3]
    tbl[1, :2] = [4, 5]
    tbl[2, :4] = [6, 7, 8, 3]
    lengths = np.array([9, 4, 17], np.int32)
    valid = np.array([5, 1, 3], np.int32)
    jargs = tuple(map(jnp.asarray, (q, k, v, tbl, lengths, valid)))
    oracle = np.asarray(ref_verify_attention(*jargs))
    pallas = np.asarray(paged_prefill_attention_pallas(*jargs,
                                                       interpret=True))
    targs = tuple(map(_t, (q, k, v, tbl, lengths, valid)))
    before = paged_prefill_attention_kernel.launches
    for entry in (paged_prefill_attention_ref, paged_verify_attention):
        got = entry(*targs).numpy()
        for b, n in enumerate(valid):
            np.testing.assert_allclose(got[b, :n], oracle[b, :n], atol=2e-5,
                                       rtol=0)
            np.testing.assert_allclose(got[b, :n], pallas[b, :n], atol=2e-5,
                                       rtol=0)
    assert paged_prefill_attention_kernel.launches == before   # CPU: plain


@pytest.mark.parametrize("preset", [(G.gpt_tiny, TG.gpt_tiny),
                                    (G.llama_tiny, TG.llama_tiny)],
                         ids=["gpt", "llama"])
def test_verify_step_paged_matches_reference(preset):
    """The reference's scenario on both packages: a prefilled chunk, a
    verify at valid 2 (positions past it masked: the rollback shape), then
    a re-verify over the once-rejected region.  Logits at every position
    and the pool agree with the reference's (whose own test holds its
    valid rows to the dense forward)."""
    cfg, tcfg = preset[0](64), preset[1](64)
    params = G.init_params(cfg, jax.random.key(1))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, "cpu")
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (1, 13)).astype(np.int32)
    page, Tp, T = 4, 8, 4
    table = np.zeros((1, 6), np.int32)
    table[0, :4] = [3, 1, 4, 2]
    ids = np.zeros((1, 8), np.int32)
    ids[0, :Tp] = toks[0, :Tp]
    jpool = G.init_paged_cache(cfg, num_pages=10, page_size=page)
    tpool = TG.init_paged_cache(tcfg, 10, page, device="cpu")
    _, jpool = G.prefill_chunk_paged(params, jnp.asarray(ids), cfg, jpool,
                                     jnp.asarray(table),
                                     jnp.asarray([0], jnp.int32),
                                     jnp.asarray([Tp], jnp.int32))
    TG.prefill_chunk_paged(tparams, _t(ids), tcfg, tpool, _t(table),
                           _t(np.array([0], np.int32)),
                           _t(np.array([Tp], np.int32)))
    vt = np.zeros((1, T), np.int32)
    vt[0, :3] = toks[0, Tp + 2:Tp + 5]
    for tokens, q0, n in ((toks[:, Tp:Tp + T], Tp, 2), (vt, Tp + 2, 3)):
        q0a, na = np.array([q0], np.int32), np.array([n], np.int32)
        ref, jpool = G.verify_step_paged(
            params, jnp.asarray(tokens), jpool, jnp.asarray(table),
            jnp.asarray(q0a), jnp.asarray(na), cfg)
        got, tpool = TG.verify_step_paged(tparams, _t(tokens), tpool,
                                          _t(table), _t(q0a), _t(na), tcfg)
        assert got.shape == (1, T, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                                   rtol=2e-4)
    for name in ("k", "v"):     # page 0 takes the padded rows' writes
        np.testing.assert_allclose(tpool[name][:, 1:].numpy(),
                                   np.asarray(jpool[name])[:, 1:],
                                   atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# engine streams and counters against the reference engine
# ---------------------------------------------------------------------------

def _parity_prompts(vocab):
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, (n,)).astype(np.int32)
               for n in (5, 9, 17, 3)]
    prompts.append(np.concatenate(          # shared prefix: the COW lane
        [prompts[2], rng.randint(0, vocab, (4,)).astype(np.int32)]))
    return prompts


# spec with and without the prefix cache; the spec-off streams they must
# equal are the port's own, held to the reference's by test_torch_engine.py
# and test_torch_unfused.py
SPEC_KEYS = {"spec": dict(spec_len=4),
             "spec-nopfx": dict(spec_len=4, prefix_cache=False)}


@pytest.fixture(scope="module")
def parity_runs(tiny):
    """The reference's parity traffic (5 prompts x 10 tokens) and
    {mode: {key: (reference outputs, reference engine)}}."""
    prompts = _parity_prompts(tiny[0].vocab_size)
    runs = {mode: {} for mode in FUSE}
    for mode, fuse in FUSE.items():
        for key, kw in SPEC_KEYS.items():
            ref, _ = _engines(tiny, fuse=fuse, **GEOMETRY, **kw)
            runs[mode][key] = (_serve(ref, prompts, 10), ref)
    return prompts, runs


@pytest.mark.parametrize("mode", list(FUSE))
def test_engine_spec_parity_and_program_bound(tiny, parity_runs, mode):
    """Spec on emits exactly the spec-off stream, prefix cache on and off,
    with the reference's streams and spec counters; decode-side programs:
    1 fused, at most 2 unfused (decode + verify); fewer decode iterations
    than spec off."""
    prompts, runs = parity_runs
    off = _port(tiny, fuse=FUSE[mode], spec_len=0, **GEOMETRY)
    off_outs = _serve(off, prompts, 10)
    assert off.stats()["verify_steps"] == 0
    for key, kw in SPEC_KEYS.items():
        ref_outs, ref_eng = runs[mode][key]
        eng = _port(tiny, fuse=FUSE[mode], **GEOMETRY, **kw)
        outs = _serve(eng, prompts, 10)
        _assert_same(ref_outs, outs)
        _assert_same(off_outs, outs)
        _assert_spec_stats(ref_eng, eng)
        st = eng.stats()
        assert st["pages_in_use"] == 0
        eng.cache.check_invariants()
        assert st["verify_steps"] > 0 and st["spec_emitted_tokens"] > 0
        # unfused: the verify program, and the decode program where an
        # iteration had no draft (<= 2, the reference's bound)
        assert st["verify_executables"] == (0 if FUSE[mode] else 1)
        assert st["decode_executables"] + st["verify_executables"] <= \
            (1 if FUSE[mode] else 2)
        assert st["verify_dispatches"] == \
            (0 if FUSE[mode] else st["verify_steps"])
        if FUSE[mode]:      # (the tiny buckets take 4 prefill programs)
            assert "decode_side_executables" not in over_budget(st)
        assert st["decode_iterations"] < off.stats()["decode_iterations"]


@pytest.mark.parametrize("mode", list(FUSE))
def test_engine_spec_chunked_prefill_parity(tiny, mode):
    """Spec composes with chunked prefill (`prefill_chunk=8`, so the fused
    program is 8 wide, the verify lane 4): mid-prefill slots stay out of
    the verify rows.  Streams and counters equal the reference's, prefix
    cache on and off, and the spec-off chunked stream."""
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, tiny[0].vocab_size, (n,)).astype(np.int32)
               for n in (30, 5, 17)]
    fuse = FUSE[mode]
    off = _port(tiny, fuse=fuse, prefill_chunk=8, **GEOMETRY)
    base = _serve(off, prompts, 8)
    for kw in (dict(spec_len=3), dict(spec_len=3, prefix_cache=False)):
        ref, eng = _engines(tiny, fuse=fuse, prefill_chunk=8, **GEOMETRY,
                            **kw)
        assert eng._fused_T == 8
        outs = _serve(eng, prompts, 8)
        _assert_same(_serve(ref, prompts, 8), outs)
        _assert_same(base, outs)
        _assert_spec_stats(ref, eng)
        st = eng.stats()
        assert st["decode_executables"] + st["verify_executables"] <= 2
        assert st["prefill_executables"] <= 2
        assert st["pages_in_use"] == 0 and st["spec_events"] > 0


@pytest.mark.parametrize("mode", list(FUSE))
def test_engine_spec_eos_inside_accepted_prefix(tiny, mode):
    """A drafted token equal to EOS cuts the emitted run at the EOS, as
    vanilla decode stops there, and retires the slot."""
    prompt = np.zeros((3,), np.int32)
    geo = dict(num_slots=1, page_size=8, max_model_len=64, fuse=FUSE[mode])
    first = _port(tiny, **geo)
    eos = _serve(first, [prompt], 10)[0].token_ids[3]   # mid-stream
    van = _port(tiny, eos_token_id=eos, **geo)
    spec_ref, spec = _engines(tiny, eos_token_id=eos, spec_len=4, **geo)
    a = _serve(van, [prompt], 10)
    b = _serve(spec, [prompt], 10)
    _assert_same(_serve(spec_ref, [prompt], 10), b)
    _assert_same(a, b)
    _assert_spec_stats(spec_ref, spec)
    assert b[0].finish_reason == "stop" and b[0].token_ids[-1] == eos
    assert spec.cache.pages_in_use() == 0


def test_accepted_per_step_exceeds_one_on_repetitive_stream(tiny):
    """Self-drafting pays on a looping prompt: more than one token a
    drafted verify event, as the reference's."""
    rng = np.random.RandomState(0)
    vocab = tiny[0].vocab_size
    pat = rng.randint(0, vocab, (4,)).astype(np.int32)
    prompts = [np.tile(pat, 3)] + \
        [rng.randint(0, vocab, (n,)).astype(np.int32) for n in (7, 12, 5)]
    ref, eng = _engines(tiny, spec_len=4, **GEOMETRY)
    _assert_same(_serve(ref, prompts, 12), _serve(eng, prompts, 12))
    _assert_spec_stats(ref, eng)
    st = eng.stats()
    assert st["spec_accepted_tokens"] > 0
    assert st["accepted_per_step"] > 1.0
    assert st["decode_tokens"] > st["decode_iterations"]


def test_spec_rollback_keeps_refcount_invariants(tiny):
    """Shared prefixes, rejected drafts and retirements: the page
    partition and refcounts hold after every step, and the streams,
    counters and page state at the end equal the reference's."""
    rng = np.random.RandomState(3)
    vocab = tiny[0].vocab_size
    base = rng.randint(0, vocab, (21,)).astype(np.int32)
    ext = np.concatenate([base, rng.randint(0, vocab, (6,)).astype(np.int32)])
    prompts = [base, ext, base.copy()]
    ref, eng = _engines(tiny, num_slots=2, page_size=8, max_model_len=64,
                        num_pages=12, spec_len=4)
    ref_outs = _serve(ref, prompts, 8)
    rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    while eng.has_work:
        eng.step()
        eng.cache.check_invariants()
    _assert_same(ref_outs, [eng.outputs[r] for r in rids])
    _assert_spec_stats(ref, eng)
    st = eng.stats()
    assert st["pages_in_use"] == 0 and st["verify_steps"] > 0
    assert st["spec_drafted_tokens"] >= st["spec_accepted_tokens"] > 0
    got, want = eng.cache.prefix_stats(), ref.cache.prefix_stats()
    assert got == want              # both built without the KV tier


def _abort_mid_verify(eng, rng, vocab):
    """Serve a looping prompt until 2 verify steps ran (fused: the second
    is still in flight), abort it, then serve a fresh prompt in the freed
    slot.  Returns (the aborted output, the fresh output)."""
    prompt = np.tile(rng.randint(0, vocab, (3,)).astype(np.int32), 4)
    r1 = eng.add_request(prompt, max_new_tokens=12)
    while eng.stats()["verify_steps"] < 2:
        eng.step()
    assert eng.abort(r1)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use() == 0 and not eng.has_work
    r2 = eng.add_request(rng.randint(0, vocab, (9,)).astype(np.int32),
                         max_new_tokens=6)
    while eng.has_work:
        eng.step()
    eng.cache.check_invariants()
    return eng._outputs[r1], eng._outputs[r2]


def _abort_mid_chunk(eng, rng, vocab):
    """A donor registers its prompt; its extension is aborted one chunk
    into its prefill, holding the donor's shared page.  Returns the shared
    page's refcount before and after."""
    base = rng.randint(0, vocab, (24,)).astype(np.int32)
    rd = eng.add_request(base, max_new_tokens=4)
    while eng.has_work:
        eng.step()
    ext = np.concatenate([base, rng.randint(0, vocab, (20,))
                          .astype(np.int32)])
    rx = eng.add_request(ext, max_new_tokens=4)
    eng.step()
    assert rd in eng._outputs and rx not in eng._outputs
    slot = next(iter(eng._prefilling))
    shared = int(eng.cache.page_table[slot][0])
    before = int(eng.cache._ref[shared])
    assert eng.abort(rx)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use() == 0
    return before, int(eng.cache._ref[shared])


def test_abort_mid_verify_and_mid_chunk_prefill(tiny):
    """abort() of a slot whose drafted dispatch is in flight (the harvest
    lands before the release; its rejected-candidate KV is stale), of a
    mid-chunk slot holding a shared prefix page (dereferenced once), and
    of a queued request behind another.  Outputs equal the reference
    engine's on the same sequence."""
    vocab = tiny[0].vocab_size
    kw = dict(num_slots=2, page_size=8, max_model_len=64, spec_len=4)
    ref, eng = _engines(tiny, **kw)
    got = _abort_mid_verify(eng, np.random.RandomState(2), vocab)
    want = _abort_mid_verify(ref, np.random.RandomState(2), vocab)
    assert got[0].finish_reason == "abort"
    _assert_same(want, got)
    _assert_spec_stats(ref, eng)

    ref, eng = _engines(tiny, prefill_chunk=8, **kw)
    refs = _abort_mid_chunk(eng, np.random.RandomState(5), vocab)
    assert refs == (1, 0)
    assert refs == _abort_mid_chunk(ref, np.random.RandomState(5), vocab)

    eng = _port(tiny, num_slots=1, page_size=8, max_model_len=64,
                      num_pages=9)
    rng = np.random.RandomState(6)
    q0, qa, qb = (eng.add_request(rng.randint(0, vocab, (n,))
                                  .astype(np.int32), max_new_tokens=4)
                  for n in (5, 6, 7))
    assert eng.abort(qb) and eng.abort(qa)      # qb sits behind qa
    assert eng.abort(q0) and not eng.has_work
    eng.cache.check_invariants()


def test_greedy_fast_path_in_sampling_engine(tiny):
    """A temperature=0.0 request on a sampling engine takes the argmax:
    its stream and the spec counters (drafts go to greedy slots only)
    equal the reference's; the sampled request decodes beside it.  A
    greedy engine never draws from its generator."""
    rng = np.random.RandomState(5)
    p = rng.randint(0, tiny[0].vocab_size, (7,)).astype(np.int32)
    kw = dict(num_slots=2, page_size=8, max_model_len=64, temperature=0.8,
              seed=9, spec_len=4)
    ref, eng = _engines(tiny, **kw)
    outs = []
    for e in (ref, eng):
        rg = e.add_request(p, max_new_tokens=10, temperature=0.0)
        rs = e.add_request(p, max_new_tokens=10)
        res = e.run()
        outs.append((res[rg], res[rs]))
    _assert_same([outs[0][0]], [outs[1][0]])
    assert len(outs[1][1].token_ids) == 10
    rs_, st = ref.stats(), eng.stats()
    for k in SPEC_STATS[:7]:
        assert st[k] == rs_[k], k
    assert st["verify_steps"] > 0 and st["decode_executables"] == 1
    with pytest.raises(ValueError, match="per-request temperature"):
        eng.add_request(p, temperature=0.3)
    with pytest.raises(ValueError, match="must be >= 0"):
        eng.add_request(p, temperature=-0.7)
    g = _port(tiny, num_slots=2, page_size=8, max_model_len=64,
                    spec_len=4)
    with pytest.raises(ValueError, match="cannot serve sampled"):
        g.add_request(p, temperature=0.7)
    state = g._generator.get_state().clone()
    g.add_request(p, max_new_tokens=5)
    g.run()
    assert torch.equal(g._generator.get_state(), state)


class _AlwaysWrongProposer:
    """Drafts a constant token the greedy stream never emits: acceptance
    is 0 on every verify event."""
    max_lookback = 4

    def __init__(self, token):
        self.token = token
        self.calls = 0

    def propose(self, context, max_tokens):
        self.calls += 1
        return np.full((max_tokens,), self.token, np.int32)


@pytest.mark.parametrize("mode", list(FUSE))
def test_adaptive_spec_backoff_stops_dead_drafting(tiny, mode):
    """After `spec_backoff_window` zero-accept verify events the slot stops
    drafting: the proposer is called exactly W times, the counters freeze,
    the stream is still the vanilla one.  Window 0 never backs off.  Both
    as the reference."""
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, tiny[0].vocab_size, (6,)).astype(np.int32)
    W, NEW = 3, 24
    geo = dict(num_slots=1, page_size=8, max_model_len=64, fuse=FUSE[mode])
    base = _port(tiny, spec_len=0, **geo)
    ref_stream = _serve(base, [prompt], NEW)[0].token_ids
    bad = next(t for t in range(tiny[0].vocab_size) if t not in ref_stream)
    for window in (W, 0):
        props = [_AlwaysWrongProposer(bad) for _ in range(2)]
        kw = dict(spec_len=3, spec_backoff_window=window, **geo)
        eng = _port(tiny, draft_proposer=props[1], kv_tier=False, **kw)
        assert eng.proposer is props[1]
        got = _serve(eng, [prompt], NEW)
        assert got[0].token_ids == ref_stream
        st = eng.stats()
        if window:
            ref = JaxEngine(tiny[1], tiny[0], draft_proposer=props[0],
                            kv_tier=False, **kw)
            _assert_same(_serve(ref, [prompt], NEW), got)
            _assert_spec_stats(ref, eng)
            assert props[1].calls == props[0].calls == W
            assert st["spec_backoffs"] == 1
            assert st["spec_drafted_tokens"] == W * 3
            assert st["spec_accepted_tokens"] == 0
        else:
            assert st["spec_backoffs"] == 0 and props[1].calls > W
        eng.cache.check_invariants()


def test_adaptive_spec_backoff_resets_on_acceptance(tiny):
    """Accepted drafts reset the zero-accept streak: on a tight loop the
    n-gram proposer keeps drafting, with the reference's counters."""
    prompt = np.asarray([9, 9, 9, 9, 9, 9], np.int32)
    ref, eng = _engines(tiny, num_slots=1, page_size=8, max_model_len=64,
                        spec_len=3, spec_backoff_window=2)
    _assert_same(_serve(ref, [prompt], 16), _serve(eng, [prompt], 16))
    _assert_spec_stats(ref, eng)
    st = eng.stats()
    if st["spec_accepted_tokens"] > 0:
        assert st["spec_backoffs"] == 0


def test_spec_knobs_validate_and_warm_spec(tiny):
    """The reference's knob checks; `prefill_chunk="auto"` takes the verify
    lane's width with spec on; `warm_spec` builds the unfused verify
    program (decode-side 2 with `warm_decode`, beyond the default budget
    of 1 as in the reference) and is a no-op when fused."""
    _, _, tcfg, tparams = tiny
    for kw, match in ((dict(spec_len=-1), "spec_len"),
                      (dict(spec_len=64), "max_model_len"),
                      (dict(spec_len=2, spec_backoff_window=-1),
                       "spec_backoff_window")):
        with pytest.raises(ValueError, match=match):
            LLMEngine(tparams, tcfg, device="cpu", **GEOMETRY, **kw)
    eng = LLMEngine(tparams, tcfg, device="cpu", spec_len=4,
                    prefill_chunk="auto", **GEOMETRY)
    assert eng.prefill_chunk == 5 and eng._fused_T == 5
    assert isinstance(eng.proposer, NgramProposer)
    eng.warm_spec()
    eng.warm_decode()
    st = eng.stats()
    assert (st["decode_executables"], st["verify_executables"]) == (1, 0)
    off = LLMEngine(tparams, tcfg, device="cpu", prefill_chunk="auto",
                    **GEOMETRY)
    assert off.prefill_chunk == 8 and off.proposer is None
    uf = LLMEngine(tparams, tcfg, device="cpu", spec_len=4, fuse=False,
                   **GEOMETRY)
    uf.warm_spec()
    uf.warm_decode()
    st = uf.stats()
    assert (st["decode_executables"], st["verify_executables"]) == (1, 1)
    assert over_budget(st) == {"decode_side_executables": (2, 1)}
