"""The port's int8 serving engine vs the JAX reference's, on the CPU: the
engine half of `tests/test_torch_quantized.py` (its helpers, fixtures and
tolerances), in a file of its own so that the two halves run on separate
test workers.

- `LLMEngine(weight_dtype="int8", kv_dtype="int8")` greedy streams, fused
  and unfused, bucketed and chunked, against the reference int8 engine
  (`prefix_cache=False, spec_len=0`, never warmed, run once a preset); a
  divergence passes only as a near-tie, reported.  `stats()`'s
  quantization keys equal the reference's, program counts the fp
  engine's.
- The fp default is byte-identical to the explicit fp knobs.
- int8 and fp engines agree on at least AGREEMENT_BAR of greedy tokens,
  the reference's bar, in its bucketed, chunked, `chunked_spec_prefix`,
  `mp2` and "preempt" modes.

Each port engine configuration is served once a preset (`port_runs`): the
bucketed and chunked runs that the stream test holds against the
reference are the ones the agreement test compares.
"""
import jax
import pytest
import torch

from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.quantization import serving as TQ
from paddle_tpu.quantization import serving as RQ
from test_torch_engine import _serve
from test_torch_quantized import (AGREEMENT_BAR, GEOMETRY,  # noqa: F401
                                  _assert_int8_parity, _np, _preempt_prompts,
                                  _requests, quant_models)
from torch_threads import one_torch_thread  # noqa: F401

INT8 = dict(weight_dtype="int8", kv_dtype="int8")


@pytest.fixture(scope="module")
def int8_reference(quant_models):
    """{chunk: reference int8 engine outputs, stats} on `_requests`."""
    _, cfg, params, _, _, _ = quant_models
    runs = {}
    for chunk in (None, 8):
        eng = JaxEngine(params, cfg, prefill_chunk=chunk, prefix_cache=False,
                        spec_len=0, weight_dtype="int8", kv_dtype="int8",
                        **GEOMETRY)
        runs[chunk] = (_serve(eng, _requests(cfg.vocab_size)), eng.stats())
    return runs


@pytest.fixture(scope="module")
def port_runs():
    """serve(quant_models, **engine keywords) -> (engine, {rid: tokens}):
    each port configuration served on `_requests` once a preset, over the
    fp weights bridged from the reference (the int8 ones quantize them)."""
    cache = {}

    def serve(quant_models, **kw):
        name, cfg, params, _, tcfg, _ = quant_models
        key = (name, tuple(sorted(kw.items())))
        if key not in cache:
            tparams = params_from_numpy(_np(params), tcfg, "cpu")
            eng = LLMEngine(tparams, tcfg, device="cpu", **GEOMETRY, **kw)
            outs = _serve(eng, _requests(cfg.vocab_size))
            cache[key] = (eng, outs)
        return cache[key]
    return serve


def _stream_kw(chunk, fuse=True):
    """The stream test's engine keywords (the agreement test's bucketed and
    chunked modes are the fused ones; without the prefix cache the KV tier
    is off whatever `kv_tier` says)."""
    return dict(prefill_chunk=chunk, fuse=fuse, prefix_cache=False,
                kv_tier=False)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
def test_int8_engine_streams_match_reference(quant_models, int8_reference,
                                             port_runs, chunk, fuse):
    """The reference holds its fused and unfused steps byte-equal, so its
    fused engine's streams stand for both."""
    _, cfg, _, qparams, tcfg, tq = quant_models
    ref_outs, ref_stats = int8_reference[chunk]
    # the port quantizes fp params itself, as the reference engine does
    eng, outs = port_runs(quant_models, **_stream_kw(chunk, fuse), **INT8)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(eng.params), jax.tree_util.tree_leaves(tq)))
    _assert_int8_parity(ref_outs, outs, qparams, cfg)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use() == 0 and not eng.has_work
    st = eng.stats()
    for k in ("weight_dtype", "kv_dtype", "kv_pool_bytes"):
        assert st[k] == ref_stats[k], k
    assert eng._pool["k"].dtype == torch.int8 and set(eng._pool) == {
        "k", "v", "k_scale", "v_scale"}
    fp, _ = port_runs(quant_models, **_stream_kw(chunk, fuse))
    for k in st:
        if k.endswith("_executables"):
            assert st[k] == fp.stats()[k], k


def test_fp_default_is_byte_identical_to_explicit_fp_knobs(quant_models):
    _, cfg, params, _, tcfg, _ = quant_models
    tparams = params_from_numpy(_np(params), tcfg, "cpu")
    outs, engines = [], []
    for kw in ({}, dict(weight_dtype="bf16", kv_dtype=None)):
        eng = LLMEngine(tparams, tcfg, prefill_chunk=8, device="cpu",
                        **GEOMETRY, **kw)
        outs.append({r: o.token_ids for r, o in
                     _serve(eng, _requests(cfg.vocab_size)).items()})
        engines.append(eng)
    assert outs[0] == outs[1]
    assert engines[0].params is tparams and engines[1].params is tparams
    for eng in engines:
        st = eng.stats()
        assert st["weight_dtype"] is None and st["kv_dtype"] is None
        assert set(eng._pool) == {"k", "v"}
        assert eng._pool["k"].dtype == tcfg.dtype
    assert engines[0].kv_pool_bytes() == engines[1].kv_pool_bytes()
    q = LLMEngine(tparams, tcfg, kv_dtype="int8", device="cpu", **GEOMETRY)
    ratio = engines[0].kv_pool_bytes() / q.kv_pool_bytes()
    assert ratio == pytest.approx(TQ.kv_page_bytes(tcfg, 8) /
                                  TQ.kv_page_bytes(tcfg, 8, "int8"))
    assert TQ.kv_page_bytes(tcfg, 8) == RQ.kv_page_bytes(cfg, 8)
    assert TQ.kv_page_bytes(tcfg, 8, "int8") == \
        RQ.kv_page_bytes(cfg, 8, "int8")


TOP1_MODES = {   # the reference's MODES that the port serves
    "bucketed": dict(prefill_chunk=None, prefix_cache=False),
    "chunked": dict(prefill_chunk=8, prefix_cache=False),
    "chunked_spec_prefix": dict(num_slots=4, prefill_chunk=8, spec_len=2),
    "mp2": dict(num_slots=4, prefill_chunk=8, spec_len=2, mp=2),
    "preempt": dict(num_slots=6, num_pages=9, prefill_chunk=8,
                    admission="optimistic", preempt="recompute")}


@pytest.mark.parametrize("mode", list(TOP1_MODES))
def test_int8_engine_top1_agreement_with_fp(quant_models, port_runs, mode):
    """The reference's bar (`test_quantized_serving.py`): greedy top-1
    agreement of the int8 engine with the fp engine, and every request
    decodes its whole budget; `chunked_spec_prefix` drafts (spec_len 2)
    with the prefix cache on, `preempt` preempts (optimistic admission,
    8 real pages), as the reference's modes of those names.  The bucketed
    and chunked modes are the stream test's fused runs; `mp2` serves
    `chunked_spec_prefix` tensor-parallel (each engine on a CPU mesh of
    its own, int8 weights quantized before sharding)."""
    name, cfg, params, _, tcfg, _ = quant_models
    tparams = params_from_numpy(_np(params), tcfg, "cpu")
    # the preempt mode on the reference's traffic for it, which preempts
    reqs = [(p, 12) for p in _preempt_prompts(cfg.vocab_size)] \
        if mode == "preempt" else _requests(cfg.vocab_size)
    geo = {**GEOMETRY, **TOP1_MODES[mode]}
    if mode in ("bucketed", "chunked"):
        kw = _stream_kw(geo["prefill_chunk"])
        runs = [port_runs(quant_models, **kw),
                port_runs(quant_models, **kw, **INT8)]
    else:
        runs = []
        for kw in ({}, INT8):
            eng = LLMEngine(tparams, tcfg, device="cpu", kv_tier=False,
                            **geo, **kw)
            runs.append((eng, _serve(eng, reqs)))
    engines = [eng for eng, _ in runs]
    fp, q = ({r: o.token_ids for r, o in outs.items()} for _, outs in runs)
    if geo.get("spec_len"):
        assert engines[1].stats()["spec_events"] > 0
    total = sum(max(len(fp[r]), len(q[r])) for r in fp)
    agree = sum(int(a == b) for r in fp for a, b in zip(fp[r], q[r]))
    if mode == "preempt":
        assert engines[1].stats()["preemptions"] > 0
    if mode == "preempt" and name != "gpt_tiny":
        # the reference holds this mode on gpt_tiny; on llama_tiny's
        # weights its own int8 engine agrees 59 of 72 on this traffic, so
        # there the port must agree at least as often as the reference's
        ref = [JaxEngine(params, cfg, kv_tier=False, **geo, **kw)
               for kw in ({}, dict(weight_dtype="int8", kv_dtype="int8"))]
        rfp, rq = ({r: o.token_ids for r, o in _serve(eng, reqs).items()}
                   for eng in ref)
        assert agree >= sum(int(a == b) for r in rfp
                            for a, b in zip(rfp[r], rq[r]))
    else:
        assert agree / total >= AGREEMENT_BAR
    assert [len(q[r]) for r in sorted(q)] == [n for _, n in reqs]
