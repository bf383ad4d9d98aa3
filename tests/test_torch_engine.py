"""The PyTorch port's `LLMEngine` vs the JAX reference engine, on the CPU.

Both engines serve the same request stream on the reference's weights
(bridged through numpy) at `gpt_tiny` and `llama_tiny`, fp32.  The
reference runs `LLMEngine(prefix_cache=False, spec_len=0)`, never warmed
(its warm-up path needs an API jax 0.9 dropped), and the port's engines
turn the prefix cache off too (`test_torch_prefix_cache.py` holds it).
Greedy streams must match token for token; a divergence is accepted only
as an exact tie (top-2 margin of the reference's logits < 1e-4 at the
diverging position), which is reported as a warning instead of failing.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.inference.cache import (LocalDirStore, PageStore,
                                              PagedKVCache)
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.faults import FaultPlan
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

PRESETS = {"gpt_tiny": (G.gpt_tiny, TG.gpt_tiny),
           "llama_tiny": (G.llama_tiny, TG.llama_tiny)}
GEOMETRY = dict(num_slots=3, page_size=8, max_model_len=64)
TIE_MARGIN = 1e-4


def _requests(vocab, n=7, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, rng.randint(2, 41)).astype(np.int32),
             int(rng.randint(1, 13))) for _ in range(n)]


def _serve(engine, requests, **kw):
    for prompt, max_new in requests:
        engine.add_request(prompt, max_new_tokens=max_new, **kw)
    if isinstance(engine, JaxEngine):
        return engine.run()
    # bounded: a scheduler fault must fail the test, not hang it
    for _ in range(sum(p.size + n for p, n in requests) + 10):
        if not engine.has_work:
            break
        engine.step()
    assert not engine.has_work, "engine did not drain"
    return engine.outputs


@pytest.fixture(scope="module")
def reference():
    """name -> (jax cfg, jax params, port cfg, port params, requests,
    {chunk: reference outputs})"""
    out = {}
    for name, (jax_preset, port_preset) in PRESETS.items():
        cfg, tcfg = jax_preset(64), port_preset(64)
        params = G.init_params(cfg, jax.random.key(1))
        tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        reqs = _requests(cfg.vocab_size)
        streams = {}
        for chunk in (None, 8):
            eng = JaxEngine(params, cfg, prefill_chunk=chunk,
                            prefix_cache=False, spec_len=0, **GEOMETRY)
            streams[chunk] = _serve(eng, reqs)
        out[name] = (cfg, params, tcfg, tparams, reqs, streams)
    return out


def _assert_greedy_parity(ref_outs, got_outs, params, cfg):
    assert sorted(ref_outs) == sorted(got_outs)
    ties = []
    for rid, ref in ref_outs.items():
        a, b = list(ref.token_ids), list(got_outs[rid].token_ids)
        if a == b:
            assert got_outs[rid].finish_reason == ref.finish_reason
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        seq = np.concatenate([ref.prompt, np.asarray(a[:i], np.int32)])
        logits = np.asarray(G.forward(params, jnp.asarray(seq[None]),
                                      cfg))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE_MARGIN, (
            f"request {rid} diverges at token {i}: reference {a}, port {b}, "
            f"top-2 margin {margin:.3g} is no tie")
        ties.append((rid, i, margin))
    if ties:
        warnings.warn(f"greedy ties (request, position, margin): {ties}")


@pytest.mark.parametrize("double_buffer", [True, False], ids=["db", "sync"])
@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
@pytest.mark.parametrize("name", list(PRESETS))
def test_greedy_streams_match_reference_engine(reference, name, chunk,
                                               double_buffer):
    cfg, params, tcfg, tparams, reqs, streams = reference[name]
    eng = LLMEngine(tparams, tcfg, prefill_chunk=chunk, prefix_cache=False,
                    double_buffer=double_buffer, device="cpu", **GEOMETRY)
    outs = _serve(eng, reqs)
    _assert_greedy_parity(streams[chunk], outs, params, cfg)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use() == 0 and not eng.has_work
    st = eng.stats()
    assert st["finished_requests"] == len(reqs)
    # every request's first token comes from its prefill, the rest from
    # fused decode steps
    assert st["decode_tokens"] == \
        sum(len(o.token_ids) for o in outs.values()) - len(reqs)
    if chunk:
        assert st["prefill_chunks"] >= len(reqs)
        assert st["prefilled_tokens"] == sum(p.size for p, _ in reqs)


def test_sampling_engine_keeps_greedy_requests_exact(reference):
    """A sampling engine routes temperature=0.0 requests through the argmax
    (their streams equal the greedy engine's) and is reproducible under a
    fixed seed; sampled tokens stay in the vocabulary."""
    cfg, params, tcfg, tparams, reqs, streams = reference["llama_tiny"]

    def serve(seed):
        eng = LLMEngine(tparams, tcfg, temperature=0.8, top_k=20, seed=seed,
                        prefill_chunk=8, prefix_cache=False, device="cpu",
                        **GEOMETRY)
        for i, (prompt, max_new) in enumerate(reqs):
            eng.add_request(prompt, max_new_tokens=max_new,
                            temperature=0.0 if i % 2 else None)
        assert len(eng.run()) == len(reqs)
        return eng.outputs

    a, b = serve(5), serve(5)
    for rid, out in a.items():
        assert out.token_ids == b[rid].token_ids
        assert all(0 <= t < cfg.vocab_size for t in out.token_ids)
        if rid % 2:
            assert out.token_ids == list(streams[8][rid].token_ids)


def test_eos_stops_a_stream(reference):
    cfg, params, tcfg, tparams, reqs, streams = reference["gpt_tiny"]
    rid, ref = next((r, o) for r, o in streams[None].items()
                    if len(o.token_ids) >= 3)
    eos = ref.token_ids[1]
    eng = LLMEngine(tparams, tcfg, eos_token_id=eos, device="cpu",
                    **GEOMETRY)
    prompt, max_new = reqs[rid]
    eng.add_request(prompt, max_new_tokens=max_new)
    out = eng.run()[0]
    assert out.finish_reason == "stop"
    assert out.token_ids == ref.token_ids[:ref.token_ids.index(eos) + 1]


def test_add_request_validation(reference):
    _, _, tcfg, tparams, _, _ = reference["gpt_tiny"]
    auto = LLMEngine(tparams, tcfg, prefill_chunk="auto", device="cpu",
                     **GEOMETRY)
    assert auto.prefill_chunk == GEOMETRY["page_size"]   # one page per chunk
    eng = LLMEngine(tparams, tcfg, device="cpu", num_pages=5, **GEOMETRY)
    with pytest.raises(ValueError, match="empty"):
        eng.add_request([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_request([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError, match="greedy"):
        eng.add_request([1, 2], temperature=0.5)
    with pytest.raises(ValueError, match="max_model_len"):
        eng.add_request(np.ones(60, np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="deadline_s"):
        eng.add_request([1, 2], deadline_s=0.0)
    # a deadline is taken (test_torch_overload.py serves them)
    rid = eng.add_request([1, 2], deadline_s=1.0)
    assert eng._queue[-1].deadline is not None and eng.abort(rid)
    # 40 tokens need 5 pages; the pool has 4 real ones: rejected at intake
    rid = eng.add_request(np.ones(30, np.int32), max_new_tokens=10)
    assert eng.outputs[rid].finish_reason == "rejected"
    assert eng.stats()["rejected_requests"] == 1 and not eng.has_work


class _MemStore(PageStore):
    """A `PageStore` in a dict (any backend with the six methods will do)."""

    def __init__(self):
        self.objects, self.blob_map = {}, {}

    def put(self, name, data):
        self.objects[name] = dict(data)

    def get(self, name):
        return self.objects[name]

    def delete(self, name):
        self.objects.pop(name, None)

    def exists(self, name):
        return name in self.objects

    def put_blob(self, name, payload):
        self.blob_map[name] = payload

    def blobs(self, prefix):
        return sorted((n, b) for n, b in self.blob_map.items()
                      if n.startswith(prefix))


@pytest.mark.parametrize("knob", [
    dict(spec_len=2), dict(fuse=False, spec_len=2),
    dict(admission="optimistic"), dict(preempt="swap"),
    dict(fault_plan=FaultPlan(pressure_steps=(1,))), dict(kv_tier=True),
    dict(spill_dir="x"), dict(page_store=_MemStore()), dict(role="prefill"),
    dict(mesh=object()),
    dict(mp=2), dict(request_tracing=True), dict(clock=lambda: 0.0),
], ids=lambda d: next(iter(d)))
def test_later_slice_knobs_raise(reference, knob, tmp_path):
    _, _, tcfg, tparams, _, _ = reference["gpt_tiny"]
    if "spec_len" in knob:
        # speculative decoding has landed (test_torch_spec_decode.py): the
        # knob is taken, fused and unfused
        eng = LLMEngine(tparams, tcfg, device="cpu", **GEOMETRY, **knob)
        assert eng.stats()["spec_len"] == knob["spec_len"]
        assert eng.fused == knob.get("fuse", True)
        return
    if set(knob) & {"admission", "preempt", "fault_plan", "clock"}:
        # optimistic admission and preemption have landed
        # (test_torch_overload.py): the knob is taken
        eng = LLMEngine(tparams, tcfg, device="cpu", **GEOMETRY, **knob)
        st = eng.stats()
        assert st["admission"] == knob.get("admission", "reservation")
        assert st["preempt"] == knob.get("preempt", "recompute")
        if "fault_plan" in knob:
            assert eng._faults is knob["fault_plan"]
        if "clock" in knob:
            # the clock stamps through the metrics registry, as in the
            # reference (metrics, tracing and health have landed)
            assert eng.metrics._clock is knob["clock"]
            assert eng._now() == 0.0
        return
    if "request_tracing" in knob:
        # metrics, tracing and health have landed
        # (test_torch_observability.py): the knob is taken
        eng = LLMEngine(tparams, tcfg, device="cpu", **GEOMETRY, **knob)
        rid = eng.add_request(np.arange(5, dtype=np.int32), max_new_tokens=2)
        out = eng.run()[rid]
        assert eng._req_tracing is knob["request_tracing"]
        assert [e["name"] for e in out.trace.events][0] == "enqueue"
        return
    if set(knob) & {"kv_tier", "spill_dir", "page_store", "role"}:
        # the KV tier, its store and the roles have landed
        # (test_torch_kv_tier.py, test_torch_disagg.py): the knob is taken
        if "spill_dir" in knob:
            knob = {"spill_dir": str(tmp_path / knob["spill_dir"])}
        eng = LLMEngine(tparams, tcfg, device="cpu", **GEOMETRY, **knob)
        st = eng.stats()
        assert eng.kv_tier and st["kv_tier"]["enabled"]
        assert st["role"] == knob.get("role")
        store = eng.cache._tier.store
        if "spill_dir" in knob:
            assert isinstance(store, LocalDirStore)
            assert store.root == knob["spill_dir"] == st["kv_tier"][
                "spill_dir"]
        else:
            assert store is knob.get("page_store")
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        LLMEngine(tparams, tcfg, device="cpu", **GEOMETRY, **knob)


def test_engine_refuses_params_on_another_device(reference):
    _, _, tcfg, tparams, _, _ = reference["gpt_tiny"]
    with pytest.raises(ValueError, match="params live on"):
        LLMEngine(tparams, tcfg, device="meta", **GEOMETRY)


def test_paged_cache_partition_invariants():
    mgr = PagedKVCache(num_pages=9, page_size=4, num_slots=3,
                       max_pages_per_slot=4)
    row = mgr.allocate(0, 10)
    assert list(row[:3]) == [1, 2, 3] and row[3] == 0
    mgr.allocate(2, 16)
    assert mgr.pages_in_use() == 7 and mgr.num_free_pages == 1
    with pytest.raises(RuntimeError, match="out of KV pages"):
        mgr.allocate(1, 8)
    with pytest.raises(ValueError, match="capacity"):
        mgr.allocate(1, 17)
    with pytest.raises(RuntimeError, match="already has pages"):
        mgr.allocate(0, 4)
    mgr.check_invariants()
    mgr.release(0)
    mgr.check_invariants()
    assert mgr.pages_in_use() == 4 and (mgr.page_table[0] == 0).all()
    mgr.allocate(1, 12)
    mgr.check_invariants()
    mgr._free.append(mgr._used[1][0])           # a double-free is caught
    with pytest.raises(AssertionError):
        mgr.check_invariants()
