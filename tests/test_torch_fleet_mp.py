"""Fleets and the front door over tensor-parallel engines, on the CPU: the
port's `EngineFleet` of `LLMEngine(mp=2)` replicas over one gloo
`ServingMesh` against the JAX reference's fleets.

One mesh of two ranks (`serving_mesh(2, ["cpu"] * 2)`) carries every
port fleet of the module.  A fleet built from `engine_kwargs=dict(mesh=)`
puts its followers on the leader's mesh and its weight shards, as the
reference's share `leader.mesh`; each replica is an engine of its own on
the worker.  The streams are held to the reference's mp=1 fleets, which
the reference holds token-equal to its mp engines, and once to the
reference's own `EngineFleet(engine_kwargs=dict(mp=2))` on the forced CPU
devices (`tests/conftest.py`), its engines never warmed.  A divergence
passes only as a near-tie of the reference's logits, reported
(`test_torch_engine._assert_greedy_parity`).

Beside the streams: affinity against round robin, `roles="P:D"`, the
door's completion, `create_predictor(replicas=2, mp=2)`, abort freeing
every replica's pages, one weight shard on the worker however many
replicas attach, and two replica loops stepping together while each
program's message to the worker and rank 0's run of it stay one span
that no other thread's run enters.
"""
import gc
import http.client
import json
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.inference.router import EngineFleet as RefFleet
from paddle_tpu.models import gpt as G
import paddle_tpu_torch.inference as port_inf
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.frontend import ServingFrontend
from paddle_tpu_torch.inference.graphs import StepProgram
from paddle_tpu_torch.inference.router import EngineFleet, _adopt_executables
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel import hybrid as TH
from paddle_tpu_torch.parallel.tp import EngineLink, serving_mesh
from test_torch_engine import _assert_greedy_parity
from torch_threads import one_torch_thread  # noqa: F401

EKW = dict(num_slots=2, page_size=8, max_model_len=64, prefill_chunk=16,
           seed=0)
WAIT_S = 120.0          # a wedged loop must fail a test, not hang it
MESH_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def mesh():
    m = serving_mesh(2, ["cpu"] * 2, timeout_s=MESH_TIMEOUT_S)
    yield m
    m.close()


def _models(name):
    cfg = getattr(G, name)(64)
    params = G.init_params(cfg, jax.random.key(0))
    tcfg = getattr(TG, name)(64)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, "cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def tiny():
    return _models("gpt_tiny")


def _port_fleet(tiny, mesh, **kw):
    _, _, tcfg, tparams = tiny
    ekw = dict(EKW, device="cpu", mesh=mesh, **kw.pop("engine_kwargs", {}))
    return EngineFleet(tparams, tcfg, engine_kwargs=ekw, **kw)


def _ref_fleet(tiny, **kw):
    cfg, params, _, _ = tiny
    ekw = dict(EKW, **kw.pop("engine_kwargs", {}))
    return RefFleet(params, cfg, engine_kwargs=ekw, **kw)


def _sessions(vocab, n=3, seed=7):
    rng = np.random.RandomState(seed)
    first = {f"s{i}": rng.randint(0, vocab, (10,)).astype(np.int32)
             for i in range(n)}
    more = {k: rng.randint(0, vocab, (4,)).astype(np.int32) for k in first}
    return first, more


def _two_turns(fl, first, more):
    outs = {}
    with fl:
        for k, p in first.items():
            outs[(k, 1)] = fl.result(
                fl.submit(p, session=k, max_new_tokens=5), timeout=WAIT_S)
        for k, p in first.items():
            conv = np.concatenate([p, np.asarray(outs[(k, 1)].token_ids,
                                                 np.int32), more[k]])
            outs[(k, 2)] = fl.result(
                fl.submit(conv, session=k, max_new_tokens=5), timeout=WAIT_S)
        fl.check_invariants()
    assert all(o is not None for o in outs.values())
    return outs


def _shard_bytes(tparams, tcfg, rank):
    return sum(t.numel() * t.element_size() for t in
               TH._leaves(TH.shard_params(tparams, tcfg, 2, rank)))


@pytest.mark.parametrize("name", ["gpt_tiny", "llama_tiny"])
def test_mp2_fleet_streams_affinity_and_one_weight_shard(mesh, name):
    """Two mp 2 replicas on one mesh, affinity and round robin, on a
    3-session x 2-turn stream: the streams and cached tokens of the
    reference's mp=1 fleets of the same policy (affinity's returning turns
    reuse the whole turn-1 KV, 14 tokens; round robin's none).  The
    followers run on the leader's rank-0 shard and, on the worker, on its
    shard: the worker holds one shard's bytes of weights and one pool
    shard a replica (a dropped replica's part leaves the worker with
    it)."""
    models = _models(name)
    cfg, params, tcfg, tparams = models
    first, more = _sessions(cfg.vocab_size)
    for router, cached in (("affinity", 14), ("round_robin", 0)):
        want = _two_turns(_ref_fleet(models, replicas=2, router=router),
                          first, more)
        gc.collect()        # an earlier fleet's engines leave the worker
        fl = _port_fleet(models, mesh, replicas=2, router=router)
        e0, e1 = fl.engines.values()
        assert e1.mesh is e0.mesh is mesh and e1.params is e0.params
        assert e1._link.eid != e0._link.eid and fl.shared_executables()
        assert mesh.query(1, "weight_bytes") == \
            _shard_bytes(tparams, tcfg, 1)
        got = _two_turns(fl, first, more)
        _assert_greedy_parity(want, got, params, cfg)
        assert {k: o.cached_tokens for k, o in got.items()} == \
            {k: o.cached_tokens for k, o in want.items()}
        assert all(got[(k, 2)].cached_tokens == cached for k in first)
        assert e0.rank_pool_bytes() == [e0.kv_pool_bytes()] * 2 == \
            e1.rank_pool_bytes()
        del fl, e0, e1


def test_mp2_fleet_matches_the_reference_mp2_fleet(tiny, mesh):
    """The reference's own `EngineFleet(engine_kwargs=dict(mp=2))` (two
    forced CPU devices, never warmed) and the port's on the gloo mesh
    answer the same sessions with the same tokens."""
    cfg, params, _, _ = tiny
    first, more = _sessions(cfg.vocab_size, seed=3)
    want = _two_turns(_ref_fleet(tiny, replicas=2,
                                 engine_kwargs=dict(mp=2)), first, more)
    got = _two_turns(_port_fleet(tiny, mesh, replicas=2), first, more)
    _assert_greedy_parity(want, got, params, cfg)


def test_prebuilt_mp_engines_on_distinct_meshes_and_refusal(tiny, mesh):
    """Pre-built engines: one on the module's mesh and one on a mesh of
    its own (the dp x mp layout) serve one fleet as the reference's mp=1
    fleet does; a follower on another copy of the weights is not adopted
    (the worker's shard differs)."""
    cfg, params, tcfg, tparams = tiny
    first, more = _sessions(cfg.vocab_size, n=2, seed=5)
    want = _two_turns(_ref_fleet(tiny, replicas=2), first, more)
    other = serving_mesh(2, ["cpu"] * 2, timeout_s=MESH_TIMEOUT_S)
    try:
        a = LLMEngine(tparams, tcfg, device="cpu", mesh=mesh, **EKW)
        b = LLMEngine(tparams, tcfg, device="cpu", mesh=other, **EKW)
        fl = EngineFleet(engines=[a, b])
        assert not fl.shared_executables()
        _assert_greedy_parity(want, _two_turns(fl, first, more), params,
                              cfg)
        c = LLMEngine(tparams, tcfg, device="cpu", mesh=mesh, **EKW)
        with pytest.raises(ValueError, match="one copy of the weights"):
            _adopt_executables(c, a)
        with pytest.raises(ValueError, match="one copy of the weights"):
            _adopt_executables(b, a)
    finally:
        other.close()


def test_disagg_roles_over_mp_engines(tiny, mesh, tmp_path):
    """`roles="P:D"` over mp 2 replicas on one mesh: two sessions x two
    turns equal the reference's colocated mp=1 engine; the prefill side
    exports through the shared store (host slabs of the full layout), the
    decode side restores, and the handoff counters equal the reference's
    1P:1D fleet's."""
    cfg, params, tcfg, tparams = tiny
    rng = np.random.RandomState(9)
    prompts = [rng.randint(0, cfg.vocab_size, (18,)).astype(np.int32)
               for _ in range(2)]
    ekw = dict(num_slots=2, page_size=8, max_model_len=64, prefill_chunk=16,
               seed=3)
    got = {}
    for which in ("reference", "port"):
        kw = dict(ekw, spill_dir=str(tmp_path / which))
        fl = RefFleet(params, cfg, roles="P:D", engine_kwargs=kw) \
            if which == "reference" else EngineFleet(
                tparams, tcfg, roles="P:D",
                engine_kwargs=dict(kw, device="cpu", mesh=mesh))
        convs, toks = [list(p) for p in prompts], []
        with fl:
            for s in range(2):
                for _ in range(2):
                    out = fl.result(fl.submit(np.asarray(convs[s], np.int32),
                                              session=f"s{s}",
                                              max_new_tokens=5),
                                    timeout=WAIT_S)
                    toks.append(list(out.token_ids))
                    convs[s] += list(out.token_ids)
            fl.check_invariants()
        pe, de = fl.engines["engine0"], fl.engines["engine1"]
        fst = fl.stats()["disagg"]
        got[which] = (toks, pe.stats()["kv_tier"]["handoff_exports"],
                      de.stats()["kv_tier"]["restores"],
                      {k: fst[k] for k in ("handoffs", "handoff_skips",
                                           "handoff_degrades")})
    assert got["port"] == got["reference"]
    assert got["port"][1] >= 1 and got["port"][2] >= 1


def test_door_and_create_predictor_over_mp(tiny, mesh):
    """The door's completion round trip over an mp 2 fleet equals the
    reference engine's tokens; `create_predictor(replicas=2, mp=2)` builds
    a fleet of two replicas on one mesh of its own, one weight shard on
    its worker."""
    cfg, params, tcfg, tparams = tiny
    prompt = [int(x) for x in np.arange(8)]
    ref = JaxEngine(params, cfg, **EKW)
    rid = ref.add_request(np.asarray(prompt, np.int32), max_new_tokens=4)
    want = [int(t) for t in ref.run()[rid].token_ids]
    fl = _port_fleet(tiny, mesh, replicas=2).start()
    door = ServingFrontend(fl).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", door.port, timeout=60)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": prompt, "max_tokens": 4}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        door.close()
        fl.stop()
    assert resp.status == 200, body
    assert body["choices"][0]["token_ids"] == want
    assert ServingFrontend(fl.engines["engine0"]).fleet.engines["engine0"] \
        is fl.engines["engine0"]

    pred = port_inf.create_predictor(tcfg, params=tparams, replicas=2, mp=2,
                                     device="cpu", **EKW)
    e0, e1 = pred.engines.values()
    try:
        assert isinstance(pred, EngineFleet) and e0.mesh is e1.mesh
        assert e0.mesh is not mesh and e0.mp == 2
        assert pred.shared_executables()
        assert e0.mesh.query(1, "weight_bytes") == \
            _shard_bytes(tparams, tcfg, 1)
        with pred:
            out = pred.result(pred.submit(np.asarray(prompt, np.int32),
                                          max_new_tokens=4), timeout=WAIT_S)
        assert [int(t) for t in out.token_ids] == want
    finally:
        e0.mesh.close()


def test_abort_frees_every_replicas_pages_at_mp(tiny, mesh):
    """Abort mid-generation on an mp 2 fleet, as on the reference's mp=1
    fleet: the same replica, partial stream and finish reason, every
    replica's pages released, invariants; the survivors' pools still
    serve (a request after the abort streams as on one engine)."""
    got = {}
    for which in ("reference", "port"):
        fl = _ref_fleet(tiny, replicas=2) if which == "reference" \
            else _port_fleet(tiny, mesh, replicas=2)
        h = fl.submit(np.arange(20, dtype=np.int32), max_new_tokens=40)
        eng = fl.engines[h.label]
        steps = 0
        while not fl.progress(h)["token_ids"]:
            eng.step()
            steps += 1
            assert steps < 20
        assert fl.abort(h)
        with fl:
            out = fl.result(h, timeout=WAIT_S)
            assert out is not None and out.finish_reason == "abort"
            assert fl.drain(timeout=WAIT_S)
            after = fl.result(fl.submit(np.arange(7, dtype=np.int32),
                                        max_new_tokens=3), timeout=WAIT_S)
            fl.check_invariants()
        got[which] = (h.label, steps, list(out.token_ids),
                      list(after.token_ids),
                      {l: e.cache.pages_in_use()
                       for l, e in fl.engines.items()})
    assert got["port"] == got["reference"]
    assert all(n == 0 for n in got["port"][4].values())


def test_two_loops_never_interleave_a_run_on_the_mesh(tiny, mesh,
                                                      monkeypatch):
    """Two mp 2 replicas' loops stepping together under a short switch
    interval: from the worker's message to the end of rank 0's run of a
    program (its collectives), no other thread's run starts, and both
    replicas' streams equal the same requests served one at a time."""
    spans, lock = [], threading.Lock()
    open_at = {}
    send, body = EngineLink.run, StepProgram._run

    def sent(self, *a, **k):
        open_at[threading.get_ident()] = time.perf_counter()
        return send(self, *a, **k)

    def ran(self):
        try:
            return body(self)
        finally:
            t0 = open_at.pop(threading.get_ident(), None)
            if t0 is not None:
                with lock:
                    spans.append((threading.get_ident(), t0,
                                  time.perf_counter()))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 256, (int(n),)).astype(np.int32)
               for n in rng.randint(3, 30, 8)]
    solo = _port_fleet(tiny, mesh, replicas=1)
    with solo:
        want = [list(solo.result(solo.submit(p, max_new_tokens=6),
                                 timeout=WAIT_S).token_ids) for p in prompts]
    monkeypatch.setattr(EngineLink, "run", sent)
    monkeypatch.setattr(StepProgram, "_run", ran)
    fl = _port_fleet(tiny, mesh, replicas=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with fl:
            hs = [fl.submit(p, max_new_tokens=6, policy="round_robin")
                  for p in prompts]
            got = [list(fl.result(h, timeout=WAIT_S).token_ids) for h in hs]
    finally:
        sys.setswitchinterval(old)
    assert got == want
    assert {h.label for h in hs} == {"engine0", "engine1"}
    assert len({tid for tid, _, _ in spans}) == 2
    spans.sort(key=lambda s: s[1])
    for (ta, a0, a1), (tb, b0, b1) in zip(spans, spans[1:]):
        assert b0 >= a1, "two threads' runs interleaved on the mesh"


def test_host_slab_spans_first_fit_reuse_and_layout():
    """`HostSlabs`: spans of consecutive page slots, first fit; a span
    given back is free only after a drain (taken when nothing else
    fits), a slab is added only when no span fits, freed spans merge;
    `fill` then `full` round-trips the host tier's layout, and each rank's
    part is its kv heads of the span's pages."""
    from paddle_tpu_torch.parallel.tp import HostSlabs
    made, drains = [], []

    class Mesh:
        def slab(self, eid, sid, tensors):
            made.append(sid)

    class Link:
        eid, mesh = 1, Mesh()

        def drain(self):
            drains.append(1)

    pool = {"k": torch.zeros(2, 9, 4, 2, 8)}    # [L, pages, page, KVH/2, hd]
    hs = HostSlabs(Link(), pool, 2, 4)
    hs.reserve(10)
    a, b = hs.take(3), hs.take(5)
    assert (a, b, made) == ((0, 0, 3), (0, 3, 5), [0])
    hs.give(a)
    c = hs.take(3)                  # 2 slots left: drain, then a's span
    assert c == (0, 0, 3) and drains == [1]
    assert hs.take(6) == (1, 0, 6) and made == [0, 1]
    hs.give(b)
    hs.give(c)
    hs.drain()
    assert hs._free[0] == [(0, 10)]
    rng = np.random.RandomState(0)
    lanes = {"k": [torch.tensor(rng.randn(2, 4, 4, 8), dtype=torch.float32)
                   for _ in range(3)]}      # [L, page, KVH, hd] a page
    span = hs.take(3)
    hs.fill(span, lanes)
    want = torch.stack(lanes["k"], 1)       # [L, 3, page, KVH, hd]
    assert torch.equal(hs.full(span)["k"], want)
    assert torch.equal(hs.full(span, 1)["k"], lanes["k"][1])
    for r in range(2):
        torch.testing.assert_close(hs.part(span, r, copy=True)["k"],
                                   want[:, :, :, 2 * r:2 * r + 2])


def test_parked_swap_keeps_its_span_until_swap_in(tiny, mesh):
    """Under mp a swapped victim's pages stay in their span of the host
    slabs from the gather to the swap-in, which stages straight from it
    (no host-tier layout in between); `warm_swap` reserves two slots'
    pages, not the pool; the streams equal the mp=1 engine's, and once
    the work is done every span is free again."""
    from test_torch_quantized import _preempt_prompts
    _, _, tcfg, tparams = tiny
    kw = dict(device="cpu", page_size=8, max_model_len=64, prefill_chunk=8,
              num_slots=6, num_pages=9, admission="optimistic",
              preempt="swap", kv_tier=False)
    prompts = _preempt_prompts(tcfg.vocab_size)
    want = LLMEngine(tparams, tcfg, **kw)
    rids = [want.add_request(p, max_new_tokens=12) for p in prompts]
    while want.has_work:
        want.step()
    eng = LLMEngine(tparams, tcfg, mesh=mesh, **kw)
    eng.warm_swap()
    hs = eng._slabs
    slots = 2 * eng.cache.max_pages_per_slot
    page = sum(a[:, 0].nbytes for a in eng._pool.values())  # a rank's page
    assert hs.nbytes == 2 * slots * page and hs._free[0] == [(0, slots)]
    for p in prompts:
        eng.add_request(p, max_new_tokens=12)
    parked = 0
    while eng.has_work:
        eng.step()
        for rec in eng._preempted.values():
            if rec["kind"] == "swap" and rec["fetched"]:
                assert rec["data"] is None and rec["slab"] is not None
                parked += 1
    assert parked > 0 and eng.stats()["preempt_swaps"] > 0
    assert [eng.outputs[r].token_ids for r in rids] == \
        [want.outputs[r].token_ids for r in rids]
    hs.drain()
    assert all(free == [(0, hs.slabs[sid]["k"].shape[1])]
               for sid, free in hs._free.items())
