"""The port's durable tier index and prefill -> decode handoff vs the JAX
reference, on the CPU, and handoffs between the two frameworks.

The twins of the six engine-level cases of `tests/test_disagg.py`, at its
sizes (`gpt_tiny(64)`, page 8, nine pages, fp32): an engine serves turn 1
on a `spill_dir`, exports the conversation (`export_prefix`) and is
dropped; a fresh engine on the same directory merges the `kvindex_*` blob
at init and serves the returning turn.  Each case runs on the reference
engine and on the port's, each on a directory of its own: the returning
turn's stream must equal the reference's cold re-prefill, the export's
counts and the tier counters must equal the reference engine's, every
cached page must hold the reference's KV (`test_torch_kv_tier.py`'s
check), a restore must be one "swap_in" replay, and `check_invariants`
must hold.

Across the frameworks (float32, one store): a JAX engine's export restored
by a port engine, the reverse, and both writers on one directory, whose
index blobs and page objects must not collide.  Beside them: a page object
of another type than the pool's degrades to a re-prefill, the restore-plan
partition of the port's `check_invariants` catches a stranded plan, and a
bfloat16 lane keeps its bits through the store from either writer.

Left for later slices: the two `EngineFleet` cases
(`test_disagg_fleet_parity_and_handoff_counters`,
`test_disagg_fail_h2d_degrades_to_local_reprefill`) wait for ROADMAP
Queue 1 item 9 (fleet and front door).
"""
import json
import os

import jax
import numpy as np
import pytest

from paddle_tpu.inference.cache import HostKVTier as RefTier
from paddle_tpu.inference.cache import PagedKVCache as RefCache
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.inference.cache import (TIER_INDEX_VERSION, HostKVTier,
                                              PagedKVCache)
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from torch_kv_parity import assert_same_kv

TIER_STATS = ("spills", "restores", "restored_tokens", "partial_page_hits",
              "disk_spills", "disk_restores", "tier_drops", "pages_host",
              "pages_disk", "store", "handoff_exports", "handoff_pages",
              "handoff_tokens", "store_nodes_restored")
MAX_STEPS = 2000


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, port params)."""
    cfg = G.gpt_tiny(64)
    params = G.init_params(cfg, jax.random.key(0))
    tcfg = TG.gpt_tiny(64)
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    return cfg, params, tcfg, tparams


def _engine(tiny, port, **kw):
    cfg, params, tcfg, tparams = tiny
    base = dict(num_slots=2, page_size=8, num_pages=9, max_model_len=64,
                prefill_chunk=16, seed=3, swap_pool_pages=64)
    base.update(kw)
    if port:
        return LLMEngine(tparams, tcfg, device="cpu", **base)
    return JaxEngine(params, cfg, **base)


def _result(eng, rid):
    """The request's output once the engine drains (the reference's
    `result`; the port's loop surface waits for ROADMAP Queue 1 item 9);
    on the port, `check_invariants` after every step."""
    if isinstance(eng, JaxEngine):
        return eng.run()[rid]
    for _ in range(MAX_STEPS):
        if not eng.has_work:
            break
        eng.step()
        eng.cache.check_invariants()
    assert not eng.has_work, "engine did not drain"
    return eng.outputs[rid]


def _turns(vocab, first, rng_seed=7):
    """(turn-1 prompt, the returning turn after the reply `first`)."""
    rng = np.random.RandomState(rng_seed)
    prompt = rng.randint(0, vocab, (20,)).astype(np.int32)
    if first is None:
        return prompt, None
    conv = np.concatenate([prompt, np.asarray(first, np.int32)])
    return prompt, np.concatenate(
        [conv, rng.randint(0, vocab, (4,)).astype(np.int32)])


@pytest.fixture(scope="module")
def oracle(tiny):
    """rng seed -> (turn-1 reply, returning turn, its tokens from a cold
    reference engine: the re-prefill baseline)."""
    out = {}
    for seed in (7, 8):
        eng = _engine(tiny, False)
        prompt, _ = _turns(64, None, seed)
        first = list(_result(eng, eng.add_request(prompt,
                                                  max_new_tokens=5)).token_ids)
        _, conv2 = _turns(64, first, seed)
        cold = _engine(tiny, False)
        ref = list(_result(cold, cold.add_request(conv2,
                                                  max_new_tokens=5)).token_ids)
        out[seed] = (first, conv2, ref)
    return out


def _serve_and_export(tiny, port, spill_dir, oracle, seed=7):
    """Engine A serves turn 1 on `spill_dir`, exports the conversation and
    is dropped.  Returns (returning turn, the export's counts)."""
    first, conv2, _ = oracle[seed]
    prompt, _ = _turns(64, None, seed)
    eng = _engine(tiny, port, spill_dir=spill_dir)
    out1 = _result(eng, eng.add_request(prompt, max_new_tokens=5))
    assert list(out1.token_ids) == first
    exp = eng.export_prefix(conv2[:prompt.size + len(first)])
    assert exp["pages"] > 0 and exp["index_nodes"] > 0
    eng.cache.check_invariants()
    assert eng.stats()["kv_tier"]["handoff_exports"] == 1
    del eng
    return conv2, exp


def _count_scatters(eng):
    """A list that grows by one with each restore scatter of `eng`."""
    calls = []
    if isinstance(eng, JaxEngine):
        orig = eng._swap_in_fn

        def counting(*a, **kw):
            calls.append(1)
            return orig(*a, **kw)

        eng._swap_in_fn = counting
    else:
        orig = eng._tier_restore

        def counted(*a, **kw):
            before = eng.stats()["swap_in_dispatches"]
            ok = orig(*a, **kw)
            calls.extend([1] * (eng.stats()["swap_in_dispatches"] - before))
            return ok

        eng._tier_restore = counted
    return calls


def _scenario(tiny, tmp_path, oracle, damage=None):
    """Serve, export, optionally damage the store, restart, serve the
    returning turn, on both frameworks.  Returns {"reference": (engine,
    export, scatters, output), "port": ...}; the streams equal the cold
    re-prefill's and the counters the reference's."""
    runs = {}
    for name, port in (("reference", False), ("port", True)):
        root = str(tmp_path / name)
        conv2, exp = _serve_and_export(tiny, port, root, oracle)
        if damage is not None:
            damage(root)
        eng = _engine(tiny, port, spill_dir=root)
        calls = _count_scatters(eng)
        out = _result(eng, eng.add_request(conv2, max_new_tokens=5))
        assert list(out.token_ids) == oracle[7][2], name
        eng.cache.check_invariants()
        runs[name] = (eng, exp, calls, out)
    (ref, rexp, rcalls, rout), (eng, exp, calls, out) = \
        runs["reference"], runs["port"]
    assert exp == rexp
    assert len(calls) == len(rcalls)
    assert out.cached_tokens == rout.cached_tokens
    rs, ps = ref.stats()["kv_tier"], eng.stats()["kv_tier"]
    for k in TIER_STATS:
        assert ps[k] == rs[k], (k, ps[k], rs[k])
    assert_same_kv(ref, eng)
    return runs


# ---------------------------------------------------------------------------
# restart: the durable index re-attaches, one scatter, the cold stream
# ---------------------------------------------------------------------------

def test_restart_restores_with_one_scatter(tiny, tmp_path, oracle):
    runs = _scenario(tiny, tmp_path, oracle)
    eng, _, calls, _ = runs["port"]
    assert eng._store_restored_nodes > 0
    assert len(calls) == 1, f"restore took {len(calls)} scatters, not 1"
    st = eng.stats()
    assert st["kv_tier"]["restores"] == 1
    assert st["kv_tier"]["restored_tokens"] >= 16
    assert st["kv_tier"]["store_nodes_restored"] > 0
    assert st["swap_executables"] <= 2


def test_corrupted_index_degrades_to_reprefill(tiny, tmp_path, oracle):
    def corrupt(root):
        blobs = [f for f in os.listdir(root) if f.startswith("kvindex_")]
        assert blobs
        for b in blobs:
            with open(os.path.join(root, b), "wb") as f:
                f.write(b"{corrupt json \xff\xfe")

    eng = _scenario(tiny, tmp_path, oracle, corrupt)["port"][0]
    assert eng._store_restored_nodes == 0
    assert eng.stats()["kv_tier"]["restores"] == 0


def test_version_skewed_index_is_ignored(tiny, tmp_path, oracle):
    def skew(root):
        for b in os.listdir(root):
            if not b.startswith("kvindex_"):
                continue
            path = os.path.join(root, b)
            with open(path) as f:
                doc = json.load(f)
            assert doc["version"] == TIER_INDEX_VERSION
            doc["version"] = 99
            with open(path, "w") as f:
                json.dump(doc, f)

    eng = _scenario(tiny, tmp_path, oracle, skew)["port"][0]
    assert eng._store_restored_nodes == 0


def test_missing_page_object_breaks_chain_not_engine(tiny, tmp_path, oracle):
    def remove(root):
        pages = sorted(f for f in os.listdir(root)
                       if f.startswith("kvnode_"))
        assert len(pages) >= 2
        remove.n = len(pages)
        os.remove(os.path.join(root, pages[1]))     # mid-chain object

    eng = _scenario(tiny, tmp_path, oracle, remove)["port"][0]
    assert 0 < eng._store_restored_nodes < remove.n


# ---------------------------------------------------------------------------
# an abort while a restore plan is pending
# ---------------------------------------------------------------------------

def test_release_discards_pending_restore_plan(tmp_path):
    """`release` between `allocate_prefixed` (which plans a restore) and
    `take_restore` discards the plan; the planned nodes stay in the tier
    and match again; both caches alike."""
    got = []
    for name, cache_cls, tier_cls in (("reference", RefCache, RefTier),
                                      ("port", PagedKVCache, HostKVTier)):
        mgr = cache_cls(num_pages=9, page_size=4, num_slots=2,
                        max_pages_per_slot=8)
        tier = tier_cls(spill_dir=str(tmp_path / name), disk_pages=64)
        mgr.attach_tier(tier, lambda nodes: {nd.node_id for nd in nodes})
        toks = np.arange(12, dtype=np.int32)
        mgr.allocate(0, 12)
        mgr.lengths[0] = 12
        mgr.register_prefix(0, toks, 12)
        mgr.release(0)
        # park the whole chain in the tier (the engine's bookkeeping)
        full, partial = mgr._match(toks)
        for nd in list(full) + [partial[0]]:
            mgr._lru.pop(nd.node_id)
            mgr._free.append(nd.page)
            del mgr._page_node[nd.page]
            nd.page = -1
            mgr._tier_nodes[nd.node_id] = nd
            tier.add_pending(nd.node_id)
            tier.fill(nd.node_id, {"k": np.zeros((4,), np.float32)})
        mgr.check_invariants()
        _, matched, _ = mgr.allocate_prefixed(0, 12, toks)
        assert matched > 0 and mgr._restore_plan.get(0)
        mgr.check_invariants()
        mgr.release(0)
        assert not mgr._restore_plan, "release leaked the plan"
        mgr.check_invariants()
        _, matched2, _ = mgr.allocate_prefixed(1, 12, toks)
        assert matched2 == matched
        plan = mgr.take_restore(1)
        assert plan
        mgr.release(1)
        mgr.check_invariants()
        got.append((matched, [(d, nd.node_id, n) for d, nd, n in plan],
                    mgr.prefix_stats()))
    assert got[0] == got[1]


def test_port_cache_catches_a_stranded_plan(tmp_path):
    """The restore-plan partition of the port's `check_invariants`: a plan
    left for a released slot, or one naming a page the slot does not
    hold, is caught."""
    mgr = PagedKVCache(num_pages=9, page_size=4, num_slots=2,
                       max_pages_per_slot=8)
    mgr.attach_tier(HostKVTier(), lambda nodes: {nd.node_id for nd in nodes})
    toks = np.arange(8, dtype=np.int32)
    mgr.allocate(0, 8)
    mgr.register_prefix(0, toks, 8)
    mgr.release(0)
    mgr.spill_lru(list(mgr._lru.values()))
    for nid in list(mgr._tier._host):
        mgr._tier.fill(nid, {"k": np.zeros((4,), np.float32)})
    mgr.check_invariants()
    mgr.allocate_prefixed(0, 9, np.arange(9, dtype=np.int32))
    plan = mgr._restore_plan[0]
    mgr._restore_plan[0] = [(8, plan[0][1], plan[0][2])]
    with pytest.raises(AssertionError, match="foreign page"):
        mgr.check_invariants()
    mgr._restore_plan[0] = plan
    mgr._used[0], used = [], mgr._used[0]
    with pytest.raises(AssertionError):
        mgr.check_invariants()
    mgr._used[0] = used
    mgr.release(0)
    mgr.check_invariants()


def test_engine_abort_between_plan_and_restore(tiny, tmp_path, oracle):
    """Aborting a queued request whose admission would restore leaves no
    plan, and the session stays restorable."""
    got = []
    for name, port in (("reference", False), ("port", True)):
        root = str(tmp_path / name)
        conv2, _ = _serve_and_export(tiny, port, root, oracle)
        eng = _engine(tiny, port, spill_dir=root)
        rid = eng.add_request(conv2, max_new_tokens=5)
        assert eng.abort(rid)
        eng.cache.check_invariants()
        out = _result(eng, eng.add_request(conv2, max_new_tokens=5))
        assert list(out.token_ids) == oracle[7][2], name
        eng.cache.check_invariants()
        got.append({k: eng.stats()["kv_tier"][k] for k in TIER_STATS})
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# across the frameworks, on one store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(False, True), (True, False)],
                         ids=["jax_to_port", "port_to_jax"])
def test_handoff_across_frameworks(tiny, tmp_path, oracle, writer, reader):
    """One framework's engine exports turn 1 (pages and `kvindex_*` blob);
    the other's, on the same store, restores it with one scatter and
    continues the cold re-prefill's greedy stream."""
    root = str(tmp_path)
    conv2, exp = _serve_and_export(tiny, writer, root, oracle)
    eng = _engine(tiny, reader, spill_dir=root, role="decode")
    assert eng._store_restored_nodes == exp["index_nodes"] > 0
    calls = _count_scatters(eng)
    out = _result(eng, eng.add_request(conv2, max_new_tokens=5))
    assert list(out.token_ids) == oracle[7][2]
    assert len(calls) == 1
    cold = _engine(tiny, reader)
    _result(cold, cold.add_request(conv2, max_new_tokens=5))
    restored = [nd for nd in eng.cache._index.values() if nd.page >= 0]
    assert len(restored) * 8 >= exp["tokens"] - 8
    for nd in restored:         # the handed-over KV is the computed KV
        want = cold.cache._index[nd.key]
        for n in cold._pool:
            np.testing.assert_allclose(
                np.asarray(eng._pool[n])[:, nd.page, :nd.n_tokens],
                np.asarray(cold._pool[n])[:, want.page, :nd.n_tokens],
                rtol=1e-4, atol=1e-4)
    st = eng.stats()["kv_tier"]
    assert st["restores"] == 1 and st["disk_restores"] == exp["pages"]
    assert st["restored_tokens"] == exp["tokens"]
    assert out.cached_tokens == exp["tokens"]
    eng.cache.check_invariants()


def test_both_writers_on_one_store(tiny, tmp_path, oracle):
    """A JAX engine and a port engine in one process export two sessions
    to one directory: their index blobs and page objects do not collide,
    and a reader of either framework restores both."""
    root = str(tmp_path)
    names = []
    for port, seed in ((False, 7), (True, 8)):
        before = set(os.listdir(root)) if os.path.isdir(root) else set()
        _serve_and_export(tiny, port, root, oracle, seed)
        names.append(set(os.listdir(root)) - before)
    assert all(any(n.startswith("kvindex_") for n in new) for new in names)
    assert all(any(n.startswith("kvnode_") for n in new) for new in names)
    everything = set(os.listdir(root))
    assert names[0] <= everything and names[1] <= everything
    for port in (False, True):
        eng = _engine(tiny, port, spill_dir=root, role="decode")
        assert eng.stats()["role"] == "decode"
        for seed in (7, 8):
            _, conv2, ref = oracle[seed]
            out = _result(eng, eng.add_request(conv2, max_new_tokens=5))
            assert list(out.token_ids) == ref, (port, seed)
        st = eng.stats()["kv_tier"]
        assert st["restores"] == 2 and st["disk_restores"] > 0
        eng.cache.check_invariants()
    assert set(os.listdir(root)) == everything      # shared objects kept


def test_store_object_that_does_not_fit_degrades(tiny, tmp_path, oracle):
    """A page object whose lanes are of another type than the pool's is
    handled like a vanished one: the restore drops its plan and the
    request re-prefills, with the cold stream and no crash."""
    root = str(tmp_path)
    conv2, _ = _serve_and_export(tiny, True, root, oracle)
    bad = sorted(f for f in os.listdir(root) if f.startswith("kvnode_"))[0]
    with np.load(os.path.join(root, bad)) as z:
        lanes = {k: z[k].astype(np.float16) for k in z.files}
    np.savez(os.path.join(root, bad), **lanes)
    eng = _engine(tiny, True, spill_dir=root)
    out = _result(eng, eng.add_request(conv2, max_new_tokens=5))
    assert list(out.token_ids) == oracle[7][2]
    st = eng.stats()["kv_tier"]
    assert st["restores"] == 0 and st["disk_restores"] > 0
    assert eng.stats()["swap_in_dispatches"] == 0
    eng.cache.check_invariants()


def test_bfloat16_lanes_keep_their_bits_through_the_store(tmp_path):
    """A bfloat16 lane goes to the store as its raw 2-byte pattern (the
    bytes an npz of the reference's bfloat16 array holds) and comes back
    with the same bits, from either framework's writer."""
    import ml_dtypes
    import torch

    from paddle_tpu_torch.inference.cache import (LocalDirStore,
                                                  lane_to_numpy,
                                                  lane_to_tensor)
    t = torch.randn((2, 8, 2, 16)).to(torch.bfloat16)
    ref = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    store = LocalDirStore(str(tmp_path))
    store.put("port", {"k": lane_to_numpy(t)})
    np.savez(os.path.join(str(tmp_path), "jax.npz"), k=ref)
    for name in ("port", "jax"):
        got = lane_to_tensor(store.get(name)["k"], torch.bfloat16)
        assert torch.equal(got.view(torch.int16), t.view(torch.int16))
    assert torch.equal(lane_to_tensor(ref, torch.bfloat16).view(torch.int16),
                       t.view(torch.int16))
    with pytest.raises(KeyError):
        lane_to_tensor(store.get("port")["k"], torch.float32)
