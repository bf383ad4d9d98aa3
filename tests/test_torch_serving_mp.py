"""Tensor-parallel serving on the CPU: the port's `LLMEngine(mp=N)` over a
gloo `ServingMesh` against the JAX reference engine — the twins of
`tests/test_serving_mp.py`.

Each mesh degree is started once for the module (`meshes`: mp 2 and 4,
worker processes on the CPU), and every port engine of the module serves
on it in turn.  The reference engines run unwarmed, with the reference
test's own geometry, `gpt_tiny` in f32; one case is held against the
reference's own `mp=2` engine (8 forced CPU devices, `tests/conftest.py`),
the rest against its `mp=1` engine, which the reference holds token-equal
to its mp engines.  A divergence passes only as a near-tie of the
reference's logits, reported (`test_torch_engine._assert_greedy_parity`).

The head-sharded kernel twins run each rank's heads through the port's
`paged_*_mp` entries on the mesh and gather them against the reference's
oracle.  The last tests hold the mesh's own rules: a worker's error raises
on rank 0, no fixed port, NCCL refused without a card a rank, and a worker
dies with its parent.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.paged_attention import (
    paged_attention_xla, paged_prefill_attention_xla)
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    _check_mp_heads, paged_attention_decode_mp, paged_prefill_attention_mp)
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel import hybrid as TH
from paddle_tpu_torch.parallel.tp import all_reduce, serving_mesh
from test_torch_engine import _assert_greedy_parity
from test_torch_quantized import _preempt_prompts
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TINY, TTINY = G.gpt_tiny(128), TG.gpt_tiny(128)
# a test's collectives and worker replies give up after this
MESH_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def meshes():
    """mp -> a gloo ServingMesh on the CPU, started at first use."""
    made = {}

    def get(mp):
        if mp not in made:
            made[mp] = serving_mesh(mp, ["cpu"] * mp,
                                    timeout_s=MESH_TIMEOUT_S)
        return made[mp]
    yield get
    for m in made.values():
        m.close()


@pytest.fixture(scope="module")
def params():
    return G.init_params(TINY, jax.random.key(0))


@pytest.fixture(scope="module")
def tparams(params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             TTINY, "cpu")


def _stream(seed=7, n=10):
    """The reference test's stream: random prompts and a shared prefix
    (full-page shares, a bare-prefix donor, non-aligned tails, so COW
    fires)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, TINY.vocab_size, (20,)).astype(np.int32)
    prompts = []
    for i in range(n):
        if i % 3 == 0:
            tail = int(rng.randint(0, 8))
            ext = rng.randint(0, TINY.vocab_size, (tail,)).astype(np.int32)
            prompts.append(np.concatenate([shared, ext]) if tail
                           else shared.copy())
        else:
            prompts.append(rng.randint(0, TINY.vocab_size,
                                       (rng.randint(1, 50),)).astype(np.int32))
    return prompts


def _kw(spec_len, chunk):
    return dict(num_slots=4, page_size=8, max_model_len=64,
                prefill_chunk=chunk, prefix_cache=True, spec_len=spec_len)


def _run_ref(params, config, mp, spec_len, prompts, chunk=16,
             abort_rid=None):
    eng = JaxEngine(params, config, mp=mp, **_kw(spec_len, chunk))
    rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    if abort_rid is not None:
        for _ in range(3):
            eng.step()
        eng.abort(rids[abort_rid])
    outs = eng.run()
    eng.cache.check_invariants()
    return outs


def _run_port(tparams, config, mesh, spec_len, prompts, chunk=16,
              abort_rid=None, **extra):
    eng = LLMEngine(tparams, config, device="cpu", mesh=mesh,
                    **_kw(spec_len, chunk), **extra)
    rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    if abort_rid is not None:
        for _ in range(3):
            eng.step()
            eng.cache.check_invariants()
        assert eng.abort(rids[abort_rid])
    for _ in range(500):        # bounded: a fault fails, never hangs
        if not eng.has_work:
            break
        eng.step()
        eng.cache.check_invariants()
    assert not eng.has_work
    return eng.outputs, eng.stats(), eng


@pytest.fixture(scope="module")
def single_chip(params):
    return _run_ref(params, TINY, 1, 0, _stream())


# ---------------------------------------------------------------------------
# engine token parity: mp vs single chip
# ---------------------------------------------------------------------------

def test_mp2_greedy_token_parity_chunked_prefix(params, tparams, meshes,
                                                single_chip):
    """mp=2, prefix cache and chunked prefill on, spec off: the reference's
    own mp=2 engine's streams and its mp=1 engine's, one decode-side
    program, pool invariants clean, pages shared."""
    outs, st, eng = _run_port(tparams, TTINY, meshes(2), 0, _stream())
    _assert_greedy_parity(single_chip, outs, params, TINY)
    ref_mp2 = _run_ref(params, TINY, 2, 0, _stream())
    _assert_greedy_parity(ref_mp2, outs, params, TINY)
    assert st["mp"] == 2
    assert st["decode_executables"] + st["verify_executables"] <= 2
    assert st["prefill_executables"] <= 2
    assert st["prefix_hit_requests"] > 0
    from paddle_tpu.analysis.registry import SERVE_PROGRAM_BUDGET_MP as REF
    from paddle_tpu_torch.analysis.registry import (SERVE_PROGRAM_BUDGET_MP,
                                                    over_budget)
    assert SERVE_PROGRAM_BUDGET_MP == REF and not over_budget(st)
    # each rank holds half the kv heads of every page
    assert eng._pool["k"].shape[3] == TTINY.kv_heads // 2
    assert eng.rank_pool_bytes() == [eng.kv_pool_bytes()] * 2


def test_mp2_spec_on_token_parity(params, tparams, meshes, single_chip):
    """Speculative decoding under mp=2 stays lossless."""
    outs, st, _ = _run_port(tparams, TTINY, meshes(2), 3, _stream())
    _assert_greedy_parity(single_chip, outs, params, TINY)
    assert st["decode_executables"] + st["verify_executables"] <= 2
    assert st["spec_drafted_tokens"] >= 0


@pytest.mark.slow
def test_mp4_spec_token_parity(params, tparams, meshes, single_chip):
    """mp=4 (one kv head a rank)."""
    outs, st, _ = _run_port(tparams, TTINY, meshes(4), 3, _stream())
    _assert_greedy_parity(single_chip, outs, params, TINY)
    assert st["mp"] == 4
    assert st["decode_executables"] + st["verify_executables"] <= 2


@pytest.mark.slow
def test_mp2_bucketed_prefill_parity(params, tparams, meshes):
    """Bucketed one-shot prefill under mp (each rank's heads through the
    dense flash forward)."""
    base = _run_ref(params, TINY, 1, 0, _stream(seed=9, n=6), chunk=None)
    outs, _, _ = _run_port(tparams, TTINY, meshes(2), 0,
                           _stream(seed=9, n=6), chunk=None)
    _assert_greedy_parity(base, outs, params, TINY)


@pytest.mark.slow
def test_mp2_llama_gqa_parity(meshes):
    """GQA (llama_tiny, 2 kv heads, one a rank) under mp=2."""
    config, tconfig = G.llama_tiny(128), TG.llama_tiny(128)
    params = G.init_params(config, jax.random.key(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                           tconfig, "cpu")
    prompts = [np.random.RandomState(i).randint(
        0, config.vocab_size, (1 + 5 * i,)).astype(np.int32)
        for i in range(5)]
    base = _run_ref(params, config, 1, 3, prompts)
    outs, _, _ = _run_port(tp, tconfig, meshes(2), 3, prompts)
    _assert_greedy_parity(base, outs, params, config)


def test_mp2_abort_midrun_keeps_invariants(params, tparams, meshes):
    """abort() under mp frees and derefs pages as on one device (the cache
    manager lives on rank 0 alone); the survivors match the reference's
    run of the same abort schedule."""
    base = _run_ref(params, TINY, 1, 0, _stream(seed=11, n=8), abort_rid=5)
    outs, _, _ = _run_port(tparams, TTINY, meshes(2), 0,
                           _stream(seed=11, n=8), abort_rid=5)
    _assert_greedy_parity(base, outs, params, TINY)


def test_mp_rejects_indivisible_heads(tparams):
    """mp=3 on 4 heads raises before any worker starts."""
    with pytest.raises(ValueError, match="divide"):
        LLMEngine(tparams, TTINY, device="cpu", num_slots=2, page_size=8,
                  max_model_len=64, mp=3)


# ---------------------------------------------------------------------------
# the modes the reference marks slow, at both degrees, and the host paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [2, 4])
def test_bucketed_and_gqa_streams_at_mp(meshes, mp):
    """Bucketed prefill with spec on, the modes the reference runs only in
    its slow set: llama_tiny (GQA, RMSNorm, SwiGLU, untied head; its 2 kv
    heads one a rank) at mp 2, gpt_tiny at mp 4; the reference mp=1
    engine's streams."""
    if mp == 2:
        config, tconfig = G.llama_tiny(128), TG.llama_tiny(128)
    else:
        config, tconfig = TINY, TTINY
    params = G.init_params(config, jax.random.key(2))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                           tconfig, "cpu")
    prompts = _stream(seed=5, n=6)
    base = _run_ref(params, config, 1, 2, prompts, chunk=None)
    outs, st, _ = _run_port(tp, tconfig, meshes(mp), 2, prompts, chunk=None)
    _assert_greedy_parity(base, outs, params, config)
    assert st["prefill_executables"] >= 1 and st["mp"] == mp


def _drain(eng):
    for _ in range(1000):
        if not eng.has_work:
            break
        eng.step()
        if isinstance(eng, LLMEngine):
            eng.cache.check_invariants()
    assert not eng.has_work
    return eng.outputs if isinstance(eng, LLMEngine) else eng._outputs


def _session(eng, seed=7, churn=6):
    """`tests/test_kv_tier.py`'s session: a first turn, churn that evicts
    its pages (spills), then the returning turn (a restore)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, 256, (20,)).astype(np.int32)
    r1 = eng.add_request(shared, max_new_tokens=5)
    _drain(eng)
    for _ in range(churn):
        eng.add_request(rng.randint(0, 256, (30,)).astype(np.int32),
                        max_new_tokens=4)
    outs = _drain(eng)
    eng.add_request(np.concatenate([
        shared, np.asarray(outs[r1].token_ids, np.int32),
        rng.randint(0, 256, (4,)).astype(np.int32)]), max_new_tokens=5)
    outs = _drain(eng)
    return [list(outs[r].token_ids) for r in sorted(outs)]


def test_host_paths_keep_the_stream_at_mp2(params, tparams, meshes,
                                           tmp_path):
    """The host copies of the pool under mp, one host slab of the full
    kv-head layout every rank fills or reads its heads of: the tier session
    (spills, a restore) against the reference engine, streams and tier
    counters equal; swap preemption against the mp=1 port engine; and an
    mp=2 export that an mp=1 engine restores (the store keeps mp=1's
    format)."""
    tier = dict(num_slots=2, page_size=8, num_pages=9, max_model_len=64,
                prefill_chunk=16, seed=3, swap_pool_pages=64)
    ref = JaxEngine(params, TINY, **tier)
    want = _session(ref)
    eng = LLMEngine(tparams, TTINY, device="cpu", mesh=meshes(2), **tier)
    assert _session(eng) == want
    rs, ps = ref.stats()["kv_tier"], eng.stats()["kv_tier"]
    for k in ("spills", "restores", "restored_tokens"):
        assert ps[k] == rs[k], k
    assert ps["restores"] >= 1 and ps["spills"] > 0
    assert eng.stats()["swap_in_dispatches"] == ps["restores"]

    prompts = _preempt_prompts(256)
    got = {}
    for mesh in (None, meshes(2)):
        e = LLMEngine(tparams, TTINY, device="cpu", page_size=8,
                      max_model_len=64, prefill_chunk=8, mesh=mesh,
                      num_slots=6, num_pages=9, admission="optimistic",
                      preempt="swap", kv_tier=False)
        rids = [e.add_request(p, max_new_tokens=12) for p in prompts]
        outs = _drain(e)
        st = e.stats()
        got[mesh is None] = ([outs[r].token_ids for r in rids],
                             st["preempt_swaps"], st["swap_in_dispatches"])
    assert got[False] == got[True] and got[True][1] > 0

    d = str(tmp_path / "store")
    a = LLMEngine(tparams, TTINY, device="cpu", page_size=8,
                  max_model_len=64, prefill_chunk=8, spill_dir=d,
                  mesh=meshes(2))
    prompt = np.random.RandomState(3).randint(0, 256, 30).astype(np.int32)
    a.add_request(prompt, max_new_tokens=4)
    _drain(a)
    assert a.export_prefix(prompt)["pages"] >= 3
    b = LLMEngine(tparams, TTINY, device="cpu", page_size=8,
                  max_model_len=64, prefill_chunk=8, spill_dir=d)
    b.add_request(prompt, max_new_tokens=4)
    c = LLMEngine(tparams, TTINY, device="cpu", page_size=8,
                  max_model_len=64, prefill_chunk=8, kv_tier=False)
    c.add_request(prompt, max_new_tokens=4)
    assert _drain(b)[0].token_ids == _drain(c)[0].token_ids
    assert b.stats()["kv_tier"]["restores"] == 1


# ---------------------------------------------------------------------------
# head-sharded kernels vs the oracle (q_len = 1 decode, q_len > 1 verify)
# ---------------------------------------------------------------------------

def _pool_case(rng, kvh):
    B, T, H, hd, page, P, maxp = 3, 5, 4, 64, 8, 9, 4
    q1 = rng.randn(B, H, hd).astype(np.float32)
    qT = rng.randn(B, T, H, hd).astype(np.float32)
    k = rng.randn(P, page, kvh, hd).astype(np.float32)
    v = rng.randn(P, page, kvh, hd).astype(np.float32)
    tbl = np.zeros((B, maxp), np.int32)
    tbl[0, :3] = [1, 2, 3]
    tbl[1, :2] = [4, 5]
    tbl[2, :4] = [6, 7, 8, 3]
    lengths = np.array([9, 4, 17], np.int32)
    valid = np.array([5, 1, 3], np.int32)
    return q1, qT, k, v, tbl, lengths, valid


def _rank_args(mp, q, k, v, *rest):
    """Each rank's heads of q and kv heads of the pool, the rest whole."""
    H, KVH = q.shape[-2], k.shape[2]
    t = torch.from_numpy
    return [((t(np.ascontiguousarray(q[..., r * H // mp:(r + 1) * H // mp,
                                        :])),
              t(np.ascontiguousarray(k[:, :, r * KVH // mp:
                                        (r + 1) * KVH // mp])),
              t(np.ascontiguousarray(v[:, :, r * KVH // mp:
                                        (r + 1) * KVH // mp])),
              *map(t, rest)), {}) for r in range(mp)]


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
def test_sharded_verify_kernel_matches_oracle_qlen_gt1(meshes, kvh):
    """Each rank's heads through `paged_prefill_attention_mp` (its pool
    shard, the kernel's plain version on the CPU) gather to the unsharded
    oracle's numbers on the real rows."""
    rng = np.random.RandomState(3)
    _, qT, k, v, tbl, lengths, valid = _pool_case(rng, kvh)
    ref = np.asarray(paged_prefill_attention_xla(
        *map(jnp.asarray, (qT, k, v, tbl, lengths, valid))))
    parts = meshes(2).run(paged_prefill_attention_mp,
                          _rank_args(2, qT, k, v, tbl, lengths, valid))
    got = torch.cat(parts, dim=2).numpy()
    for b, n in enumerate(valid):
        np.testing.assert_allclose(got[b, :n], ref[b, :n], atol=2e-5)


@pytest.mark.parametrize("kvh", [4, 2], ids=["mha", "gqa"])
def test_sharded_decode_kernel_matches_oracle(meshes, kvh):
    rng = np.random.RandomState(4)
    q1, _, k, v, tbl, lengths, _ = _pool_case(rng, kvh)
    ref = np.asarray(paged_attention_xla(
        *map(jnp.asarray, (q1, k, v, tbl, lengths))))
    parts = meshes(2).run(paged_attention_decode_mp,
                          _rank_args(2, q1, k, v, tbl, lengths))
    np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(), ref,
                               atol=2e-5)


def test_sharded_kernel_rejects_indivisible_heads():
    """The reference's rule, and a rank's shard that is not whole groups."""
    with pytest.raises(ValueError, match="divisible"):
        _check_mp_heads(4, 4, 8)
    from types import SimpleNamespace
    rng = np.random.RandomState(5)
    q1, _, k, v, tbl, lengths, _ = map(torch.from_numpy, _pool_case(rng, 4))
    with pytest.raises(ValueError, match="kv heads"):
        paged_attention_decode_mp(q1[:, :1], k[:, :, :2], v[:, :, :2], tbl,
                                  lengths, SimpleNamespace(mp=4, rank=0))


# ---------------------------------------------------------------------------
# the serving layout and the mesh's own rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpt_tiny", "llama_tiny"])
def test_serving_specs_and_qkv_perm_match_reference(name):
    """`serving_param_specs` names the reference's "mp" axis of every leaf
    (fp and int8 trees), `qkv_partition_perm` is its permutation, and the
    per-partition unpack restores global head order."""
    from paddle_tpu.parallel import hybrid as RH
    from paddle_tpu.quantization.serving import quantize_serving_params
    from paddle_tpu_torch.quantization.serving import \
        quantize_serving_params as tq
    cfg, tcfg = getattr(G, name)(64), getattr(TG, name)(64)
    params = G.init_params(cfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), tcfg,
                           "cpu")
    for ref_tree, tree in ((params, tp),
                           (quantize_serving_params(params, cfg), tq(tp,
                                                                    tcfg))):
        ref = RH.serving_param_specs(cfg, ref_tree)
        got = TH.serving_param_specs(tcfg, tree)

        def axis(spec):
            return next((i for i, a in enumerate(spec) if a == "mp"), None)
        assert set(got["blocks"]) == set(ref["blocks"])
        for k, s in ref["blocks"].items():
            assert got["blocks"][k] == axis(s), k
        for k, s in ref.items():
            if k != "blocks":
                assert got[k] == axis(s), k
    np.testing.assert_array_equal(TH.qkv_partition_perm(tcfg, 2),
                                  RH.qkv_partition_perm(cfg, 2))
    qkv = torch.randn(3, tcfg.qkv_dim)
    packed = TH.pack_qkv_partitions({"blocks": {"qkv_b": qkv}}, tcfg, 2)
    for a, b in zip(TG._unpack_qkv(packed["blocks"]["qkv_b"], tcfg, parts=2),
                    TG._unpack_qkv(qkv, tcfg)):
        assert torch.equal(a, b)
    # the shards are the packed leaf's contiguous halves
    sh = [TH.shard_params(tp, tcfg, 2, r) for r in range(2)]
    full = TH.pack_qkv_partitions(tp, tcfg, 2)["blocks"]["qkv_w"]
    assert torch.equal(torch.cat([s["blocks"]["qkv_w"] for s in sh], -1),
                       full)
    assert sh[0]["blocks"]["ln1_w"] is tp["blocks"]["ln1_w"]


def test_worker_error_raises_on_rank0():
    """A worker's exception comes back to rank 0 with its traceback: rank 0
    waits in a collective that the failed worker never joins, and raises
    the worker's error, not a hang."""
    m = serving_mesh(2, ["cpu"] * 2, timeout_s=MESH_TIMEOUT_S)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 failed"):
            m.run(TG.sharded_argmax, [((torch.zeros(2, 4),), {}),
                                      (("not a tensor",), {})])
        assert time.monotonic() - t0 < MESH_TIMEOUT_S
        with pytest.raises(RuntimeError, match="rank 1"):
            m.check_workers()
    finally:
        m.close()
    with pytest.raises(RuntimeError, match="closed"):
        m.query(1, "counts")


def test_mesh_rules(meshes):
    """NCCL is refused without a card a rank (no fallback to gloo); a
    closed mesh refuses work; the store is a file in a fresh directory."""
    with pytest.raises(ValueError, match="one card per rank"):
        serving_mesh(2, ["cuda:0", "cuda:0"], backend="nccl")
    with pytest.raises(ValueError, match="CPU or all CUDA"):
        serving_mesh(2, ["cpu", "cuda:0"], backend="gloo")
    m = meshes(2)
    assert m.mp == 2 and m.backend == "gloo" and os.path.isdir(m._dir)
    for op, want in (("sum", [4.0, 7.0]), ("max", [3.0, 5.0]),
                     ("min", [1.0, 2.0])):
        outs = m.run(all_reduce, [((torch.tensor([1.0, 5.0]), op), {}),
                                  ((torch.tensor([3.0, 2.0]), op), {})])
        assert [o.tolist() for o in outs] == [want, want], op


def test_worker_dies_with_its_parent(tmp_path):
    """A process that makes a mesh and dies without closing it leaves no
    worker behind: the worker watches its parent."""
    script = tmp_path / "orphan.py"
    script.write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from paddle_tpu_torch.parallel.tp import serving_mesh\n"
        "if __name__ == '__main__':\n"
        "    m = serving_mesh(2, ['cpu', 'cpu'], timeout_s=30)\n"
        "    print(m._procs[0].pid, flush=True)\n"
        "    os._exit(0)\n")
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    pid = int(r.stdout.split()[-1])
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.2)
    pytest.fail(f"worker {pid} outlived its parent")
