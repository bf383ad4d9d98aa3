"""Context parallelism on the CPU: the port's ring attention
(`parallel/ring_attention.py`) and `HybridParallelTrainer(MeshConfig(cp=))`
over a gloo mesh, against the JAX reference — the twins of the cp half of
`tests/test_ring_attention_cp.py`, and more.

One module-scoped mesh of 8 ranks (`serving_mesh(8, ["cpu"] * 8)`)
carries every ring and trainer of the module; fewer ranks run on its first
ones (`mesh.first(n)`).  The ring is held to the reference's
`ring_attention` on a 4-device CPU mesh and to `attention_xla` (outputs
2e-5, gradients 2e-4), on both of the port's routes: the plain version
and the kernel route, whose kernels take their plain versions on CPU
tensors.  The trainers start from the JAX trainer's own weights (seed 3)
and hold their losses over the steps and their gathered parameters after
the last to the single-device JAX trainer at rtol 1e-4, atol 1e-4 (the
reference's cp tests hold the losses at rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from paddle_tpu.incubate.kernels.flash_attention import attention_xla
from paddle_tpu.models import gpt as G
from paddle_tpu.parallel import hybrid as JH
from paddle_tpu.parallel.ring_attention import ring_attention as jax_ring
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
from paddle_tpu_torch.parallel.hybrid import _leaves, _names
from paddle_tpu_torch.parallel.ring_attention import ring_attention
from paddle_tpu_torch.parallel.tp import serving_mesh
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
TOL = dict(rtol=1e-4, atol=1e-4)
RANKS = 8
MESH_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def mesh():
    m = serving_mesh(RANKS, ["cpu"] * RANKS, timeout_s=MESH_TIMEOUT_S)
    yield m
    m.close()


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.RandomState(0)
    return tuple(rng.randn(2, 64, 4, 16).astype(np.float32)
                 for _ in range(3))


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


# ---------------------------------------------------------------------------
# ring attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "kernels"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_reference(mesh, qkv, causal, route):
    jmesh = Mesh(np.array(jax.devices()[:4]), ("cp",))
    jq, jk, jv = map(jnp.asarray, qkv)
    ref = np.asarray(jax_ring(jq, jk, jv, jmesh, causal=causal))
    dense = np.asarray(attention_xla(jq, jk, jv, causal=causal))
    with torch.no_grad():
        out = ring_attention(*map(_t, qkv), mesh.first(4), causal=causal,
                             route=route).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    np.testing.assert_allclose(out, dense, atol=2e-5)


@pytest.fixture(scope="module")
def jax_grads(qkv):
    """The gradients of sum(out ** 2) for q, k and v through the
    reference's ring (4-device CPU mesh) and through `attention_xla`."""
    jmesh = Mesh(np.array(jax.devices()[:4]), ("cp",))
    jargs = tuple(map(jnp.asarray, qkv))
    ring = jax.grad(lambda *a: (jax_ring(*a, jmesh) ** 2).sum(),
                    argnums=(0, 1, 2))(*jargs)
    dense = jax.grad(lambda *a: (attention_xla(*a, causal=True) ** 2).sum(),
                     argnums=(0, 1, 2))(*jargs)
    return ring, dense


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_ring_attention_grads(mesh, qkv, jax_grads, route):
    targs = tuple(_t(a, grad=True) for a in qkv)
    out = ring_attention(*targs, mesh.first(4), route=route)
    got = torch.autograd.grad((out ** 2).sum(), targs)
    for want in jax_grads:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_ring_attention_sends_kv_heads_and_widens_on_the_rank(mesh, route):
    """Grouped-query chunks travel with their KVH heads: q 4 heads, k/v 2,
    against `attention_xla` on k/v widened to 4 (values and the gradients
    of the narrow k/v); each hop moves the [2, B, S/cp, KVH, D] chunk."""
    rng = np.random.RandomState(1)
    q = rng.randn(2, 64, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 64, 2, 16).astype(np.float32) for _ in range(2))

    def ref_loss(q_, k_, v_):
        wide = [jnp.repeat(t, 2, axis=2) for t in (k_, v_)]
        return (attention_xla(q_, *wide, causal=True) ** 2).sum()

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))
    targs = tuple(_t(a, grad=True) for a in (q, k, v))
    sub = mesh.first(4)
    sub.comm.clear()
    got = torch.autograd.grad(
        (ring_attention(*targs, sub, route=route) ** 2).sum(), targs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)
    # rank 0's traffic: 3 hops forward, 3 back, 2 * 2 * 16 * 2 * 16 * 4 B
    chunk = 2 * 2 * 16 * 2 * 16 * 4
    assert sub.comm["cp_next.send"] == [3, 3 * chunk]
    assert sub.comm["cp_prev.send"] == [3, 3 * chunk]


# ---------------------------------------------------------------------------
# the trainer under cp
# ---------------------------------------------------------------------------

def _deep(gpt, seq):
    return gpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=4,
                         num_heads=4, max_seq_len=seq)


def _no_rope(gpt, seq):
    cfg = gpt.gpt_tiny(seq)
    cfg.use_rope = False
    return cfg


PRESETS = {"gpt": (G.gpt_tiny, TG.gpt_tiny),
           "no_rope": (lambda s: _no_rope(G, s), lambda s: _no_rope(TG, s)),
           "deep": (lambda s: _deep(G, s), lambda s: _deep(TG, s)),
           "llama": (G.llama_tiny, TG.llama_tiny)}

_JAX = {}


def _jax_run(preset, seq=128, steps=3, batch=4):
    """The single-device JAX trainer's run (cached): initial weights, the
    losses, the final params, on the reference test's data."""
    key = (preset, seq, steps, batch)
    if key not in _JAX:
        jcfg = PRESETS[preset][0](seq)
        jt = JH.HybridParallelTrainer(jcfg, JH.MeshConfig(), seed=3,
                                      devices=jax.devices()[:1])
        init = jax.tree_util.tree_map(np.asarray, jt.params)
        rng = np.random.RandomState(0)
        tok = rng.randint(0, jcfg.vocab_size, (batch, seq)).astype(np.int32)
        lab = np.roll(tok, -1, 1).astype(np.int32)
        losses = [float(jt.train_step(tok, lab)) for _ in range(steps)]
        _JAX[key] = dict(init=init, losses=losses, data=(tok, lab),
                         params=jax.tree_util.tree_map(np.asarray,
                                                       jt.params))
    return _JAX[key]


def _port(preset, mc, mesh, seq=128, steps=3, batch=4):
    ref = _jax_run(preset, seq, steps, batch)
    tcfg = PRESETS[preset][1](seq)
    tr = HybridParallelTrainer(tcfg, mc, mesh=mesh.first(mc.size),
                               params=params_from_numpy(ref["init"], tcfg,
                                                        "cpu"))
    return tr, ref


def _hold(tr, ref, steps=3):
    tok, lab = ref["data"]
    losses = [float(tr.train_step(tok, lab)) for _ in range(steps)]
    np.testing.assert_allclose(losses, ref["losses"], **TOL)
    got = tr.gathered_state(("params",))["params"]
    for n, a, b in zip(_names(ref["params"]), _leaves(got),
                       _leaves(ref["params"])):
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=n, **TOL)


def test_cp_trainer_matches_single(mesh):
    tr, ref = _port("gpt", MeshConfig(cp=4), mesh)
    _hold(tr, ref)


def test_cp_composes_with_dp_mp_remat(mesh):
    tr, ref = _port("gpt", MeshConfig(dp=2, cp=2, mp=2, remat=True), mesh)
    _hold(tr, ref)


def test_cp_nonrope_positions(mesh):
    """Learned positions: each cp rank adds `wpe` at its shard's global
    rows (2 steps, as the reference's case)."""
    tr, ref = _port("no_rope", MeshConfig(cp=2), mesh, steps=2)
    _hold(tr, ref, steps=2)


@pytest.mark.parametrize("kw", [
    dict(cp=2, mp=2, sequence_parallel=True),
    dict(cp=2, sharding=2, sharding_stage=3, remat=True)],
    ids=["cp2_mp2_sp", "cp2_sh2_z3_remat"])
def test_cp_with_llama_gqa_sequence_parallel_and_zero3(mesh, kw):
    """llama_tiny (GQA: the chunks travel with the rank's kv heads, rope
    at global positions) under sequence parallelism, where a rank's block
    input holds S / (cp mp) rows, and under ZeRO-3 with remat."""
    tr, ref = _port("llama", MeshConfig(**kw), mesh, seq=64)
    _hold(tr, ref)


PIPELINES = {
    "pp2_cp2": MeshConfig(pp=2, cp=2, micro_batches=2),
    "dp2_pp2_cp2_remat": MeshConfig(dp=2, pp=2, cp=2, micro_batches=2,
                                    remat=True),
    "pp2_vpp2_cp2": MeshConfig(pp=2, cp=2, vpp=2, micro_batches=2),
}


@pytest.mark.parametrize("mc", list(PIPELINES.values()), ids=list(PIPELINES))
def test_cp_composes_with_pipeline(mesh, mc):
    """cp inside the pipeline's stages: each stage's blocks run the ring
    over the ranks of its cp coordinate, the stage links join ranks of the
    same cp coordinate; against the single-device JAX trainer (the
    reference's twin of these is slow for JAX's compile time)."""
    tr, ref = _port("deep", mc, mesh)
    _hold(tr, ref)


@pytest.mark.parametrize("kw", [dict(cp=4), dict(pp=2, cp=2,
                                                 micro_batches=2,
                                                 remat=True)],
                         ids=["cp4", "pp2_cp2_remat"])
def test_a_step_sends_what_the_docstring_says(mesh, kw):
    """Ring sends a rank a step: layers (of its stage) x microbatches x 2
    (cp - 1), half on each link, each 2 * B * S/cp * KVH * hd * 4 bytes;
    remat does not run the ring again.  eval_loss: the forward's half."""
    tr, ref = _port("deep", MeshConfig(**kw), mesh)
    mc, cfg = tr.cfg, tr.config
    tok, lab = ref["data"]
    tr.reset_rank_stats()
    tr.train_step(tok, lab)
    per = cfg.num_layers // mc.pp * (mc.cp - 1)
    rows = tok.shape[0] // mc.micro_batches
    chunk = 2 * rows * (tok.shape[1] // mc.cp) * cfg.kv_heads * \
        cfg.head_dim * 4
    for stats in tr.rank_stats():
        comm = stats["comm"]
        for link in ("cp_next", "cp_prev"):
            calls = per * mc.micro_batches
            assert comm[f"{link}.send"] == [calls, calls * chunk], comm
            assert comm[f"{link}.recv"] == [calls, calls * chunk], comm
    tr.reset_rank_stats()
    tr.eval_loss(tok, lab)
    for stats in tr.rank_stats():
        assert stats["comm"]["cp_next.send"][0] == per
        assert "cp_prev.send" not in stats["comm"]


def test_cp_eval_loss(mesh):
    ref = _jax_run("gpt")
    jcfg = G.gpt_tiny(128)
    jt = JH.HybridParallelTrainer(jcfg, JH.MeshConfig(), seed=3,
                                  devices=jax.devices()[:1])
    want = float(jt.eval_loss(*ref["data"]))
    tr, _ = _port("gpt", MeshConfig(dp=2, cp=2), mesh)
    np.testing.assert_allclose(float(tr.eval_loss(*ref["data"])), want,
                               **TOL)


def test_cp_with_ep_raises_the_reference_assertion():
    cfg = TG.gpt_moe_tiny(64)
    with pytest.raises(AssertionError, match="cp x ep is not supported yet"):
        HybridParallelTrainer(cfg, MeshConfig(cp=2, ep=2), device="cpu")
    with pytest.raises(AssertionError, match="cp x ep"):
        JH.HybridParallelTrainer(G.gpt_moe_tiny(64),
                                 JH.MeshConfig(cp=2, ep=2), seed=0,
                                 devices=jax.devices()[:4])


def _ring_hops(n, *, mesh):
    """One forward and one backward hop on the ring of the first n ranks
    (`ServingMesh.run` calls it by name): what each rank received, the
    ring's group, and whether its process group is the mesh's one
    "cp_ring" process group over those ranks."""
    from paddle_tpu_torch.parallel.ring_attention import RingLink, ring_group
    r = mesh.rank
    if r >= n:
        return None
    link = RingLink.of(ring_group(mesh, list(range(n))), r, n)
    x = torch.arange(6.0).reshape(2, 3) + 10 * r
    fwd = link.forward_hop(x).wait()
    bwd = link.backward_hop(x + 100).wait()
    return {"fwd": fwd, "bwd": bwd, "name": link.group.name,
            "ranks": link.group.ranks,
            "one_pg": link.group.pg is mesh._pgs[("link",) + tuple(range(n))]}


@pytest.mark.parametrize("route", ["plain", "kernels"])
def test_ring_hops_use_one_cp_group(mesh, route):
    """Each hop sends and receives on the ring's one process group over
    its cp ranks ("cp_ring"): a forward hop brings rank - 1's tensor, a
    backward hop rank + 1's.  A ring call on either route keeps the
    traffic of the docstring, counted by direction: per rank cp - 1 sends
    of [2, B, S/cp, KVH, D] each way and as many receives, bytes equal."""
    n = 4
    outs = mesh.run(_ring_hops, [((n,), {})] * RANKS)[:n]
    for r, o in enumerate(outs):
        base = torch.arange(6.0).reshape(2, 3)
        torch.testing.assert_close(o["fwd"], base + 10 * ((r - 1) % n))
        torch.testing.assert_close(o["bwd"], base + 10 * ((r + 1) % n) + 100)
        assert (o["name"], o["ranks"], o["one_pg"]) == \
            ("cp_ring", tuple(range(n)), True)
    rng = np.random.RandomState(2)
    q = rng.randn(2, 64, 4, 16).astype(np.float32)
    k, v = (rng.randn(2, 64, 2, 16).astype(np.float32) for _ in range(2))
    sub = mesh.first(n)
    sub.comm.clear()
    args = tuple(_t(a, grad=True) for a in (q, k, v))
    torch.autograd.grad(ring_attention(*args, sub, route=route).sum(), args)
    chunk = 2 * 2 * 16 * 2 * 16 * 4
    want = [n - 1, (n - 1) * chunk]
    assert {key: sub.comm[key] for key in sub.comm if key.startswith("cp_")} \
        == {"cp_next.send": want, "cp_prev.recv": want,
            "cp_prev.send": want, "cp_next.recv": want}


def test_sequence_must_divide_over_cp(mesh):
    tr, _ = _port("gpt", MeshConfig(cp=4), mesh)
    tok = np.zeros((4, 126), np.int32)
    with pytest.raises(AssertionError, match="must divide over cp=4"):
        tr.train_step(tok, tok)


@pytest.mark.parametrize("kw", [dict(cp=2), dict(dp=2, cp=2)],
                         ids=["cp2", "dp2_cp2"])
def test_moe_under_cp_matches_the_jax_trainer_on_the_same_mesh(mesh, kw):
    """MoE blocks under cp (ep 1): each cp rank routes its sequence shard
    (with the other data ranks' rows at the same shard, a capacity group
    of the reference's), the aux divided by cp; losses and parameters
    against the JAX trainer on the same MeshConfig, drops on."""
    jcfg, tcfg = G.gpt_moe_tiny(64), TG.gpt_moe_tiny(64)
    jcfg.moe_capacity_factor = tcfg.moe_capacity_factor = 1.0
    jt = JH.HybridParallelTrainer(jcfg, JH.MeshConfig(**kw), seed=3,
                                  devices=jax.devices()[:2 * len(kw)])
    init = jax.tree_util.tree_map(np.asarray, jt.params)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, jcfg.vocab_size, (4, 64)).astype(np.int32)
    lab = np.roll(tok, -1, 1).astype(np.int32)
    want = [float(jt.train_step(tok, lab)) for _ in range(3)]
    mc = MeshConfig(**kw)
    tr = HybridParallelTrainer(tcfg, mc, mesh=mesh.first(mc.size),
                               params=params_from_numpy(init, tcfg, "cpu"))
    got = [float(tr.train_step(tok, lab)) for _ in range(3)]
    np.testing.assert_allclose(got, want, **TOL)
    ref = jax.tree_util.tree_map(np.asarray, jt.params)
    params = tr.gathered_state(("params",))["params"]
    for n, a, b in zip(_names(ref), _leaves(params), _leaves(ref)):
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=n, **TOL)
