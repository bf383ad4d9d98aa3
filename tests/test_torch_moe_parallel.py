"""Expert-parallel MoE training on the CPU: the port's `HybridParallelTrainer`
with MoE blocks under ep, pp, dp and sequence parallelism
(`parallel/moe.py`) over a gloo mesh, against the JAX reference trainer —
the twins of `tests/test_moe_parallel.py`, and more.

One module-scoped mesh of 8 ranks carries every port trainer (a trainer
of fewer ranks on its first ones, `mesh.first(size)`); every case starts
from the reference's `init_params` weights (the JAX trainer's own, seed 3)
and holds the port's 3-step losses and gathered parameters to the JAX
trainer's at rtol 1e-4, atol 1e-4.  The reference's own cases turn token
drops off (`capacity_factor` 8, aux weight 0) and compare with one device,
where any routing group gives the same tokens; they cannot see a wrong
group.  The drop-on cases (`capacity_factor` 1.0, the aux weight kept) are
held to the JAX trainer on the same `MeshConfig`, whose routing groups
(the contiguous 1/ep of the step's tokens, of each microbatch's under pp;
all of them at ep 1) the port must reproduce across ranks.
"""
import functools

import jax
import numpy as np
import pytest

from paddle_tpu.models import gpt as G
from paddle_tpu.parallel import hybrid as JH
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
from paddle_tpu_torch.parallel import moe as port_moe
from paddle_tpu_torch.parallel.hybrid import _leaves, _names
from paddle_tpu_torch.parallel.tp import serving_mesh
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
TOL = dict(rtol=1e-4, atol=1e-4)
RANKS = 8
MESH_TIMEOUT_S = 60.0


def _nodrop(gpt):
    # capacity_factor 8 => no token drops => ep/dense math is identical
    c = gpt.gpt_moe_tiny(64, num_experts=4, capacity_factor=8.0)
    c.moe_aux_weight = 0.0
    return c


def _drop(gpt):
    return gpt.gpt_moe_tiny(64, num_experts=4, capacity_factor=1.0)


def _interleaved(gpt):
    return gpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=4,
                         num_heads=4, max_seq_len=64, moe_num_experts=4,
                         moe_capacity_factor=8.0, moe_aux_weight=0.0)


PRESETS = {"nodrop": _nodrop, "drop": _drop, "interleaved": _interleaved,
           "aux": lambda gpt: gpt.gpt_moe_tiny(64, num_experts=4,
                                               capacity_factor=2.0)}


@pytest.fixture(scope="module")
def mesh():
    m = serving_mesh(RANKS, ["cpu"] * RANKS, timeout_s=MESH_TIMEOUT_S)
    yield m
    m.close()


def _data(cfg, B=8, S=64, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1).astype(np.int32)


_JAX = {}


def _jax_run(preset, kw=None):
    """The JAX trainer's 3 steps (cached) on MeshConfig(**kw) (default one
    device): initial weights, losses, final params, eval_loss after."""
    key = (preset, repr(kw))
    if key not in _JAX:
        jcfg = PRESETS[preset](G)
        mc = JH.MeshConfig(**(kw or {}))
        jt = JH.HybridParallelTrainer(jcfg, mc, seed=3,
                                      devices=jax.devices()[:mc.size])
        init = jax.tree_util.tree_map(np.asarray, jt.params)
        tok, lab = _data(jcfg)
        losses = [float(jt.train_step(tok, lab)) for _ in range(3)]
        _JAX[key] = dict(init=init, losses=losses, data=(tok, lab),
                         params=jax.tree_util.tree_map(np.asarray, jt.params),
                         eval=float(jt.eval_loss(tok, lab)), trainer=jt)
    return _JAX[key]


def _port(preset, kw, mesh, ref=None):
    ref = ref or _jax_run(preset)
    tcfg = PRESETS[preset](TG)
    mc = MeshConfig(**kw)
    return HybridParallelTrainer(tcfg, mc, mesh=mesh.first(mc.size),
                                 params=params_from_numpy(ref["init"], tcfg,
                                                          "cpu"))


def _losses(tr, ref, n=3):
    tok, lab = ref["data"]
    return [float(tr.train_step(tok, lab)) for _ in range(n)]


def _assert_params(tr, want):
    got = tr.gathered_state(("params",))
    assert set(got) == {"params", "step"}
    for n, a, b in zip(_names(want), _leaves(got["params"]), _leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=n, **TOL)


def _matches_dense(preset, kw, mesh):
    ref = _jax_run(preset)
    tr = _port(preset, kw, mesh)
    np.testing.assert_allclose(_losses(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


def test_moe_ep2_matches_dense(mesh):
    _matches_dense("nodrop", dict(ep=2), mesh)


def test_moe_pp2_ep2_matches_dense(mesh):
    _matches_dense("nodrop", dict(pp=2, ep=2, micro_batches=2), mesh)


@pytest.mark.slow      # as the reference marks its twin
def test_moe_dp2_ep2_mp2_matches_dense(mesh):
    _matches_dense("nodrop", dict(dp=2, ep=2, mp=2), mesh)


@pytest.mark.slow      # as the reference marks its twin
def test_moe_full_hybrid_dp_pp_ep_zero2_remat(mesh):
    _matches_dense("nodrop", dict(dp=2, pp=2, ep=2, micro_batches=2,
                                  sharding_stage=2, remat=True), mesh)


@pytest.mark.slow      # as the reference marks its twin
def test_moe_interleaved_pp_ep_matches_dense(mesh):
    """vpp x pp x ep: a stage's chunks of expert leaves [L/pp, E/ep, ...]."""
    _matches_dense("interleaved", dict(pp=2, ep=2, vpp=2, micro_batches=2),
                   mesh)


def test_moe_aux_loss_trains(mesh):
    ref = _jax_run("aux")
    assert PRESETS["aux"](TG).moe_aux_weight > 0
    tr = _port("aux", dict(ep=2, mp=2), mesh)
    losses = _losses(tr, ref, n=6)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_expert_params_sharded_over_ep(mesh):
    """ep 4: each rank holds E/4 experts of every expert leaf, the gate
    whole; the shapes are `addressable_shards[r]` of the JAX trainer."""
    jt = JH.HybridParallelTrainer(_nodrop(G), JH.MeshConfig(ep=4), seed=0,
                                  devices=jax.devices()[:4])
    tr = _port("nodrop", dict(ep=4), mesh)
    dev = {d: i for i, d in enumerate(jax.devices())}
    for r, shapes in enumerate(tr.rank_shapes()):
        blocks = shapes["params"]["blocks"]
        assert blocks["exp_fc1_w"][1] == 1
        assert blocks["gate_w"] == tuple(jt.params["blocks"]["gate_w"].shape)
        want = [next(tuple(s.data.shape) for s in leaf.addressable_shards
                     if dev[s.device] == r) for leaf in _leaves(jt.params)]
        assert _leaves(shapes["params"]) == want, r


DROP_LAYOUTS = {"ep2": dict(ep=2), "dp2_ep2": dict(dp=2, ep=2),
                "dp2": dict(dp=2),
                "mp2_sp": dict(mp=2, sequence_parallel=True),
                "pp2_ep2": dict(pp=2, ep=2, micro_batches=2)}


@pytest.mark.parametrize("name", list(DROP_LAYOUTS))
def test_drops_on_match_the_jax_trainer_on_the_same_mesh(mesh, name,
                                                         monkeypatch):
    """Capacity factor 1.0, aux weight kept: the routing groups, their
    capacity, each rank's queue positions and the aux loss of the JAX
    trainer on the same MeshConfig.  Where rank 0 routes a group alone it
    drops tokens (under dp its rows are its group's first, which take the
    first places of every queue)."""
    kw = DROP_LAYOUTS[name]
    jref = _jax_run("drop", kw)
    tr = _port("drop", kw, mesh, jref)
    dropped = []

    def spy(*args):
        slot, keep = slots(*args)
        dropped.append(int((~keep).sum()))
        return slot, keep

    slots = port_moe.capacity_slots
    monkeypatch.setattr(port_moe, "capacity_slots", spy)
    np.testing.assert_allclose(_losses(tr, jref), jref["losses"], **TOL)
    _assert_params(tr, jref["params"])
    if tr._rank0.view.route.size == 1:
        assert sum(dropped) > 0


def _jax_grads(jt, tok, lab):
    """The reference trainer's gradients of its loss (its `loss_of` at pp 1)
    on its own mesh."""
    cfg, config = jt.cfg, jt.config
    moe_impl = functools.partial(JH._moe_ffn_ep, cfg=cfg, mesh=jt.mesh) \
        if cfg.ep > 1 else None

    def loss_of(p, t, lb):
        return G.loss_fn(p, t, lb, config, mp_constraint=jt._mp_constraint,
                         remat=cfg.remat, moe_impl=moe_impl)

    t, lb = jt.shard_batch(tok, lab)
    return jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jax.grad(loss_of))(jt.params, t, lb))


def test_gate_and_expert_gradients_match_at_dp2_ep2(mesh):
    """dp 2 x ep 2, drops on: the gradient of `gate_w` (summed over dp x
    ep) and of an expert leaf (each ep rank's experts, summed over dp)
    equal the JAX trainer's, the aux's share counted once."""
    kw = dict(dp=2, ep=2)
    jt = JH.HybridParallelTrainer(_drop(G), JH.MeshConfig(**kw), seed=3,
                                  devices=jax.devices()[:4])
    init = jax.tree_util.tree_map(np.asarray, jt.params)
    tok, lab = _data(_drop(G))
    want = _jax_grads(jt, tok, lab)["blocks"]
    tcfg = _drop(TG)
    tr = HybridParallelTrainer(tcfg, MeshConfig(**kw), mesh=mesh.first(4),
                               params=params_from_numpy(init, tcfg, "cpu"))
    got = tr.gathered_grads(tok, lab)["blocks"]
    for k in ("gate_w", "exp_fc1_w", "exp_fc2_b"):
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("name", ["ep2", "pp2_ep2"])
def test_eval_loss_routes_the_batch_as_one_group(mesh, name):
    """The reference evaluates with the plain `loss_fn`: one routing group
    over the whole batch, all experts reached through the all-to-all."""
    kw = DROP_LAYOUTS[name]
    jref = _jax_run("drop", kw)
    tr = _port("drop", kw, mesh, jref)
    _losses(tr, jref)
    np.testing.assert_allclose(float(tr.eval_loss(*jref["data"])),
                               jref["eval"], **TOL)


ROUTE_LAYOUTS = {"ep2": ("nodrop", dict(ep=2)),
                 "dp2_mp2_sp": ("nodrop", dict(dp=2, mp=2,
                                               sequence_parallel=True)),
                 "pp2_ep2": ("nodrop", dict(pp=2, ep=2, micro_batches=2)),
                 "pp2_vpp2_ep2": ("interleaved", dict(pp=2, vpp=2, ep=2,
                                                      micro_batches=2))}


@pytest.mark.parametrize("name", list(ROUTE_LAYOUTS))
def test_step_routes_place_every_token(mesh, name):
    """`train_step_routes` puts each rank's logged router choices at their
    layer and token: from the same weights, every token's probabilities
    and top-k experts at every layer equal one device's, and the route log
    is closed after the step."""
    from paddle_tpu_torch.incubate.distributed.models.moe import dispatch
    preset, kw = ROUTE_LAYOUTS[name]
    ref = _jax_run(preset)
    tcfg = PRESETS[preset](TG)
    one = HybridParallelTrainer(tcfg, MeshConfig(), device="cpu",
                                params=params_from_numpy(ref["init"], tcfg,
                                                         "cpu"))
    loss1, idx1, probs1 = one.train_step_routes(*ref["data"])
    tr = _port(preset, kw, mesh, ref)
    loss, idx, probs = tr.train_step_routes(*ref["data"])
    L, B, S = tcfg.num_layers, *ref["data"][0].shape
    assert idx.shape == (L, B * S, tcfg.moe_topk)
    assert probs.shape == (L, B * S, tcfg.moe_num_experts)
    np.testing.assert_allclose(float(loss), float(loss1), **TOL)
    np.testing.assert_allclose(probs.numpy(), probs1.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), idx1.numpy())
    assert dispatch.log_routes(False) is None
