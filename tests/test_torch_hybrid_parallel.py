"""Data, ZeRO and tensor-parallel training on the CPU: the port's
`HybridParallelTrainer` over a gloo mesh of 4 ranks against the JAX
reference trainer — the twins of `tests/test_hybrid_parallel.py` without
pp.

One module-scoped mesh (`parallel.tp.serving_mesh(4, ["cpu"] * 4)`) carries
every port trainer of the module (`mesh=`), each layout's axis groups built
on its ranks.  Every case starts from the reference's `init_params` weights
(the JAX trainer's own, seed 3) and holds the port's losses over 3 steps
and its gathered parameters (`gathered_state`, the reference layout) to
the JAX trainer's at rtol 1e-4, atol 1e-4: the single-device JAX trainer,
which the reference's tests hold its own meshes to, and once the JAX
trainer on the same `MeshConfig` (8 forced CPU devices,
`tests/conftest.py`).  Shard shapes are held to the reference's
`addressable_shards`, device r against rank r; ZeRO-3's per-layer gathers
are counted; the rank handle's collectives are checked on named groups.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as G
from paddle_tpu.parallel import hybrid as JH
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
from paddle_tpu_torch.parallel.hybrid import _leaves, _names
from paddle_tpu_torch.parallel.tp import serving_mesh
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
TOL = dict(rtol=1e-4, atol=1e-4)
RANKS = 4
# a test's collectives and worker replies give up after this
MESH_TIMEOUT_S = 60.0


def _untied_wpe(gpt, seq):
    return gpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=seq, use_rope=False,
                         tie_word_embeddings=False)


PRESETS = {"gpt": (G.gpt_tiny, TG.gpt_tiny),
           "llama": (G.llama_tiny, TG.llama_tiny),
           "untied_wpe": (lambda s: _untied_wpe(G, s),
                          lambda s: _untied_wpe(TG, s))}


@pytest.fixture(scope="module")
def mesh():
    m = serving_mesh(RANKS, ["cpu"] * RANKS, timeout_s=MESH_TIMEOUT_S)
    yield m
    m.close()


def _data(cfg, batch=8, seq=32, uneven=False):
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1).astype(np.int32)
    if uneven:
        # the first dp rank's rows mostly ignored, the second's whole
        lab[:batch // 2, 3:] = -100
        lab[0, :] = -100
    return tok, lab


_JAX = {}


def _jax_run(preset, seq, mesh_cfg=None, uneven=False, clip=1.0):
    """The JAX trainer's run (cached): initial weights, 3 losses, the
    final params and moments, and eval_loss after the steps."""
    key = (preset, seq, repr(mesh_cfg), uneven, clip)
    if key not in _JAX:
        jcfg = PRESETS[preset][0](seq)
        mc = mesh_cfg or JH.MeshConfig()
        jt = JH.HybridParallelTrainer(jcfg, mc, seed=3, grad_clip_norm=clip,
                                      devices=jax.devices()[:mc.size])
        init = jax.tree_util.tree_map(np.asarray, jt.params)
        tok, lab = _data(jcfg, seq=seq, uneven=uneven)
        losses = [float(jt.train_step(tok, lab)) for _ in range(3)]
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        _JAX[key] = dict(init=init, losses=losses, params=host(jt.params),
                         m=host(jt.opt_state["m"]), v=host(jt.opt_state["v"]),
                         eval=float(jt.eval_loss(tok, lab)), data=(tok, lab))
    return _JAX[key]


def _port(preset, seq, mesh_cfg, mesh, clip=1.0):
    ref = _jax_run(preset, seq)
    tcfg = PRESETS[preset][1](seq)
    params = params_from_numpy(ref["init"], tcfg, "cpu")
    return HybridParallelTrainer(tcfg, mesh_cfg, params=params, mesh=mesh,
                                 grad_clip_norm=clip)


def _assert_params(tr, want, key="params", **tol):
    got = tr.gathered_state()[key]
    names = _names(want)
    for n, a, b in zip(names, _leaves(got), _leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=n,
                                   **(tol or TOL))


def _trajectory(tr, ref, steps=3):
    tok, lab = ref["data"]
    return [float(tr.train_step(tok, lab)) for _ in range(steps)]


def test_dp_mp_zero_matches_single_device(mesh):
    ref = _jax_run("gpt", 32)
    tr = _port("gpt", 32, MeshConfig(dp=2, mp=2, sharding_stage=1), mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


def test_params_and_moments_match_the_jax_trainer_on_the_same_mesh(mesh):
    """dp 2 x mp 2, ZeRO-1: the gathered parameters and moments after 3
    steps against the JAX trainer on the same MeshConfig."""
    jref = _jax_run("gpt", 32, JH.MeshConfig(dp=2, mp=2, sharding_stage=1))
    tr = _port("gpt", 32, MeshConfig(dp=2, mp=2, sharding_stage=1), mesh)
    np.testing.assert_allclose(_trajectory(tr, jref), jref["losses"], **TOL)
    _assert_params(tr, jref["params"])
    for k in ("m", "v"):
        _assert_params(tr, jref[k], k, atol=1e-6, rtol=1e-3)
    assert tr.gathered_state()["step"] == 3


def test_remat_and_sequence_parallel_match(mesh):
    ref = _jax_run("gpt", 32)
    tr = _port("gpt", 32, MeshConfig(dp=2, mp=2, sequence_parallel=True,
                                     remat=True), mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


def _bytes(shapes):
    return sum(int(np.prod(s)) * 4 for s in _leaves(shapes))


def test_zero3_param_and_moment_bytes_shrink(mesh):
    """sharding 2 x mp 2 at stage 3 against dp 4 at stage 0: every rank's
    params and moments under a third of the replicated bytes (the
    reference's test at 8 devices asks a quarter of 8-way sharding)."""
    t3 = _port("gpt", 64, MeshConfig(sharding=2, mp=2, sharding_stage=3),
               mesh)
    t0 = _port("gpt", 64, MeshConfig(dp=4, sharding_stage=0), mesh)
    for s3, s0 in zip(t3.rank_shapes(), t0.rank_shapes()):
        for key in ("params", "m"):
            assert _bytes(s3[key]) < _bytes(s0[key]) / 3, \
                (key, _bytes(s3[key]), _bytes(s0[key]))


ZERO_SET = {
    "dp4_z1": MeshConfig(dp=4, sharding_stage=1),
    "sh2mp2_z2": MeshConfig(sharding=2, mp=2, sharding_stage=2),
    "sh2mp2_z3": MeshConfig(sharding=2, mp=2, sharding_stage=3),
    "dp2sh2_z3": MeshConfig(dp=2, sharding=2, sharding_stage=3),
    # 4 does not divide the 2 layers: ZeRO-3 splits D, an all-gather
    "sh4_z3": MeshConfig(sharding=4, sharding_stage=3, remat=True),
    "mp4": MeshConfig(mp=4, remat=True),
}


@pytest.mark.parametrize("name", list(ZERO_SET))
def test_zero_stages_loss_parity(mesh, name):
    ref = _jax_run("gpt", 64)
    tr = _port("gpt", 64, ZERO_SET[name], mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


SHARD_LAYOUTS = {
    "dp2mp2_z1": dict(dp=2, mp=2, sharding_stage=1),
    "sh2mp2_z3": dict(sharding=2, mp=2, sharding_stage=3),
    "sh4_z3": dict(sharding=4, sharding_stage=3),
    "dp2sh2_z2": dict(dp=2, sharding=2, sharding_stage=2),
    "mp4": dict(mp=4),
}


@pytest.mark.parametrize("name", list(SHARD_LAYOUTS))
def test_param_shardings_are_applied(mesh, name):
    """Each rank's parameter and moment shard shapes equal
    `addressable_shards[r]` of the JAX trainer on the same MeshConfig
    (whole layers at rest under sharding 2 x ZeRO-3)."""
    kw = SHARD_LAYOUTS[name]
    jt = JH.HybridParallelTrainer(G.gpt_tiny(64), JH.MeshConfig(**kw),
                                  seed=3, devices=jax.devices()[:RANKS])
    tr = _port("gpt", 64, MeshConfig(**kw), mesh)
    dev = {d: i for i, d in enumerate(jax.devices())}

    def by_rank(leaf):
        return {dev[s.device]: tuple(s.data.shape)
                for s in leaf.addressable_shards}
    want = {k: [by_rank(a) for a in _leaves(t)] for k, t in
            (("params", jt.params), ("m", jt.opt_state["m"]))}
    for r, shapes in enumerate(tr.rank_shapes()):
        for k in ("params", "m"):
            assert [w[r] for w in want[k]] == _leaves(shapes[k]), (r, k)
    if name == "sh2mp2_z3":
        assert [s["params"]["blocks"]["qkv_w"][0] for s in
                tr.rank_shapes()] == [1] * RANKS


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_zero3_gathers_each_layer_again_for_the_backward(mesh, remat):
    """dp 2 x sharding 2, ZeRO-3, whole layers at rest: a step broadcasts
    each of a layer's 12 leaves from its owner before the layer, and the
    backward gathers again the 6 that autograd would keep (ln1_w, qkv_w,
    proj_w, ln2_w, fc1_w, fc2_w: saved as tokens, not tensors) or, under
    remat, the ones the replay reads; nothing gathered outlives the
    step."""
    ref = _jax_run("gpt", 32)
    tr = _port("gpt", 32, MeshConfig(dp=2, sharding=2, sharding_stage=3,
                                     remat=remat), mesh)
    tr.reset_rank_stats()
    tok, lab = ref["data"]
    np.testing.assert_allclose(float(tr.train_step(tok, lab)),
                               ref["losses"][0], **TOL)
    calls = [s["comm"]["sharding.broadcast"][0] for s in tr.rank_stats()]
    want = 2 * (12 + 6) if not remat else 2 * (12 + 11)
    assert calls == [want] * RANKS, calls
    assert not tr._rank0.view._saved


def test_uneven_ignored_labels_across_dp_ranks(mesh):
    """The loss is one mean over every valid label of the batch, not a mean
    of the dp ranks' means."""
    ref = _jax_run("gpt", 32, uneven=True)
    tr = _port("gpt", 32, MeshConfig(dp=2, mp=2, sequence_parallel=True),
               mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


@pytest.mark.parametrize("kw", [
    dict(dp=2, mp=2, sequence_parallel=True),
    dict(sharding=2, mp=2, sharding_stage=3),
    dict(dp=4, sharding_stage=2),
    dict(sharding=4, sharding_stage=3)],
    ids=["dp2mp2_sp", "sh2mp2_z3", "dp4_z2", "sh4_z3"])
def test_clip_global_norm_equals_single_device(mesh, kw):
    """The clip's norm counts every gradient element once: equal to the
    single-device trainer's, and with a clip that binds (0.01) the run
    still follows the JAX trainer's."""
    ref = _jax_run("gpt", 32, clip=0.01)
    tcfg = TG.gpt_tiny(32)
    one = HybridParallelTrainer(tcfg, MeshConfig(), device="cpu",
                                grad_clip_norm=0.01,
                                params=params_from_numpy(ref["init"], tcfg,
                                                         "cpu"))
    tr = _port("gpt", 32, MeshConfig(**kw), mesh, clip=0.01)
    tok, lab = ref["data"]
    for want in ref["losses"]:
        np.testing.assert_allclose(
            [float(tr.train_step(tok, lab)), float(one.train_step(tok, lab))],
            [want, want], **TOL)
        np.testing.assert_allclose(float(tr.gnorm()), float(one.gnorm()),
                                   rtol=1e-5)
    assert float(one.gnorm()) > 0.01
    _assert_params(tr, ref["params"])


@pytest.mark.parametrize("preset", ["llama", "untied_wpe"])
def test_mp_sequence_parallel_presets(mesh, preset):
    """llama_tiny (gated FFN, RMSNorm, GQA, rope, no bias, untied head)
    and untied embeddings with learned positions, at dp 2 x mp 2 with
    sequence parallelism."""
    ref = _jax_run(preset, 32)
    tr = _port(preset, 32, MeshConfig(dp=2, mp=2, sequence_parallel=True),
               mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


def test_eval_loss_on_a_mesh(mesh):
    ref = _jax_run("gpt", 32)
    tr = _port("gpt", 32, MeshConfig(sharding=2, mp=2, sharding_stage=3,
                                     sequence_parallel=True), mesh)
    _trajectory(tr, ref)
    np.testing.assert_allclose(float(tr.eval_loss(*ref["data"])),
                               ref["eval"], **TOL)


@pytest.mark.parametrize("kw,item", [(dict(cp=2), "cp")], ids=["cp"])
def test_later_sub_items_refuse(kw, item):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1") as e:
        HybridParallelTrainer(TG.gpt_tiny(32), MeshConfig(**kw),
                              devices=["cpu"] * 4)
    assert item in str(e.value)


def test_moe_at_mp_only_trains(mesh):
    """MoE blocks at mp 4, no sequence parallelism: every rank routes every
    token; the losses follow the JAX trainer's."""
    jcfg, tcfg = G.gpt_moe_tiny(32), TG.gpt_moe_tiny(32)
    jt = JH.HybridParallelTrainer(jcfg, JH.MeshConfig(), seed=3,
                                  devices=jax.devices()[:1])
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jt.params),
                               tcfg, "cpu")
    tok, lab = _data(jcfg)
    tr = HybridParallelTrainer(tcfg, MeshConfig(mp=4), params=params,
                               mesh=mesh)
    got = [float(tr.train_step(tok, lab)) for _ in range(2)]
    want = [float(jt.train_step(tok, lab)) for _ in range(2)]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("what", ["heads", "vocab", "seq", "batch",
                                  "mesh_size", "one_device"])
def test_layouts_that_do_not_divide_raise(mesh, what):
    cfg = TG.gpt_tiny(32)
    params = TG.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = np.zeros((8, 32), np.int32)
    if what == "heads":
        cfg = dataclasses.replace(cfg, num_heads=2)
        with pytest.raises(ValueError, match="num_heads"):
            HybridParallelTrainer(cfg, MeshConfig(mp=4), mesh=mesh)
    elif what == "vocab":
        cfg = dataclasses.replace(cfg, vocab_size=258)
        with pytest.raises(ValueError, match="vocab_size"):
            HybridParallelTrainer(cfg, MeshConfig(mp=4), mesh=mesh)
    elif what == "seq":
        tr = HybridParallelTrainer(cfg, MeshConfig(mp=4, sequence_parallel=True),
                                   params=params, mesh=mesh)
        with pytest.raises(ValueError, match="sequence length 30"):
            tr.train_step(tok[:, :30], tok[:, :30])
    elif what == "batch":
        tr = HybridParallelTrainer(cfg, MeshConfig(dp=4), params=params,
                                   mesh=mesh)
        with pytest.raises(ValueError, match="batch 6"):
            tr.train_step(tok[:6], tok[:6])
    elif what == "mesh_size":
        with pytest.raises(ValueError, match="needs 2 ranks"):
            HybridParallelTrainer(cfg, MeshConfig(dp=2), params=params,
                                  mesh=mesh)
    else:
        with pytest.raises(ValueError, match="not on one device"):
            HybridParallelTrainer(cfg, MeshConfig(dp=2), device="cpu")


def _collectives(*, mesh):
    """Each collective of the rank handle on a named group, on every rank
    (`ServingMesh.run` calls it by name)."""
    r = mesh.rank
    pair = mesh.group("pair", [r - r % 2, r - r % 2 + 1])
    every = mesh.group("every", range(mesh.mp))
    x = torch.arange(6.0).reshape(2, 3) + 10 * r
    return {"all_reduce": pair.all_reduce(x.clone()),
            "broadcast": pair.broadcast(x.clone(), 1),
            "all_gather": every.all_gather(x, 1),
            "reduce_scatter": every.reduce_scatter(
                torch.arange(16.0).reshape(2, 8) * (r + 1), 1),
            "comm": dict(mesh.comm)}


def test_rank_handle_collectives_on_named_groups(mesh):
    outs = mesh.run(_collectives, [((), {})] * RANKS)
    xs = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(RANKS)]
    for r, o in enumerate(outs):
        p = r - r % 2
        torch.testing.assert_close(o["all_reduce"], xs[p] + xs[p + 1])
        torch.testing.assert_close(o["broadcast"], xs[p + 1])
        torch.testing.assert_close(o["all_gather"], torch.cat(xs, 1))
        want = torch.arange(16.0).reshape(2, 8) * sum(range(1, RANKS + 1))
        torch.testing.assert_close(o["reduce_scatter"],
                                   want[:, 2 * r:2 * r + 2])
        assert o["comm"]["pair.all_reduce"][1] == 6 * 4
