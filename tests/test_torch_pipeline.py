"""Pipeline-parallel training on the CPU: the port's `HybridParallelTrainer`
at pp and interleaved vpp (`parallel/pipeline.py`) over a gloo mesh,
against the JAX reference trainer — the twins of the pp cases of
`tests/test_hybrid_parallel.py`, and more.

One module-scoped mesh of 8 ranks (`serving_mesh(8, ["cpu"] * 8)`)
carries every port trainer of the module; a trainer of fewer ranks runs on
its first ones (`mesh.first(size)`).  Every case starts from the
reference's `init_params` weights (the JAX trainer's own, seed 3) and
holds the port's losses over 3 steps and its gathered parameters
(`gathered_state`, every layer in its place) to the JAX trainer's at rtol
1e-4, atol 1e-4 (2e-4 where the reference's own test uses it): the
single-device JAX trainer, which the reference holds its pipelines to,
and, where the case says so, the JAX trainer on the same `MeshConfig` (8
forced CPU devices, `tests/conftest.py`), moments too.  Shard shapes are
held to the reference's `addressable_shards`, device r against rank r
(under vpp rank r's layers are its interleaved chunks, where device r's
are contiguous: the shapes agree, the contents differ).
"""
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
from paddle_tpu_torch.parallel.pipeline import bubble_share, units
from paddle_tpu_torch.parallel.tp import serving_mesh
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
TOL = dict(rtol=1e-4, atol=1e-4)
RANKS = 8
MESH_TIMEOUT_S = 60.0


def _untied_wpe(gpt, seq):
    return gpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=4,
                         num_heads=4, max_seq_len=seq, use_rope=False,
                         tie_word_embeddings=False)


def _deep(gpt, seq):
    return gpt.GPTConfig(vocab_size=256, hidden_size=64, num_layers=8,
                         num_heads=4, max_seq_len=seq)


PRESETS = {"gpt": (G.gpt_tiny, TG.gpt_tiny),
           "llama": (G.llama_tiny, TG.llama_tiny),
           "untied_wpe": (lambda s: _untied_wpe(G, s),
                          lambda s: _untied_wpe(TG, s)),
           "deep": (lambda s: _deep(G, s), lambda s: _deep(TG, s))}


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
        # microbatch 0 (rows 0-1 at M 4) mostly ignored, the last 5
        # positions of every row too
        lab[:2, 2:] = -100
        lab[:, -5:] = -100
    return tok, lab


_JAX = {}


def _jax_run(preset, seq, mesh_cfg=None, uneven=False):
    """The JAX trainer's run (cached): initial weights, 3 losses, the final
    params and moments, and eval_loss after the steps."""
    key = (preset, seq, repr(mesh_cfg), uneven)
    if key not in _JAX:
        jcfg = PRESETS[preset][0](seq)
        mc = mesh_cfg or JH.MeshConfig()
        jt = JH.HybridParallelTrainer(jcfg, mc, seed=3,
                                      devices=jax.devices()[:mc.size])
        init = jax.tree_util.tree_map(np.asarray, jt.params)
        tok, lab = _data(jcfg, seq=seq, uneven=uneven)
        losses = [float(jt.train_step(tok, lab)) for _ in range(3)]
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        _JAX[key] = dict(init=init, losses=losses, params=host(jt.params),
                         m=host(jt.opt_state["m"]), v=host(jt.opt_state["v"]),
                         eval=float(jt.eval_loss(tok, lab)), data=(tok, lab))
    return _JAX[key]


def _port(preset, seq, mesh_cfg, mesh, clip=1.0, lr=1e-4):
    ref = _jax_run(preset, seq)
    tcfg = PRESETS[preset][1](seq)
    params = params_from_numpy(ref["init"], tcfg, "cpu")
    return HybridParallelTrainer(tcfg, mesh_cfg, params=params,
                                 mesh=mesh.first(mesh_cfg.size),
                                 grad_clip_norm=clip, learning_rate=lr)


def _assert_params(tr, want, key="params", **tol):
    got = tr.gathered_state()[key]
    for n, a, b in zip(_names(want), _leaves(got), _leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=n,
                                   **(tol or TOL))


def _map_np(tree):
    return {k: _map_np(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _trajectory(tr, ref, steps=3):
    tok, lab = ref["data"]
    return [float(tr.train_step(tok, lab)) for _ in range(steps)]


def test_pipeline_matches_single_device(mesh):
    ref = _jax_run("gpt", 32)
    tr = _port("gpt", 32, MeshConfig(dp=2, pp=2, mp=2, micro_batches=4,
                                     sharding_stage=1), mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


def test_loss_decreases_under_pipeline(mesh):
    """pp 2, 2 microbatches, lr 1e-3: 10 steps fall."""
    ref = _jax_run("gpt", 32)
    tr = _port("gpt", 32, MeshConfig(pp=2, micro_batches=2), mesh, lr=1e-3)
    losses = _trajectory(tr, ref, steps=10)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_zero3_with_pp_and_remat(mesh):
    """pp 2 x sharding 2 x mp 2, ZeRO-3, remat: pp takes the layer axis, so
    the zero axis lands on another dimension of every block leaf, gathered
    by an all-gather ("dim"), not a whole-layer broadcast."""
    ref = _jax_run("gpt", 32)
    tr = _port("gpt", 32, MeshConfig(pp=2, sharding=2, mp=2,
                                     sharding_stage=3, micro_batches=2,
                                     remat=True), mesh)
    assert {k[0] for k in tr._rank0.view.z3.values()} == {"dim"}
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


def test_pp_untied_embeddings_and_wpe_parity(mesh):
    """Untied head and learned positions at pp 2 x mp 2: `wpe` lives on
    stage 0, `lm_head` and `lnf` on the last; every stage's copy of them
    gets the summed gradient (wrong parameters after step 1 otherwise)."""
    ref = _jax_run("untied_wpe", 64, uneven=True)
    tr = _port("untied_wpe", 64, MeshConfig(pp=2, mp=2, micro_batches=2),
               mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"],
                               rtol=2e-4, atol=2e-4)
    _assert_params(tr, ref["params"])


def test_pp4_parity(mesh):
    ref = _jax_run("deep", 32)
    tr = _port("deep", 32, MeshConfig(pp=4, micro_batches=4, remat=True),
               mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"],
                               rtol=2e-4, atol=2e-4)
    _assert_params(tr, ref["params"])


INTERLEAVED = {
    "pp2_vpp2": MeshConfig(pp=2, vpp=2, micro_batches=4),
    "pp4_vpp2_remat": MeshConfig(pp=4, vpp=2, micro_batches=4, remat=True),
    "dp2_pp2_vpp2_mp2": pytest.param(
        MeshConfig(dp=2, pp=2, vpp=2, mp=2, micro_batches=2),
        marks=pytest.mark.slow),
}


@pytest.mark.parametrize("mc", list(INTERLEAVED.values()),
                         ids=list(INTERLEAVED))
def test_interleaved_virtual_pipeline_matches_single(mesh, mc):
    ref = _jax_run("deep", 32)
    tr = _port("deep", 32, mc, mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


@pytest.mark.parametrize("what", ["layers", "batch", "micro", "no_pp"])
def test_interleave_divisibility_asserts(mesh, what):
    """The reference's AssertionErrors: layers over pp * vpp and the batch
    over the microbatches at the first step, microbatches over pp under
    vpp, and vpp without pp at construction."""
    cfg = TG.GPTConfig(vocab_size=256, hidden_size=64, num_layers=6,
                       num_heads=4, max_seq_len=64)
    params = TG.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = np.zeros((4, 64), np.int32)
    if what == "no_pp":
        with pytest.raises(AssertionError, match="requires pp > 1"):
            HybridParallelTrainer(cfg, MeshConfig(vpp=2), device="cpu")
        return
    mc = {"layers": MeshConfig(pp=2, vpp=2, micro_batches=2),
          "batch": MeshConfig(pp=2, micro_batches=3),
          "micro": MeshConfig(pp=2, vpp=2, micro_batches=1)}[what]
    tr = HybridParallelTrainer(cfg, mc, params=params, mesh=mesh.first(2))
    match = {"layers": "divide over pp\\*vpp",
             "batch": "must divide into micro_batches=3",
             "micro": "micro_batches 1 % pp 2 == 0"}[what]
    with pytest.raises(AssertionError, match=match):
        tr.train_step(tok, tok)


SHARD_LAYOUTS = {
    "dp2_pp2_mp2": dict(dp=2, pp=2, mp=2, sharding_stage=1),
    "pp2_vpp2_mp2": dict(pp=2, vpp=2, mp=2, micro_batches=2),
    "pp2_sh2_mp2_z3": dict(pp=2, sharding=2, mp=2, sharding_stage=3),
}


@pytest.mark.parametrize("name", list(SHARD_LAYOUTS))
def test_param_shardings_are_applied(mesh, name):
    """Each rank's parameter and moment shard shapes equal
    `addressable_shards[r]` of the JAX trainer on the same MeshConfig:
    block leaves split over pp on their layer axis ("pp" first, then mp,
    the ZeRO-3 axis on the next free dimension)."""
    kw = SHARD_LAYOUTS[name]
    jt = JH.HybridParallelTrainer(G.gpt_tiny(64), JH.MeshConfig(**kw),
                                  seed=3, devices=jax.devices()[:RANKS])
    assert tuple(jt.params["blocks"]["qkv_w"].sharding.spec)[:1] == ("pp",)
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


@pytest.mark.parametrize("kw", [
    dict(pp=2, vpp=2, micro_batches=4),
    dict(pp=2, mp=2, sequence_parallel=True, micro_batches=2)],
    ids=["pp2_vpp2", "pp2_mp2_sp"])
def test_params_and_moments_match_the_jax_trainer_on_the_same_mesh(mesh,
                                                                     kw):
    """The gathered parameters and moments after 3 steps against the JAX
    trainer on the same MeshConfig (under vpp every layer back in its
    place)."""
    jref = _jax_run("deep", 32, JH.MeshConfig(**kw))
    tr = _port("deep", 32, MeshConfig(**kw), mesh)
    np.testing.assert_allclose(_trajectory(tr, jref), jref["losses"], **TOL)
    _assert_params(tr, jref["params"])
    for k in ("m", "v"):
        _assert_params(tr, jref[k], k, atol=1e-6, rtol=1e-3)


def test_uneven_ignored_labels_across_microbatches(mesh):
    """One mean over every valid label of the step, not a mean of the
    microbatches' means: the first microbatch mostly ignored."""
    ref = _jax_run("gpt", 32, uneven=True)
    tr = _port("gpt", 32, MeshConfig(dp=2, pp=2, micro_batches=4), mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


@pytest.mark.parametrize("kw", [
    dict(pp=2, micro_batches=2),
    dict(pp=2, mp=2, sequence_parallel=True, micro_batches=2),
    dict(dp=2, pp=2, sharding_stage=2, micro_batches=2)],
    ids=["pp2", "pp2_mp2_sp", "dp2_pp2_z2"])
def test_clip_global_norm_equals_single_device(mesh, kw):
    """The clip's norm counts each element once (block leaves summed over
    the stages, the leaves every stage holds once): equal to the
    single-device trainer's, with a clip that binds (0.01), and so are
    the losses and parameters (the single-device trainer's own parity with
    the JAX trainer under a binding clip: `test_torch_hybrid_parallel`)."""
    ref = _jax_run("gpt", 32)
    tcfg = TG.gpt_tiny(32)
    one = HybridParallelTrainer(tcfg, MeshConfig(), device="cpu",
                                grad_clip_norm=0.01,
                                params=params_from_numpy(ref["init"], tcfg,
                                                         "cpu"))
    tr = _port("gpt", 32, MeshConfig(**kw), mesh, clip=0.01)
    tok, lab = ref["data"]
    for _ in range(3):
        np.testing.assert_allclose(float(tr.train_step(tok, lab)),
                                   float(one.train_step(tok, lab)), **TOL)
        np.testing.assert_allclose(float(tr.gnorm()), float(one.gnorm()),
                                   rtol=1e-5)
    assert float(one.gnorm()) > 0.01
    want = one.gathered_state()["params"]
    _assert_params(tr, _map_np(want))


@pytest.mark.parametrize("kw", [dict(pp=2, micro_batches=2),
                                dict(pp=2, vpp=2, mp=2, micro_batches=2)],
                         ids=["pp2", "pp2_vpp2_mp2"])
def test_eval_loss_under_pp(mesh, kw):
    ref = _jax_run("deep", 32)
    tr = _port("deep", 32, MeshConfig(**kw), mesh)
    _trajectory(tr, ref)
    np.testing.assert_allclose(float(tr.eval_loss(*ref["data"])),
                               ref["eval"], **TOL)


@pytest.mark.parametrize("kw", [dict(pp=2, micro_batches=2),
                                dict(pp=2, mp=2, sequence_parallel=True,
                                     micro_batches=4, remat=True)],
                         ids=["pp2", "pp2_mp2_sp_remat"])
def test_llama_under_pp(mesh, kw):
    """llama_tiny (gated FFN, RMSNorm, GQA, rope, untied head)."""
    ref = _jax_run("llama", 32)
    tr = _port("llama", 32, MeshConfig(**kw), mesh)
    np.testing.assert_allclose(_trajectory(tr, ref), ref["losses"], **TOL)
    _assert_params(tr, ref["params"])


@pytest.mark.parametrize("kw", [dict(pp=4, micro_batches=4),
                                dict(pp=2, vpp=2, mp=2, micro_batches=4)],
                         ids=["pp4", "pp2_vpp2_mp2"])
def test_a_step_sends_each_boundary_once(mesh, kw):
    """A step's point-to-point calls and bytes: each unit's boundary
    activation once forward and its gradient once back, [rows, S(/mp), D]
    float32 each; stage 0 never sends forward on the ring's wrap under
    vpp 1 and the last stage's last chunk goes to the loss."""
    mc = MeshConfig(**kw)
    tr = _port("deep", 32, mc, mesh)
    tr.reset_rank_stats()
    tok, lab = _data(_deep(TG, 32))
    tr.train_step(tok, lab)
    M, pp, vpp = mc.micro_batches, mc.pp, mc.vpp
    per = 8 // M * 32 * 64 * 4      # one microbatch's boundary, f32 bytes
    for r, st in enumerate(tr.rank_stats()):
        p = (r // mc.mp) % pp
        fwd = vpp * M - (M if p == pp - 1 else 0)
        bwd = vpp * M - (M if p == 0 else 0)
        comm = st["comm"]
        assert comm.get("pp_next.send", [0, 0]) == [fwd, fwd * per], (r, comm)
        assert comm.get("pp_prev.send", [0, 0]) == [bwd, bwd * per], (r, comm)
        assert comm.get("pp_prev.recv", [0, 0]) == [bwd, bwd * per], (r, comm)
    assert len(units(pp, vpp, M)) == vpp * M
    assert bubble_share(pp, vpp, M) == (pp - 1) / (vpp * M + pp - 1)


def test_units_follow_the_reference_tick_table():
    """`units` is the order the reference's closed form gives a stage:
    position u = t - p runs chunk c of microbatch m."""
    pp, vpp, M = 2, 2, 4
    want = []
    for u in range(vpp * M):
        g, r = divmod(u, vpp * pp)
        want.append((r // pp, g * pp + r % pp))
    assert units(pp, vpp, M) == want == [(0, 0), (0, 1), (1, 0), (1, 1),
                                         (0, 2), (0, 3), (1, 2), (1, 3)]
    assert units(4, 1, 3) == [(0, 0), (0, 1), (0, 2)]


def _p2p(*, mesh):
    """isend / recv around a ring of the first 4 ranks and an all-to-all
    over them (`ServingMesh.run` calls it by name)."""
    r = mesh.rank
    if r >= 4:
        return None
    # link i goes from rank i to rank i + 1; built in link order
    links = {i: mesh.group("ring_next" if i == r else "ring_prev",
                           [i, (i + 1) % 4])
             for i in range(4) if r in (i, (i + 1) % 4)}
    nxt, prv = links[r], links[(r - 1) % 4]
    every = mesh.group("ring_every", range(4))
    x = torch.arange(6.0).reshape(2, 3) + 10 * r
    sent = nxt.isend(x, 1)
    got = prv.recv((2, 3), torch.float32, 0)
    sent.wait()
    a2a = every.all_to_all(torch.arange(8.0).reshape(4, 2) + 100 * r, 0, 1)
    return {"recv": got, "all_to_all": a2a, "comm": dict(mesh.comm)}


def test_rank_handle_point_to_point_and_all_to_all(mesh):
    """The links the pipeline builds work in a ring when every rank sends
    before it receives (the send does not wait for the receiver), in
    groups whose two members are listed in either order; the tiled
    all-to-all hands part j of rank i's tensor to rank j."""
    outs = mesh.run(_p2p, [((), {})] * RANKS)[:4]
    for r, o in enumerate(outs):
        src = (r - 1) % 4
        torch.testing.assert_close(o["recv"],
                                   torch.arange(6.0).reshape(2, 3) + 10 * src)
        want = torch.cat([torch.arange(8.0).reshape(4, 2)[r:r + 1] + 100 * i
                          for i in range(4)], 1)
        torch.testing.assert_close(o["all_to_all"], want)
        assert o["comm"]["ring_next.send"][1] >= 24
