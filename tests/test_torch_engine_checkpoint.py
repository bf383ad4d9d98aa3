"""The auto-parallel Engine and distributed checkpoints on the CPU: the
port's `distributed.auto_parallel.Engine` and `distributed.checkpoint`
against the JAX package's — the twins of `tests/test_engine_checkpoint.py`,
and more.

One module-scoped mesh of 8 ranks (`serving_mesh(8, ["cpu"] * 8)`)
carries every port engine of the module that needs one (`mesh.first(n)`).
The port's engines start from the JAX engine's own weights (seed 3) and
are held to the JAX engine's losses, eval loss and logits at rtol 1e-4,
atol 1e-4; a resumed run to the uninterrupted JAX curve at rtol 2e-4, as
the reference's own test holds its resume.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.auto_parallel import Engine as JEngine
from paddle_tpu.models import gpt as G
from paddle_tpu.parallel import hybrid as JH
from paddle_tpu_torch.distributed import Engine
from paddle_tpu_torch.distributed.checkpoint import (load_state_dict,
                                                     save_state_dict,
                                                     saved_dist_attr)
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel import MeshConfig
from paddle_tpu_torch.parallel.hybrid import _leaves, _names
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


def _data(cfg, n=32, S=64, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (n, S)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1).astype(np.int32)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_fit():
    """The reference test's Engine on (dp2, mp2): its initial weights, 2
    epochs of fit at batch 8, evaluate and predict."""
    cfg = G.gpt_tiny(64)
    tok, lab = _data(cfg)
    eng = JEngine(config=cfg, mesh_config=JH.MeshConfig(dp=2, mp=2),
                  devices=jax.devices()[:4], seed=3)
    init = _host(eng.trainer.params)
    hist = list(eng.fit((tok, lab), epochs=2, batch_size=8,
                        verbose=0)["loss"])
    return dict(init=init, data=(tok, lab), hist=hist,
                eval=eng.evaluate((tok[:8], lab[:8]), verbose=0),
                logits=eng.predict(tok[:4], batch_size=4))


@pytest.fixture(scope="module")
def jax_curve(tmp_path_factory):
    """The uninterrupted 6-step curve on (dp2, mp2) from seed 3, and the
    JAX engine's checkpoint after its first 3 steps."""
    cfg = G.gpt_tiny(64)
    tok, lab = _data(cfg, n=8)
    eng = JEngine(config=cfg, mesh_config=JH.MeshConfig(dp=2, mp=2),
                  devices=jax.devices()[:4], seed=3)
    init = _host(eng.trainer.params)
    losses = []
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ckpt")
    for s in range(6):
        losses.append(float(eng.trainer.train_step(tok, lab)))
        if s == 2:
            eng.save(path)
    return dict(init=init, data=(tok, lab), losses=losses, path=path)


def _engine(mesh, mc, init=None, seed=3, cfg=None, **kw):
    cfg = cfg or TG.gpt_tiny(64)
    where = {"mesh": mesh.first(mc.size)} if mc.size > 1 else \
        {"device": "cpu"}
    params = params_from_numpy(init, cfg, "cpu") if init is not None \
        else None
    return Engine(config=cfg, mesh_config=mc, params=params, seed=seed,
                  **where, **kw)


def test_engine_fit_evaluate_predict(mesh, jax_fit):
    tok, lab = jax_fit["data"]
    eng = _engine(mesh, MeshConfig(dp=2, mp=2), jax_fit["init"])
    hist = eng.fit((tok, lab), epochs=2, batch_size=8, verbose=0)
    assert len(hist["loss"]) == 8
    assert hist["loss"][-1] < hist["loss"][0]
    np.testing.assert_allclose(hist["loss"], jax_fit["hist"], **TOL)
    ev = eng.evaluate((tok[:8], lab[:8]), verbose=0)
    np.testing.assert_allclose(ev, jax_fit["eval"], **TOL)
    logits = eng.predict(tok[:4], batch_size=4)
    assert logits.shape == (4, 64, 256)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jax_fit["logits"]),
                               **TOL)


def test_checkpoint_reshard_resume_on_curve(mesh, jax_curve, tmp_path):
    """Save on (dp2, mp2), resume on (dp4), on (mp2) and on (cp2): each
    continues on the uninterrupted JAX curve."""
    tok, lab = jax_curve["data"]
    want = jax_curve["losses"]
    a = _engine(mesh, MeshConfig(dp=2, mp=2), jax_curve["init"])
    first = [float(a.trainer.train_step(tok, lab)) for _ in range(3)]
    np.testing.assert_allclose(first, want[:3], **TOL)
    path = str(tmp_path / "ckpt")
    a.save(path)
    a.trainer.close()
    for mc in (MeshConfig(dp=4), MeshConfig(mp=2), MeshConfig(cp=2)):
        b = _engine(mesh, mc, seed=999)          # a different init
        b.load(path)
        rest = [float(b.trainer.train_step(tok, lab)) for _ in range(3)]
        np.testing.assert_allclose(rest, want[3:], rtol=2e-4)
        b.trainer.close()


@pytest.mark.parametrize("mc", [MeshConfig(mp=2), MeshConfig(cp=2),
                                MeshConfig(pp=2, sharding=2,
                                           sharding_stage=3)],
                         ids=["mp2", "cp2", "pp2_sh2_z3"])
def test_a_jax_checkpoint_resumes_in_the_port(mesh, jax_curve, mc):
    """The JAX Engine's checkpoint after 3 steps on (dp2, mp2) loads into
    the port's Engine on another mesh (its `treedef.pkl` unread) and
    continues on the JAX curve."""
    tok, lab = jax_curve["data"]
    assert os.path.exists(os.path.join(jax_curve["path"], "treedef.pkl"))
    b = _engine(mesh, mc, seed=999)
    b.load(jax_curve["path"])
    assert b.trainer.opt_state["step"] == 3
    rest = [float(b.trainer.train_step(tok, lab)) for _ in range(3)]
    np.testing.assert_allclose(rest, jax_curve["losses"][3:], rtol=2e-4)
    b.trainer.close()


def test_checkpoint_metadata_written(mesh, tmp_path):
    """The port's `dist_attr.json` equals the JAX Engine's for the same
    MeshConfig: every leaf's layout in the reference's list form, the
    mesh's axes and shape; the arrays are the full logical ones under the
    reference's names."""
    mc = dict(mp=2, sharding=2, sharding_stage=2)
    eng = _engine(mesh, MeshConfig(**mc), seed=0)
    path = str(tmp_path / "meta")
    eng.save(path)
    meta = saved_dist_attr(path)
    assert meta["mesh"]["axes"] == ["dp", "pp", "sharding", "mp", "ep", "cp"]
    qkv = meta["leaves"]["params/blocks/qkv_w"]
    assert qkv[-1] == "mp"
    jeng = JEngine(config=G.gpt_tiny(64), mesh_config=JH.MeshConfig(**mc),
                   devices=jax.devices()[:4], seed=0)
    jpath = str(tmp_path / "jmeta")
    jeng.save(jpath)
    jmeta = saved_dist_attr(jpath)
    assert meta == jmeta
    with np.load(os.path.join(path, "data.npz")) as d, \
            np.load(os.path.join(jpath, "data.npz")) as jd:
        assert sorted(d.files) == sorted(jd.files)
        for n in d.files:
            assert (d[n].shape, d[n].dtype) == (jd[n].shape, jd[n].dtype), n


def test_checkpoint_without_optimizer(tmp_path):
    cfg = TG.gpt_tiny(64)
    tok, lab = _data(cfg, n=8)
    a = _engine(None, MeshConfig(), seed=3)
    a.trainer.train_step(tok, lab)
    path = str(tmp_path / "infer_only")
    a.save(path, training=False)
    assert "opt" not in load_state_dict(path)
    b = _engine(None, MeshConfig(), seed=7)
    b.load(path, load_optimizer=False)
    la = float(a.trainer.eval_loss(tok, lab))
    lb = float(b.trainer.eval_loss(tok, lab))
    np.testing.assert_allclose(la, lb, rtol=1e-5)


def test_load_optimizer_mismatch_paths(tmp_path):
    """Checkpoint without optimizer loads with default flags and vice
    versa."""
    cfg = TG.gpt_tiny(64)
    tok, lab = _data(cfg, n=8)
    a = _engine(None, MeshConfig(), seed=3)
    a.trainer.train_step(tok, lab)
    p1 = str(tmp_path / "no_opt")
    a.save(p1, training=False)
    b = _engine(None, MeshConfig(), seed=9)
    b.load(p1)          # load_optimizer=True but checkpoint has no opt: fine
    np.testing.assert_allclose(float(b.trainer.eval_loss(tok, lab)),
                               float(a.trainer.eval_loss(tok, lab)),
                               rtol=1e-5)
    assert b.trainer.opt_state["step"] == 0
    p2 = str(tmp_path / "with_opt")
    a.save(p2, training=True)
    c = _engine(None, MeshConfig(), seed=11)
    c.load(p2, load_optimizer=False)   # opt present but skipped: fine
    np.testing.assert_allclose(float(c.trainer.eval_loss(tok, lab)),
                               float(a.trainer.eval_loss(tok, lab)),
                               rtol=1e-5)
    assert c.trainer.opt_state["step"] == 0


def test_predict_includes_tail_batch():
    cfg = TG.gpt_tiny(64)
    tok, _ = _data(cfg, n=10)
    eng = _engine(None, MeshConfig(), seed=0)
    out = eng.predict(tok, batch_size=4)
    assert out.shape[0] == 10
    np.testing.assert_allclose(out[8:].numpy(),
                               eng.predict(tok[8:]).numpy(), atol=1e-6)


def test_bf16_checkpoints_round_trip_and_load_from_jax(tmp_path):
    """bf16 leaves go to npz as uint16 bits with "bfloat16" under dtypes,
    both ways: the port's save loads back bit for bit, and the JAX
    Engine's bf16 checkpoint (llama_tiny, bf16 moments) loads into the
    port bit for bit."""
    jcfg = G.llama_tiny(64)
    jcfg.dtype = jnp.bfloat16
    jeng = JEngine(config=jcfg, mesh_config=JH.MeshConfig(),
                   devices=jax.devices()[:1], seed=5,
                   moment_dtype=jnp.bfloat16)
    jpath = str(tmp_path / "jax_bf16")
    jeng.save(jpath)
    tcfg = TG.llama_tiny(64)
    tcfg.dtype = torch.bfloat16
    eng = _engine(None, MeshConfig(), seed=1, cfg=tcfg,
                  moment_dtype=torch.bfloat16)
    eng.load(jpath)
    want = _host(jeng.trainer.params)
    got = eng.trainer.gathered_state(("params",))["params"]
    for n, a, b in zip(_names(want), _leaves(got), _leaves(want)):
        assert a.dtype == torch.bfloat16, n
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16),
                                      err_msg=n)
    path = str(tmp_path / "port_bf16")
    eng.save(path)
    with open(os.path.join(path, "dist_attr.json")) as f:
        dtypes = json.load(f)["dtypes"]
    assert dtypes["params/wte"] == dtypes["opt/m/wte"] == "bfloat16"
    with np.load(os.path.join(path, "data.npz")) as d:
        assert d["params/wte"].dtype == np.uint16
    back = load_state_dict(path)
    for a, b in zip(_leaves(back["params"]), _leaves(got)):
        assert torch.equal(a, b)


def test_checkpoint_without_dist_attr_raises(tmp_path):
    """A checkpoint missing `dist_attr.json` (its leaves' dtypes) does not
    load: its bf16 leaves would come back as uint16 bits."""
    path = str(tmp_path / "bf16")
    save_state_dict({"params": {"w": torch.ones(3, dtype=torch.bfloat16)}},
                    path)
    assert load_state_dict(path)["params"]["w"].dtype == torch.bfloat16
    os.remove(os.path.join(path, "dist_attr.json"))
    with pytest.raises(FileNotFoundError, match="dist_attr.json"):
        load_state_dict(path)
    eng = _engine(None, MeshConfig(), seed=3)
    with pytest.raises(FileNotFoundError, match="dist_attr.json"):
        eng.load(path)


def test_strategy_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        Engine(config=TG.gpt_tiny(64), strategy=object(), device="cpu")


def test_load_refuses_another_model(tmp_path):
    """strict: the checkpoint's leaves and shapes must be the model's;
    strict=False loads the leaves it holds and keeps the others."""
    a = _engine(None, MeshConfig(), seed=3)
    path = str(tmp_path / "gpt")
    a.save(path)
    other = TG.gpt_tiny(64)
    other.hidden_size = 32
    b = _engine(None, MeshConfig(), seed=3, cfg=other)
    with pytest.raises(ValueError, match="shape"):
        b.load(path)
    c = _engine(None, MeshConfig(), seed=4)
    data = dict(np.load(os.path.join(path, "data.npz")))
    del data["params/lnf_w"]
    np.savez(os.path.join(path, "data.npz"), **data)
    with pytest.raises(KeyError, match="lnf_w"):
        c.load(path)
    keep = c.trainer.params["lnf_w"].detach().clone()
    c.load(path, strict=False)
    assert torch.equal(c.trainer.params["lnf_w"], keep)
    assert torch.equal(c.trainer.params["wte"], a.trainer.params["wte"])
