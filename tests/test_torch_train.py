"""The PyTorch port's training path vs the JAX reference, on the CPU.

Both packages get the same numpy-seeded inputs; weights go JAX
`init_params` -> numpy -> `params_from_numpy`.  The reference's backward
kernels have no interpret mode, so the attention backward is held against
`jax.vjp(attention_xla)`, as the reference's own flash tests do.
Tolerances, all float32 (the same math summed in another order): the
attention and RMSNorm backward 1e-5 abs/rel; `loss_fn` and its gradients
1e-4 (relative to each gradient leaf's largest element); the trainer's
losses rtol 1e-4, its params 99.9% within 1e-6 abs and all within
2 * lr * steps, the most Adam can move an element whose near-zero gradient
changes sign when sums are reordered.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.flash_attention import attention_xla
from paddle_tpu.incubate.kernels.rms_norm import _rms_ref as jax_rms_ref
from paddle_tpu.models import gpt as G
from paddle_tpu.parallel import hybrid as JH
from paddle_tpu_torch.incubate.kernels.flash_attention import (
    FlashAttention, _flash_bwd_ref, _flash_fwd_ref, attention_ref,
    flash_attention_fused)
from paddle_tpu_torch.incubate.kernels.rms_norm import rms_norm_fused
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
from paddle_tpu_torch.parallel.hybrid import _leaves
from torch_threads import one_torch_thread  # noqa: F401

PRESETS = {"gpt_tiny": (G.gpt_tiny, TG.gpt_tiny),
           "llama_tiny": (G.llama_tiny, TG.llama_tiny)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_params(params, tcfg, grad=True):
    tree = jax.tree_util.tree_map(np.asarray, params)
    out = params_from_numpy(tree, tcfg, "cpu")
    for leaf in _leaves(out):
        leaf.requires_grad_(grad)
    return out


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [16, 33, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_backward_matches_reference(causal, S, D):
    rng = np.random.RandomState(S + D)
    q, k, v, g = (rng.randn(2, S, 2, D).astype(np.float32) for _ in range(4))
    scale = 1.0 / np.sqrt(D)
    _, vjp = jax.vjp(lambda a, b, c: attention_xla(a, b, c, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    out, lse = _flash_fwd_ref(_t(q), _t(k), _t(v), causal, scale)
    plain = _flash_bwd_ref(_t(q), _t(k), _t(v), out, lse, _t(g), causal,
                           scale)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    got = FlashAttention.apply(tq, tk, tv, causal, scale)
    assert got.grad_fn is not None
    got.backward(_t(g))
    for name, r, a, b in zip("qkv", ref, plain, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(a.numpy(), r, atol=1e-5, rtol=1e-5,
                                   err_msg=f"plain d{name}")
        np.testing.assert_allclose(b.numpy(), r, atol=1e-5, rtol=1e-5,
                                   err_msg=f"Function d{name}")


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 72)], ids=["2d", "3d"])
def test_rms_norm_backward_matches_reference(shape):
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32) * 3
    w = rng.randn(shape[-1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_rms_ref(a, b, 1e-6), jnp.asarray(x),
                     jnp.asarray(w))
    rdx, rdw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = rms_norm_fused(tx, tw)
    assert y.grad_fn is not None
    y.backward(_t(g))
    np.testing.assert_allclose(tx.grad.numpy(), rdx, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), rdw, atol=1e-5, rtol=1e-5)


_REF_CACHE = {}


def _reference_loss_and_grads(preset, S, remat):
    key = (preset, S, remat)
    if key not in _REF_CACHE:
        cfg = PRESETS[preset][0](S)
        params = G.init_params(cfg, jax.random.key(0))
        rng = np.random.RandomState(S)
        tok = rng.randint(0, cfg.vocab_size, (2, S)).astype(np.int32)
        lab = np.roll(tok, -1, axis=1)
        lab[:, -5:] = -100                      # ignored labels count too
        loss, grads = jax.value_and_grad(G.loss_fn)(
            params, jnp.asarray(tok), jnp.asarray(lab), cfg, remat=remat,
            loss_chunk=512)
        _REF_CACHE[key] = (params, tok, lab, float(loss),
                           [np.asarray(a) for a in _leaves(
                               jax.tree_util.tree_map(np.asarray, grads))])
    return _REF_CACHE[key]


@pytest.mark.parametrize("S", [128, 1024], ids=["unchunked", "chunked"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_loss_fn_value_and_grads_match(preset, remat, S):
    params, tok, lab, ref_loss, ref_grads = _reference_loss_and_grads(
        preset, S, remat)
    tcfg = PRESETS[preset][1](S)
    tparams = _port_params(params, tcfg)
    loss = TG.loss_fn(tparams, tok, lab, tcfg, remat=remat, loss_chunk=512)
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-4)
    grads = torch.autograd.grad(loss, _leaves(tparams), allow_unused=True,
                                materialize_grads=True)
    assert len(grads) == len(ref_grads)
    for got, ref in zip(grads, ref_grads):
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-4 * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_attention_runs_once_per_layer(remat):
    """With remat the backward replays the blocks around attention but
    never attention itself: one run per layer in a forward + backward."""
    tcfg = TG.llama_tiny(32)
    tparams = TG.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for leaf in _leaves(tparams):
        leaf.requires_grad_()
    runs = []

    def counting(q, k, v):
        runs.append(1)
        return attention_ref(q, k, v, causal=True)

    tok = np.random.RandomState(0).randint(0, tcfg.vocab_size, (2, 32))
    loss = TG.loss_fn(tparams, tok, np.roll(tok, -1, 1), tcfg, remat=remat,
                      attn_impl=counting)
    loss.backward()
    assert len(runs) == tcfg.num_layers
    assert tparams["blocks"]["qkv_w"].grad.abs().sum() > 0


def test_flash_entry_is_differentiable_and_matches_plain_autograd():
    """The Function's gradients equal autograd through `attention_ref`."""
    rng = np.random.RandomState(1)
    q, k, v, g = (rng.randn(1, 9, 3, 8).astype(np.float32) for _ in range(4))
    grads = []
    for fn in (flash_attention_fused, attention_ref):
        ts = [_t(x).requires_grad_() for x in (q, k, v)]
        fn(*ts, causal=True).backward(_t(g))
        grads.append([t.grad.numpy() for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def _trajectories(preset, steps=3):
    jcfg, tcfg = PRESETS[preset][0](64), PRESETS[preset][1](64)
    jt = JH.HybridParallelTrainer(jcfg, JH.MeshConfig(remat=True), seed=3)
    tt = HybridParallelTrainer(tcfg, MeshConfig(remat=True), device="cpu",
                               params=_port_params(jt.params, tcfg, False))
    rng = np.random.RandomState(11)
    tok = rng.randint(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    jl = [float(jt.train_step(tok, lab)) for _ in range(steps)]
    tl = [float(tt.train_step(tok, lab)) for _ in range(steps)]
    return jt, tt, jl, tl, (tok, lab)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_trainer_matches_reference(preset):
    steps = 3
    jt, tt, jl, tl, (tok, lab) = _trajectories(preset, steps)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    ref = _leaves(jax.tree_util.tree_map(np.asarray, jt.params))
    got = [p.detach().numpy() for p in _leaves(tt.params)]
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, ref)])
    assert np.mean(diff <= 1e-6) >= 0.999, np.mean(diff <= 1e-6)
    assert diff.max() <= 2 * tt.lr * steps, diff.max()
    for name in ("m", "v"):
        rm = _leaves(jax.tree_util.tree_map(np.asarray, jt.opt_state[name]))
        gm = [t.numpy() for t in _leaves(tt.opt_state[name])]
        for a, b in zip(gm, rm):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-3)
    assert tt.opt_state["step"] == int(jt.opt_state["step"]) == steps
    np.testing.assert_allclose(float(tt.eval_loss(tok, lab)),
                               float(jt.eval_loss(tok, lab)), rtol=1e-4)


def test_count_params_matches_reference():
    for jp, tp in PRESETS.values():
        params = G.init_params(jp(64), jax.random.key(0))
        assert TG.count_params(_port_params(params, tp(64), False)) == \
            G.count_params(params)


def test_mesh_config_keeps_reference_fields_and_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(MeshConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JH.MeshConfig)}
    assert ours == ref


@pytest.mark.parametrize("kw,item", [
    (dict(dp=2), "not on one device"), (dict(sharding=2), "not on one device"),
    (dict(dp=2, sharding_stage=2), "not on one device"),
    (dict(pp=2), "not on one device"), (dict(vpp=2), "requires pp > 1"),
    (dict(mp=2), "not on one device"),
    (dict(mp=2, sequence_parallel=True), "not on one device"),
    (dict(ep=2), "not on one device"), (dict(cp=2), "cp")],
    ids=["dp", "sharding", "zero2", "pp", "vpp", "mp", "sp", "ep", "cp"])
def test_trainer_refuses_other_meshes(kw, item):
    """One device takes the degree-1 mesh only: dp, pp, sharding, mp and ep
    run on a mesh of ranks (`tests/test_torch_hybrid_parallel.py`,
    `test_torch_pipeline.py`, `test_torch_moe_parallel.py`) and raise
    ValueError here, never falling back to one device; vpp without pp
    raises the reference's AssertionError, and cp NotImplementedError
    naming its ROADMAP item."""
    exc = {"cp": NotImplementedError,
           "requires pp > 1": AssertionError}.get(item, ValueError)
    with pytest.raises(exc, match="ROADMAP Queue 1" if item == "cp"
                       else item) as e:
        HybridParallelTrainer(TG.gpt_tiny(32), MeshConfig(**kw),
                              device="cpu")
    assert item in str(e.value)


def test_moe_config_still_refuses():
    """MoE blocks run at expert-parallel degree 1 on one device
    (`test_torch_moe.py` holds them against the reference); ep > 1 runs on
    a mesh of ranks (`test_torch_moe_parallel.py`) and refuses one
    device."""
    cfg = TG.gpt_tiny(32)
    cfg.moe_num_experts = 4
    params = TG.init_params(cfg, torch.Generator(), "cpu")
    assert params["blocks"]["gate_w"].dtype == torch.float32
    assert "fc1_w" not in params["blocks"]
    with pytest.raises(ValueError, match="not on one device"):
        HybridParallelTrainer(cfg, MeshConfig(ep=2), device="cpu")
