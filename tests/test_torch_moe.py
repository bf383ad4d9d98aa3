"""The port's MoE blocks vs the JAX reference, on the CPU.

Same numpy-seeded inputs through both packages; weights go the reference's
`init_params` -> numpy -> `params_from_numpy`.  float32 throughout.

- The dispatch functions (`moe_capacity`, `topk_gating`, `capacity_slots`,
  `dispatch`, `combine`) against the reference's, exactly (the slots and
  routes) or within 1e-6 (values), with assignments dropped past capacity
  and rows whose probabilities tie (top-k breaks ties toward the lower
  expert, as `lax.top_k`).
- `moe_ffn_dense`'s values and gradients against `jax.vjp`, 1e-4 relative
  to each output's largest element, with and without drops.
- `gpt_moe_tiny`'s `loss_fn` (with the aux penalty) and its gradients, and
  3 trainer steps against the JAX trainer, as `test_torch_train.py` holds
  the dense presets.
- Engine streams against the reference engine (never warmed, built with
  `prefix_cache=False`): fused bucketed, fused chunked, `fuse=False`, and
  int8 weights and KV.  Greedy tokens must be equal; a divergence passes
  only as a near-tie (top-2 margin below TIE_MARGIN, INT8_TIE_MARGIN for
  the int8 engine, whose KV rounding can flip a step), reported.
- `params_from_numpy` keeps the gate float32 in a bf16 model;
  `quantize_serving_params` passes the gate and the expert banks through
  (expert parallelism: `tests/test_torch_moe_parallel.py`).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.distributed.models.moe import dispatch as RD
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu.parallel import hybrid as JH
from paddle_tpu_torch.incubate.distributed.models.moe import dispatch as TD
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
from paddle_tpu_torch.parallel.hybrid import _leaves
from paddle_tpu_torch.quantization import quantize_serving_params
from test_torch_engine import _serve
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
TIE_MARGIN = 1e-4
INT8_TIE_MARGIN = 2e-3
GEOMETRY = dict(num_slots=3, page_size=8, max_model_len=64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_close(got, ref, what=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), (what, err)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,k,E,cf", [(1, 2, 4, 2.0), (8, 2, 4, 1.25),
                                      (37, 1, 8, 1.0), (512, 2, 4, 2.0),
                                      (100, 2, 16, 0.5)])
def test_moe_capacity_matches_reference(T, k, E, cf):
    assert TD.moe_capacity(T, k, E, cf) == RD.moe_capacity(T, k, E, cf)


def _tied_logits(rng, T, E):
    """Random logits with rows that tie: all-zero rows (uniform
    probabilities), a row with two equal maxima, one with equal runner-ups."""
    logits = rng.randn(T, E).astype(np.float32)
    logits[0] = 0.0
    logits[3] = 0.0
    logits[5, [1, 3]] = 2.0
    logits[6] = [1.0, 0.5, 0.5, -1.0][:E] + [0.0] * (E - 4)
    return logits


@pytest.mark.parametrize("k", [1, 2])
def test_topk_gating_matches_reference_with_ties(k):
    rng = np.random.RandomState(k)
    logits = _tied_logits(rng, 16, 4)
    ri, rv, ra = RD.topk_gating(jnp.asarray(logits), k)
    ti, tv, ta = TD.topk_gating(_t(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    assert ti[0].tolist() == list(range(k))     # a tie goes to expert 0
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=1e-6)
    np.testing.assert_allclose(ta.item(), float(ra), rtol=1e-6)


def test_capacity_slots_and_drop():
    gate_idx = np.asarray([[0], [0], [0], [1]], np.int32)  # 3 tokens -> e0
    slot, keep = TD.capacity_slots(_t(gate_idx), num_experts=2, capacity=2)
    assert keep[:, 0].tolist() == [True, True, False, True]
    x = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    buf = TD.dispatch(x, slot, 2, 2)
    assert torch.equal(buf[0, 0], x[0]) and torch.equal(buf[0, 1], x[1])
    assert torch.equal(buf[1, 0], x[3])
    out = TD.combine(buf, slot, keep, torch.ones((4, 1)))
    assert torch.equal(out[0], x[0]) and torch.equal(out[2], torch.zeros(2))


@pytest.mark.parametrize("C", [3, 6, 16], ids=["drops", "some", "none"])
def test_slots_dispatch_combine_match_reference(C):
    """Arrival order is row-major over [T, k]: a drop hits the same
    assignments in both, and the buffers and the combine agree."""
    rng = np.random.RandomState(C)
    T, D, E, k = 12, 8, 4, 2
    x = rng.randn(T, D).astype(np.float32)
    ri, rv, _ = RD.topk_gating(jnp.asarray(_tied_logits(rng, T, E)), k)
    rs, rk = RD.capacity_slots(ri, E, C)
    ts, tk = TD.capacity_slots(_t(np.asarray(ri)), E, C)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    assert (C >= T) == bool(tk.all())
    rb = RD.dispatch(jnp.asarray(x), rs, E, C)
    tb = TD.dispatch(_t(x), ts, E, C)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
    eo = rng.randn(E, C, D).astype(np.float32)
    ro = RD.combine(jnp.asarray(eo), rs, rk, rv)
    to = TD.combine(_t(eo), ts, tk, _t(np.asarray(rv)))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), atol=1e-6)


def _moe_block(cfg, seed):
    """One block's expert weights (the reference's init, layer 0) and a
    numpy input with an all-zero row (uniform gate probabilities)."""
    params = G.init_params(cfg, jax.random.key(seed))
    bp = {k: np.asarray(v[0]) for k, v in params["blocks"].items()
          if k == "gate_w" or k.startswith("exp_")}
    for k in ("exp_fc1_b", "exp_fc2_b"):      # nonzero biases reach grads
        bp[k] = np.random.RandomState(seed).randn(*bp[k].shape) \
            .astype(np.float32) * 0.1
    x = np.random.RandomState(seed + 1).randn(24, cfg.hidden_size) \
        .astype(np.float32)
    x[4] = 0.0
    return bp, x


@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["no_drop", "drops"])
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_moe_ffn_dense_values_and_grads_match(cf, act):
    cfg, tcfg = G.gpt_moe_tiny(64, capacity_factor=cf), \
        TG.gpt_moe_tiny(64, capacity_factor=cf)
    cfg.activation = tcfg.activation = act
    bp, x = _moe_block(cfg, 3)
    names = sorted(bp)

    def ref_fn(x, *leaves):
        y, aux = RD.moe_ffn_dense(dict(zip(names, leaves)), x, cfg)
        return y, aux

    (ry, raux), vjp = jax.vjp(ref_fn, jnp.asarray(x),
                              *(jnp.asarray(bp[n]) for n in names))
    g = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    ref_grads = vjp((jnp.asarray(g), jnp.asarray(0.7, jnp.float32)))
    tx = _t(x).requires_grad_()
    tbp = {n: _t(bp[n]).requires_grad_() for n in names}
    ty, taux = TD.moe_ffn_dense(tbp, tx, tcfg)
    _rel_close(ty.detach().numpy(), ry, "y")
    np.testing.assert_allclose(taux.item(), float(raux), rtol=TOL)
    got = torch.autograd.grad((ty * _t(g)).sum() + 0.7 * taux,
                              [tx] + [tbp[n] for n in names])
    for n, a, b in zip(["x"] + names, got, ref_grads):
        _rel_close(a.numpy(), b, n)


# ---------------------------------------------------------------------------
# model and trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_model():
    cfg, tcfg = G.gpt_moe_tiny(64), TG.gpt_moe_tiny(64)
    params = G.init_params(cfg, jax.random.key(1))
    return cfg, params, tcfg, params_from_numpy(_np(params), tcfg, "cpu")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_moe_loss_fn_value_and_grads_match(moe_model, remat):
    cfg, params, tcfg, _ = moe_model
    rng = np.random.RandomState(2)
    tok = rng.randint(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    lab[:, -5:] = -100
    loss, grads = jax.value_and_grad(G.loss_fn)(
        params, jnp.asarray(tok), jnp.asarray(lab), cfg, remat=remat)
    _, _, aux = G.backbone(params, jnp.asarray(tok), cfg)
    tparams = params_from_numpy(_np(params), tcfg, "cpu")
    for leaf in _leaves(tparams):
        leaf.requires_grad_()
    got = TG.loss_fn(tparams, tok, lab, tcfg, remat=remat)
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    _, _, taux = TG.backbone(tparams, tok, tcfg)
    assert float(aux) > 0
    np.testing.assert_allclose(taux.item(), float(aux), rtol=TOL)
    tg = torch.autograd.grad(got, _leaves(tparams), allow_unused=True,
                             materialize_grads=True)
    ref = _leaves(_np(grads))
    assert len(tg) == len(ref)
    for a, b in zip(tg, ref):
        _rel_close(a.numpy(), b)
    assert tparams["blocks"]["gate_w"].dtype == torch.float32


def test_moe_trainer_matches_reference():
    """3 steps of the port's trainer against the JAX trainer from the same
    weights (remat on), as `test_torch_train.py` holds the dense presets;
    the losses fall, as in the reference's `test_moe_dense_learns`."""
    steps = 3
    cfg, tcfg = G.gpt_moe_tiny(64), TG.gpt_moe_tiny(64)
    jt = JH.HybridParallelTrainer(cfg, JH.MeshConfig(remat=True), seed=3)
    tparams = params_from_numpy(_np(jt.params), tcfg, "cpu")
    tt = HybridParallelTrainer(tcfg, MeshConfig(remat=True), device="cpu",
                               params=tparams)
    rng = np.random.RandomState(11)
    tok = rng.randint(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    jl = [float(jt.train_step(tok, lab)) for _ in range(steps)]
    tl = [float(tt.train_step(tok, lab)) for _ in range(steps)]
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    assert tl[-1] < tl[0]
    ref = _leaves(_np(jt.params))
    got = [p.detach().numpy() for p in _leaves(tt.params)]
    diff = np.concatenate([np.abs(a - b).ravel() for a, b in zip(got, ref)])
    assert np.mean(diff <= 1e-6) >= 0.999, np.mean(diff <= 1e-6)
    assert diff.max() <= 2 * tt.lr * steps, diff.max()


def test_convert_keeps_the_gate_float32_and_int8_passes_experts():
    cfg, tcfg = G.gpt_moe_tiny(64), TG.gpt_moe_tiny(64)
    cfg.dtype, tcfg.dtype = jnp.bfloat16, torch.bfloat16
    params = G.init_params(cfg, jax.random.key(0))
    tree = _np(params)
    assert tree["blocks"]["gate_w"].dtype == np.float32
    tparams = params_from_numpy(tree, tcfg, "cpu")
    blocks = tparams["blocks"]
    assert blocks["gate_w"].dtype == torch.float32
    assert {k for k, v in blocks.items() if v.dtype != torch.bfloat16} == \
        {"gate_w"}
    np.testing.assert_array_equal(blocks["gate_w"].numpy(),
                                  tree["blocks"]["gate_w"])
    assert TG.count_params(tparams) == G.count_params(params)
    spec = TG.param_spec(tcfg, "int8")["blocks"]
    moe_keys = {"gate_w", "exp_fc1_w", "exp_fc1_b", "exp_fc2_w", "exp_fc2_b"}
    assert moe_keys <= set(spec) and "fc1_w" not in spec
    q = quantize_serving_params(tparams, tcfg)
    for k in moe_keys:
        assert q["blocks"][k] is blocks[k]
    assert q["blocks"]["qkv_w_q"].dtype == torch.int8
    # the port's int8 tree is the reference quantizer's
    from paddle_tpu.quantization import serving as RQ
    ref = params_from_numpy(RQ.quantize_serving_params(tree, cfg), tcfg,
                            "cpu")
    for a, b in zip(_leaves(ref), _leaves(q)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

def _requests(vocab):
    rng = np.random.RandomState(5)
    return [(rng.randint(0, vocab, n).astype(np.int32), m)
            for n, m in ((3, 9), (17, 6), (26, 12), (9, 4), (38, 8))]


@pytest.fixture(scope="module")
def moe_reference(moe_model):
    """{(chunk, int8): reference engine outputs} on `_requests`."""
    cfg, params, _, _ = moe_model
    runs = {}
    for chunk, int8 in ((None, False), (8, False), (None, True)):
        quant = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
        eng = JaxEngine(params, cfg, prefill_chunk=chunk, prefix_cache=False,
                        spec_len=0, **quant, **GEOMETRY)
        runs[chunk, int8] = (_serve(eng, _requests(cfg.vocab_size)),
                             eng.stats())
    return runs


def _assert_streams(ref_outs, outs, tparams, tcfg, margin_bar):
    """Equal greedy streams; a divergence only at a near-tie of the port's
    dense forward (over the served weights), reported."""
    assert sorted(ref_outs) == sorted(outs)
    ties = []
    for rid, ref in ref_outs.items():
        a, b = list(ref.token_ids), list(outs[rid].token_ids)
        if a == b:
            assert outs[rid].finish_reason == ref.finish_reason
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        seq = np.concatenate([ref.prompt, np.asarray(a[:i], np.int32)])
        with torch.no_grad():
            top2 = torch.topk(TG.forward(tparams, seq[None], tcfg)[0, -1],
                              2).values
        margin = float(top2[0] - top2[1])
        assert margin < margin_bar, (rid, i, a, b, margin)
        ties.append((rid, i, margin))
    if ties:
        warnings.warn(f"MoE greedy ties (request, position, margin): {ties}")


@pytest.mark.parametrize("mode", ["fused_bucketed", "fused_chunked",
                                  "unfused_bucketed", "int8_bucketed"])
def test_moe_engine_streams_match_reference(moe_model, moe_reference, mode):
    """The reference's fused and unfused steps are byte-equal, so its
    fused bucketed engine stands for the unfused one too."""
    cfg, params, tcfg, tparams = moe_model
    int8 = mode.startswith("int8")
    chunk = 8 if mode.endswith("chunked") else None
    quant = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    eng = LLMEngine(tparams, tcfg, prefill_chunk=chunk, prefix_cache=False,
                    fuse=not mode.startswith("unfused"), device="cpu",
                    **quant, **GEOMETRY)
    outs = _serve(eng, _requests(cfg.vocab_size))
    ref_outs, ref_stats = moe_reference[chunk, int8]
    _assert_streams(ref_outs, outs, eng.params, tcfg,
                    INT8_TIE_MARGIN if int8 else TIE_MARGIN)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use() == 0 and not eng.has_work
    st = eng.stats()
    for k in ("kv_pool_bytes", "dense_token_footprint", "weight_dtype",
              "kv_dtype", "decode_tokens", "finished_requests"):
        assert st[k] == ref_stats[k], k
    if int8:
        assert eng.params["blocks"]["exp_fc1_w"] is tparams["blocks"][
            "exp_fc1_w"]
    else:
        for k in st:
            if k.endswith("_executables"):
                assert st[k] == ref_stats[k], k


def test_moe_engine_warm_decode_keeps_the_stream(moe_model, moe_reference):
    cfg, params, tcfg, tparams = moe_model
    eng = LLMEngine(tparams, tcfg, prefix_cache=False, device="cpu",
                    **GEOMETRY)
    eng.warm_decode()
    assert eng.stats()["decode_executables"] == 1
    outs = _serve(eng, _requests(cfg.vocab_size))
    _assert_streams(moe_reference[None, False][0], outs, tparams, tcfg,
                    TIE_MARGIN)
