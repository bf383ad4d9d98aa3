"""The port's quantized serving (int8 weights, int8 KV pages) vs the JAX
reference, on the CPU.

- `quantize_weight` / `quantize_serving_params` and the KV quantizer
  `_quantize_kv` equal the reference's bit for bit on the same numpy
  inputs; `params_from_numpy` carries a reference-quantized tree with its
  int8 and float32 leaves intact.
- The plain int8 lanes of the two paged kernels (`paged_attention_ref`,
  `paged_prefill_attention_ref` with `kv_scales=`) against
  `paged_*_attention_xla(kv_scales=)` and the Pallas kernels in interpret
  mode, rtol = atol = 1e-5 on valid rows (the same dequant, f32 sums in
  another order).
- `decode_step_paged`, `prefill_chunk_paged`, `prefill_paged` and
  `serve_step_paged` over int8 weights and an int8 pool against the
  reference's: int8 pool values equal except for one-step rounding flips
  (a k or v that differs from the reference's in its last f32 bits can
  round to the next int8 step: at most FLIP_SHARE of the written values,
  none more than one step), scales within SCALE_RTOL, logits within
  FP_TOL where no value flipped and within LOGIT_TOL where one did (a
  flipped step moves a dequantized value by one scale, ~1/127 of its row's
  absmax, far above f32 rounding).
- `LLMEngine(weight_dtype="int8", kv_dtype="int8")` greedy streams, fused
  and unfused, bucketed and chunked, against the reference int8 engine
  (`prefix_cache=False, spec_len=0`, never warmed); a divergence passes
  only as a near-tie, reported: the top-2 margin of the dense forward over
  the dequantized weights at that position below LOGIT_TOL.  `stats()`'s
  quantization keys equal the reference's, program counts the fp
  engine's; the fp default is byte-identical to the explicit fp knobs;
  int8 and fp engines agree on at least AGREEMENT_BAR of greedy tokens,
  the reference's bar.
- The reference's six engine keywords the port had lacked: each at its
  default builds, any other value raises `NotImplementedError` naming its
  ROADMAP item.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.paged_attention import (
    paged_attention_pallas, paged_attention_xla,
    paged_prefill_attention_pallas, paged_prefill_attention_xla)
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu.quantization import serving as RQ
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    paged_attention_decode, paged_attention_kernel, paged_attention_ref,
    paged_prefill_attention_kernel, paged_prefill_attention_ref,
    paged_serve_attention)
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.quantization import serving as TQ
from test_torch_engine import PRESETS, _serve

LANE_TOL = dict(rtol=1e-5, atol=1e-5)
FP_TOL = 1e-4           # the fp programs' logits tolerance (test_torch_model)
LOGIT_TOL = 2e-3
SCALE_RTOL = 1e-5
FLIP_SHARE = 5e-3       # one-step int8 flips allowed, of the values written
AGREEMENT_BAR = 0.85    # int8 vs fp greedy agreement (the reference's bar)
GEOMETRY = dict(num_slots=3, page_size=8, max_model_len=64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=list(PRESETS))
def quant_models(request):
    """(name, jax cfg, jax fp params, jax int8 params, port cfg, port int8
    params): the reference's weights, quantized by the reference and
    carried into the port."""
    jax_preset, port_preset = PRESETS[request.param]
    cfg, tcfg = jax_preset(64), port_preset(64)
    params = G.init_params(cfg, jax.random.key(4))
    qtree = RQ.quantize_serving_params(_np(params), cfg)
    qparams = jax.tree_util.tree_map(jnp.asarray, qtree)
    return (request.param, cfg, params, qparams, tcfg,
            params_from_numpy(qtree, tcfg, "cpu"))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((2, 64, 192), (0, 2)),
                                        ((256, 64), 0), ((64, 256), 1)],
                         ids=["blocks", "wte", "lm_head"])
def test_quantize_weight_is_the_reference_bit_for_bit(shape, axis):
    rng = np.random.RandomState(0)
    w = (rng.randn(*shape) * rng.rand(*shape[-1:]) * 3).astype(np.float32)
    w.reshape(-1)[:shape[-1]] = 0.0         # an all-zero channel somewhere
    ref_q, ref_s = RQ.quantize_weight(w, channel_axis=axis)
    q, s = TQ.quantize_weight(torch.from_numpy(w), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), ref_q)
    np.testing.assert_array_equal(s.numpy(), ref_s)
    np.testing.assert_array_equal(
        TQ.dequantize_weight(q, s).numpy(), RQ.dequantize_weight(ref_q,
                                                                ref_s))


def test_weight_quant_roundtrip_per_channel():
    rng = np.random.RandomState(0)
    w = torch.from_numpy((rng.randn(2, 64, 192) *
                          rng.rand(1, 1, 192)).astype(np.float32))
    q, s = TQ.quantize_weight(w, channel_axis=(0, 2))
    assert s.shape == (2, 1, 192) and int(q.abs().max()) <= 127
    assert bool(((TQ.dequantize_weight(q, s) - w).abs() <=
                 s / 2 + 1e-7).all())


def test_quantize_serving_params_is_the_reference(quant_models):
    _, cfg, params, _, tcfg, _ = quant_models
    tree = _np(params)
    ref = RQ.quantize_serving_params(tree, cfg)
    got = TQ.quantize_serving_params(
        params_from_numpy(tree, tcfg, "cpu"), tcfg)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat_ref) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat_ref:
        node = got
        for p in path:
            node = node[p.key]
        name = path[-1].key
        want = torch.int8 if name.endswith("_q") else \
            torch.float32 if name.endswith("_scale") else tcfg.dtype
        assert node.dtype == want, name
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert "wte" not in got and ("lm_head" not in got)
    assert got["wte_scale"].shape == (cfg.vocab_size, 1)


def test_params_from_numpy_carries_a_quantized_tree(quant_models):
    _, cfg, _, qparams, tcfg, tq = quant_models
    for path, leaf in jax.tree_util.tree_flatten_with_path(_np(qparams))[0]:
        node = tq
        for p in path:
            node = node[p.key]
        assert node.numpy().dtype == leaf.dtype, path
        np.testing.assert_array_equal(node.numpy(), leaf)
    spec = TG.param_spec(tcfg, "int8")
    assert spec["blocks"]["qkv_w_scale"][0] == (cfg.num_layers, 1,
                                                cfg.qkv_dim)


# ---------------------------------------------------------------------------
# the KV quantizer
# ---------------------------------------------------------------------------

def test_quantize_kv_is_the_reference_bit_for_bit():
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 5, 4, 64) * rng.rand(3, 5, 4, 1) * 7).astype(
        np.float32)
    x[0, 0, 0] = 0.0                                 # a zero token
    x[1, 1, 1, :8] = np.arange(8) * 0.5 - 2.0        # halves to round
    ref_q, ref_s = G._quantize_kv(jnp.asarray(x))
    q, s = TG._quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


def test_kv_quant_roundtrip():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(3, 4, 16).astype(np.float32) * 5.0)
    q, s = TG._quantize_kv(x)
    assert s.shape == (3, 4)
    deq = q.float() * s[..., None]
    assert float((deq - x).abs().max()) <= float(s.max()) / 2 + 1e-6


# ---------------------------------------------------------------------------
# the int8 lanes of the two paged kernels
# ---------------------------------------------------------------------------

def _int8_pool(rng, hd, page, KVH, P=9):
    kq, vq = (rng.randint(-127, 128, (P, page, KVH, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.rand(P, page, KVH) * 0.05).astype(np.float32)
              for _ in range(2))
    return kq, vq, ks, vs


def _lane_case(hd, page, G_, T=None, KVH=2, seed=0):
    """Three slots, non-contiguous table rows, lengths / last queries that
    end mid-page, one null-table slot."""
    rng = np.random.RandomState(seed + hd + page + G_)
    mp = 64 // page
    kq, vq, ks, vs = _int8_pool(rng, hd, page, KVH)
    tbl = np.zeros((3, mp), np.int32)
    tbl[0] = rng.permutation(np.arange(1, 9))[:mp]
    tbl[1, :mp - 1] = rng.permutation(np.arange(1, 9))[:mp - 1]
    H = KVH * G_
    if T is None:
        q = rng.randn(3, H, hd).astype(np.float32)
        per_slot = (np.array([61, 64 - page - 3, 1], np.int32),)
    else:
        q = rng.randn(3, T, H, hd).astype(np.float32)
        per_slot = (np.array([64 - T - 1, 64 - page - T - 2, 0], np.int32),
                    np.array([T, max(1, T - 1), 1], np.int32))
    return q, kq, vq, tbl, per_slot, (ks, vs)


@pytest.mark.parametrize("G_", [1, 4])
@pytest.mark.parametrize("page", [8, 32])
@pytest.mark.parametrize("hd", [64, 128])
def test_int8_decode_plain_matches_reference(hd, page, G_):
    q, kq, vq, tbl, (lengths,), scales = _lane_case(hd, page, G_)
    jargs = tuple(map(jnp.asarray, (q, kq, vq, tbl, lengths)))
    jsc = tuple(map(jnp.asarray, scales))
    xla = np.asarray(paged_attention_xla(*jargs, kv_scales=jsc))
    pallas = np.asarray(paged_attention_pallas(*jargs, interpret=True,
                                               kv_scales=jsc))
    targs = tuple(map(_t, (q, kq, vq, tbl, lengths)))
    tsc = tuple(map(_t, scales))
    before = paged_attention_kernel.launches_int8
    for entry in (paged_attention_ref, paged_attention_kernel,
                  paged_attention_decode):
        got = entry(*targs, kv_scales=tsc)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), xla, **LANE_TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **LANE_TOL)
    assert paged_attention_kernel.launches_int8 == before  # CPU: plain only


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("G_", [1, 4])
@pytest.mark.parametrize("page", [8, 32])
@pytest.mark.parametrize("hd", [64, 128])
def test_int8_prefill_plain_matches_reference(hd, page, G_, T):
    q, kq, vq, tbl, (qoff, valid), scales = _lane_case(hd, page, G_, T)
    jargs = tuple(map(jnp.asarray, (q, kq, vq, tbl, qoff, valid)))
    jsc = tuple(map(jnp.asarray, scales))
    xla = np.asarray(paged_prefill_attention_xla(*jargs, kv_scales=jsc))
    pallas = np.asarray(paged_prefill_attention_pallas(
        *jargs, interpret=True, kv_scales=jsc))
    targs = tuple(map(_t, (q, kq, vq, tbl, qoff, valid)))
    tsc = tuple(map(_t, scales))
    before = paged_prefill_attention_kernel.launches_int8
    for entry in (paged_prefill_attention_ref, paged_prefill_attention_kernel,
                  paged_serve_attention):
        got = entry(*targs, kv_scales=tsc).numpy()
        for b, n in enumerate(valid):     # rows t >= valid are padding
            np.testing.assert_allclose(got[b, :n], xla[b, :n], **LANE_TOL)
            np.testing.assert_allclose(got[b, :n], pallas[b, :n],
                                       **LANE_TOL)
    assert paged_prefill_attention_kernel.launches_int8 == before


def test_int8_lane_returns_q_dtype():
    """The reference's oracles return float32 for an int8 pool; the Pallas
    kernels, and the port, q's dtype."""
    q, kq, vq, tbl, (lengths,), scales = _lane_case(64, 8, 4)
    qb = _t(q).to(torch.bfloat16)
    out = paged_attention_ref(qb, _t(kq), _t(vq), _t(tbl), _t(lengths),
                              kv_scales=tuple(map(_t, scales)))
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the serving programs over int8 weights and an int8 pool
# ---------------------------------------------------------------------------

def _int8_pools(rng, cfg, num_pages, page):
    shape = (cfg.num_layers, num_pages, page, cfg.kv_heads, cfg.head_dim)
    leaves = {"k": rng.randint(-127, 128, shape).astype(np.int8),
              "v": rng.randint(-127, 128, shape).astype(np.int8),
              "k_scale": (rng.rand(*shape[:-1]) * 0.05).astype(np.float32),
              "v_scale": (rng.rand(*shape[:-1]) * 0.05).astype(np.float32)}
    return ({n: jnp.asarray(a) for n, a in leaves.items()},
            {n: torch.from_numpy(a.copy()) for n, a in leaves.items()})


def _check_int8_pools(tpool, jpool, skip_null=True):
    """int8 values equal but for one-step flips (counted, bounded), scales
    within SCALE_RTOL.  The null page takes padded rows' colliding writes,
    whose winner is unspecified in both frameworks.  Returns the logits
    tolerance: FP_TOL without a flip, LOGIT_TOL with one."""
    lo = 1 if skip_null else 0
    flips = 0
    for n in ("k", "v"):
        got = tpool[n][:, lo:].numpy().astype(np.int32)
        want = np.asarray(jpool[n])[:, lo:].astype(np.int32)
        diff = np.abs(got - want)
        assert diff.max() <= 1, n
        assert (diff > 0).mean() <= FLIP_SHARE, (n, (diff > 0).mean())
        flips += int((diff > 0).sum())
        np.testing.assert_allclose(tpool[n + "_scale"][:, lo:].numpy(),
                                   np.asarray(jpool[n + "_scale"])[:, lo:],
                                   rtol=SCALE_RTOL, atol=0)
    assert tpool["k"].dtype == torch.int8
    return LOGIT_TOL if flips else FP_TOL


def test_decode_step_paged_int8(quant_models):
    _, cfg, _, qparams, tcfg, tq = quant_models
    rng = np.random.RandomState(1)
    page = 4
    tokens = rng.randint(0, cfg.vocab_size, (3,)).astype(np.int32)
    table = np.array([[1, 5, 3, 0], [2, 4, 6, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([9, 8, 0], np.int32)
    jpool, tpool = _int8_pools(rng, cfg, 7, page)
    ref, jpool = G.decode_step_paged(qparams, jnp.asarray(tokens), jpool,
                                     jnp.asarray(table), jnp.asarray(lengths),
                                     cfg)
    got, tpool = TG.decode_step_paged(tq, _t(tokens), tpool, _t(table),
                                      _t(lengths), tcfg)
    tol = _check_int8_pools(tpool, jpool)
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(ref)[:2],
                               rtol=tol, atol=tol)


def test_prefill_chunk_paged_int8(quant_models):
    _, cfg, _, qparams, tcfg, tq = quant_models
    rng = np.random.RandomState(2)
    page, C = 4, 8
    ids = rng.randint(0, cfg.vocab_size, (2, C)).astype(np.int32)
    table = np.array([[1, 5, 3, 0], [2, 4, 6, 0]], np.int32)
    q_offset = np.array([5, 0], np.int32)
    valid = np.array([6, 3], np.int32)
    jpool, tpool = _int8_pools(rng, cfg, 7, page)
    ref, jpool = G.prefill_chunk_paged(qparams, jnp.asarray(ids), cfg, jpool,
                                       jnp.asarray(table),
                                       jnp.asarray(q_offset),
                                       jnp.asarray(valid))
    got, tpool = TG.prefill_chunk_paged(tq, _t(ids), tcfg, tpool, _t(table),
                                        _t(q_offset), _t(valid))
    tol = _check_int8_pools(tpool, jpool)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


def test_prefill_paged_int8(quant_models):
    """Bucketed prefill writes the quantized pool, but its own logits read
    the full-precision k/v."""
    _, cfg, _, qparams, tcfg, tq = quant_models
    rng = np.random.RandomState(3)
    page, Sb = 8, 16
    ids = rng.randint(0, cfg.vocab_size, (2, Sb)).astype(np.int32)
    pages = np.array([[3, 1], [2, 0]], np.int32)
    length = np.array([13, 6], np.int32)
    jpool, tpool = _int8_pools(rng, cfg, 5, page)
    ref, jpool = G.prefill_paged(qparams, jnp.asarray(ids), cfg, jpool,
                                 jnp.asarray(pages), jnp.asarray(length))
    got, tpool = TG.prefill_paged(tq, _t(ids), tcfg, tpool, _t(pages),
                                  _t(length))
    _check_int8_pools(tpool, jpool)
    # the logits read full-precision k/v: the fp programs' tolerance
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=FP_TOL,
                               atol=FP_TOL)


def test_serve_step_paged_int8(quant_models):
    """Two decode slots and a chunk slot in one fused step."""
    _, cfg, _, qparams, tcfg, tq = quant_models
    rng = np.random.RandomState(5)
    page, T = 4, 4
    tokens = rng.randint(0, cfg.vocab_size, (3, T)).astype(np.int32)
    table = np.array([[1, 5, 3, 0], [2, 4, 6, 0], [7, 8, 0, 0]], np.int32)
    q_offset = np.array([9, 8, 2], np.int32)
    valid = np.array([1, 1, 4], np.int32)
    jpool, tpool = _int8_pools(rng, cfg, 9, page)
    ref_out, _, jpool, _ = G.serve_step_paged(
        qparams, jnp.asarray(tokens), jpool, jnp.asarray(table),
        jnp.asarray(q_offset), jnp.asarray(valid), cfg)
    out, _, tpool = TG.serve_step_paged(tq, _t(tokens), tpool, _t(table),
                                        _t(q_offset), _t(valid), tcfg)
    ref_out = np.asarray(ref_out)
    for b, n in enumerate(valid):
        assert out[b, :n].tolist() == ref_out[b, :n].tolist()
    _check_int8_pools(tpool, jpool)


# ---------------------------------------------------------------------------
# the int8 engine against the reference int8 engine
# ---------------------------------------------------------------------------

def _requests(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, n).astype(np.int32), m)
            for n, m in ((3, 9), (17, 6), (26, 12), (9, 4), (38, 8))]


def _dequantized(qparams, cfg):
    """The reference's int8 tree with its table and head dequantized (the
    blocks dequantize in the forward): the dense model the int8 engine
    serves, without KV quantization."""
    out = {k: v for k, v in qparams.items()
           if not k.startswith(("wte_", "lm_head_"))}
    out["wte"] = G._deq(qparams["wte_q"], qparams["wte_scale"], cfg.dtype)
    if "lm_head_q" in qparams:
        out["lm_head"] = G._deq(qparams["lm_head_q"],
                                qparams["lm_head_scale"], cfg.dtype)
    return out


@pytest.fixture(scope="module")
def int8_reference(quant_models):
    """{chunk: reference int8 engine outputs, stats} on `_requests`."""
    _, cfg, params, _, _, _ = quant_models
    runs = {}
    for chunk in (None, 8):
        eng = JaxEngine(params, cfg, prefill_chunk=chunk, prefix_cache=False,
                        spec_len=0, weight_dtype="int8", kv_dtype="int8",
                        **GEOMETRY)
        runs[chunk] = (_serve(eng, _requests(cfg.vocab_size)), eng.stats())
    return runs


def _assert_int8_parity(ref_outs, got_outs, qparams, cfg):
    assert sorted(ref_outs) == sorted(got_outs)
    dense = _dequantized(qparams, cfg)
    ties = []
    for rid, ref in ref_outs.items():
        a, b = list(ref.token_ids), list(got_outs[rid].token_ids)
        if a == b:
            assert got_outs[rid].finish_reason == ref.finish_reason
            continue
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        seq = np.concatenate([ref.prompt, np.asarray(a[:i], np.int32)])
        logits = np.asarray(G.forward(dense, jnp.asarray(seq[None]),
                                      cfg))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < LOGIT_TOL, (
            f"request {rid} diverges at token {i}: reference {a}, port {b}, "
            f"top-2 margin {margin:.3g} is no near-tie")
        ties.append((rid, i, margin))
    if ties:
        warnings.warn(f"int8 greedy near-ties (request, position, margin): "
                      f"{ties}")


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
def test_int8_engine_streams_match_reference(quant_models, int8_reference,
                                             chunk, fuse):
    """The reference holds its fused and unfused steps byte-equal, so its
    fused engine's streams stand for both."""
    _, cfg, _, qparams, tcfg, tq = quant_models
    ref_outs, ref_stats = int8_reference[chunk]
    # the port quantizes fp params itself, as the reference engine does
    tparams = params_from_numpy(_np(quant_models[2]), tcfg, "cpu")
    eng = LLMEngine(tparams, tcfg, prefill_chunk=chunk, fuse=fuse,
                    weight_dtype="int8", kv_dtype="int8", device="cpu",
                    **GEOMETRY)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(eng.params), jax.tree_util.tree_leaves(tq)))
    outs = _serve(eng, _requests(cfg.vocab_size))
    _assert_int8_parity(ref_outs, outs, qparams, cfg)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use() == 0 and not eng.has_work
    st = eng.stats()
    for k in ("weight_dtype", "kv_dtype", "kv_pool_bytes"):
        assert st[k] == ref_stats[k], k
    assert eng._pool["k"].dtype == torch.int8 and set(eng._pool) == {
        "k", "v", "k_scale", "v_scale"}
    fp = LLMEngine(tparams, tcfg, prefill_chunk=chunk, fuse=fuse,
                   device="cpu", **GEOMETRY)
    _serve(fp, _requests(cfg.vocab_size))
    for k in st:
        if k.endswith("_executables"):
            assert st[k] == fp.stats()[k], k


def test_fp_default_is_byte_identical_to_explicit_fp_knobs(quant_models):
    _, cfg, params, _, tcfg, _ = quant_models
    tparams = params_from_numpy(_np(params), tcfg, "cpu")
    outs, engines = [], []
    for kw in ({}, dict(weight_dtype="bf16", kv_dtype=None)):
        eng = LLMEngine(tparams, tcfg, prefill_chunk=8, device="cpu",
                        **GEOMETRY, **kw)
        outs.append({r: o.token_ids for r, o in
                     _serve(eng, _requests(cfg.vocab_size)).items()})
        engines.append(eng)
    assert outs[0] == outs[1]
    assert engines[0].params is tparams and engines[1].params is tparams
    for eng in engines:
        st = eng.stats()
        assert st["weight_dtype"] is None and st["kv_dtype"] is None
        assert set(eng._pool) == {"k", "v"}
        assert eng._pool["k"].dtype == tcfg.dtype
    assert engines[0].kv_pool_bytes() == engines[1].kv_pool_bytes()
    q = LLMEngine(tparams, tcfg, kv_dtype="int8", device="cpu", **GEOMETRY)
    ratio = engines[0].kv_pool_bytes() / q.kv_pool_bytes()
    assert ratio == pytest.approx(TQ.kv_page_bytes(tcfg, 8) /
                                  TQ.kv_page_bytes(tcfg, 8, "int8"))
    assert TQ.kv_page_bytes(tcfg, 8) == RQ.kv_page_bytes(cfg, 8)
    assert TQ.kv_page_bytes(tcfg, 8, "int8") == \
        RQ.kv_page_bytes(cfg, 8, "int8")


@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
def test_int8_engine_top1_agreement_with_fp(quant_models, chunk):
    """The reference's bar (`test_quantized_serving.py`): greedy top-1
    agreement of the int8 engine with the fp engine, and every request
    decodes its whole budget."""
    _, cfg, params, _, tcfg, _ = quant_models
    tparams = params_from_numpy(_np(params), tcfg, "cpu")
    reqs = _requests(cfg.vocab_size)
    fp, q = ({r: o.token_ids for r, o in _serve(LLMEngine(
        tparams, tcfg, prefill_chunk=chunk, device="cpu", **GEOMETRY, **kw),
        reqs).items()}
        for kw in ({}, dict(weight_dtype="int8", kv_dtype="int8")))
    total = sum(max(len(fp[r]), len(q[r])) for r in fp)
    agree = sum(int(a == b) for r in fp for a, b in zip(fp[r], q[r]))
    assert agree / total >= AGREEMENT_BAR
    assert [len(q[r]) for r in sorted(q)] == [n for _, n in reqs]


@pytest.mark.parametrize("knob", ["weight_dtype", "kv_dtype"])
def test_quant_dtype_validation(quant_models, knob):
    _, _, _, _, tcfg, tq = quant_models
    with pytest.raises(ValueError, match=knob):
        LLMEngine(tq, tcfg, device="cpu", **GEOMETRY, **{knob: "int4"})


# ---------------------------------------------------------------------------
# the reference's engine keywords
# ---------------------------------------------------------------------------

KEYWORDS = {    # keyword: (the reference's default, another value, item)
    "draft_proposer": (None, object(), "speculative decoding"),
    "spec_backoff_window": (8, 4, "speculative decoding"),
    "swap_pool_pages": (None, 2, "optimistic admission and preemption"),
    "spill_disk_pages": (None, 8, "KV tiering, durable store and roles"),
    "trace_ring": (512, 64, "metrics, tracing and health"),
    "trace_retention": (4096, None, "metrics, tracing and health"),
}


@pytest.mark.parametrize("name", list(KEYWORDS))
def test_reference_keywords_take_their_defaults(name):
    default, other, item = KEYWORDS[name]
    cfg = TG.gpt_tiny(64)
    params = TG.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = LLMEngine(params, cfg, device="cpu", **GEOMETRY,
                    **{name: default})
    eng.add_request(np.arange(5, dtype=np.int32), max_new_tokens=2)
    assert len(eng.run()) == 1
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP Queue 1: {item}"):
        LLMEngine(params, cfg, device="cpu", **GEOMETRY, **{name: other})
