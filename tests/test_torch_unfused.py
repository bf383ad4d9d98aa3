"""The port's unfused serving step vs the JAX reference, on the CPU.

- `paged_attention_ref` (the plain version of the decode kernel) against
  the reference's `paged_attention_xla` and its Pallas kernel in interpret
  mode, MHA/GQA/MQA with lengths that end mid-page, atol 2e-5;
- `decode_step_paged` and `prefill_chunk_paged` against the reference's on
  logits and on the pool (`gpt_tiny`, `llama_tiny`, fp32, rtol 1e-4);
- `LLMEngine(fuse=False)`, bucketed and chunked, against the reference
  `LLMEngine(fuse=False, prefix_cache=False, spec_len=0)` (never warmed)
  under the greedy-tie rule of `test_torch_engine.py`, and against the
  port's own fused engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.paged_attention import (
    paged_attention_pallas, paged_attention_xla)
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    paged_attention_decode, paged_attention_kernel, paged_attention_ref)
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from test_torch_engine import GEOMETRY, PRESETS, _assert_greedy_parity, \
    _requests, _serve
from test_torch_model import TOL, _pools, models  # noqa: F401 (fixture)
from torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _decode_case(kvh, seed=0):
    """B=4 slots over a 13-page pool (page 8): non-contiguous table rows,
    lengths ending mid-page, one slot at a page boundary and one length-1
    slot on the null page."""
    rng = np.random.RandomState(seed)
    B, H, hd, page, P, mp = 4, 4, 16, 8, 13, 5
    q = rng.randn(B, H, hd).astype(np.float32)
    k = rng.randn(P, page, kvh, hd).astype(np.float32)
    v = rng.randn(P, page, kvh, hd).astype(np.float32)
    tbl = np.zeros((B, mp), np.int32)
    tbl[0, :3] = [5, 2, 9]
    tbl[1, :5] = [1, 12, 3, 4, 7]
    tbl[2, :2] = [11, 6]
    lengths = np.array([19, 37, 16, 1], np.int32)
    return q, k, v, tbl, lengths


@pytest.mark.parametrize("kvh", [4, 2, 1], ids=["mha", "gqa", "mqa"])
def test_paged_decode_plain_matches_reference(kvh):
    args = _decode_case(kvh)
    jargs = tuple(map(jnp.asarray, args))
    xla = np.asarray(paged_attention_xla(*jargs))
    pallas = np.asarray(paged_attention_pallas(*jargs, interpret=True))
    before = paged_attention_kernel.launches
    targs = tuple(map(_t, args))
    for entry in (paged_attention_ref, paged_attention_kernel,
                  paged_attention_decode):
        got = entry(*targs).numpy()
        np.testing.assert_allclose(got, xla, atol=2e-5, rtol=0)
        np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=0)
    assert paged_attention_kernel.launches == before    # CPU: plain only


def test_paged_decode_entry_refuses_later_slices():
    """Tensor-parallel attention raises; int8 pools (`kv_scales=`) are this
    slice's (tests/test_torch_quantized.py)."""
    args = tuple(map(_t, _decode_case(2)))
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        paged_attention_decode(*args, mesh=object())


def _check_pools(tpool, jpool, skip_null=False):
    lo = 1 if skip_null else 0
    for n in ("k", "v"):
        np.testing.assert_allclose(tpool[n][:, lo:].numpy(),
                                   np.asarray(jpool[n])[:, lo:], **TOL)


def test_decode_step_paged_matches(models):
    """Slot 0 mid-page, slot 1 at a page boundary, slot 2 inactive (length
    0, null row).  Logits of the active slots and every real page agree."""
    cfg, params, tcfg, tparams = models
    rng = np.random.RandomState(1)
    page = 4
    tokens = rng.randint(0, cfg.vocab_size, (3,)).astype(np.int32)
    table = np.array([[1, 5, 3, 0], [2, 4, 6, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.array([9, 8, 0], np.int32)
    jpool, tpool = _pools(rng, cfg, 7, page)
    ref, jpool = G.decode_step_paged(params, jnp.asarray(tokens), jpool,
                                     jnp.asarray(table), jnp.asarray(lengths),
                                     cfg)
    got, tpool = TG.decode_step_paged(tparams, _t(tokens), tpool, _t(table),
                                      _t(lengths), tcfg)
    assert got.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(ref)[:2], **TOL)
    _check_pools(tpool, jpool)


def test_prefill_chunk_paged_matches(models):
    """Slot 0's chunk starts mid-page at 5 with 6 real tokens; slot 1's
    starts at 0 with 3 (its padded rows go to the null page)."""
    cfg, params, tcfg, tparams = models
    rng = np.random.RandomState(2)
    page, C = 4, 8
    ids = rng.randint(0, cfg.vocab_size, (2, C)).astype(np.int32)
    table = np.array([[1, 5, 3, 0], [2, 4, 6, 0]], np.int32)
    q_offset = np.array([5, 0], np.int32)
    valid = np.array([6, 3], np.int32)
    jpool, tpool = _pools(rng, cfg, 7, page)
    ref, jpool = G.prefill_chunk_paged(params, jnp.asarray(ids), cfg, jpool,
                                       jnp.asarray(table),
                                       jnp.asarray(q_offset),
                                       jnp.asarray(valid))
    got, tpool = TG.prefill_chunk_paged(tparams, _t(ids), tcfg, tpool,
                                        _t(table), _t(q_offset), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    _check_pools(tpool, jpool, skip_null=True)  # page 0 takes padded writes


@pytest.fixture(scope="module")
def reference_unfused():
    """name -> (jax cfg, jax params, port cfg, port params, requests,
    {chunk: reference unfused outputs})"""
    out = {}
    for name, (jax_preset, port_preset) in PRESETS.items():
        cfg, tcfg = jax_preset(64), port_preset(64)
        params = G.init_params(cfg, jax.random.key(1))
        tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        reqs = _requests(cfg.vocab_size)
        streams = {}
        for chunk in (None, 8):
            eng = JaxEngine(params, cfg, prefill_chunk=chunk, fuse=False,
                            prefix_cache=False, spec_len=0, **GEOMETRY)
            streams[chunk] = _serve(eng, reqs)
        out[name] = (cfg, params, tcfg, tparams, reqs, streams)
    return out


@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
@pytest.mark.parametrize("name", list(PRESETS))
def test_unfused_streams_match_reference_unfused_engine(reference_unfused,
                                                        name, chunk):
    cfg, params, tcfg, tparams, reqs, streams = reference_unfused[name]
    eng = LLMEngine(tparams, tcfg, prefill_chunk=chunk, fuse=False,
                    prefix_cache=False, device="cpu", **GEOMETRY)
    assert not eng.double_buffer
    outs = _serve(eng, reqs)
    _assert_greedy_parity(streams[chunk], outs, params, cfg)
    eng.cache.check_invariants()
    assert eng.cache.pages_in_use() == 0 and not eng.has_work
    st = eng.stats()
    assert st["fuse"] is False and st["fused_dispatches"] == 0
    assert st["finished_requests"] == len(reqs)
    # one decode program an iteration; every token after the first comes
    # from one, every first token from a prefill
    assert st["decode_dispatches"] == st["decode_iterations"] > 0
    assert st["decode_tokens"] == \
        sum(len(o.token_ids) for o in outs.values()) - len(reqs)
    if chunk:
        assert st["chunk_dispatches"] == st["prefill_chunks"] >= len(reqs)
        assert st["prefill_dispatches"] == 0
        assert st["prefilled_tokens"] == sum(p.size for p, _ in reqs)
    else:
        assert st["prefill_dispatches"] == len(reqs)
        assert st["chunk_dispatches"] == 0


@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
def test_unfused_streams_equal_fused_streams(reference_unfused, chunk):
    """The port's two steps agree with each other token for token (the
    reference holds its own fused and unfused steps byte-equal)."""
    _, _, tcfg, tparams, reqs, _ = reference_unfused["llama_tiny"]
    outs = [_serve(LLMEngine(tparams, tcfg, prefill_chunk=chunk, fuse=fuse,
                             prefix_cache=False, device="cpu", **GEOMETRY),
                   reqs)
            for fuse in (True, False)]
    for rid, out in outs[0].items():
        assert outs[1][rid].token_ids == out.token_ids
        assert outs[1][rid].finish_reason == out.finish_reason


def test_unfused_sampling_keeps_greedy_requests_exact(reference_unfused):
    """Sampled requests on the unfused path pick through `sample_token`
    with the engine's generator: reproducible under a seed, in the
    vocabulary, and temperature=0.0 requests keep the greedy stream."""
    cfg, _, tcfg, tparams, reqs, streams = reference_unfused["gpt_tiny"]

    def serve(seed):
        eng = LLMEngine(tparams, tcfg, temperature=0.8, top_k=20, seed=seed,
                        prefill_chunk=8, fuse=False, prefix_cache=False,
                        device="cpu", **GEOMETRY)
        for i, (prompt, max_new) in enumerate(reqs):
            eng.add_request(prompt, max_new_tokens=max_new,
                            temperature=0.0 if i % 2 else None)
        assert len(eng.run()) == len(reqs)
        return eng.outputs

    a, b = serve(3), serve(3)
    for rid, out in a.items():
        assert out.token_ids == b[rid].token_ids
        assert all(0 <= t < cfg.vocab_size for t in out.token_ids)
        if rid % 2:
            assert out.token_ids == list(streams[8][rid].token_ids)
