"""The vocab-sharded serving head on the CPU — the twins of
`tests/test_sharded_head.py`.

Under tensor-parallel serving the port keeps `wte`, `lm_head` (and their
int8 twins) split along the vocab axis, the logits `[.., V/mp]` on their
rank, and merges every pick with all-reduces: `sharded_argmax` (MAX of the
ranks' maxima, then MIN of the global index where a rank holds it) is
`jnp.argmax`'s first-occurrence rule, and `sample_token`'s top-k threshold
comes from every rank's local top-k.  Each rank here gets its vocab
columns of the reference's logits (and of its Gumbel noise, the full-width
draw of the reference's key, handed in through `noise=` as
`test_torch_model.py` does) on a gloo `ServingMesh` started once for the
module per degree; the gathered picks must be the reference's.  Engine
streams: the port's mp 1, 2 and 4 engines emit the same greedy tokens as
the reference's engine, sampled streams are equal across mp under one
seed, and the int8 engine's greedy stream is equal at mp 1 and 2.  The
reference's JXP006 case audits its XLA cost model, which the port does not
have, and has no twin.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel.tp import serving_mesh
from test_torch_engine import _assert_greedy_parity
from torch_threads import one_torch_thread  # noqa: F401

MESH_TIMEOUT_S = 60.0


@pytest.fixture(scope="module")
def meshes():
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
def tiny():
    cfg, tcfg = G.gpt_tiny(64), TG.gpt_tiny(64)
    params = G.init_params(cfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                tcfg, "cpu")
    return cfg, params, tcfg, tparams


def _mixed_prompts(cfg, seed=0):
    """The reference's stream: a repeated pattern, random prompts, and one
    that extends another (prefix cache and COW on the parity path)."""
    rng = np.random.RandomState(seed)
    pat = rng.randint(0, cfg.vocab_size, (4,)).astype(np.int32)
    prompts = [np.tile(pat, 3)]
    prompts += [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
                for n in (5, 9, 17, 30)]
    prompts.append(np.concatenate(
        [prompts[-1], rng.randint(0, cfg.vocab_size, (4,)).astype(np.int32)]))
    return prompts


def _by_rank(mp, *arrays):
    """Each rank's vocab columns of every array (last axis)."""
    out = []
    for r in range(mp):
        cols = []
        for a in arrays:
            n = a.shape[-1] // mp
            cols.append(torch.from_numpy(np.ascontiguousarray(
                a[..., r * n:(r + 1) * n])))
        out.append(cols)
    return out


# ---------------------------------------------------------------------------
# unit goldens: the merge vs the replicated reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("shape", [(3, 64), (2, 3, 64)],
                         ids=["decode2d", "verify3d"])
def test_sharded_argmax_matches_replicated(meshes, mp, shape):
    """The MAX/MIN merge equals `jnp.argmax` on random logits, at both
    logits ranks the serving programs produce, the same on every rank."""
    logits = np.asarray(jax.random.normal(jax.random.key(5), shape,
                                          jnp.float32))
    outs = meshes(mp).run(TG.sharded_argmax,
                          [((x,), {}) for (x,) in _by_rank(mp, logits)])
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    for out in outs:
        assert out.dtype == torch.int32
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_argmax_tie_break_first_occurrence(meshes, mp):
    """Ties within a rank, across ranks and in the last rank only resolve
    to the lowest global index, `jnp.argmax`'s rule."""
    V = 64
    rows = [([5, 37], 5), ([40, 8], 8), ([10, 12], 10), ([63], 63),
            ([0, 32, 48], 0)]
    logits = np.zeros((len(rows), V), np.float32)
    for r, (idxs, _) in enumerate(rows):
        logits[r, idxs] = 1.0
    outs = meshes(mp).run(TG.sharded_argmax,
                          [((x,), {}) for (x,) in _by_rank(mp, logits)])
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), [w for _, w in rows])
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jnp.argmax(jnp.asarray(logits), -1)))


@pytest.mark.parametrize("top_k", [0, 7], ids=["full", "topk7"])
@pytest.mark.parametrize("mp", [2, 4])
def test_sharded_sample_token_matches_replicated(meshes, mp, top_k):
    """`sample_token` under a mesh, fed the reference's full-width noise
    for its key, picks exactly the reference's ids (mp=1 sampler): each
    rank keeps its columns of the noise, and the top-k threshold merges
    the ranks' local top-ks."""
    logits = np.asarray(jax.random.normal(jax.random.key(9), (4, 64),
                                          jnp.float32))
    key = jax.random.key(7)
    ref, _ = G.sample_token(jnp.asarray(logits), key, sample=True,
                            temperature=0.8, top_k=top_k)
    _, sub = jax.random.split(key)
    noise = torch.from_numpy(np.array(jax.random.gumbel(
        sub, (4, 64), jnp.float32)))
    kw = dict(sample=True, temperature=0.8, top_k=top_k, noise=noise)
    outs = meshes(mp).run(TG.sample_token, [((x, None), kw) for (x,) in
                                            _by_rank(mp, logits)])
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# engine parity: the same streams across mesh sizes
# ---------------------------------------------------------------------------

def _port_outputs(tiny, meshes, prompts, mp, max_new=8, **kw):
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", num_slots=3, page_size=8,
                    max_model_len=64, mesh=meshes(mp) if mp > 1 else None,
                    **kw)
    rids = [eng.add_request(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(500):
        if not eng.has_work:
            break
        eng.step()
        eng.cache.check_invariants()
    assert not eng.has_work
    return {r: eng.outputs[r] for r in rids}


def _tokens(outs):
    return [list(outs[r].token_ids) for r in sorted(outs)]


def _greedy_parity_mp124(tiny, meshes, **kw):
    """The port's mp 1, 2 and 4 engines emit the same greedy tokens, and
    they are the reference engine's."""
    cfg, params, _, _ = tiny
    prompts = _mixed_prompts(cfg)
    ref = JaxEngine(params, cfg, num_slots=3, page_size=8, max_model_len=64,
                    **kw)
    rids = [ref.add_request(p, max_new_tokens=8) for p in prompts]
    ref_outs = ref.run()
    outs = {mp: _port_outputs(tiny, meshes, prompts, mp, **kw)
            for mp in (1, 2, 4)}
    assert _tokens(outs[1]) == _tokens(outs[2]) == _tokens(outs[4])
    _assert_greedy_parity({r: ref_outs[r] for r in rids}, outs[2], params,
                          cfg)


def test_greedy_byte_parity_mp124(tiny, meshes):
    """The full serving mode (spec and chunked prefill, prefix cache and
    COW on)."""
    _greedy_parity_mp124(tiny, meshes, prefill_chunk=8, spec_len=3)


@pytest.mark.slow
@pytest.mark.parametrize("spec_len,chunk",
                         [(0, None), (3, None), (0, 8)],
                         ids=["plain", "spec", "chunked"])
def test_greedy_byte_parity_mp124_mode_matrix(tiny, meshes, spec_len, chunk):
    _greedy_parity_mp124(tiny, meshes, prefill_chunk=chunk,
                         spec_len=spec_len)


def _sampled(tiny, meshes, mps, top_k):
    cfg = tiny[0]
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 12)]
    outs = {mp: _tokens(_port_outputs(
        tiny, meshes, prompts, mp, temperature=0.8, seed=42,
        top_k=top_k or None, spec_len=0)) for mp in mps}
    return outs


def test_sampled_fixed_key_parity_mp12(tiny, meshes):
    """A fixed seed gives the same sampled streams at mp 1 and 2, with and
    without top-k: every rank draws the same full-width noise and keeps
    its columns, and the sharded pick is the mp=1 pick."""
    for tk in (0, 7):
        outs = _sampled(tiny, meshes, (1, 2), tk)
        assert outs[1] == outs[2], f"sampled divergence at top_k={tk}"


@pytest.mark.slow
def test_sampled_fixed_key_parity_mp4(tiny, meshes):
    outs = _sampled(tiny, meshes, (1, 4), 7)
    assert outs[1] == outs[4]


def test_int8_top1_agreement_mp12(tiny, meshes):
    """int8 weights: quantized before sharding, so each rank's int8 head
    holds the same quantized rows, and the greedy stream is the same at
    mp 1 and 2."""
    prompts = _mixed_prompts(tiny[0])[:3]
    outs = {mp: _tokens(_port_outputs(tiny, meshes, prompts, mp,
                                      weight_dtype="int8"))
            for mp in (1, 2)}
    assert outs[1] == outs[2]


@pytest.mark.slow
def test_int8_top1_agreement_mp4(tiny, meshes):
    prompts = _mixed_prompts(tiny[0])[:3]
    outs = {mp: _tokens(_port_outputs(tiny, meshes, prompts, mp,
                                      weight_dtype="int8", prefill_chunk=8,
                                      spec_len=2))
            for mp in (1, 4)}
    assert outs[1] == outs[4]


def test_int8_kv_pool_shards_its_scale_lanes(tiny, meshes):
    """An int8 pool under mp=2: each rank holds half the kv heads of the
    int8 pages and of their scale lanes, and the streams are mp=1's."""
    prompts = _mixed_prompts(tiny[0])[:3]
    kw = dict(weight_dtype="int8", kv_dtype="int8", prefill_chunk=8)
    one = _port_outputs(tiny, meshes, prompts, 1, **kw)
    _, _, tcfg, tparams = tiny
    eng = LLMEngine(tparams, tcfg, device="cpu", num_slots=3, page_size=8,
                    max_model_len=64, mesh=meshes(2), **kw)
    rids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
    eng.run()
    assert [eng.outputs[r].token_ids for r in rids] == _tokens(one)
    assert eng._pool["k_scale"].shape[3] == tcfg.kv_heads // 2
    assert eng._pool["k"].dtype == torch.int8
    full = LLMEngine(tparams, tcfg, device="cpu", num_slots=3, page_size=8,
                     max_model_len=64, **kw)
    assert eng.rank_pool_bytes() == [full.kv_pool_bytes() // 2] * 2
