"""The PyTorch port's model programs vs the JAX reference, on the CPU.

Both packages run the reference's `init_params` weights (bridged through
numpy) on the same numpy-seeded inputs, at `gpt_tiny` and `llama_tiny` in
float32 (GQA, rope, SwiGLU, RMSNorm, untied head on the Llama side).
Logits and pools agree to 1e-4 abs/rel: the same math summed in another
order; tokens and accept counts agree exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as G
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
PRESETS = [(G.gpt_tiny, TG.gpt_tiny), (G.llama_tiny, TG.llama_tiny)]
IDS = ["gpt_tiny", "llama_tiny"]


@pytest.fixture(scope="module", params=PRESETS, ids=IDS)
def models(request):
    jax_preset, port_preset = request.param
    cfg, tcfg = jax_preset(64), port_preset(64)
    params = G.init_params(cfg, jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return cfg, params, tcfg, params_from_numpy(tree, tcfg, "cpu")


def _pools(rng, cfg, num_pages, page):
    """The same random pool content for both packages (random, not zeros,
    so every read through the page table is checked)."""
    shape = (cfg.num_layers, num_pages, page, cfg.kv_heads, cfg.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def test_params_from_numpy_copies_every_leaf(models):
    cfg, params, _, tparams = models
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(
        {k: v for k, v in tparams.items()}))
    for path, leaf in flat:
        node = tparams
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_params_from_numpy_takes_bfloat16_trees(models):
    """A bf16 reference tree (ml_dtypes arrays) lands bit-exact in a bf16
    port config."""
    cfg, params, tcfg, _ = models
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), params)
    bcfg = TG.GPTConfig(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    got = params_from_numpy(tree, bcfg, "cpu")
    assert got["wte"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["blocks"]["qkv_w"].float().numpy(),
        tree["blocks"]["qkv_w"].astype(np.float32))


def test_params_from_numpy_rejects_wrong_shapes(models):
    cfg, params, tcfg, _ = models
    tree = jax.tree_util.tree_map(np.asarray, params)
    tree["wte"] = tree["wte"][:, :-1]
    with pytest.raises(ValueError, match="wte"):
        params_from_numpy(tree, tcfg, "cpu")


def test_init_params_matches_reference_keys_shapes_and_stds(models):
    cfg, params, tcfg, _ = models
    tp = TG.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax.tree_util.tree_map(lambda a: a.shape, params)
    got = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
               if isinstance(v, dict) else tuple(v.shape))
           for k, v in tp.items()}
    assert got == ref
    for name in ("qkv_w", "fc1_w"):
        assert abs(float(tp["blocks"][name].std()) -
                   float(np.std(np.asarray(params["blocks"][name])))) < 2e-3


def test_forward_logits_match(models):
    cfg, params, tcfg, tparams = models
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 12))
    ref = np.asarray(G.forward(params, jnp.asarray(toks, jnp.int32), cfg))
    got = TG.forward(tparams, toks, tcfg)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_ffn_dense_matches_reference(models):
    """Weights and inputs at unit scale, where the activation's form shows
    (jax.nn.gelu is the tanh approximation, not erf)."""
    cfg, params, tcfg, _ = models
    rng = np.random.RandomState(5)
    bp = {k: rng.randn(*np.asarray(v).shape[1:]).astype(np.float32) * 0.5
          for k, v in params["blocks"].items()
          if k.startswith(("fc1", "fcg", "fc2"))}
    h = rng.randn(3, cfg.hidden_size).astype(np.float32)
    ref = np.asarray(G._ffn_dense({k: jnp.asarray(v) for k, v in bp.items()},
                                  jnp.asarray(h), cfg))
    got = TG._ffn_dense({k: torch.from_numpy(v) for k, v in bp.items()},
                        torch.from_numpy(h), tcfg)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_prefill_paged_matches(models):
    cfg, params, tcfg, tparams = models
    rng = np.random.RandomState(1)
    page, Sb = 4, 16
    ids = np.zeros((2, Sb), np.int32)
    length = np.array([13, 7], np.int32)
    for b, n in enumerate(length):
        ids[b, :n] = rng.randint(0, cfg.vocab_size, n)
    pages = np.array([[3, 1, 8, 5], [2, 7, 4, 6]], np.int32)
    jpool, tpool = _pools(rng, cfg, 9, page)
    ref_logits, jpool = G.prefill_paged(params, jnp.asarray(ids), cfg, jpool,
                                        jnp.asarray(pages),
                                        jnp.asarray(length))
    logits, tpool = TG.prefill_paged(tparams, torch.from_numpy(ids), tcfg,
                                     tpool, torch.from_numpy(pages),
                                     torch.from_numpy(length))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpool[n].numpy(), np.asarray(jpool[n]),
                                   **TOL)


def _serve_case(cfg, rng, T=6):
    """Slot 0 decodes (valid 1) at q_offset 9, slot 1 carries a prefill
    chunk (5 of T tokens at q_offset 4), slot 2 is inactive (null row)."""
    page = 4
    tokens = rng.randint(0, cfg.vocab_size, (3, T)).astype(np.int32)
    table = np.array([[1, 5, 3, 0], [2, 4, 6, 0], [0, 0, 0, 0]], np.int32)
    q_offset = np.array([9, 4, 0], np.int32)
    valid = np.array([1, 5, 1], np.int32)
    return page, tokens, table, q_offset, valid


def _run_serve(models, tokens, table, q_offset, valid, jpool, tpool,
               sample=False):
    cfg, params, tcfg, tparams = models
    greedy = np.array([False, True, False])
    key = jax.random.key(7)
    kw = dict(sample=sample, temperature=0.7, top_k=5)
    out, acc, jpool, _ = G.serve_step_paged(
        params, jnp.asarray(tokens), jpool, jnp.asarray(table),
        jnp.asarray(q_offset), jnp.asarray(valid), cfg, key=key,
        greedy=jnp.asarray(greedy), **kw)
    noise = None
    if sample:
        # the reference's noise: sample_token splits the key once and draws
        # full-width Gumbel noise at the picked rows' dtype
        _, sub = jax.random.split(key)
        noise = torch.from_numpy(np.array(
            jax.random.gumbel(sub, (tokens.shape[0], cfg.vocab_size),
                              jnp.float32)))
    tout, tacc, tpool = TG.serve_step_paged(
        tparams, torch.from_numpy(tokens), tpool, torch.from_numpy(table),
        torch.from_numpy(q_offset), torch.from_numpy(valid), tcfg,
        greedy=torch.from_numpy(greedy), noise=noise, **kw)
    return np.asarray(out), np.asarray(acc), jpool, tout.numpy(), \
        tacc.numpy(), tpool


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_serve_step_paged_matches(models, sample):
    cfg = models[0]
    rng = np.random.RandomState(2)
    page, tokens, table, q_offset, valid = _serve_case(cfg, rng)
    jpool, tpool = _pools(rng, cfg, 7, page)
    out, acc, jpool, tout, tacc, tpool = _run_serve(
        models, tokens, table, q_offset, valid, jpool, tpool, sample)
    # active slots' real rows only: padded rows are the caller's junk, and
    # the inactive slot reads page 0, which padded rows write in a race
    for b in (0, 1):
        np.testing.assert_array_equal(tout[b, :valid[b]], out[b, :valid[b]])
    np.testing.assert_array_equal(tacc, acc)
    for n in ("k", "v"):                # page 0 takes racing padded writes
        np.testing.assert_allclose(tpool[n][:, 1:].numpy(),
                                   np.asarray(jpool[n])[:, 1:], **TOL)


def test_serve_step_paged_accepts_matching_drafts(models):
    """A verify-style slot whose drafted token equals the prediction gets
    accept >= 1, identically in both packages."""
    cfg = models[0]
    rng = np.random.RandomState(3)
    page, tokens, table, q_offset, valid = _serve_case(cfg, rng)
    jpool, tpool = _pools(rng, cfg, 7, page)
    jk, tk = {n: jnp.array(a) for n, a in jpool.items()}, \
        {n: a.clone() for n, a in tpool.items()}
    out = _run_serve(models, tokens, table, q_offset, valid, jpool, tpool)[0]
    tokens[0, 1] = out[0, 0]
    valid[0] = 3
    _, acc, _, _, tacc, _ = _run_serve(models, tokens, table, q_offset,
                                       valid, jk, tk)
    assert acc[0] >= 1
    np.testing.assert_array_equal(tacc, acc)


def test_gumbel_pick_matches_reference_sampler():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 40).astype(np.float32)
    key = jax.random.key(3)
    ref, _ = G.sample_token(jnp.asarray(logits), key, sample=True,
                            temperature=0.5, top_k=7)
    _, sub = jax.random.split(key)
    noise = np.array(jax.random.gumbel(sub, (5, 40), jnp.float32))
    got = TG._gumbel_pick(torch.from_numpy(logits), torch.from_numpy(noise),
                          0.5, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sharded_argmax_takes_the_first_maximum():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert TG.sharded_argmax(logits).tolist() == [1, 0]
