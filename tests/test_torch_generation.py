"""The port's dense KV-cache generation and the BERT presets vs the JAX
reference, on the CPU.

Same numpy-seeded inputs through both packages; weights go the reference's
`init_params` -> numpy -> `params_from_numpy`.  float32 throughout.

- `prefill` and `decode_step`: logits and the cache against the
  reference's, 1e-4 relative to the largest element.
- `generate` against the reference's `generate` token for token on
  `gpt_tiny`, `llama_tiny` and `gpt_moe_tiny`, greedy and sampled (the
  port's sampler fed the reference's Gumbel noise through `noise=`); a
  divergence passes only as a near-tie (top-2 margin of the reference's
  logits below TIE_MARGIN), reported.
- The reference's generation tests, mirrored: greedy `generate` equals the
  dense forward's argmax, EOS freezes a sequence, the learned-position
  bound raises, the program cache is LRU-bounded and counts compiles.
- The port's `LLMEngine` against the port's `generate` (the reference's
  `test_engine_matches_generate` and its EOS twin).
- `bert_tiny`: forward, the MLM loss (with segment ids) and its gradients.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as G
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.parallel.hybrid import _leaves
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
TIE_MARGIN = 1e-4
PRESETS = {"gpt_tiny": (G.gpt_tiny, TG.gpt_tiny),
           "llama_tiny": (G.llama_tiny, TG.llama_tiny),
           "gpt_moe_tiny": (G.gpt_moe_tiny, TG.gpt_moe_tiny)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_close(got, ref, what=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= TOL * max(1.0, np.abs(ref).max()), (what, err)


@pytest.fixture(scope="module", params=list(PRESETS))
def model(request):
    """(name, jax cfg, jax params, port cfg, port params) at seq 64."""
    jp, tp = PRESETS[request.param]
    cfg, tcfg = jp(64), tp(64)
    params = G.init_params(cfg, jax.random.key(0))
    return (request.param, cfg, params, tcfg,
            params_from_numpy(_np(params), tcfg, "cpu"))


def _prompts(vocab, B=3, Tp=7, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (B, Tp)) \
        .astype(np.int32)


def test_prefill_and_decode_step_match(model):
    _, cfg, params, tcfg, tparams = model
    ids = _prompts(cfg.vocab_size)
    B, Tp = ids.shape
    ref_logits, ref_kv = G.prefill(params, jnp.asarray(ids), cfg,
                                   G.init_cache(cfg, B, 12))
    kv = TG.init_cache(tcfg, B, 12, device="cpu")
    logits, kv = TG.prefill(tparams, ids, tcfg, kv)
    _rel_close(logits.numpy(), ref_logits, "prefill logits")
    tok = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for pos in range(Tp, 11):
        ref_logits, ref_kv = G.decode_step(params, jnp.asarray(tok), ref_kv,
                                           pos, cfg)
        logits, kv = TG.decode_step(tparams, torch.from_numpy(tok), kv,
                                    torch.tensor(pos), tcfg)
        _rel_close(logits.numpy(), ref_logits, f"decode logits at {pos}")
        tok = np.asarray(jnp.argmax(ref_logits, -1)).astype(np.int32)
    for n in ("k", "v"):
        _rel_close(kv[n].numpy(), ref_kv[n], f"cache {n}")


def _assert_same_tokens(ref, got, params, cfg, Tp):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    ties = []
    for b in range(ref.shape[0]):
        if np.array_equal(ref[b], got[b]):
            continue
        i = int(np.nonzero(ref[b] != got[b])[0][0])
        assert i >= Tp + 1, (b, i)
        logits = np.asarray(G.forward(params, jnp.asarray(ref[b:b + 1, :i]),
                                      cfg))[0, -1]
        top2 = np.sort(logits)[-2:]
        margin = float(top2[1] - top2[0])
        assert margin < TIE_MARGIN, (b, i, ref[b], got[b], margin)
        ties.append((b, i, margin))
    if ties:
        warnings.warn(f"generate ties (row, position, margin): {ties}")


def test_greedy_generate_matches_reference(model):
    _, cfg, params, tcfg, tparams = model
    ids = _prompts(cfg.vocab_size)
    ref = G.generate(params, jnp.asarray(ids), cfg, max_new_tokens=8)
    got = TG.generate(tparams, ids, tcfg, max_new_tokens=8)
    assert got.dtype == torch.int32
    _assert_same_tokens(ref, got.numpy(), params, cfg, ids.shape[1])


def _reference_noise(cfg, B, max_new, key=None):
    """The Gumbel noise the reference's `generate` draws for each of its
    picks: `sample_token` splits the carried key once a pick."""
    key = jax.random.key(0) if key is None else key
    out = []
    for _ in range(max_new):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (B, cfg.vocab_size),
                                                jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("top_k", [None, 20], ids=["full", "top20"])
def test_sampled_generate_matches_reference_noise(model, top_k):
    _, cfg, params, tcfg, tparams = model
    ids = _prompts(cfg.vocab_size, seed=1)
    ref = G.generate(params, jnp.asarray(ids), cfg, max_new_tokens=8,
                     temperature=0.8, top_k=top_k)
    got = TG.generate(tparams, ids, tcfg, max_new_tokens=8, temperature=0.8,
                      top_k=top_k,
                      noise=_reference_noise(cfg, ids.shape[0], 8))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the port's own draws: reproducible under a seeded generator
    runs = [TG.generate(tparams, ids, tcfg, max_new_tokens=8,
                        temperature=0.8, top_k=top_k,
                        generator=torch.Generator().manual_seed(5)).numpy()
            for _ in range(2)]
    assert np.array_equal(*runs) and (runs[0] < cfg.vocab_size).all()


@pytest.mark.parametrize("preset", ["gpt_tiny", "llama_tiny"])
def test_greedy_generate_matches_full_forward(preset):
    tcfg = PRESETS[preset][1](64)
    tparams = TG.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = _prompts(tcfg.vocab_size, B=2, Tp=5)
    out = TG.generate(tparams, prompt, tcfg, max_new_tokens=6)
    assert out.shape == (2, 11)
    assert np.array_equal(out[:, :5].numpy(), prompt)
    with torch.no_grad():
        logits = TG.forward(tparams, out, tcfg)
    for t in range(4, 10):
        assert torch.equal(out[:, t + 1], logits[:, t].argmax(-1).int())


def test_generate_honors_eos():
    cfg, tcfg = G.gpt_tiny(64), TG.gpt_tiny(64)
    params = G.init_params(cfg, jax.random.key(0))
    tparams = params_from_numpy(_np(params), tcfg, "cpu")
    prompt = np.zeros((1, 3), np.int32)
    ref = TG.generate(tparams, prompt, tcfg, max_new_tokens=8)
    eos = int(ref[0, 5])                # whatever greedy emits at step 5
    out = TG.generate(tparams, prompt, tcfg, max_new_tokens=8,
                      eos_token_id=eos)
    assert (out[0, 6:] == eos).all()    # frozen at EOS after it
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(G.generate(params, jnp.asarray(prompt), cfg,
                                           max_new_tokens=8,
                                           eos_token_id=eos)))


def test_generate_seq_len_bound():
    tcfg = TG.gpt_tiny(16)
    tcfg.use_rope = False
    tparams = TG.init_params(tcfg, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="max_seq_len"):
        TG.generate(tparams, np.zeros((1, 10), np.int32), tcfg,
                    max_new_tokens=10)
    out = TG.generate(tparams, np.zeros((1, 10), np.int32), tcfg,
                      max_new_tokens=6)         # exactly max_seq_len
    assert out.shape == (1, 16)


def test_generate_cache_lru_bounded(monkeypatch):
    """The program cache is LRU-bounded and counts compiles; a cached
    (recently used) shape does not compile again."""
    cap = 4
    monkeypatch.setattr(TG, "GENERATE_CACHE_MAX", cap)
    tcfg = TG.gpt_tiny(128)
    tparams = TG.init_params(tcfg, torch.Generator(), "cpu")
    start = TG.generate_cache_stats()["compiles"]
    for tp in range(1, cap + 4):                    # more shapes than the cap
        TG.generate(tparams, np.zeros((1, tp), np.int32), tcfg,
                    max_new_tokens=2)
    st = TG.generate_cache_stats()
    assert st["size"] <= cap and st["max_size"] == cap
    assert st["compiles"] >= start + cap + 3
    before = TG.generate_cache_stats()["compiles"]
    TG.generate(tparams, np.zeros((1, cap + 3), np.int32), tcfg,
                max_new_tokens=2)
    assert TG.generate_cache_stats()["compiles"] == before
    # other weights of the same shapes are another program
    other = TG.init_params(tcfg, torch.Generator(), "cpu")
    TG.generate(other, np.zeros((1, cap + 3), np.int32), tcfg,
                max_new_tokens=2)
    assert TG.generate_cache_stats()["compiles"] == before + 1


@pytest.mark.parametrize("preset", list(PRESETS))
def test_engine_matches_generate(preset):
    """The port's continuous-batching engine emits exactly the port's
    one-shot `generate` tokens for mixed-length prompts."""
    tcfg = PRESETS[preset][1](64)
    tparams = TG.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    eng = LLMEngine(tparams, tcfg, num_slots=3, page_size=8,
                    max_model_len=64, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tcfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 9, 17, 3, 30)]
    rids = [eng.add_request(p, max_new_tokens=6) for p in prompts]
    outs = eng.run()
    for rid, p in zip(rids, prompts):
        ref = TG.generate(tparams, p[None], tcfg, max_new_tokens=6)
        np.testing.assert_array_equal(outs[rid].tokens, ref[0].numpy())
        assert outs[rid].finish_reason == "length"


def test_engine_eos_stop_matches_generate_freeze():
    tcfg = TG.gpt_tiny(64)
    tparams = TG.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = np.zeros((3,), np.int32)
    ref = TG.generate(tparams, prompt[None], tcfg, max_new_tokens=8)[0]
    eos = int(ref[5])
    frozen = TG.generate(tparams, prompt[None], tcfg, max_new_tokens=8,
                         eos_token_id=eos)[0].numpy()
    assert (frozen[6:] == eos).all()
    eng = LLMEngine(tparams, tcfg, num_slots=2, page_size=8,
                    max_model_len=64, eos_token_id=eos, device="cpu")
    rid = eng.add_request(prompt, max_new_tokens=8)
    out = eng.run()[rid]
    assert out.finish_reason == "stop" and out.token_ids[-1] == eos
    np.testing.assert_array_equal(out.tokens, frozen[:len(out.tokens)])


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

def _mlm_batch(cfg, B=2, S=64, seed=0):
    """Tokens, segment ids (two segments a row) and MLM labels (15% of the
    positions, -100 elsewhere)."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    types = (np.arange(S)[None] >= rng.randint(8, S - 8, (B, 1))) \
        .astype(np.int32)
    lab = np.where(rng.rand(B, S) < 0.15, tok, -100).astype(np.int32)
    return tok, types, lab


def _mlm_loss_ref(params, tok, types, lab, cfg):
    x, head, _ = G.backbone(params, tok, cfg, type_ids=types)
    s, n = G._ce_sums(jnp.matmul(x, head), lab)
    return s / jnp.maximum(n, 1.0)


def _mlm_loss(params, tok, types, lab, cfg, remat=False):
    x, head, _ = TG.backbone(params, tok, cfg, type_ids=types, remat=remat)
    s, n = TG._ce_sums(torch.matmul(x, head), torch.as_tensor(lab).long())
    return s / torch.clamp(n, min=1.0)


def test_bert_presets_match_reference():
    for jp, tp in ((G.bert_base, TG.bert_base), (G.bert_tiny, TG.bert_tiny)):
        ref, got = jp(), tp()
        assert {k: v for k, v in vars(got).items() if k != "dtype"} == \
            {k: v for k, v in vars(ref).items() if k != "dtype"}
    assert TG.bert_config(num_layers=3).num_layers == 3


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_bert_tiny_forward_mlm_loss_and_grads_match(remat):
    cfg, tcfg = G.bert_tiny(64), TG.bert_tiny(64)
    params = G.init_params(cfg, jax.random.key(2))
    tok, types, lab = _mlm_batch(cfg)
    tparams = params_from_numpy(_np(params), tcfg, "cpu")
    with torch.no_grad():
        _rel_close(TG.forward(tparams, tok, tcfg).numpy(),
                   G.forward(params, jnp.asarray(tok), cfg), "forward")
    loss, grads = jax.value_and_grad(_mlm_loss_ref)(
        params, jnp.asarray(tok), jnp.asarray(types), jnp.asarray(lab), cfg)
    for leaf in _leaves(tparams):
        leaf.requires_grad_()
    got = _mlm_loss(tparams, tok, types, lab, tcfg, remat)
    np.testing.assert_allclose(got.item(), float(loss), rtol=TOL)
    tg = torch.autograd.grad(got, _leaves(tparams), allow_unused=True,
                             materialize_grads=True)
    ref = _leaves(_np(grads))
    assert len(tg) == len(ref)
    for a, b in zip(tg, ref):
        _rel_close(a.numpy(), b)
    # loss_fn (segment 0 everywhere) too
    ref_l = G.loss_fn(params, jnp.asarray(tok), jnp.asarray(lab), cfg)
    with torch.no_grad():
        np.testing.assert_allclose(
            TG.loss_fn(tparams, tok, lab, tcfg).item(), float(ref_l),
            rtol=TOL)
