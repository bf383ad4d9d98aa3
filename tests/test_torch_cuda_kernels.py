"""The port's hand-written kernels vs their plain PyTorch versions, on the
card.  Marked `cuda`: they skip without an NVIDIA GPU.  On a machine with
the card and no jax, run them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: float32 1e-4 abs/rel (the same math summed in another order);
bfloat16 2e-2 abs/rel (the kernels round the unnormalized probabilities to
bf16 before the PV product, the plain versions the normalized ones).
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.kernels.flash_attention import (
    _flash_fwd_ref, flash_attention_fwd)
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    paged_prefill_attention_kernel, paged_prefill_attention_ref)
from paddle_tpu_torch.incubate.kernels.rms_norm import _rms_ref, \
    rms_norm_fused

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
        .to(device=dev, dtype=dtype)


def _close(got, ref, dtype):
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 64), (7, 4096), (3, 5, 100)],
                         ids=["one_row", "llama_width", "odd_width"])
def test_rms_kernel_matches_plain(dev, dtype, shape):
    rng = np.random.RandomState(0)
    x = _randn(rng, shape, dtype, dev) * 3
    w = _randn(rng, shape[-1:], dtype, dev)
    before = rms_norm_fused.launches
    got = rms_norm_fused(x, w)
    torch.cuda.synchronize()
    assert rms_norm_fused.launches == before + 1
    _close(got, _rms_ref(x, w, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,Sk,causal", [(1, 1, True), (17, 17, True),
                                         (130, 130, True), (17, 40, False)])
def test_flash_kernel_matches_plain(dev, dtype, D, S, Sk, causal):
    rng = np.random.RandomState(S + D)
    q = _randn(rng, (2, S, 3, D), dtype, dev)
    k = _randn(rng, (2, Sk, 3, D), dtype, dev)
    v = _randn(rng, (2, Sk, 3, D), dtype, dev)
    scale = 1.0 / math.sqrt(D)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = _flash_fwd_ref(q, k, v, causal, scale)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def _paged_inputs(rng, dtype, dev, T, hd, page, B=5, H=8, KVH=2,
                  max_pages=12):
    """Mixed q_offset/valid, non-contiguous table rows and one null-table
    slot (valid 1, q_offset 0)."""
    q_offset = np.array([0, 3, page * 5 + 1, page * max_pages - T, 0])
    valid = np.array([T, min(T, 2), T, T, 1])
    table = np.zeros((B, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, B * max_pages)))
    for b in range(B - 1):
        n = -(-(q_offset[b] + valid[b]) // page)
        table[b, :n] = [free.pop() for _ in range(n)]
    P = B * max_pages
    args = (_randn(rng, (B, T, H, hd), dtype, dev),
            _randn(rng, (P, page, KVH, hd), dtype, dev),
            _randn(rng, (P, page, KVH, hd), dtype, dev),
            torch.from_numpy(table).to(dev),
            torch.from_numpy(q_offset.astype(np.int32)).to(dev),
            torch.from_numpy(valid.astype(np.int32)).to(dev))
    return args, valid


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T,page", [(1, 16), (16, 16), (5, 8), (33, 32)])
def test_paged_kernel_matches_plain_on_valid_rows(dev, dtype, hd, T, page):
    rng = np.random.RandomState(T * hd + page)
    args, valid = _paged_inputs(rng, dtype, dev, T, hd, page)
    before = paged_prefill_attention_kernel.launches
    got = paged_prefill_attention_kernel(*args)
    torch.cuda.synchronize()
    assert paged_prefill_attention_kernel.launches == before + 1
    ref = paged_prefill_attention_ref(*args)
    for b, n in enumerate(valid):
        _close(got[b, :n], ref[b, :n], dtype)


def test_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.RandomState(1)
    q = _randn(rng, (1, 4, 2, 96), torch.float32, dev)
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_attention_fwd(q, q, q, True, 0.1)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), q.half(), q.half(), True, 0.1)
    args, _ = _paged_inputs(rng, torch.float32, dev, 1, 64, 16)
    with pytest.raises(ValueError, match="int32"):
        paged_prefill_attention_kernel(*args[:3], args[3].long(), *args[4:])


@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
def test_engine_on_card_matches_cpu_plain_path(dev, chunk):
    """The fp32 engine on the card (all three kernels) emits the greedy
    streams of the same engine on the CPU (plain versions), at a small
    Llama-style config whose head_dim (64) the kernels take; a divergence
    passes only as a tie (CPU top-2 margin < 1e-4)."""
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=128,
                        use_rms_norm=True, activation="silu",
                        gated_ffn=True, use_bias=False,
                        tie_word_embeddings=False, intermediate_size=512)
    cpu = gpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(dev))
            for k, v in cpu.items()}
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(0, 512, rng.randint(2, 60)), int(rng.randint(1, 12)))
            for _ in range(7)]
    outs = {}
    K.reset_launches()
    for params, d in ((cpu, "cpu"), (card, dev)):
        eng = LLMEngine(params, cfg, num_slots=3, page_size=16,
                        max_model_len=128, prefill_chunk=chunk, device=d)
        for prompt, n in reqs:
            eng.add_request(prompt, max_new_tokens=n)
        outs[str(d)] = eng.run()
    launches = K.launches()
    assert launches["paged_prefill_attention_kernel"] > 0
    assert launches["rms_norm_fused"] > 0
    assert (launches["flash_attention_fwd"] > 0) == (chunk is None)
    for rid, ref in outs["cpu"].items():
        a, b = ref.token_ids, outs[str(dev)][rid].token_ids
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([ref.prompt, np.asarray(a[:i], np.int32)])
        top2 = torch.topk(gpt.forward(cpu, seq[None], cfg)[0, -1], 2).values
        assert float(top2[0] - top2[1]) < 1e-4, (rid, i, a, b)
