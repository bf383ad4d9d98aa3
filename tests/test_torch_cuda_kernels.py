"""The port's hand-written kernels vs their plain PyTorch versions, on the
card.  Marked `cuda`: they skip without an NVIDIA GPU.  On a machine with
the card and no jax, run them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerances: float32 1e-4 abs/rel (the same math summed in another order);
bfloat16 2e-2 abs/rel (the kernels round the unnormalized probabilities to
bf16 before the PV product, the plain versions the normalized ones).  The
attention backward: max abs error within 1e-4 * max(1, max|ref|) in
float32 and 2e-2 * max(1, max|ref|) in bfloat16 (p and dS round to bf16 at
the same points in both, so only a flipped rounding of a term differs; the
floor of 1 covers gradients that are rounding noise, as at S = 1).  The
segment-masked kernels are held to the same tolerances as the dense ones.
In bf16 the forward runs the tensor-core body (wgmma, `FWD_BODY`), in
float32 the CUDA-core one; the backward pair, dense and segment-masked,
runs the tensor-core body in bf16 at D 64 and 128 and the CUDA-core one
otherwise (`BWD_BODY`).  Each body is held to the same plain versions.
The serving engine's step programs (`inference/graphs.py`) are held on
the card too: each program's graph replay bitwise equal to the eager step
(tokens and pool), sampled streams with and without graphs, a warmed
chunked loop under `torch.cuda.set_sync_debug_mode("error")`.
The int8 lanes of the two paged kernels (an int8 pool with f32 scales, as
`models.gpt._quantize_kv` writes it) are held to their plain versions at
float32 1e-4 and, for bfloat16 q, 1e-2 (no p rounding in either: the two
differ by the output's one bf16 rounding, and sums in another order); an
int8 serving step replayed from its graph equals the eager step bitwise on
tokens and all four pool leaves.
"""
import contextlib
import math
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.incubate.kernels.flash_attention import (
    BWD_BODY, _flash_bwd_ref, _flash_fwd_ref, _flash_fwd_seg_ref, attention_ref,
    attention_ref_segmented, flash_attention_bwd, flash_attention_fused,
    flash_attention_fwd, flash_attention_seg_bwd, flash_attention_seg_fwd,
    flash_attention_varlen, flash_bwd_dkv, flash_bwd_dq, flash_bwd_seg_dkv,
    flash_bwd_seg_dq)
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    DECODE_CK, PREFILL_CK, _decode_split_plan, _prefill_split_plan,
    paged_attention_kernel, paged_attention_ref,
    paged_prefill_attention_kernel, paged_prefill_attention_ref)
from paddle_tpu_torch.incubate.kernels.rms_norm import (
    RING_BYTES, _padded, _rms_launch, _rms_ref, rms_norm_fused)

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
INT8_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


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


RMS_DTYPES = [(torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32),
              (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("xw", RMS_DTYPES,
                         ids=["f32", "bf16", "bf16_f32w", "f32_bf16w"])
@pytest.mark.parametrize("shape,offset", [
    ((8, 4096), 0), ((4096, 4096), 0), ((2, 14336), 0), ((128, 4096), 1),
    ((3, 40000), 0), ((33, 100), 0), ((5, 4100), 0)],
    ids=["decode", "square", "ffn_width", "unaligned", "two_pass", "odd",
         "ragged_w"])
def test_rms_kernel_launch_shapes_and_dtypes(dev, xw, shape, offset):
    """Every launch shape of `_rms_launch` (the ring kernel for wide
    rows, with 2 or 4 stages; on the register kernel one warp a row,
    single-element pieces for a pointer off 16 bytes, a w row of no whole
    16 bytes, a row read twice) in each dtype pair: the product in
    promote(x, w), the plain version's values, and the same bits from two
    calls."""
    xd, wd = xw
    rng = np.random.RandomState(shape[0] + offset)
    N, D = shape
    flat = _randn(rng, (N * D + offset,), xd, dev) * 3
    x = flat[offset:].view(N, D)
    w = _randn(rng, (D,), wd, dev)
    xs, wsz = x.element_size(), w.element_size()
    plan = _rms_launch(D, xs, wsz, x.data_ptr() % 16 == 0)
    vec = 16 // xs if offset == 0 and D % (16 // xs) == 0 else 1
    ring = vec > 1 and D > 1024 and D * wsz % 16 == 0 and \
        2 * _padded(D * xs) <= RING_BYTES - _padded(D * wsz)
    assert plan.vec == vec and (plan.stages > 0) == ring
    before = rms_norm_fused.launches
    got = rms_norm_fused(x, w)
    again = rms_norm_fused(x, w)
    torch.cuda.synchronize()
    assert rms_norm_fused.launches == before + 2
    assert got.dtype == torch.promote_types(xd, wd)
    ref = _rms_ref(x, w, 1e-6)
    assert ref.dtype == got.dtype
    _close(got, ref, xd)        # y rounds to x's dtype before the product
    assert torch.equal(got, again)


def _split_decode_inputs(rng, dtype, dev, hd, G, ck, page=16, KVH=2):
    """Lengths on the split edges (1, ck - 1, ck, ck + 1), several splits,
    0, and the whole table row; non-contiguous table rows."""
    max_pages = -(-(3 * ck + 7) // page)
    S = max_pages * page
    lengths = np.array([1, ck - 1, ck, ck + 1, 3 * ck + 5, 0, S])
    B, H = len(lengths), KVH * G
    table = np.zeros((B, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, B * max_pages)))
    for b in range(B):
        n = -(-lengths[b] // page)
        table[b, :n] = [free.pop() for _ in range(n)]
    P = B * max_pages
    args = (_randn(rng, (B, H, hd), dtype, dev),
            _randn(rng, (P, page, KVH, hd), dtype, dev),
            _randn(rng, (P, page, KVH, hd), dtype, dev),
            torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))
    return args, lengths


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_paged_decode_splits_merge_on_the_card(dev, dtype, hd, G):
    """Slots of one split (written out directly) and of several (merged by
    the last block) against the plain version, length 0 giving 0, and two
    calls giving the same bits."""
    rng = np.random.RandomState(hd + G)
    args, lengths = _split_decode_inputs(rng, dtype, dev, hd, G, DECODE_CK)
    B, H, _ = args[0].shape
    plan = _decode_split_plan(B, H, args[1].shape[2], hd, args[1].shape[1],
                              args[3].shape[1])
    assert plan.nsplit >= 4 and plan.ck == DECODE_CK
    before = paged_attention_kernel.launches
    got = paged_attention_kernel(*args)
    again = paged_attention_kernel(*args)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 2
    live = lengths > 0
    _close(got[live], paged_attention_ref(*args)[live], dtype)
    assert float(got[~live].abs().max()) == 0.0
    assert torch.equal(got, again)


def test_decode_and_prefill_share_the_merge_counters(dev):
    """Decode, then the prefill kernel, then decode again on one stream,
    with shapes that change between calls: each kernel's merging blocks
    leave the shared counters at 0, so every call matches the plain
    version and a repeated call repeats its bits."""
    firsts = {}
    for rnd in range(2):
        for i, (dtype, hd, G) in enumerate([(torch.bfloat16, 128, 4),
                                            (torch.float32, 64, 16),
                                            (torch.bfloat16, 256, 1)]):
            rng = np.random.RandomState(i)
            dargs, lengths = _split_decode_inputs(rng, dtype, dev, hd, G,
                                                  DECODE_CK)
            pargs, valid = _paged_inputs(rng, dtype, dev, 16, hd, 16, G=G)
            outs = [paged_attention_kernel(*dargs),
                    paged_prefill_attention_kernel(*pargs),
                    paged_attention_kernel(*dargs)]
            torch.cuda.synchronize()
            assert torch.equal(outs[0], outs[2])
            if rnd == 0:
                live = lengths > 0
                _close(outs[0][live], paged_attention_ref(*dargs)[live],
                       dtype)
                ref = paged_prefill_attention_ref(*pargs)
                for b, n in enumerate(valid):
                    _close(outs[1][b, :n], ref[b, :n], dtype)
                firsts[i] = outs
            else:
                assert all(torch.equal(a, b)
                           for a, b in zip(outs, firsts[i]))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,Sk,causal", [
    (1, 1, True), (17, 17, True), (130, 130, True), (17, 40, False),
    # one tile less, exactly and one more; many tiles of the K/V ring and
    # the diagonal tiles of both warpgroups; ragged keys, no mask
    (63, 63, True), (64, 64, True), (65, 65, True), (1000, 1000, True),
    (2048, 2048, True), (100, 333, False)])
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


def _grad_close(name, got, ref, dtype):
    err = float((got.float() - ref.float()).abs().max())
    top = float(ref.float().abs().max())
    lim = (1e-4 if dtype == torch.float32 else 2e-2) * max(1.0, top)
    assert err <= lim, f"{name}: max abs err {err:.3g} > {lim:.3g}"


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,Sk,causal", [
    (1, 1, True), (17, 17, True), (130, 130, True), (200, 200, True),
    (17, 40, False), (70, 33, False),
    # the tensor-core body's 64-row tiles: one less, exactly, one more, at
    # one and two tiles; many tiles of the rings; ragged keys, no mask
    (63, 63, True), (64, 64, True), (65, 65, True), (127, 127, True),
    (128, 128, True), (129, 129, True), (1000, 1000, True),
    (2048, 2048, True), (100, 333, False)])
def test_flash_bwd_kernels_match_plain(dev, dtype, D, S, Sk, causal):
    """dkv and dq against `_flash_bwd_ref` on the plain forward's out and
    lse; ragged tiles on both axes, causal and full."""
    rng = np.random.RandomState(S + Sk + D)
    q = _randn(rng, (2, S, 3, D), dtype, dev)
    k = _randn(rng, (2, Sk, 3, D), dtype, dev)
    v = _randn(rng, (2, Sk, 3, D), dtype, dev)
    g = _randn(rng, (2, S, 3, D), dtype, dev)
    scale = 1.0 / math.sqrt(D)
    out, lse = _flash_fwd_ref(q, k, v, causal, scale)
    before = (flash_bwd_dkv.launches, flash_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal, scale)
    torch.cuda.synchronize()
    assert (flash_bwd_dkv.launches, flash_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = _flash_bwd_ref(q, k, v, out, lse, g, causal, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        _grad_close(name, a, b, dtype)


@pytest.mark.parametrize("seg", [False, True], ids=["dense", "seg"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_bwd_takes_strided_views(dev, dtype, seg):
    """q, k, v as the strided views a packed qkv projection gives (every
    BERT layer, GPT's v): the backward pair equals its call on contiguous
    copies bitwise.  The wrappers copy such views and must hold the copies
    until the launch is queued, or the outputs they allocate next can be
    given the copies' memory while the kernels read it."""
    rng = np.random.RandomState(5)
    B, S, H, D = 4, 512, 12, 64
    qkv = _randn(rng, (B, S, 3 * H * D), dtype, dev)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, -1))
    g = _randn(rng, (B, S, H, D), dtype, dev)
    ids = torch.zeros((B, S), dtype=torch.int32, device=dev)
    ids[:, S // 3:] = 1
    out, lse = _flash_fwd_ref(q, k, v, False, 0.125)
    bwd = (lambda *a: flash_attention_seg_bwd(*a[:3], ids, ids, *a[3:],
                                              False, 0.125)) if seg else \
        (lambda *a: flash_attention_bwd(*a, False, 0.125))
    want = bwd(*(t.contiguous() for t in (q, k, v)), out, lse, g)
    for _ in range(3):
        got = bwd(q, k, v, out, lse, g)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,Sk,causal", [(1000, 1000, True),
                                         (100, 333, False)])
def test_flash_bwd_is_bitwise_deterministic(dev, D, S, Sk, causal):
    """One owner per output tile and no atomics: two bf16 backward calls on
    the same inputs give the same bits of dq, dk and dv."""
    rng = np.random.RandomState(S + D)
    q, g = (_randn(rng, (2, S, 3, D), torch.bfloat16, dev) for _ in range(2))
    k, v = (_randn(rng, (2, Sk, 3, D), torch.bfloat16, dev) for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    out, lse = _flash_fwd_ref(q, k, v, causal, scale)
    first = flash_attention_bwd(q, k, v, out, lse, g, causal, scale)
    for _ in range(2):
        again = flash_attention_bwd(q, k, v, out, lse, g, causal, scale)
        for name, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("seg", [False, True], ids=["dense", "seg"])
def test_bwd_body_names_the_kernels_that_run(dev, dtype, D, seg):
    """`BWD_BODY[(dtype, D, seg)]` names the body whose two kernels the
    backward launches, read from the profiler's device kernel names."""
    rng = np.random.RandomState(D)
    q, k, v, g = (_randn(rng, (1, 130, 2, D), dtype, dev) for _ in range(4))
    ids = torch.zeros((1, 130), dtype=torch.int32, device=dev)
    ids[:, 70:] = 1
    out, lse = _flash_fwd_ref(q, k, v, True, 0.1)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        if seg:
            flash_attention_seg_bwd(q, k, v, ids, ids, out, lse, g, True, 0.1)
        else:
            flash_attention_bwd(q, k, v, out, lse, g, True, 0.1)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    suffix = {"wgmma": "_wgmma", "cuda_core": "_kernel"}[
        BWD_BODY[(dtype, D, seg)]]
    for part in ("flash_bwd_dkv", "flash_bwd_dq"):
        ran = [n for n in names if part in n]
        assert len(ran) == 1 and part + suffix in ran[0], (part, names)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_kernel_entries_are_differentiable(dev, dtype):
    """`flash_attention_fused` and `rms_norm_fused` return a tensor with a
    grad_fn whenever an input requires grad, and their gradients match
    autograd through the plain versions on the same inputs."""
    rng = np.random.RandomState(5)
    q, k, v, g = (_randn(rng, (2, 77, 4, 64), dtype, dev) for _ in range(4))
    grads = []
    for fn in (flash_attention_fused, attention_ref):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts, causal=True)
        assert out.grad_fn is not None
        out.backward(g)
        grads.append([t.grad for t in ts])
    for name, a, b in zip(("dq", "dk", "dv"), *grads):
        _grad_close(name, a, b, dtype)
    x, gy = (_randn(rng, (5, 300), dtype, dev) * 2 for _ in range(2))
    w = _randn(rng, (300,), dtype, dev)
    grads = []
    for fn in (rms_norm_fused, lambda a, b: _rms_ref(a, b, 1e-6)):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xs, ws)
        assert y.grad_fn is not None
        y.backward(gy)
        grads.append((xs.grad, ws.grad))
    for a, b in zip(*grads):
        _close(a, b, dtype)


def test_train_step_on_card_matches_cpu(dev):
    """One float32 AdamW step at a gpt_tiny-shaped config whose head_dim
    (64) the kernels take: the card (flash forward, dkv and dq kernels,
    once per layer each) agrees with the CPU plain path.  The first Adam
    step moves each element by ~lr * sign(g), so an element whose
    gradient is numerically zero may move 2 * lr apart."""
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    from paddle_tpu_torch.parallel.hybrid import _leaves

    cfg = gpt.GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                        num_heads=2, max_seq_len=128)
    cpu = gpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    trainers = [HybridParallelTrainer(
        cfg, MeshConfig(remat=True), device=d,
        params={k: ({kk: vv.clone() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.clone())
                for k, v in cpu.items()}) for d in ("cpu", dev)]
    tok = np.random.RandomState(0).randint(0, 256, (2, 128))
    lab = np.roll(tok, -1, axis=1)
    losses = [float(trainers[0].train_step(tok, lab))]
    K.reset_launches()
    losses.append(float(trainers[1].train_step(tok, lab)))
    n = K.launches()
    assert (n["flash_attention_fwd"], n["flash_bwd_dkv"],
            n["flash_bwd_dq"]) == (2, 2, 2)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    diff = torch.cat([(a.detach().cpu() - b.detach()).abs().reshape(-1)
                      for a, b in zip(_leaves(trainers[1].params),
                                      _leaves(trainers[0].params))])
    assert float((diff <= 1e-6).float().mean()) >= 0.999
    assert float(diff.max()) <= 2 * trainers[0].lr


def _paged_inputs(rng, dtype, dev, T, hd, page, G=4, KVH=2):
    """Mixed q_offset/valid over rows of at least 3 * PREFILL_CK + T
    positions, non-contiguous table rows and one null-table slot (valid 1,
    q_offset 0).  Slots 1, 4 and 5 hold G * valid at, just below and just
    above the stream lane's capacity (GC), so both lanes run in one call;
    slot 3 ends on its row's last position and slot 4 starts past 2 * CK
    (several splits); slot 5's chunk starts 3 keys below a split."""
    max_pages = -(-(3 * PREFILL_CK + T) // page)
    S, CK = page * max_pages, PREFILL_CK
    gc = _prefill_split_plan(7, T, G * KVH, KVH, hd, page, max_pages).gc
    q_offset = np.array([0, 3, page * 5 + 1, S - T, 2 * CK + 5, CK - 3, 0])
    valid = np.array([T, gc // G, T, T, max(gc // G - 1, 1), gc // G + 1, 1])
    valid = np.clip(valid, 1, T)
    B = len(valid)
    table = np.zeros((B, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, B * max_pages)))
    for b in range(B - 1):
        n = -(-(q_offset[b] + valid[b]) // page)
        table[b, :n] = [free.pop() for _ in range(n)]
    P = B * max_pages
    args = (_randn(rng, (B, T, G * KVH, hd), dtype, dev),
            _randn(rng, (P, page, KVH, hd), dtype, dev),
            _randn(rng, (P, page, KVH, hd), dtype, dev),
            torch.from_numpy(table).to(dev),
            torch.from_numpy(q_offset.astype(np.int32)).to(dev),
            torch.from_numpy(valid.astype(np.int32)).to(dev))
    return args, valid


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T,page", [(1, 16), (16, 16), (5, 8), (33, 32)])
@pytest.mark.parametrize("G", [4, 1, 8])
def test_paged_kernel_matches_plain_on_valid_rows(dev, dtype, hd, T, page,
                                                  G):
    """Valid rows against the plain version, padding rows 0, one launch."""
    rng = np.random.RandomState(T * hd + page + G)
    args, valid = _paged_inputs(rng, dtype, dev, T, hd, page, G=G)
    before = paged_prefill_attention_kernel.launches
    got = paged_prefill_attention_kernel(*args)
    torch.cuda.synchronize()
    assert paged_prefill_attention_kernel.launches == before + 1
    ref = paged_prefill_attention_ref(*args)
    for b, n in enumerate(valid):
        _close(got[b, :n], ref[b, :n], dtype)
        assert not got[b, n:].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 16])
def test_paged_kernel_is_bitwise_deterministic(dev, dtype, T):
    """The split merge reads the partials in split order, whichever block
    finishes last: two calls give the same bits."""
    rng = np.random.RandomState(T)
    args, _ = _paged_inputs(rng, dtype, dev, T, 128, 16)
    before = paged_prefill_attention_kernel.launches
    first = paged_prefill_attention_kernel(*args)
    again = paged_prefill_attention_kernel(*args)
    torch.cuda.synchronize()
    assert paged_prefill_attention_kernel.launches == before + 2
    assert torch.equal(first, again)


def test_paged_kernel_shapes_back_to_back(dev):
    """Calls of other shapes between two of the same shape: the merge
    counters return to 0 after every call (a stale count would make the
    wrong block merge), so each call matches the plain version and the
    repeated call repeats its bits."""
    cases = [(torch.bfloat16, 16, 128, 16, 4), (torch.float32, 1, 64, 8, 8),
             (torch.bfloat16, 33, 256, 32, 1), (torch.float32, 5, 128, 16, 4)]
    firsts = []
    for rnd in range(2):
        for i, (dtype, T, hd, page, G) in enumerate(cases):
            rng = np.random.RandomState(i)
            args, valid = _paged_inputs(rng, dtype, dev, T, hd, page, G=G)
            got = paged_prefill_attention_kernel(*args)
            torch.cuda.synchronize()
            if rnd == 0:
                ref = paged_prefill_attention_ref(*args)
                for b, n in enumerate(valid):
                    _close(got[b, :n], ref[b, :n], dtype)
                firsts.append(got)
            else:
                assert torch.equal(got, firsts[i])


def _quantized(args):
    """Paged kernel arguments with their float pool replaced by the int8
    pool and scales `models.gpt._quantize_kv` makes of it: (args,
    kv_scales)."""
    from paddle_tpu_torch.models.gpt import _quantize_kv
    (kq, ks), (vq, vs) = (_quantize_kv(x.float()) for x in args[1:3])
    return (args[0], kq, vq, *args[3:]), (ks, vs)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("T,page", [(1, 16), (16, 16), (1, 32), (16, 32)])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_int8_paged_kernel_matches_plain_on_valid_rows(dev, dtype, hd, T,
                                                       page, G):
    """The prefill kernel's int8 lane (stream and tile lanes, key splits,
    a null-table slot): valid rows against the plain version, padding rows
    0, one launch counted on `launches_int8`."""
    rng = np.random.RandomState(T * hd + page + G)
    fargs, valid = _paged_inputs(rng, dtype, dev, T, hd, page, G=G)
    args, scales = _quantized(fargs)
    before = (paged_prefill_attention_kernel.launches,
              paged_prefill_attention_kernel.launches_int8)
    got = paged_prefill_attention_kernel(*args, kv_scales=scales)
    torch.cuda.synchronize()
    assert (paged_prefill_attention_kernel.launches,
            paged_prefill_attention_kernel.launches_int8) == \
        (before[0], before[1] + 1)
    assert got.dtype == dtype
    ref = paged_prefill_attention_ref(*args, kv_scales=scales)
    for b, n in enumerate(valid):
        torch.testing.assert_close(got[b, :n].float(), ref[b, :n].float(),
                                   **INT8_TOL[dtype])
        assert not got[b, n:].any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("page", [16, 32])
def test_int8_decode_kernel_matches_plain(dev, dtype, hd, G, page):
    """The decode kernel's int8 lane over slots of one split and of several
    (lengths on the split edges), length 0 giving 0."""
    rng = np.random.RandomState(hd + G + page)
    fargs, lengths = _split_decode_inputs(rng, dtype, dev, hd, G, DECODE_CK,
                                          page=page)
    args, scales = _quantized(fargs)
    before = paged_attention_kernel.launches_int8
    got = paged_attention_kernel(*args, kv_scales=scales)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches_int8 == before + 1
    ref = paged_attention_ref(*args, kv_scales=scales)
    live = lengths > 0
    torch.testing.assert_close(got[live].float(), ref[live].float(),
                               **INT8_TOL[dtype])
    assert float(got[~live].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_int8_paged_kernels_are_bitwise_deterministic(dev, dtype):
    """Both int8 lanes merge their splits in split order: two calls give
    the same bits (prefill at T 1 and 16, decode)."""
    rng = np.random.RandomState(11)
    for T in (1, 16):
        args, scales = _quantized(_paged_inputs(rng, dtype, dev, T, 128,
                                                16)[0])
        first = paged_prefill_attention_kernel(*args, kv_scales=scales)
        again = paged_prefill_attention_kernel(*args, kv_scales=scales)
        assert torch.equal(first, again)
    args, scales = _quantized(_split_decode_inputs(rng, dtype, dev, 128, 4,
                                                   DECODE_CK)[0])
    first = paged_attention_kernel(*args, kv_scales=scales)
    again = paged_attention_kernel(*args, kv_scales=scales)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_int8_lanes_refuse_what_they_do_not_take(dev):
    rng = np.random.RandomState(3)
    args, scales = _quantized(_paged_inputs(rng, torch.float32, dev, 1, 64,
                                            16)[0])
    with pytest.raises(TypeError, match="dtype"):
        paged_prefill_attention_kernel(*args)               # no scales
    with pytest.raises(TypeError, match="kv_scales"):
        paged_prefill_attention_kernel(
            *args, kv_scales=(scales[0].half(), scales[1]))
    with pytest.raises(TypeError, match="kv_scales"):
        paged_prefill_attention_kernel(
            *args, kv_scales=(scales[0][:, :8], scales[1]))
    dargs, _ = _decode_inputs(rng, torch.float32, dev, 64, 4, 16)
    with pytest.raises(TypeError, match="kv_scales"):
        paged_attention_kernel(*dargs, kv_scales=scales)    # float pool


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_weight_dequant_is_one_rounding_of_the_f32_product(dev, dtype):
    """`models.gpt._deq` (one multiply into the compute dtype) gives the
    bits of the reference's two-step `(q.astype(f32) * scale).astype()`."""
    from paddle_tpu_torch.models.gpt import _deq
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randint(-127, 128, (4096, 1024)).astype(
        np.int8)).to(dev)
    s = torch.from_numpy(rng.rand(1, 1024).astype(np.float32) * 0.03).to(dev)
    assert torch.equal(_deq(q, s, dtype), (q.float() * s).to(dtype))


def test_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.RandomState(1)
    q = _randn(rng, (1, 4, 2, 96), torch.float32, dev)
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_attention_fwd(q, q, q, True, 0.1)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.half(), q.half(), q.half(), True, 0.1)
    lse = torch.zeros((2, 4, 1), device=dev)
    with pytest.raises(ValueError, match="unsupported shapes"):
        flash_attention_bwd(q, q, q, q, lse, q, True, 0.1)
    q = _randn(rng, (1, 4, 2, 64), torch.float32, dev)
    with pytest.raises(ValueError, match="lse/delta"):
        flash_attention_bwd(q, q, q, q, lse[:, :-1], q, True, 0.1)
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


def _decode_inputs(rng, dtype, dev, hd, G, page, KVH=2, max_pages=9):
    """Six slots: lengths ending mid-page, on a page boundary, a single
    token, the whole row, and 0 (the kernel gives 0 there); non-contiguous
    table rows."""
    lengths = np.array([page * 3 + 5, page * 2, 1, page * max_pages,
                        page + 1, 0])
    B, H = len(lengths), KVH * G
    table = np.zeros((B, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, B * max_pages)))
    for b in range(B):
        n = -(-lengths[b] // page)
        table[b, :n] = [free.pop() for _ in range(n)]
    P = B * max_pages
    args = (_randn(rng, (B, H, hd), dtype, dev),
            _randn(rng, (P, page, KVH, hd), dtype, dev),
            _randn(rng, (P, page, KVH, hd), dtype, dev),
            torch.from_numpy(table).to(dev),
            torch.from_numpy(lengths.astype(np.int32)).to(dev))
    return args, lengths


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 16])
@pytest.mark.parametrize("page", [16, 8])
def test_paged_decode_kernel_matches_plain(dev, dtype, hd, G, page):
    rng = np.random.RandomState(hd + G + page)
    args, lengths = _decode_inputs(rng, dtype, dev, hd, G, page)
    before = paged_attention_kernel.launches
    got = paged_attention_kernel(*args)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 1
    ref = paged_attention_ref(*args)
    live = lengths > 0          # length 0: the kernel's 0, the oracle's mean
    _close(got[live], ref[live], dtype)
    assert float(got[~live].abs().max()) == 0.0


def _seg_inputs(rng, dtype, dev, S, Sk, D, causal):
    """Random (unsorted) segment ids in [0, 4); non-causal cross layouts
    draw the key ids from [0, 3), so segment-3 rows see no key."""
    B, H = 2, 3
    seg_q = rng.randint(0, 4, (B, S)).astype(np.int32)
    seg_k = seg_q if causal else rng.randint(0, 3, (B, Sk)).astype(np.int32)
    if causal:
        seg_q = np.sort(seg_q, axis=1)          # packed runs, one unsorted
        seg_q[1] = rng.randint(0, 4, S)
        seg_k = seg_q
    qkv = [_randn(rng, (B, L, H, D), dtype, dev) for L in (S, Sk, Sk, S)]
    segs = [torch.from_numpy(a).to(dev) for a in (seg_q, seg_k)]
    return qkv, segs


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,Sk,causal", [
    (1, 1, True), (77, 77, True), (200, 200, True), (70, 33, False),
    (130, 130, False),
    # the tensor-core backward's 64-row tiles (128-row dq blocks): one less,
    # exactly, one more, at one and two tiles; many tiles of the rings
    (63, 63, True), (64, 64, True), (65, 65, True), (127, 127, True),
    (128, 128, True), (129, 129, True), (1000, 1000, True)])
def test_seg_flash_kernels_match_plain(dev, dtype, D, S, Sk, causal):
    """Forward (out, lse) and the backward pair under the segment mask,
    ragged tiles, rows with no visible key (out 0, lse -1e30); causal
    cases hold one batch row of sorted ids and one of unsorted ids."""
    rng = np.random.RandomState(S + Sk + D)
    (q, k, v, g), (sq, sk) = _seg_inputs(rng, dtype, dev, S, Sk, D, causal)
    scale = 1.0 / math.sqrt(D)
    before = (flash_attention_seg_fwd.launches, flash_bwd_seg_dkv.launches,
              flash_bwd_seg_dq.launches)
    out, lse = flash_attention_seg_fwd(q, k, v, sq, sk, causal, scale)
    ref_out, ref_lse = _flash_fwd_seg_ref(q, k, v, sq, sk, causal, scale)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    got = flash_attention_seg_bwd(q, k, v, sq, sk, ref_out, ref_lse, g,
                                  causal, scale)
    torch.cuda.synchronize()
    assert (flash_attention_seg_fwd.launches, flash_bwd_seg_dkv.launches,
            flash_bwd_seg_dq.launches) == tuple(n + 1 for n in before)
    ref = _flash_bwd_ref(q, k, v, ref_out, ref_lse, g, causal, scale,
                         seg=(sq, sk))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        _grad_close(name, a, b, dtype)


def _skip_patterns(name, rng):
    """(causal, seg_q [1, S], seg_k [1, Sk]) whose 64-key tiles the bf16
    forward either skips (segment-id range disjoint from the query block's)
    or masks element by element."""
    if name == "interleaved":           # 0, 5, 0, 5, ...: every range overlaps
        ids = np.tile([0, 5], 550)
        return True, ids, ids
    if name == "length_one":            # each row sees itself only
        ids = np.arange(1024)
        return True, ids, ids
    if name == "every_offset":          # a boundary at each offset of a tile
        ids = np.repeat(np.arange(64), 65)
        return True, ids, ids
    if name == "unsorted_runs":         # packed runs, ids shuffled
        lens = []
        while sum(lens) < 2048:
            lens.append(int(rng.randint(1, 300)))
        lens[-1] -= sum(lens) - 2048
        ids = np.repeat(rng.permutation(len(lens)), lens)
        return True, ids, ids
    # blind: long runs of query rows whose id no key has (across many
    # tiles), beside rows that see some keys
    sq = np.repeat([7, 0, 7, 2, 1, 9], [300, 100, 200, 150, 74, 200])
    sk = np.repeat([0, 1, 2, 3], [400, 300, 500, 300])
    return False, sq, sk


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("name", ["interleaved", "length_one",
                                  "every_offset", "unsorted_runs", "blind"])
def test_seg_fwd_kernel_skips_tiles_exactly(dev, dtype, D, name):
    """The segment forward at S >= 1024, where the bf16 body skips key
    tiles by segment-id range: out, lse (rows that see nothing: out 0, lse
    -1e30 + log(1e-30)) against `_flash_fwd_seg_ref`; one launch."""
    rng = np.random.RandomState(D)
    causal, sq, sk = _skip_patterns(name, rng)
    S, Sk = len(sq), len(sk)
    q = _randn(rng, (1, S, 2, D), dtype, dev)
    k, v = (_randn(rng, (1, Sk, 2, D), dtype, dev) for _ in range(2))
    sq, sk = (torch.from_numpy(a.astype(np.int32)[None]).to(dev)
              for a in (sq, sk))
    scale = 1.0 / math.sqrt(D)
    before = flash_attention_seg_fwd.launches
    out, lse = flash_attention_seg_fwd(q, k, v, sq, sk, causal, scale)
    torch.cuda.synchronize()
    assert flash_attention_seg_fwd.launches == before + 1
    ref_out, ref_lse = _flash_fwd_seg_ref(q, k, v, sq, sk, causal, scale)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def _skip_case(rng, dtype, dev, D, name):
    """A `_skip_patterns` case at one batch row, two heads: (causal, q,
    k, v, dO, seg_q, seg_k)."""
    causal, sq, sk = _skip_patterns(name, rng)
    S, Sk = len(sq), len(sk)
    q, g = (_randn(rng, (1, S, 2, D), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (1, Sk, 2, D), dtype, dev) for _ in range(2))
    sq, sk = (torch.from_numpy(a.astype(np.int32)[None]).to(dev)
              for a in (sq, sk))
    return causal, q, k, v, g, sq, sk


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("name", ["interleaved", "length_one",
                                  "every_offset", "unsorted_runs", "blind"])
def test_seg_bwd_kernels_skip_tiles_exactly(dev, dtype, D, name):
    """The segment backward pair on the forward's tile-skip patterns, where
    both bodies skip walked tiles by segment-id range (query tiles in dkv,
    key tiles in dq): dq, dk, dv against `_flash_bwd_ref` on the plain
    forward's out and lse (blind rows: lse ~ -1e30, gradient 0); one launch
    of each kernel."""
    rng = np.random.RandomState(D + 1)
    causal, q, k, v, g, sq, sk = _skip_case(rng, dtype, dev, D, name)
    scale = 1.0 / math.sqrt(D)
    out, lse = _flash_fwd_seg_ref(q, k, v, sq, sk, causal, scale)
    before = (flash_bwd_seg_dkv.launches, flash_bwd_seg_dq.launches)
    got = flash_attention_seg_bwd(q, k, v, sq, sk, out, lse, g, causal,
                                  scale)
    torch.cuda.synchronize()
    assert (flash_bwd_seg_dkv.launches, flash_bwd_seg_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = _flash_bwd_ref(q, k, v, out, lse, g, causal, scale, seg=(sq, sk))
    for part, a, b in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(part, a, b, dtype)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("name", ["unsorted_runs", "blind"])
def test_seg_flash_bwd_is_bitwise_deterministic(dev, D, name):
    """One owner per output tile and no atomics under the segment mask too:
    two bf16 calls of the pair give the same bits of dq, dk and dv."""
    rng = np.random.RandomState(D + 2)
    causal, q, k, v, g, sq, sk = _skip_case(rng, torch.bfloat16, dev, D,
                                            name)
    out, lse = _flash_fwd_seg_ref(q, k, v, sq, sk, causal, 0.1)
    first = flash_attention_seg_bwd(q, k, v, sq, sk, out, lse, g, causal, 0.1)
    for _ in range(2):
        again = flash_attention_seg_bwd(q, k, v, sq, sk, out, lse, g, causal,
                                        0.1)
        for part, a, b in zip(("dq", "dk", "dv"), first, again):
            assert torch.equal(a, b), part


# (D, S, Sk, causal) the kernels do not take: the entries route them to the
# plain versions on the card, as the reference routes them to XLA
ROUTED_CASES = {"hd16": (16, 40, 40, True), "hd96": (96, 40, 40, True),
                "causal_short_q": (64, 24, 40, True),
                "causal_long_q": (128, 40, 24, True)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(ROUTED_CASES))
def test_entries_route_shapes_the_kernels_do_not_take(dev, dtype, name):
    """`flash_attention_fused` (forward and gradients), `flash_attention_
    varlen` and, at hd 16 and 96, the four paged entries give their plain
    versions' values on the card through the counted composed route, and
    launch no kernel."""
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.incubate.kernels.paged_attention import (
        paged_attention_decode, paged_prefill_attention,
        paged_serve_attention, paged_verify_attention)
    D, S, Sk, causal = ROUTED_CASES[name]
    rng = np.random.RandomState(D + S)
    q, g = (_randn(rng, (2, S, 3, D), dtype, dev) for _ in range(2))
    k, v = (_randn(rng, (2, Sk, 3, D), dtype, dev) for _ in range(2))
    seg_q, seg_k = (torch.from_numpy(np.sort(rng.randint(0, 3, (2, L)), 1)
                                     .astype(np.int32)).to(dev)
                    for L in (S, Sk))
    K.reset_launches()
    results = []
    for fn in (flash_attention_fused, attention_ref):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts, causal=causal)
        out.backward(g)
        results.append([out.detach()] + [t.grad for t in ts])
    for got, ref in zip(*results):
        _close(got, ref, dtype)
    _close(flash_attention_varlen(q, k, v, seg_q, seg_k, causal=causal),
           attention_ref_segmented(q, k, v, seg_q, seg_k, causal,
                                   1.0 / math.sqrt(D)), dtype)
    paged = D not in (64, 128, 256)
    if paged:
        args, valid = _paged_inputs(rng, dtype, dev, 5, D, 8)
        ref = paged_prefill_attention_ref(*args)
        for entry in (paged_prefill_attention, paged_verify_attention,
                      paged_serve_attention):
            got = entry(*args)
            for b, n in enumerate(valid):
                _close(got[b, :n], ref[b, :n], dtype)
        args, lengths = _decode_inputs(rng, dtype, dev, D, 4, 16)
        live = lengths > 0
        _close(paged_attention_decode(*args)[live],
               paged_attention_ref(*args)[live], dtype)
    torch.cuda.synchronize()
    assert K.composed_calls() == {
        "flash_attention_fused": 1, "flash_attention_varlen": 1,
        "paged_prefill_attention": 3 if paged else 0,
        "paged_attention_decode": 1 if paged else 0}
    assert set(K.launches().values()) == {0}


def test_hd16_model_trains_and_serves_on_card(dev):
    """A `gpt_tiny` config (head dim 16, which no attention kernel takes)
    takes a float32 train step on the card with the CPU's loss, and serves
    greedy requests with the CPU's streams (a divergence passes only as a
    tie), every attention call on the counted plain route."""
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig

    cfg = gpt.gpt_tiny()
    cpu = gpt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def on(d):
        return {k: ({kk: vv.clone().to(d) for kk, vv in v.items()}
                    if isinstance(v, dict) else v.clone().to(d))
                for k, v in cpu.items()}

    tok = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 64))
    lab = np.roll(tok, -1, axis=1)
    losses = [float(HybridParallelTrainer(
        cfg, MeshConfig(remat=True), device="cpu", params=on("cpu"))
        .train_step(tok, lab))]
    K.reset_launches()
    losses.append(float(HybridParallelTrainer(
        cfg, MeshConfig(remat=True), device=dev, params=on(dev))
        .train_step(tok, lab)))
    assert K.composed_calls()["flash_attention_fused"] == cfg.num_layers
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, cfg.vocab_size, n), 6) for n in (5, 23, 40)]
    outs = {}
    for params, d in ((on("cpu"), "cpu"), (on(dev), dev)):
        K.reset_launches()
        eng = LLMEngine(params, cfg, num_slots=2, page_size=16,
                        max_model_len=128, device=d)
        for prompt, n in reqs:
            eng.add_request(prompt, max_new_tokens=n)
        outs[str(d)] = eng.run()
    routed = K.composed_calls()
    assert routed["flash_attention_fused"] > 0
    assert routed["paged_prefill_attention"] > 0
    assert set(K.launches().values()) == {0}
    for rid, ref in outs["cpu"].items():
        a, b = ref.token_ids, outs[str(dev)][rid].token_ids
        assert len(b) == len(a) == 6
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([ref.prompt, np.asarray(a[:i], np.int32)])
        top2 = torch.topk(gpt.forward(cpu, seq[None], cfg)[0, -1], 2).values
        assert float(top2[0] - top2[1]) < 1e-4, (rid, i, a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_varlen_entries_are_differentiable(dev, dtype):
    """`flash_attention_varlen` and `flash_attn_unpadded` (kernel route)
    return a grad_fn, and their gradients match autograd through the plain
    `attention_ref_segmented` where every row sees a key."""
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    rng = np.random.RandomState(7)
    q, k, v, g = (_randn(rng, (1, 150, 4, 64), dtype, dev) for _ in range(4))
    cu = [0, 40, 41, 150]
    seg = torch.tensor([[0] * 40 + [1] + [2] * 109], device=dev,
                       dtype=torch.int32)
    grads = []
    for fn in (lambda a, b, c: flash_attention_varlen(a, b, c, seg),
               lambda a, b, c: flash_attn_unpadded(
                   a[0], b[0], c[0], cu, cu, 109, 109, 0.125,
                   causal=True)[0][None],
               lambda a, b, c: attention_ref_segmented(a, b, c, seg, seg,
                                                       True, 0.125)):
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ts)
        assert out.grad_fn is not None
        out.backward(g)
        grads.append([t.grad for t in ts])
    for other in grads[:2]:
        for name, a, b in zip(("dq", "dk", "dv"), other, grads[2]):
            _grad_close(name, a, b, dtype)


def test_new_kernels_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.nn.functional import flash_attention
    rng = np.random.RandomState(2)
    args, _ = _decode_inputs(rng, torch.float32, dev, 64, 4, 16)
    with pytest.raises(ValueError, match=r"\[B, H, hd\]"):
        paged_attention_kernel(args[0][:, None], *args[1:])
    with pytest.raises(ValueError, match="int32"):
        paged_attention_kernel(*args[:4], args[4].long())
    q = _randn(rng, (1, 8, 2, 64), torch.float32, dev)
    seg = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        flash_attention_seg_fwd(q, q, q, seg.long(), seg, True, 0.1)
    with pytest.raises(ValueError, match="S == Sk"):
        flash_attention_seg_fwd(q, q[:, :4], q[:, :4], seg, seg[:, :4],
                                True, 0.1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(q, q, q, dropout=0.1, segment_ids=seg)


@pytest.mark.parametrize("chunk", [None, 8], ids=["bucketed", "chunked"])
def test_unfused_engine_on_card_matches_cpu_plain_path(dev, chunk):
    """`LLMEngine(fuse=False)` in fp32 on the card emits the greedy streams
    of the same engine on the CPU; the decode kernel launches once a layer
    a decode dispatch.  A divergence passes only as a tie."""
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
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(0, 512, rng.randint(2, 60)), int(rng.randint(1, 12)))
            for _ in range(7)]
    outs, stats = {}, {}
    for params, d in ((cpu, "cpu"), (card, dev)):
        K.reset_launches()
        eng = LLMEngine(params, cfg, num_slots=3, page_size=16,
                        max_model_len=128, prefill_chunk=chunk, fuse=False,
                        device=d)
        for prompt, n in reqs:
            eng.add_request(prompt, max_new_tokens=n)
        outs[str(d)] = eng.run()
        stats[str(d)] = eng.stats()
    launches = K.launches()
    st = stats[str(dev)]
    assert launches["paged_attention_kernel"] == \
        cfg.num_layers * st["decode_dispatches"] > 0
    assert launches["paged_prefill_attention_kernel"] == \
        cfg.num_layers * st["chunk_dispatches"]
    assert launches["flash_attention_fwd"] == \
        cfg.num_layers * st["prefill_dispatches"]
    for rid, ref in outs["cpu"].items():
        a, b = ref.token_ids, outs[str(dev)][rid].token_ids
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([ref.prompt, np.asarray(a[:i], np.int32)])
        top2 = torch.topk(gpt.forward(cpu, seq[None], cfg)[0, -1], 2).values
        assert float(top2[0] - top2[1]) < 1e-4, (rid, i, a, b)


# ---------------------------------------------------------------------------
# the serving engine's step programs as CUDA graphs (`inference/graphs.py`)
# ---------------------------------------------------------------------------

def _small_llama(dtype):
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=128,
                        use_rms_norm=True, activation="silu",
                        gated_ffn=True, use_bias=False,
                        tie_word_embeddings=False, intermediate_size=512)
    cfg.dtype = dtype
    return cfg


def _card_params(cfg, dev, seed=0):
    from paddle_tpu_torch.models import gpt
    return gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)


# role -> (program, fuse, prefill_chunk, spec_len); 3 slots, page 16, 8
# pages a slot.  fused_spec: the fused step at T = 5 with drafts (its output
# carries the accept column); verify: the unfused verify program
STEP_ROLES = {"fused_t1": ("fused", True, None, 0),
              "fused_t16": ("fused", True, 16, 0),
              "fused_spec": ("fused", True, None, 4),
              "decode": ("decode", False, 16, 0),
              "chunk": ("chunk", False, 16, 0),
              "verify": ("verify", False, None, 4),
              "prefill_b64": ("prefill:64", True, None, 0)}
# the attention kernel each program launches once a layer
ATTENTION_OF = {"decode": "paged_attention_kernel",
                "prefill:64": "flash_attention_fwd"}


def _step_inputs(role, rng, eng, offsets=(37, 16)):
    """Identical staged inputs for one program: slot 0 decodes at
    offsets[0], slot 1 runs a chunk (or decodes) at offsets[1], slot 2 is
    inactive (null row); the active rows hold the pages they reach."""
    mgr = eng.cache
    P = mgr.max_pages_per_slot
    T = 16 if role == "chunk" else eng._fused_T if role == "fused" else \
        eng.spec_len + 1 if role == "verify" else 1
    table = np.zeros((mgr.num_slots, P), np.int32)
    pages = list(rng.permutation(np.arange(1, mgr.num_pages)))
    for b, q0 in enumerate(offsets):
        n = (q0 + T) // mgr.page_size + 1
        table[b, :n] = [pages.pop() for _ in range(n)]
    if role == "chunk":
        return dict(tokens=rng.randint(0, 512, (1, 16)), table=table[1:2],
                    q_offset=[offsets[1]], valid=[11], greedy=[True])
    if role.startswith("prefill:"):         # a 51-token prompt, bucket 64
        width = int(role.split(":")[1])
        rows = [pages.pop() for _ in range(width // mgr.page_size)]
        return dict(ids=rng.randint(0, 512, (1, width)), pages=[rows],
                    length=[width - 13], greedy=[True])
    if role == "decode":
        return dict(tokens=rng.randint(0, 512, 3), table=table,
                    lengths=np.array([*offsets, 0]),
                    greedy=np.ones(3, bool))
    # spec: slot 0 drafted 2 tokens, slot 1 a full draft; else slot 0
    # decodes and slot 1 runs a chunk
    inputs = dict(tokens=rng.randint(0, 512, (3, T)), table=table,
                  q_offset=np.array([*offsets, 0]),
                  valid=np.array([3 if eng.spec_len else 1, T, 1]))
    if role == "verify":
        return inputs
    return dict(inputs, greedy=np.ones(3, bool))


def _small_moe(dtype):
    """The MoE family (LayerNorm, GELU, biases, tied head) at the small
    llama's attention widths: 4 experts, top-2, capacity factor 2."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=2, max_seq_len=128,
                        intermediate_size=512, moe_num_experts=4,
                        moe_capacity_factor=2.0)
    cfg.dtype = dtype
    return cfg


def _replay_and_eager(dev, dtype, role, int8=False, small=_small_llama):
    """One replay of the step program `role` and one eager step on
    identical staged inputs and an identical random pool (int8 weights and
    pool with `int8`) of the `small` model: {eager: (tokens, pool after,
    launches, int8 launches, replays)}.  The warm-up may write page 0
    only."""
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    name, fuse, chunk, spec_len = STEP_ROLES[role]
    cfg = small(dtype)
    params = _card_params(cfg, dev)
    rng = np.random.RandomState(7)
    shape = (cfg.num_layers, 13, 16, 2, 64)
    if int8:
        pool = {n: torch.from_numpy(rng.randint(-127, 128, shape).astype(
            np.int8)).to(dev) for n in ("k", "v")}
        pool.update({n: torch.rand(shape[:-1], device=dev) * 0.05
                     for n in ("k_scale", "v_scale")})
    else:
        pool = {n: _randn(rng, shape, dtype, dev) for n in ("k", "v")}
    quant = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    runs = {}
    for eager in (False, True):
        eng = LLMEngine(params, cfg, num_slots=3, page_size=16,
                        max_model_len=128, num_pages=13, prefill_chunk=chunk,
                        fuse=fuse, spec_len=spec_len, device=dev,
                        _eager=eager, **quant)
        assert set(eng._pool) == set(pool)
        for n in pool:
            eng._pool[n].copy_(pool[n])
        prog = eng._program(name)
        prog.build()
        for n in pool:                      # the warm-up wrote page 0 only
            assert torch.equal(eng._pool[n][:, 1:], pool[n][:, 1:])
            eng._pool[n].copy_(pool[n])
        prog.stage(**_step_inputs(name, np.random.RandomState(3), eng))
        torch.cuda.synchronize()
        K.reset_launches()
        prog.run()
        out = prog.result()
        runs[eager] = (out, {n: t.clone() for n, t in eng._pool.items()},
                       K.launches(), K.launches_int8(), prog.replays)
        assert (prog.graph is None) == eager
    return cfg, name, runs


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("role", list(STEP_ROLES))
def test_step_replay_is_bitwise_the_eager_step(dev, dtype, role):
    """One replay of each step program (fused at T 1 and 16, fused at T 5
    with drafts, unfused decode, chunk and verify, the one-shot prefill of
    bucket 64) against the eager step on identical staged inputs and an
    identical pool: output tokens (and the fused step's accept column) and
    every real page of the pool after the step bitwise equal, and the same
    kernel launch counts.  Page 0 is left out, as in the int8 twin below:
    inactive and padded rows write there at colliding positions, whose
    winner the scatter does not fix (the null page is read only for
    outputs the scheduler drops)."""
    cfg, name, runs = _replay_and_eager(dev, dtype, role)
    (g_out, g_pool, g_n, _, g_rep), (e_out, e_pool, e_n, _, e_rep) = \
        runs[False], runs[True]
    assert np.array_equal(g_out, e_out)
    for n in ("k", "v"):
        assert torch.equal(g_pool[n][:, 1:], e_pool[n][:, 1:]), n
    assert g_n == e_n and (g_rep, e_rep) == (1, 0)
    kern = ATTENTION_OF.get(name, "paged_prefill_attention_kernel")
    assert g_n[kern] == cfg.num_layers and g_n["rms_norm_fused"] > 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("role", list(STEP_ROLES))
def test_int8_step_replay_is_bitwise_the_eager_step(dev, dtype, role):
    """The same over int8 weights and an int8 pool: tokens and all four
    pool leaves bitwise equal, every paged launch on the int8 lane.  Page 0
    is left out: inactive and padded rows write there at colliding
    positions, whose winner the scatter does not fix (the null page is
    read only for outputs the scheduler drops)."""
    cfg, name, runs = _replay_and_eager(dev, dtype, role, int8=True)
    (g_out, g_pool, g_n, g_q, g_rep), (e_out, e_pool, e_n, e_q, e_rep) = \
        runs[False], runs[True]
    assert np.array_equal(g_out, e_out)
    assert set(g_pool) == {"k", "v", "k_scale", "v_scale"}
    for n in g_pool:
        assert torch.equal(g_pool[n][:, 1:], e_pool[n][:, 1:]), n
    assert (g_n, g_q) == (e_n, e_q) and (g_rep, e_rep) == (1, 0)
    kern = ATTENTION_OF.get(name, "paged_prefill_attention_kernel")
    if kern in g_q:         # a paged kernel: on the int8 lane only
        assert g_q[kern] == cfg.num_layers and g_n[kern] == 0
    else:                   # the prefill attends to its fp k/v
        assert g_n[kern] == cfg.num_layers and set(g_q.values()) == {0}


@pytest.mark.parametrize("mode", ["fused_bucketed", "fused_chunked",
                                  "unfused_chunked"])
def test_sampled_streams_equal_with_and_without_graphs(dev, mode):
    """A sampling engine (temperature 0.8, top-k 20, one seed) gives the
    same streams with graphs and eagerly: the noise is drawn from the
    generator outside the graph, the same draws either way.  On graphs,
    every program dispatch is one replay (the KV tier's spill gathers and
    restore scatters among them), and the program counts stay within the
    budget."""
    from paddle_tpu_torch.analysis.registry import over_budget
    from paddle_tpu_torch.inference.engine import LLMEngine
    cfg = _small_llama(torch.bfloat16)
    params = _card_params(cfg, dev, seed=1)
    fuse, chunk = mode.startswith("fused"), \
        None if mode.endswith("bucketed") else 8
    rng = np.random.RandomState(2)
    reqs = [(rng.randint(0, 512, rng.randint(2, 60)), int(rng.randint(1, 12)))
            for _ in range(7)]
    streams, stats = {}, {}
    for eager in (False, True):
        eng = LLMEngine(params, cfg, num_slots=3, page_size=16,
                        max_model_len=128, prefill_chunk=chunk, fuse=fuse,
                        temperature=0.8, top_k=20, seed=9, device=dev,
                        _eager=eager)
        for i, (prompt, n) in enumerate(reqs):
            eng.add_request(prompt, max_new_tokens=n,
                            temperature=0.0 if i % 3 == 0 else None)
        streams[eager] = {r: o.token_ids for r, o in eng.run().items()}
        stats[eager] = eng.stats()
    assert streams[False] == streams[True]
    st = stats[False]
    assert st["graph_replays"] == st["fused_dispatches"] + \
        st["decode_dispatches"] + st["chunk_dispatches"] + \
        st["prefill_dispatches"] + st["cow_page_copies"] + \
        st["swap_out_dispatches"] + st["swap_in_dispatches"] > 0
    assert stats[True]["graph_replays"] == 0
    assert st["decode_executables"] == 1 and not over_budget(st)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("role", ["fused_t1", "fused_t16", "decode", "chunk",
                                  "prefill_b64"])
def test_moe_step_replay_is_bitwise_the_eager_step(dev, dtype, role):
    """The MoE engine's programs (the gate, capacity slots, dispatch, the
    batched expert GEMMs and the combine inside each layer): one replay
    bitwise the eager step on tokens and real pages, the same launches."""
    cfg, name, runs = _replay_and_eager(dev, dtype, role, small=_small_moe)
    (g_out, g_pool, g_n, _, g_rep), (e_out, e_pool, e_n, _, e_rep) = \
        runs[False], runs[True]
    assert np.array_equal(g_out, e_out)
    for n in ("k", "v"):
        assert torch.equal(g_pool[n][:, 1:], e_pool[n][:, 1:]), n
    assert g_n == e_n and (g_rep, e_rep) == (1, 0)
    kern = ATTENTION_OF.get(name, "paged_prefill_attention_kernel")
    assert g_n[kern] == cfg.num_layers and g_n["rms_norm_fused"] == 0


@pytest.mark.parametrize("small", [_small_llama, _small_moe],
                         ids=["llama", "moe"])
def test_generate_graph_loop_is_bitwise_the_eager_loop(dev, small):
    """`generate` replays its prefill graph and its decode-step graph; the
    tokens equal the eager loop's bitwise, greedy and sampled on the same
    generator, with the EOS freeze; a second call with the same key
    compiles nothing, replays, and never syncs (a device prompt)."""
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.models import gpt
    cfg = small(torch.bfloat16)
    params = _card_params(cfg, dev)
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 512, (3, 37))).to(dev)
    greedy = None
    for kw in (dict(), dict(temperature=0.8, top_k=20),
               dict(eos_token_id=7)):
        outs, counts = [], []
        for eager in (False, True):
            if "temperature" in kw:
                kw["generator"] = torch.Generator(dev).manual_seed(3)
            K.reset_launches()
            outs.append(gpt.generate(params, ids, cfg, max_new_tokens=9,
                                     _eager=eager, **kw))
            torch.cuda.synchronize()
            counts.append(K.launches())
        assert torch.equal(outs[0], outs[1]), kw
        assert counts[0] == counts[1] and \
            counts[0]["flash_attention_fwd"] == cfg.num_layers
        greedy = outs[0] if greedy is None else greedy
    before = gpt.generate_cache_stats()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = gpt.generate(params, ids, cfg, max_new_tokens=9)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = gpt.generate_cache_stats()
    assert after["compiles"] == before["compiles"]
    assert after["replays"] == before["replays"] + 9
    assert torch.equal(again, greedy)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_flash_kernels_at_the_encoder_shape(dev, dtype):
    """BERT-base's attention, [16, 512, 12, 64] non-causal: the forward and
    the backward pair against their plain versions."""
    rng = np.random.RandomState(64)
    q, k, v, g = (_randn(rng, (16, 512, 12, 64), dtype, dev)
                  for _ in range(4))
    scale = 1.0 / 8.0
    out, lse = flash_attention_fwd(q, k, v, False, scale)
    ref_out, ref_lse = _flash_fwd_ref(q, k, v, False, scale)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    got = flash_attention_bwd(q, k, v, ref_out, ref_lse, g, False, scale)
    ref = _flash_bwd_ref(q, k, v, ref_out, ref_lse, g, False, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(name, a, b, dtype)
    if dtype == torch.bfloat16:
        assert BWD_BODY[(dtype, 64, False)] == "wgmma"


def test_warmed_chunked_fused_loop_never_syncs(dev):
    """After `warm_decode()`, the chunked fused loop (admission, staging,
    replay, the harvest's event wait) runs under
    `torch.cuda.set_sync_debug_mode("error")`."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    cfg = _small_llama(torch.bfloat16)
    eng = LLMEngine(_card_params(cfg, dev), cfg, num_slots=3, page_size=16,
                    max_model_len=128, prefill_chunk=16, device=dev)
    eng.warm_decode()
    rng = np.random.RandomState(4)
    for n in (5, 40, 70, 17):
        eng.add_request(rng.randint(0, 512, n), max_new_tokens=9)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        while eng.has_work:
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(len(o.token_ids) == 9 for o in eng.outputs.values())
    st = eng.stats()
    assert st["graph_replays"] == st["fused_dispatches"] > 0


@pytest.mark.parametrize("chunk", [None, 16], ids=["bucketed", "chunked"])
def test_tracing_leaves_the_graph_replays_stream(dev, chunk, tmp_path):
    """Request tracing, the metrics registry and a `trace()` window are
    host state: a warmed engine with tracing on, its loop inside a window
    (host spans recorded) and under `set_sync_debug_mode("error")` with
    `stats()` and `health()` read every step, replays the same graphs and
    gives bitwise the tokens and program counts of the engine with tracing
    off."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    cfg = _small_llama(torch.bfloat16)
    params = _card_params(cfg, dev)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 512, n) for n in (5, 40, 70, 17)]
    runs = {}
    for tracing in (True, False):
        eng = LLMEngine(params, cfg, num_slots=3, page_size=16,
                        max_model_len=128, prefill_buckets=[32, 64, 128],
                        prefill_chunk=chunk, request_tracing=tracing,
                        device=dev)
        eng.warm_decode()
        # every bucket's program built before the guarded loop
        for n in (5, 40, 70):
            eng.add_request(np.random.RandomState(n).randint(0, 512, n),
                            max_new_tokens=2)
        eng.run()
        rids = [eng.add_request(p, max_new_tokens=9) for p in prompts]
        torch.cuda.synchronize()
        window = eng.trace(str(tmp_path / str(tracing)), device=False) \
            if tracing else contextlib.nullcontext()
        with window:
            torch.cuda.set_sync_debug_mode("error")
            try:
                while eng.has_work:
                    eng.step()
                    eng.stats()
                    eng.health()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        st = eng.stats()
        runs[tracing] = ([eng._outputs[r].token_ids for r in rids],
                         {k: st[k] for k in st
                          if k.endswith("_executables")},
                         st["graph_replays"], eng)
    (on, on_execs, on_replays, eng), (off, off_execs, off_replays, _) = \
        runs[True], runs[False]
    assert on == off and on_execs == off_execs and on_replays == off_replays
    assert eng.stats()["roofline"]["steady_state_recompiles"] == 0
    assert all(eng._outputs[r].trace is not None for r in eng._outputs)
    assert not any(o.trace for o in runs[False][3]._outputs.values())


def test_warmed_spec_chunked_fused_loop_never_syncs(dev):
    """The same with speculative decoding (`spec_len=4`, chunk 16) over
    looping prompts: the proposer's drafts ride the warmed fused graph,
    and the loop still never syncs."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    cfg = _small_llama(torch.bfloat16)
    eng = LLMEngine(_card_params(cfg, dev), cfg, num_slots=3, page_size=16,
                    max_model_len=128, prefill_chunk=16, spec_len=4,
                    device=dev)
    eng.warm_decode()
    eng.warm_spec()                     # fused: nothing to build
    rng = np.random.RandomState(4)
    for n in (5, 40, 70, 17):
        eng.add_request(np.tile(rng.randint(0, 512, 4), -(-n // 4))[:n],
                        max_new_tokens=9)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        while eng.has_work:
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(len(o.token_ids) == 9 for o in eng.outputs.values())
    st = eng.stats()
    assert st["graph_replays"] == st["fused_dispatches"] > 0
    assert st["spec_events"] > 0 and st["verify_executables"] == 0


def test_eager_call_after_capture_leaves_the_replay_unchanged(dev):
    """An eager paged call on the capture stream that needs more split
    counters than the graph baked in replaces them; the graph keeps its
    own alive, so memory allocated and written afterwards cannot reach the
    next replay's merge (512 positions a slot: the graph's blocks split
    each slot's keys 4 ways and merge through the counters)."""
    from paddle_tpu_torch.incubate.kernels.paged_attention import \
        split_counters
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.inference.graphs import side_stream
    cfg = _small_llama(torch.bfloat16)
    eng = LLMEngine(_card_params(cfg, dev), cfg, num_slots=3, page_size=16,
                    max_model_len=512, prefill_chunk=16, device=dev)
    rng = np.random.RandomState(5)
    for n in ("k", "v"):
        eng._pool[n].copy_(_randn(rng, tuple(eng._pool[n].shape),
                                  torch.bfloat16, dev))
    prog = eng._program("fused")
    feed = _step_inputs("fused", np.random.RandomState(6), eng,
                        offsets=(300, 200))  # past the first key split
    prog.stage(**feed)
    prog.run()
    first = prog.result()
    side = side_stream(dev)
    baked = split_counters(dev, side)
    assert baked is not None and prog._keep is baked
    # 32 counters a slot (8 kv heads x 4 row tiles of 16 x 4 rows)
    B = baked.numel() // 32 + 2
    pages = rng.permutation(np.arange(1, 2 * B + 1)).astype(np.int32)
    args = (_randn(rng, (B, 16, 32, 128), torch.bfloat16, dev),
            _randn(rng, (2 * B + 1, 16, 8, 128), torch.bfloat16, dev),
            _randn(rng, (2 * B + 1, 16, 8, 128), torch.bfloat16, dev),
            torch.from_numpy(pages.reshape(B, 2)).to(dev),
            torch.zeros(B, dtype=torch.int32, device=dev),
            torch.full((B,), 16, dtype=torch.int32, device=dev))
    with torch.cuda.stream(side):
        big = paged_prefill_attention_kernel(*args)
        junk = [torch.full((baked.numel(),), 7, dtype=torch.int32,
                           device=dev) for _ in range(64)]
    torch.cuda.synchronize()
    assert split_counters(dev, side) is not baked       # replaced
    assert int(baked.abs().sum()) == 0                  # still at rest
    _close(big, paged_prefill_attention_ref(*args), torch.bfloat16)
    prog.stage(**feed)
    prog.run()
    # the two active slots: the inactive one reads the null page, which
    # padding rows write at colliding positions (its output is dropped)
    assert np.array_equal(prog.result()[:2], first[:2])
    del junk


def test_a_capture_that_syncs_raises(dev):
    """A body that reads a value on the host cannot be captured: the build
    raises, it does not fall back to the eager step."""
    from paddle_tpu_torch.inference.graphs import StepProgram

    def body(x):
        return x * int(x.sum())             # a device-to-host read
    prog = StepProgram("bad", body, {"x": ((4,), torch.int32, 1)}, dev)
    with pytest.raises(RuntimeError):
        prog.build()
    assert not prog.built and prog.graph is None


def _random_pool(eng, seed):
    """Fill every leaf of the engine's pool from a seeded generator (int8
    leaves with int8 values, scale lanes in [0, 0.05))."""
    rng = np.random.RandomState(seed)
    for n, t in eng._pool.items():
        if t.dtype == torch.int8:
            t.copy_(torch.from_numpy(rng.randint(-127, 128, tuple(t.shape))
                                     .astype(np.int8)))
        else:
            t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32)
                                     * 0.05 if n.endswith("scale") else
                                     rng.randn(*t.shape).astype(np.float32)))
    return {n: t.clone() for n, t in eng._pool.items()}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_copy_program_is_a_bitwise_page_copy(dev, int8):
    """The COW copy program: its build (inert src = dst = the null page)
    changes nothing; two dispatches copy page 5 into page 9 and page 2 into
    page 11 in every leaf of the pool (k, v, and the scale lanes of an int8
    pool) bitwise, leave every other page as it was, launch no kernel, and
    the replays equal the eager body."""
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    cfg = _small_llama(torch.bfloat16)
    params = _card_params(cfg, dev)
    quant = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    pools = {}
    for eager in (False, True):
        eng = LLMEngine(params, cfg, num_slots=3, page_size=16,
                        max_model_len=128, num_pages=13, device=dev,
                        _eager=eager, **quant)
        before = _random_pool(eng, 8)
        assert len(before) == (4 if int8 else 2)
        prog = eng._program("copy")
        prog.build()
        torch.cuda.synchronize()
        for n, t in eng._pool.items():
            assert torch.equal(t, before[n]), n
        K.reset_launches()
        for src, dst in ((5, 9), (2, 11)):
            prog.stage(src=src, dst=dst)
            assert prog.run() is None
        torch.cuda.synchronize()
        for n, t in eng._pool.items():
            want = before[n].clone()
            want[:, 9], want[:, 11] = before[n][:, 5], before[n][:, 2]
            assert torch.equal(t, want), n
        assert set(K.counts().values()) == {0}
        assert (prog.graph is None) == eager
        assert prog.replays == (0 if eager else 2)
        assert eng.stats()["copy_executables"] == 1
        pools[eager] = {n: t.clone() for n, t in eng._pool.items()}
    for n in pools[True]:
        assert torch.equal(pools[False][n], pools[True][n])


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_paged_kernel_at_the_prefix_tail_shape(dev, dtype, int8):
    """Row 1 as a bucketed prefix-hit tail calls it: one slot, T 2048 (the
    largest bucket of max_model_len 2048), Llama-3-8B's heads (32 over 8
    kv heads, hd 128), page 16, a match ending mid-page (q_offset 1000)
    and a 700-token tail over its pages.  The split workspace cap leaves
    one split of 2048 keys.  Valid rows against the plain version, padding
    rows 0, two calls bitwise equal, one launch each on the pool's lane."""
    rng = np.random.RandomState(12)
    T, page, H, KVH, hd, P = 2048, 16, 32, 8, 128, 128
    q_offset, valid = 1000, 700
    plan = _prefill_split_plan(1, T, H, KVH, hd, page, P)
    assert plan.nsplit == 1 and plan.ck == T
    n = -(-(q_offset + valid) // page)
    table = np.zeros((1, P), np.int32)
    table[0, :n] = rng.permutation(np.arange(1, P + 1))[:n]
    args = (_randn(rng, (1, T, H, hd), dtype, dev),
            _randn(rng, (P + 1, page, KVH, hd), dtype, dev),
            _randn(rng, (P + 1, page, KVH, hd), dtype, dev),
            torch.from_numpy(table).to(dev),
            torch.tensor([q_offset], dtype=torch.int32, device=dev),
            torch.tensor([valid], dtype=torch.int32, device=dev))
    kw, tol, lane = {}, TOL[dtype], "launches"
    if int8:
        args, scales = _quantized(args)
        kw, tol, lane = dict(kv_scales=scales), INT8_TOL[dtype], \
            "launches_int8"
    before = getattr(paged_prefill_attention_kernel, lane)
    got = paged_prefill_attention_kernel(*args, **kw)
    again = paged_prefill_attention_kernel(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(paged_prefill_attention_kernel, lane) == before + 2
    assert torch.equal(got, again)
    ref = paged_prefill_attention_ref(*args, **kw)
    torch.testing.assert_close(got[0, :valid].float(),
                               ref[0, :valid].float(), **tol)
    assert not got[0, valid:].any()


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16", "int8"])
def test_double_swap_preemption_on_card_keeps_the_stream(dev, kv, fuse):
    """Two swap victims in one growth pass (the schedule of
    `test_torch_overload.py::test_double_swap_preemption_in_one_step` on
    the small llama, bf16, page 8): each victim's pages are gathered by
    the "swap_out" graph and copied into a pinned buffer of its own right
    after that replay, so the second replay cannot overwrite the first
    victim's pages before its copy lands; both resume through the
    "swap_in" graph (an int8 pool's scale lanes in the same scatter).  The
    streams equal the undisturbed engine's bitwise, and the replays equal
    the dispatches."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    cfg = _small_llama(torch.bfloat16)
    params = _card_params(cfg, dev)
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (8, 8, 16, 16)]
    geo = dict(num_slots=4, page_size=8, max_model_len=64, fuse=fuse,
               kv_dtype=kv, kv_tier=False, device=dev)   # as the CPU twin
    base = LLMEngine(params, cfg, **geo)
    for p in prompts:
        base.add_request(p, max_new_tokens=12)
    want = {r: o.token_ids for r, o in base.run().items()}
    eng = LLMEngine(params, cfg, num_pages=8, admission="optimistic",
                    preempt="swap", **geo)
    for i, p in enumerate(prompts):
        eng.add_request(p, max_new_tokens=12, priority=-1 if i < 2 else 0)
    doubles = 0
    while eng.has_work:
        pre = eng.stats()["preemptions"]
        eng.step()
        eng.cache.check_invariants()
        doubles += eng.stats()["preemptions"] - pre >= 2
    st = eng.stats()
    assert doubles >= 1 and st["preempt_swaps"] == st["preemptions"] >= 2
    assert st["swap_executables"] == 2
    assert all(eng._programs[r].graph is not None
               for r in ("swap_out", "swap_in"))
    assert st["graph_replays"] == sum(
        st[k] for k in ("fused_dispatches", "decode_dispatches",
                        "chunk_dispatches", "prefill_dispatches",
                        "swap_out_dispatches", "swap_in_dispatches"))
    assert {r: o.token_ids for r, o in eng.outputs.items()} == want


@pytest.mark.parametrize("store", [False, True], ids=["host", "store"])
@pytest.mark.parametrize("kv", [None, "int8"], ids=["bf16", "int8"])
def test_tier_restore_on_card_keeps_the_stream(dev, kv, store, tmp_path):
    """The KV tier on the card (the session of `test_torch_kv_tier.py` on
    the small llama, page 8, nine pages): evicted prefix pages are
    gathered by the "swap_out" graph into pinned buffers and landed as
    slabs (with `store`, a host budget of 6 pages moves them on to npz
    files, bf16 as raw 2-byte lanes), and the returning turn is restored
    by one "swap_in" replay a restore.  The streams equal a never-evicting
    pool's bitwise (its returning turn hits the device), and the replays
    equal the dispatches."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    cfg = _small_llama(torch.bfloat16)
    params = _card_params(cfg, dev)
    geo = dict(num_slots=2, page_size=8, max_model_len=64, prefill_chunk=16,
               kv_dtype=kv, device=dev)

    def session(eng):
        rng = np.random.RandomState(7)
        shared = rng.randint(0, cfg.vocab_size, (20,)).astype(np.int32)
        r1 = eng.add_request(shared, max_new_tokens=5)
        first = eng.run()[r1].token_ids
        for _ in range(6):
            eng.add_request(rng.randint(0, cfg.vocab_size, (30,))
                            .astype(np.int32), max_new_tokens=4)
        while eng.has_work:
            eng.step()
            eng.cache.check_invariants()
        eng.add_request(np.concatenate([
            shared, np.asarray(first, np.int32),
            rng.randint(0, cfg.vocab_size, (4,)).astype(np.int32)]),
            max_new_tokens=5)
        return {r: o.token_ids for r, o in eng.run().items()}

    want = session(LLMEngine(params, cfg, num_pages=64, **geo))
    more = dict(swap_pool_pages=6, spill_dir=str(tmp_path)) if store else \
        dict(swap_pool_pages=64)
    eng = LLMEngine(params, cfg, num_pages=9, **geo, **more)
    eng.warm_swap()
    assert session(eng) == want
    st = eng.stats()
    tier = st["kv_tier"]
    assert tier["spills"] > 0 and tier["restores"] > 0
    assert st["swap_in_dispatches"] == tier["restores"]
    if store:
        assert tier["disk_spills"] > 0 and tier["disk_restores"] > 0
    assert all(eng._programs[r].graph is not None
               for r in ("swap_out", "swap_in"))
    assert st["graph_replays"] == sum(
        st[k] for k in ("fused_dispatches", "decode_dispatches",
                        "chunk_dispatches", "prefill_dispatches",
                        "cow_page_copies", "swap_out_dispatches",
                        "swap_in_dispatches"))
    eng.cache.check_invariants()


def _fused_replay_and_eager(eng):
    """One replay of `eng`'s fused program and one eager call of its body,
    on identical staged inputs and the same pool: (tokens, pool after) of
    each.  The pool is put back as it was."""
    prog = eng._programs["fused"]
    pool = {n: t.clone() for n, t in eng._pool.items()}
    feed = _step_inputs("fused", np.random.RandomState(3), eng)
    runs = []
    for eager in (False, True):
        for n in pool:
            eng._pool[n].copy_(pool[n])
        prog.stage(**feed)
        if eager:
            out = prog._body(**prog.inputs).cpu().numpy()
        else:
            prog.run()
            out = prog.result()
        torch.cuda.synchronize()
        runs.append((out, {n: t[:, 1:].clone() for n, t in eng._pool.items()}))
    for n in pool:
        eng._pool[n].copy_(pool[n])
    return runs


def test_fleet_loops_capture_while_the_other_replica_swaps(dev):
    """Two replicas of the small llama (bf16, bucketed, page 8) on one copy
    of the weights, their loops running: replica 1 captures a prefill
    bucket it never built inside its loop while replica 0 replays its fused
    step and swaps victims (optimistic admission, forced pressure).  Both
    streams equal the same requests run alone, and on each replica a
    replay of the fused program is bitwise the eager step."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.inference.faults import FaultPlan
    from paddle_tpu_torch.inference.router import (EngineFleet,
                                                   _adopt_executables)
    cfg = _small_llama(torch.bfloat16)
    params = _card_params(cfg, dev)
    geo = dict(num_slots=3, page_size=8, max_model_len=128, device=dev)
    rng = np.random.RandomState(9)
    swap_ps = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (8, 12, 16)]
    new_p = rng.randint(0, cfg.vocab_size, (100,)).astype(np.int32)
    solo = LLMEngine(params, cfg, **geo)
    rids = [solo.add_request(p, max_new_tokens=40) for p in swap_ps]
    want = [solo.run()[r].token_ids for r in rids]
    want_new = solo.result(solo.add_request(new_p,
                                            max_new_tokens=16)).token_ids
    e0 = LLMEngine(params, cfg, admission="optimistic", preempt="swap",
                   fault_plan=FaultPlan(pressure_steps=range(4, 60, 3)),
                   **geo)
    e1 = LLMEngine(params, cfg, **geo)
    _adopt_executables(e1, e0)
    fleet = EngineFleet(engines=[e0, e1])
    assert fleet.shared_executables()
    fleet.warm()
    e1.result(e1.submit(np.arange(5, dtype=np.int32), max_new_tokens=2))
    assert "prefill:128" not in e1._programs
    with fleet:
        rids = [e0.submit(p, max_new_tokens=40) for p in swap_ps]
        deadline = time.monotonic() + 300
        while True:             # replica 0 has swapped once: capture now
            with e0._serve_lock:
                if e0.stats()["preemptions"]:
                    break
            assert time.monotonic() < deadline
            time.sleep(0.001)
        got_new = e1.result(e1.submit(new_p, max_new_tokens=16),
                            timeout=300).token_ids
        got = [e0.result(r, timeout=300).token_ids for r in rids]
        fleet.check_invariants()
    assert got == want and got_new == want_new
    st = e0.stats()
    assert st["preempt_swaps"] > 0 and st["pages_in_use"] == 0
    assert e1._programs["prefill:128"].graph is not None
    for eng in (e0, e1):
        (g_out, g_pool), (e_out, e_pool) = _fused_replay_and_eager(eng)
        assert np.array_equal(g_out, e_out)
        for n in g_pool:
            assert torch.equal(g_pool[n], e_pool[n]), n


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("heads", [(16, 4), (8, 2)], ids=["mp2", "mp4"])
def test_kernels_at_a_tensor_parallel_rank_shape(dev, dtype, heads):
    """Rows 1, 4 and 2 at one rank's heads of Llama-3-8B under mp 2 and 4
    (H16 KVH4, H8 KVH2; hd 128, G 4): each launches once and agrees with
    its plain version (paged prefill: valid rows, padding rows 0)."""
    H, KVH = heads
    rng = np.random.RandomState(H)
    for T in (1, 16):
        args, valid = _paged_inputs(rng, dtype, dev, T, 128, 16, G=H // KVH,
                                    KVH=KVH)
        before = paged_prefill_attention_kernel.launches
        got = paged_prefill_attention_kernel(*args)
        torch.cuda.synchronize()
        assert paged_prefill_attention_kernel.launches == before + 1
        ref = paged_prefill_attention_ref(*args)
        for b, n in enumerate(valid):
            _close(got[b, :n], ref[b, :n], dtype)
            assert not got[b, n:].any()
    args, lengths = _decode_inputs(rng, dtype, dev, 128, H // KVH, 16,
                                   KVH=KVH)
    before = paged_attention_kernel.launches
    got = paged_attention_kernel(*args)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 1
    live = lengths > 0
    _close(got[live], paged_attention_ref(*args)[live], dtype)
    q, k, v = (_randn(rng, (1, 512, H, 128), dtype, dev) for _ in range(3))
    before = flash_attention_fwd.launches
    out, _ = flash_attention_fwd(q, k, v, True, 128 ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    _close(out, _flash_fwd_ref(q, k, v, True, 128 ** -0.5)[0], dtype)


def test_mp2_gloo_engine_on_card_matches_mp1(dev):
    """Two ranks on one card (gloo, eager): the small llama in f32, fused
    chunked with spec on and the prefix cache, and unfused bucketed, emits
    the mp=1 engine's greedy streams; each rank holds half the pool and
    launches the paged kernels once a layer a dispatch; a gloo engine asked
    to capture raises."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.parallel.tp import serving_mesh
    cfg = _small_llama(torch.float32)
    params = _card_params(cfg, dev)
    rng = np.random.RandomState(2)
    shared = rng.randint(0, cfg.vocab_size, (40,)).astype(np.int32)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (5, 33, 70)]
    prompts += [np.concatenate([shared, rng.randint(0, cfg.vocab_size,
                                                    (n,)).astype(np.int32)])
                for n in (3, 20)]
    mesh = serving_mesh(2, [dev, dev], backend="gloo", timeout_s=120)
    try:
        with pytest.raises(ValueError, match="capture gloo"):
            LLMEngine(params, cfg, num_slots=3, page_size=16,
                      max_model_len=128, device=dev, mesh=mesh)
        for kw in (dict(prefill_chunk=16, spec_len=3), dict(fuse=False)):
            streams, pools = [], []
            for m in (None, mesh):
                eng = LLMEngine(params, cfg, num_slots=3, page_size=16,
                                max_model_len=128, device=dev, mesh=m,
                                _eager=m is not None, **kw)
                rids = [eng.add_request(p, max_new_tokens=12)
                        for p in prompts]
                if m is not None:
                    m.reset_counts()
                eng.run()
                streams.append([eng.outputs[r].token_ids for r in rids])
                pools.append(eng.rank_pool_bytes())
                if m is not None:
                    st = eng.stats()
                    want = cfg.num_layers * (
                        st["decode_dispatches"] if not eng.fused else
                        st["fused_dispatches"] + st["chunk_dispatches"] +
                        st["verify_dispatches"])
                    name = "paged_prefill_attention_kernel" if eng.fused \
                        else "paged_attention_kernel"
                    assert [c["launches"][name] for c in m.rank_counts()] \
                        == [want, want]
            assert streams[0] == streams[1], kw
            assert pools[1] == [pools[0][0] // 2] * 2
    finally:
        mesh.close()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 2048, 8, 128), (1, 2048, 4, 128),
                                   (1, 2048, 16, 128)],
                         ids=["dp2_mp2", "dp4_mp4", "pp_stage"])
def test_flash_kernels_at_a_training_rank_shape(dev, dtype, shape):
    """Rows 2, 5 and 6 at the shapes a GPT-3 1.3B training rank gives them
    (B 4, S 2048, 16 heads of 128: dp 2 x mp 2, and dp 4 x mp 4; a pipeline
    stage's microbatch of B 8 over 8), causal: each launches once and
    agrees with its plain version."""
    rng = np.random.RandomState(shape[2])
    q, k, v, g = (_randn(rng, shape, dtype, dev) for _ in range(4))
    scale = 128 ** -0.5
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, True, scale)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = _flash_fwd_ref(q, k, v, True, scale)
    _close(out, ref_out, dtype)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    before = (flash_bwd_dkv.launches, flash_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, ref_out, ref_lse, g, True, scale)
    torch.cuda.synchronize()
    assert (flash_bwd_dkv.launches, flash_bwd_dq.launches) == \
        (before[0] + 1, before[1] + 1)
    ref = _flash_bwd_ref(q, k, v, ref_out, ref_lse, g, True, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _grad_close(name, a, b, dtype)


@pytest.fixture(scope="module")
def card_mesh():
    """Four ranks of a training mesh on the one card (gloo)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from paddle_tpu_torch.parallel.tp import serving_mesh
    mesh = serving_mesh(4, ["cuda:0"] * 4, backend="gloo", timeout_s=120)
    yield mesh
    mesh.close()


def _card_collectives(*, mesh):
    """The rank handle's collectives on CUDA tensors (`ServingMesh.run`
    calls it by name on every rank)."""
    r, dev = mesh.rank, mesh.device
    pair = mesh.group("card_pair", [r - r % 2, r - r % 2 + 1])
    every = mesh.group("card_every", range(mesh.mp))
    x = torch.arange(6.0, device=dev).reshape(2, 3) + 10 * r
    out = {"all_reduce": pair.all_reduce(x.clone()),
           "broadcast": pair.broadcast(x.clone(), 1),
           "all_gather": every.all_gather(x, 1),
           "reduce_scatter": every.reduce_scatter(
               torch.arange(16.0, device=dev).reshape(2, 8) * (r + 1), 1)}
    assert all(t.is_cuda for t in out.values())
    return {k: t.cpu() for k, t in out.items()}


def test_mesh_collectives_on_cuda_tensors(card_mesh):
    """Gloo takes the four collectives of a training mesh on CUDA tensors
    (it stages them through host memory itself), with the right values."""
    n = card_mesh.mp
    outs = card_mesh.run(_card_collectives, [((), {})] * n)
    xs = [torch.arange(6.0).reshape(2, 3) + 10 * r for r in range(n)]
    for r, o in enumerate(outs):
        p = r - r % 2
        torch.testing.assert_close(o["all_reduce"], xs[p] + xs[p + 1])
        torch.testing.assert_close(o["broadcast"], xs[p + 1])
        torch.testing.assert_close(o["all_gather"], torch.cat(xs, 1))
        want = torch.arange(16.0).reshape(2, 8) * sum(range(1, n + 1))
        torch.testing.assert_close(o["reduce_scatter"],
                                   want[:, 2 * r:2 * r + 2])


@pytest.mark.parametrize("kw", [
    dict(dp=2, mp=2, sequence_parallel=True, remat=True),
    dict(sharding=2, mp=2, sharding_stage=3),
    dict(dp=4, sharding_stage=2)], ids=["dp2mp2_sp", "sh2mp2_z3", "dp4_z2"])
def test_mesh_trainer_on_card_matches_one_device(dev, card_mesh, kw):
    """Four gloo ranks on the card, float32 (hd 64, the kernels' route):
    3 steps give the one-device trainer's losses and, gathered, its
    parameters; every rank launches rows 2, 5 and 6 once a layer a step
    and takes no composed route."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    from paddle_tpu_torch.parallel.hybrid import _leaves
    cfg = gpt.GPTConfig(vocab_size=256, hidden_size=256, num_layers=2,
                        num_heads=4, max_seq_len=128)
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    tok = np.random.RandomState(0).randint(0, 256, (4, 128))
    lab = np.roll(tok, -1, axis=1)
    one = HybridParallelTrainer(cfg, MeshConfig(remat=kw.get("remat", False)),
                                device=dev, params=params)
    tr = HybridParallelTrainer(cfg, MeshConfig(**kw), params=params,
                               mesh=card_mesh)
    card_mesh.reset_counts()
    got = [float(tr.train_step(tok, lab)) for _ in range(3)]
    counts = card_mesh.rank_counts()
    want = [float(one.train_step(tok, lab)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for c in counts:
        assert [c["launches"][k] for k in ("flash_attention_fwd",
                                           "flash_bwd_dkv", "flash_bwd_dq")] \
            == [cfg.num_layers * 3] * 3
        assert not any(c["composed_calls"].values())
    a, b = tr.gathered_state()["params"], one.gathered_state()["params"]
    for x, y in zip(_leaves(a), _leaves(b)):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)
    tr.close()


def _card_p2p(*, mesh):
    """isend / recv around the ring of the mesh's ranks and an all-to-all
    over them, on CUDA tensors (`ServingMesh.run` calls it by name)."""
    r, n, dev = mesh.rank, mesh.mp, mesh.device
    links = {i: mesh.group("card_next" if i == r else "card_prev",
                           [i, (i + 1) % n])
             for i in range(n) if r in (i, (i + 1) % n)}
    every = mesh.group("card_every", range(n))
    mesh.comm.clear()
    x = torch.arange(6.0, device=dev).reshape(2, 3) + 10 * r
    sent = links[r].isend(x, 1)
    got = links[(r - 1) % n].recv((2, 3), torch.float32, 0)
    sent.wait()
    a2a = every.all_to_all(torch.arange(2.0 * n, device=dev).reshape(n, 2)
                           + 100 * r, 0, 1)
    assert got.is_cuda and a2a.is_cuda
    return {"recv": got.cpu(), "all_to_all": a2a.cpu(),
            "comm": dict(mesh.comm)}


def test_mesh_p2p_and_all_to_all_on_cuda_tensors(card_mesh):
    """The pipeline's send/recv (through host memory under gloo, counted)
    and the ep all-to-all on CUDA tensors, against plain copies of what
    each rank sent."""
    n = card_mesh.mp
    outs = card_mesh.run(_card_p2p, [((), {})] * n)
    for r, o in enumerate(outs):
        src = (r - 1) % n
        torch.testing.assert_close(o["recv"],
                                   torch.arange(6.0).reshape(2, 3) + 10 * src)
        want = torch.cat([torch.arange(2.0 * n).reshape(n, 2)[r:r + 1]
                          + 100 * i for i in range(n)], 1)
        torch.testing.assert_close(o["all_to_all"], want)
        comm = o["comm"]
        assert comm["card_next.send"] == [1, 24]
        assert comm["card_prev.recv"] == [1, 24]
        assert comm.get("card_next.send_host") == [1, 24]
        assert comm["card_every.all_to_all"] == [1, 8 * n]


@pytest.mark.parametrize("kw", [
    dict(pp=2, mp=2, micro_batches=2, remat=True),
    dict(pp=2, vpp=2, mp=2, sequence_parallel=True, micro_batches=2),
    dict(pp=4, micro_batches=4),
    dict(pp=2, ep=2, micro_batches=2, moe=True)],
    ids=["pp2_mp2_remat", "pp2_vpp2_mp2_sp", "pp4", "moe_pp2_ep2"])
def test_mesh_pipeline_on_card_matches_one_device(dev, card_mesh, kw):
    """Four gloo ranks on the card, float32 (hd 64, the kernels' route):
    3 pipeline steps give the one-device trainer's losses and, gathered,
    its parameters; every rank launches rows 2, 5 and 6 once a layer of
    its stage a microbatch a step, and takes no composed route.  MoE: 4
    experts, capacity factor 8 and no aux, as the reference compares ep
    with one device."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    from paddle_tpu_torch.parallel.hybrid import _leaves
    kw = dict(kw)
    moe = kw.pop("moe", False)
    cfg = gpt.GPTConfig(vocab_size=256, hidden_size=256, num_layers=4,
                        num_heads=4, max_seq_len=128,
                        moe_num_experts=4 if moe else 0,
                        moe_capacity_factor=8.0, moe_aux_weight=0.0)
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    tok = np.random.RandomState(0).randint(0, 256, (8, 128))
    lab = np.roll(tok, -1, axis=1)
    mc = MeshConfig(**kw)
    one = HybridParallelTrainer(cfg, MeshConfig(remat=mc.remat), device=dev,
                                params=params)
    tr = HybridParallelTrainer(cfg, mc, params=params, mesh=card_mesh)
    card_mesh.reset_counts()
    got = [float(tr.train_step(tok, lab)) for _ in range(3)]
    counts = card_mesh.rank_counts()
    want = [float(one.train_step(tok, lab)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    per = cfg.num_layers // mc.pp * mc.micro_batches * 3
    for c in counts:
        assert [c["launches"][k] for k in ("flash_attention_fwd",
                                           "flash_bwd_dkv", "flash_bwd_dq")] \
            == [per] * 3
        assert not any(c["composed_calls"].values())
    a, b = tr.gathered_state()["params"], one.gathered_state()["params"]
    for x, y in zip(_leaves(a), _leaves(b)):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)
    tr.close()
