"""Kernel modules of the PyTorch port vs the JAX reference, on the CPU.

The same numpy-seeded inputs go through the reference function and the
port's plain version (which the port's wrappers take for CPU tensors).  The
reference's paged kernel runs in Pallas interpret mode, as its own tests run
it; flash attention and RMSNorm run through `attention_xla` / `_rms_ref`.
Tolerance 1e-4 abs/rel in float32: the same math summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.flash_attention import attention_xla
from paddle_tpu.incubate.kernels.paged_attention import (
    paged_prefill_attention_pallas, paged_prefill_attention_xla)
from paddle_tpu.incubate.kernels.rms_norm import _rms_ref as jax_rms_ref
from paddle_tpu.incubate.kernels.rope import apply_rope as jax_apply_rope
from paddle_tpu_torch.incubate import kernels as K
from paddle_tpu_torch.incubate.kernels.flash_attention import (
    attention_ref, flash_attention_fused, flash_attention_fwd)
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    paged_prefill_attention, paged_prefill_attention_kernel,
    paged_prefill_attention_ref, paged_serve_attention,
    paged_verify_attention)
from paddle_tpu_torch.incubate.kernels.rms_norm import (
    MAX_PIECES, MAX_STAGES, RING_BYTES, RmsLaunch, _max_threads, _padded,
    _rms_launch, _rms_ref, rms_norm_fused)
from paddle_tpu_torch.incubate.kernels.rope import apply_rope

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("neox", [True, False], ids=["neox", "gptj"])
@pytest.mark.parametrize("batched", [False, True], ids=["shared", "per_slot"])
def test_apply_rope_matches_reference(neox, batched):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 8).astype(np.float32)
    tshape = (2, 5, 4) if batched else (5, 4)
    sin = rng.randn(*tshape).astype(np.float32)
    cos = rng.randn(*tshape).astype(np.float32)
    ref = jax_apply_rope(jnp.asarray(x), jnp.asarray(sin), jnp.asarray(cos),
                         neox_style=neox)
    got = apply_rope(_t(x), _t(sin), _t(cos), neox_style=neox)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 72)], ids=["2d", "3d"])
def test_rms_norm_plain_matches_reference(shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32) * 3
    w = rng.randn(shape[-1]).astype(np.float32)
    ref = np.asarray(jax_rms_ref(jnp.asarray(x), jnp.asarray(w), 1e-6))
    before = rms_norm_fused.launches
    got = rms_norm_fused(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_array_equal(_rms_ref(_t(x), _t(w), 1e-6).numpy(),
                                  got.numpy())
    assert rms_norm_fused.launches == before    # CPU: plain version only


def test_rms_norm_casts_before_weight_multiply():
    """bf16: the f32 normalized row is rounded to bf16 BEFORE the multiply
    by w (two roundings), as the reference does.  Rounding once after the
    multiply changes ~1/4 of the elements by an ulp; the port and the
    reference may differ only where their f32 rsqrt/mean differ."""
    rng = np.random.RandomState(2)
    x = rng.randn(64, 256).astype(np.float32)
    w = (rng.randn(256) * 3).astype(np.float32)
    ref = np.asarray(jax_rms_ref(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16),
                                 1e-6).astype(jnp.float32))
    got = rms_norm_fused(_t(x).bfloat16(), _t(w).bfloat16())
    assert got.dtype == torch.bfloat16
    assert np.mean(got.float().numpy() != ref) < 0.02


@pytest.mark.parametrize("name,group", [
    ("void (anonymous namespace)::rms_kernel<__nv_bfloat16, __nv_bfloat16, "
     "__nv_bfloat16, 8, 1>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16*, int, int, int, float)", "rms_norm"),
    ("void (anonymous namespace)::rms_tma_kernel<__nv_bfloat16, "
     "__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, float)",
     "rms_norm"),
    ("void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, 128, 4, "
     "8>(__nv_bfloat16 const*, int)", "paged_decode"),
    ("void (anonymous namespace)::paged_prefill_kernel<__nv_bfloat16, 128, "
     "4>(__nv_bfloat16 const*, int)", "paged_attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm")])
def test_step_profile_files_kernels_by_group(name, group):
    from paddle_tpu_torch.inference.step_profile import _group
    assert _group(name) == group


# (D, itemsize) -> (vec, nv, threads, rows, stages) of `csrc/rms_norm.cu`,
# w of x's dtype: narrow rows on the register kernel, a warp a row, 8 rows a
# block; wide rows on the ring kernel, one a block of 256 threads, 2 rows in
# flight; 16-byte pieces where D is a multiple of them, single elements
# otherwise
RMS_LAUNCHES = {
    (64, 4): (4, 1, 32, 8, 0), (64, 2): (8, 1, 32, 8, 0),
    (100, 4): (4, 1, 32, 8, 0), (100, 2): (1, 4, 32, 8, 0),
    (4096, 4): (4, 0, 256, 1, 2), (4096, 2): (8, 0, 256, 1, 2),
    (14336, 4): (4, 0, 256, 1, 2), (14336, 2): (8, 0, 256, 1, 2),
}


def _ring_bytes(plan, D, itemsize, w_itemsize):
    return _padded(D * w_itemsize) + plan.stages * _padded(D * itemsize)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 100, 4096, 14336])
def test_rms_launch_shape(D, itemsize):
    """Wide aligned rows take the ring within its shared-memory budget;
    the register kernel covers the row in registers within its launch
    bounds; an unaligned pointer takes single-element pieces on the
    register kernel, and a row that no shape holds in registers is read
    twice (nv 0)."""
    for aligned in (True, False):
        plan = _rms_launch(D, itemsize, itemsize, aligned)
        if aligned:
            assert tuple(plan) == RMS_LAUNCHES[D, itemsize]
        else:
            assert plan.vec == 1 and plan.stages == 0
        assert isinstance(plan, RmsLaunch)
        assert plan.threads % 32 == 0 and plan.rows >= 1
        if plan.stages:
            assert 2 <= plan.stages <= MAX_STAGES
            assert plan.rows == 1 and plan.threads >= 64 and D > 1024
            assert _ring_bytes(plan, D, itemsize, itemsize) <= RING_BYTES
            continue
        assert plan.threads * plan.rows <= _max_threads(plan.nv * plan.vec)
        if plan.nv == 0:
            assert plan.threads == 1024
            pieces = D // plan.vec
            for t in (32, 64, 128, 256, 512, 1024):
                need = -(-pieces // t)
                nv = next((n for n in (1, 2, 4, 8) if n >= need), None)
                assert nv is None or t > _max_threads(nv * plan.vec)
            continue
        assert plan.nv <= MAX_PIECES
        assert plan.nv * plan.threads * plan.vec >= D


def test_rms_launch_ring_needs_whole_16_byte_rows_of_w():
    """f32 x with bf16 w: a w row of 4100 * 2 bytes is not a multiple of 16,
    so the ring kernel's bulk copy cannot take it."""
    assert _rms_launch(4096, 4, 2).stages == 2
    assert _rms_launch(4100, 4, 2).stages == 0
    assert _rms_launch(4100, 4, 4).stages == 2


def test_rms_launch_ring_takes_the_stages_that_fit():
    """Up to the stages asked for, as many rows of x as fit the ring's
    budget beside w; under 2 the register kernel takes the row."""
    assert _rms_launch(4096, 2, 2, stages=8).stages == 8
    assert _rms_launch(14336, 4, 4, stages=8).stages == 2
    assert _rms_launch(40000, 2, 2, stages=8).stages == 0


def test_rms_launch_reads_rows_too_wide_for_registers_twice():
    plan = _rms_launch(40000, 2, 2, False)
    assert plan.nv == 0 and plan.threads == 1024 and plan.rows == 1
    assert plan.stages == 0


def test_rms_norm_runs_no_autograd_node_without_grad():
    """Serving (grad off, or no input requiring grad) runs the forward
    alone; training goes through the Function."""
    rng = np.random.RandomState(3)
    x = _t(rng.randn(8, 64).astype(np.float32))
    w = _t(rng.randn(64).astype(np.float32))
    assert rms_norm_fused(x, w).grad_fn is None
    with torch.no_grad():
        assert rms_norm_fused(x.requires_grad_(), w).grad_fn is None
    assert rms_norm_fused(x, w).grad_fn is not None
    with torch.no_grad():
        y = rms_norm_fused(x, w)
    np.testing.assert_array_equal(y.numpy(),
                                  _rms_ref(x, w, 1e-6).detach().numpy())


@pytest.mark.parametrize("grad_of", ["x", "w", "both"])
def test_rms_norm_grads_match_jax_vjp(grad_of):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 96).astype(np.float32) * 2
    w = rng.randn(96).astype(np.float32)
    g = rng.randn(3, 96).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_rms_ref(a, b, 1e-6), jnp.asarray(x),
                     jnp.asarray(w))
    rdx, rdw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tx, tw = _t(x), _t(w)
    tx.requires_grad_(grad_of in ("x", "both"))
    tw.requires_grad_(grad_of in ("w", "both"))
    rms_norm_fused(tx, tw).backward(_t(g))
    for t, ref in ((tx, rdx), (tw, rdw)):
        if t.requires_grad:
            np.testing.assert_allclose(t.grad.numpy(), ref, atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("S", [1, 16, 33])
def test_attention_plain_matches_reference(causal, S):
    rng = np.random.RandomState(S)
    q, k, v = (rng.randn(2, S, 4, 16).astype(np.float32) for _ in range(3))
    ref = np.asarray(attention_xla(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal))
    np.testing.assert_allclose(
        attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy(), ref, **TOL)
    before = flash_attention_fwd.launches
    np.testing.assert_allclose(
        flash_attention_fused(_t(q), _t(k), _t(v), causal=causal).numpy(),
        ref, **TOL)
    # the kernel's second output: per-row logsumexp, [B*H, S, 1] f32
    _, lse = flash_attention_fwd(_t(q), _t(k), _t(v), causal, 0.25)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
    if causal:
        logits = np.where(np.tril(np.ones((S, S), bool)), logits, -1e30)
    ref_lse = np.asarray(jax.nn.logsumexp(jnp.asarray(logits), axis=-1))
    np.testing.assert_allclose(lse.numpy(), ref_lse.reshape(2 * 4, S, 1),
                               **TOL)
    assert flash_attention_fwd.launches == before


def test_attention_mask_lane_on_cpu_matches_reference():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 6, 2, 8).astype(np.float32) for _ in range(3))
    mask = rng.rand(1, 2, 6, 6) > 0.3
    mask[..., 0] = True
    ref = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        mask=jnp.asarray(mask))
    got = flash_attention_fused(_t(q), _t(k), _t(v), mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _paged_case(kvh, T, seed=0):
    """Pool, non-contiguous table rows, mixed q_offset/valid and one
    null-table slot (valid 1, q_offset 0)."""
    rng = np.random.RandomState(seed)
    B, H, hd, page, P, mp = 4, 4, 16, 8, 13, 5
    q = rng.randn(B, T, H, hd).astype(np.float32)
    k = rng.randn(P, page, kvh, hd).astype(np.float32)
    v = rng.randn(P, page, kvh, hd).astype(np.float32)
    tbl = np.zeros((B, mp), np.int32)
    tbl[0, :3] = [5, 2, 9]
    tbl[1, :5] = [1, 12, 3, 4, 7]
    tbl[2, :2] = [11, 6]
    qoff = np.array([17, 30 - T, 3, 0], np.int32)
    valid = np.array([min(T, 6), T, 1, 1], np.int32)
    return q, k, v, tbl, qoff, valid


@pytest.mark.parametrize("kvh", [2, 1], ids=["gqa", "mqa"])
@pytest.mark.parametrize("T", [1, 8])
def test_paged_plain_matches_xla_oracle(kvh, T):
    q, k, v, tbl, qoff, valid = _paged_case(kvh, T)
    ref = np.asarray(paged_prefill_attention_xla(*map(jnp.asarray, (
        q, k, v, tbl, qoff, valid))))
    got = paged_prefill_attention_ref(*map(_t, (q, k, v, tbl, qoff, valid)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)     # every row


@pytest.mark.parametrize("kvh", [2, 1], ids=["gqa", "mqa"])
def test_paged_plain_matches_pallas_kernel_on_valid_rows(kvh):
    """The TPU kernel (interpret mode) skips pages past the last real query,
    so only rows t < valid are held against it."""
    q, k, v, tbl, qoff, valid = _paged_case(kvh, 8, seed=1)
    ref = np.asarray(paged_prefill_attention_pallas(*map(jnp.asarray, (
        q, k, v, tbl, qoff, valid)), interpret=True))
    before = paged_prefill_attention_kernel.launches
    args = tuple(map(_t, (q, k, v, tbl, qoff, valid)))
    for entry in (paged_prefill_attention, paged_verify_attention,
                  paged_serve_attention, paged_prefill_attention_kernel):
        got = entry(*args).numpy()
        for b, n in enumerate(valid):
            np.testing.assert_allclose(got[b, :n], ref[b, :n], **TOL)
    assert paged_prefill_attention_kernel.launches == before


def test_paged_entries_refuse_later_slices():
    """Tensor-parallel attention raises; int8 pools (`kv_scales=`) are this
    slice's (tests/test_torch_quantized.py)."""
    args = tuple(map(_t, _paged_case(2, 1)))
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        paged_serve_attention(*args, mesh=object())


def test_launch_counters_cover_the_three_kernels():
    """The three forward kernels of the fused serving step, and every
    kernel ported since: the backward pair, paged decode and the three
    segment-masked flash kernels — nine counters, one per TPU kernel."""
    names = set(K.launches())
    assert names == {"paged_prefill_attention_kernel", "flash_attention_fwd",
                     "rms_norm_fused", "flash_bwd_dkv", "flash_bwd_dq",
                     "paged_attention_kernel", "flash_attention_seg_fwd",
                     "flash_bwd_seg_dkv", "flash_bwd_seg_dq"}
    K.reset_launches()
    assert set(K.launches().values()) == {0}


def test_cuda_entries_name_the_library_that_defines_them():
    """Each C entry of `_cuda.SIGNATURES` is defined in exactly one source
    of `_cuda.SOURCES` (every `csrc/*.cu` is one), and every wrapper's
    `_cuda.entry(library, function)` names that source: a wrong library
    name would show only on the card."""
    import re
    from pathlib import Path

    from paddle_tpu_torch.incubate.kernels import _cuda
    defined = {}
    for src in sorted(_cuda.CSRC.glob("*.cu")):
        for fn in re.findall(r'extern "C" int (\w+)\(', src.read_text()):
            assert fn not in defined, fn
            defined[fn] = src.stem
    assert set(_cuda.SOURCES) == set(defined.values())
    assert set(defined) == set(_cuda.SIGNATURES)
    calls = []
    for py in Path(K.__file__).parent.glob("*.py"):
        calls += re.findall(r'_cuda\.entry\("(\w+)",\s*"(\w+)"\)',
                            py.read_text())
    assert {fn for _, fn in calls} == set(defined)
    for lib, fn in calls:
        assert defined[fn] == lib, (lib, fn)


def test_bwd_body_covers_every_instantiation():
    """`BWD_BODY` names a body for each (dtype, D, segment-masked) the
    backward kernels take: the tensor-core one for the bf16 pair at D 64
    and 128, dense and segment-masked."""
    from paddle_tpu_torch.incubate.kernels.flash_attention import BWD_BODY
    assert set(BWD_BODY) == {(dt, D, seg)
                             for dt in (torch.float32, torch.bfloat16)
                             for D in (64, 128, 256) for seg in (False, True)}
    assert {k for k, v in BWD_BODY.items() if v == "wgmma"} == {
        (torch.bfloat16, D, seg) for D in (64, 128) for seg in (False, True)}
    assert set(BWD_BODY.values()) == {"wgmma", "cuda_core"}
