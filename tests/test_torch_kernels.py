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
from paddle_tpu_torch.incubate.kernels.rms_norm import _rms_ref, \
    rms_norm_fused
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
    args = tuple(map(_t, _paged_case(2, 1)))
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        paged_serve_attention(*args, mesh=object())
    with pytest.raises(NotImplementedError, match="int8"):
        paged_serve_attention(*args, kv_scales=(args[1], args[2]))


def test_launch_counters_cover_the_three_kernels():
    names = set(K.launches())
    assert names == {"paged_prefill_attention_kernel", "flash_attention_fwd",
                     "rms_norm_fused"}
    K.reset_launches()
    assert set(K.launches().values()) == {0}
