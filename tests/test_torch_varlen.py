"""The port's varlen (segment-masked) attention vs the JAX reference, on the
CPU.

The reference's `_seg` Pallas kernels take no `interpret` flag, so on the
CPU the reference runs its oracle `attention_xla_segmented` (and its
composed `flash_attn_unpadded` route); the port runs the plain versions of
its kernels.  Values and `jax.vjp` gradients agree within 1e-5 in float32.
A query row that sees no key is the one place the two differ by contract:
the kernels (TPU and port alike) zero the masked probabilities and give
out 0, the oracle softmaxes over all-masked scores and gives the mean of V.
Such rows are held against the port's own contract, and their cotangent is
zeroed where gradients are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.flash_attention import \
    attention_xla_segmented
from paddle_tpu.nn.functional.flash_attention import (
    flash_attention as ref_flash_attention,
    flash_attn_unpadded as ref_flash_attn_unpadded)
from paddle_tpu_torch.incubate import kernels as K
from paddle_tpu_torch.incubate.kernels.flash_attention import (
    NEG_INF, _flash_bwd_ref, _flash_fwd_seg_ref, attention_ref_segmented,
    flash_attention_seg_bwd, flash_attention_seg_fwd, flash_attention_varlen)
from paddle_tpu_torch.nn import functional as PF
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x._data if hasattr(x, "_data") else x)


# (causal, seg_q, seg_k): packed self-attention with sorted ids, with
# unsorted ids, and a cross layout (Sk != S) where two rows see no key
CASES = {
    "causal_packed": (True, [[0, 0, 0, 1, 1, 1, 1, 2, 2],
                             [0, 0, 0, 0, 0, 1, 1, 1, 1]], None),
    "causal_unsorted": (True, [[2, 2, 0, 0, 1, 2, 0, 1, 1],
                               [5, 5, 5, 5, 5, 5, 5, 5, 5]], None),
    "full_packed": (False, [[0, 0, 1, 1, 1, 2, 2, 2, 2],
                            [0, 1, 1, 1, 1, 1, 1, 1, 1]], None),
    "full_cross": (False, [[0, 0, 1, 1, 1, 3, 2, 2, 2],
                           [0, 0, 0, 1, 1, 1, 1, 1, 1]],
                   [[0, 0, 0, 1, 1, 2, 2], [1, 1, 1, 1, 1, 1, 1]]),
    # the id patterns the card's tile-skipping tests use, at this size:
    # interleaved ids, segments of one token, runs of blind rows
    "causal_interleaved": (True, [[0, 5, 0, 5, 0, 5, 0, 5, 0],
                                  [5, 0, 5, 0, 5, 0, 5, 0, 5]], None),
    "causal_length_one": (True, [[0, 1, 2, 3, 4, 5, 6, 7, 8],
                                 [3, 1, 4, 0, 5, 9, 2, 6, 8]], None),
    "full_blind_runs": (False, [[7, 7, 7, 0, 0, 1, 7, 1, 1],
                                [0, 1, 0, 1, 0, 1, 0, 1, 0]],
                        [[0, 0, 0, 0, 1, 1, 1], [2, 2, 2, 2, 2, 2, 2]]),
}


def _case(name, D=16, H=2, seed=0):
    causal, sq, sk = CASES[name]
    sq = np.asarray(sq, np.int32)
    sk = sq if sk is None else np.asarray(sk, np.int32)
    rng = np.random.RandomState(seed)
    B, S, Sk = sq.shape[0], sq.shape[1], sk.shape[1]
    q = rng.randn(B, S, H, D).astype(np.float32)
    k = rng.randn(B, Sk, H, D).astype(np.float32)
    v = rng.randn(B, Sk, H, D).astype(np.float32)
    g = rng.randn(B, S, H, D).astype(np.float32)
    seen = (sq[:, :, None] == sk[:, None, :])           # [B, S, Sk]
    if causal:
        seen &= np.tril(np.ones((S, Sk), bool))[None]
    empty = ~seen.any(-1)                                # [B, S]
    g[empty] = 0.0
    return causal, q, k, v, g, sq, sk, empty, 1.0 / np.sqrt(D)


def _jax_ref(causal, q, k, v, g, sq, sk, scale):
    """Reference out and (dq, dk, dv) = jax.vjp of the oracle."""
    out, vjp = jax.vjp(lambda a, b, c: attention_xla_segmented(
        a, b, c, jnp.asarray(sq), jnp.asarray(sk), causal, scale),
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("name", list(CASES))
def test_seg_forward_plain_matches_reference(name):
    causal, q, k, v, g, sq, sk, empty, scale = _case(name)
    ref, _ = _jax_ref(causal, q, k, v, g, sq, sk, scale)
    before = K.launches()
    out, lse = flash_attention_seg_fwd(*map(_t, (q, k, v, sq, sk)), causal,
                                       scale)
    assert K.launches() == before                   # CPU: plain version only
    np.testing.assert_allclose(out.numpy()[~empty], ref[~empty], **TOL)
    # lse: the log-sum-exp of the visible scores, [B*H, S, 1]
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    seen = sq[:, None, :, None] == sk[:, None, None, :]
    if causal:
        seen = seen & np.tril(np.ones(logits.shape[-2:], bool))
    want = np.asarray(jax.nn.logsumexp(jnp.where(seen, logits, -np.inf),
                                       axis=-1))
    B, S, H = q.shape[:3]
    vis = np.broadcast_to(~empty[:, None, :], (B, H, S))
    np.testing.assert_allclose(lse.numpy().reshape(B, H, S)[vis], want[vis],
                               **TOL)
    # the oracle twin: the mean of V on empty rows, as the reference's
    np.testing.assert_allclose(
        attention_ref_segmented(*map(_t, (q, k, v, sq, sk)), causal,
                                scale).numpy(), ref, **TOL)


def test_rows_that_see_no_key_follow_the_port_contract():
    """out 0 and lse = NEG_INF + log(1e-30), which is NEG_INF in float32,
    the TPU kernel's finalize; their gradients are 0."""
    causal, q, k, v, g, sq, sk, empty, scale = _case("full_cross")
    assert empty.sum() == 4          # b0's segment 3, b1's segment 0 rows
    args = tuple(map(_t, (q, k, v, sq, sk)))
    out, lse = _flash_fwd_seg_ref(*args, causal, scale)
    np.testing.assert_array_equal(out.numpy()[empty], 0.0)
    B, S, H = q.shape[:3]
    rows = lse.numpy().reshape(B, H, S).transpose(0, 2, 1)[empty]
    np.testing.assert_array_equal(
        rows, np.float32(NEG_INF) + np.log(np.float32(1e-30)))
    dq, _, _ = _flash_bwd_ref(*args[:3], out, lse, torch.ones_like(out),
                              causal, scale, seg=args[3:])
    np.testing.assert_array_equal(dq.numpy()[empty], 0.0)
    ql = flash_attention_varlen(*(a.clone().requires_grad_() for a in
                                  args[:3]), args[3], args[4], causal=causal,
                                scale=scale)
    np.testing.assert_array_equal(ql.detach().numpy()[empty], 0.0)


@pytest.mark.parametrize("name", list(CASES))
def test_seg_backward_plain_matches_jax_vjp(name):
    causal, q, k, v, g, sq, sk, empty, scale = _case(name, seed=1)
    _, ref = _jax_ref(causal, q, k, v, g, sq, sk, scale)
    args = tuple(map(_t, (q, k, v, sq, sk)))
    out, lse = flash_attention_seg_fwd(*args, causal, scale)
    got = flash_attention_seg_bwd(*args, out, lse, _t(g), causal, scale)
    for name_, a, b in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), b, **TOL, err_msg=name_)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_varlen_autograd_matches_jax_vjp(name):
    """The entry runs `FlashAttentionSeg`: a grad_fn, gradients equal to
    `jax.vjp` of the oracle, none for the integer segment ids."""
    causal, q, k, v, g, sq, sk, empty, scale = _case(name, seed=2)
    ref_out, ref = _jax_ref(causal, q, k, v, g, sq, sk, scale)
    ts = [_t(a).clone().requires_grad_() for a in (q, k, v)]
    kv_seg = None if CASES[name][2] is None else sk
    out = flash_attention_varlen(*ts, sq, kv_seg, causal=causal)
    assert out.grad_fn is not None
    np.testing.assert_allclose(out.detach().numpy()[~empty], ref_out[~empty],
                               **TOL)
    out.backward(_t(g))
    for name_, t, b in zip(("dq", "dk", "dv"), ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), b, **TOL, err_msg=name_)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("segmented", [True, False], ids=["seg", "dense"])
def test_nn_flash_attention_matches_reference(causal, segmented):
    _, q, k, v, _, sq, _, _, _ = _case("causal_packed", seed=3)
    seg = sq if segmented else None
    ref, none = ref_flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal,
        segment_ids=None if seg is None else jnp.asarray(seg))
    got, got_none = PF.flash_attention(*map(_t, (q, k, v)), causal=causal,
                                       segment_ids=seg)
    assert none is None and got_none is None
    np.testing.assert_allclose(got.numpy(), _np(ref), **TOL)


def test_nn_flash_attention_masked_dropout_lane_on_cpu():
    """With segment ids and dropout the lane is plain attention under the
    segment mask: exact when not training, dropped-out when training."""
    causal, q, k, v, _, sq, _, _, scale = _case("causal_packed", seed=4)
    args = tuple(map(_t, (q, k, v)))
    want = attention_ref_segmented(*args, _t(sq), _t(sq), causal, scale)
    got, _ = PF.flash_attention(*args, dropout=0.5, causal=causal,
                                training=False, segment_ids=sq)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    torch.manual_seed(0)
    dropped, _ = PF.flash_attention(*args, dropout=0.5, causal=causal,
                                    segment_ids=sq)
    assert torch.isfinite(dropped).all()
    assert not torch.allclose(dropped, want)


# (cu_q, cu_k, causal, D): which route the reference's condition picks
UNPADDED = {
    "causal_same_layout": ([0, 3, 7, 12], [0, 3, 7, 12], True, 64, "kernel"),
    "full_cross_layout": ([0, 3, 7, 12], [0, 5, 6, 10], False, 64, "kernel"),
    "causal_cross_layout": ([0, 3, 7, 12], [0, 5, 6, 10], True, 64,
                            "composed"),
    "odd_head_dim": ([0, 4, 9], [0, 4, 9], True, 24, "composed"),
}


@pytest.mark.parametrize("name", list(UNPADDED))
def test_flash_attn_unpadded_matches_reference(name):
    cu_q, cu_k, causal, D, route = UNPADDED[name]
    rng = np.random.RandomState(5)
    H = 2
    q = rng.randn(cu_q[-1], H, D).astype(np.float32)
    k = rng.randn(cu_k[-1], H, D).astype(np.float32)
    v = rng.randn(cu_k[-1], H, D).astype(np.float32)
    g = rng.randn(cu_q[-1], H, D).astype(np.float32)
    scale = 0.3
    args = (max(np.diff(cu_q)), max(np.diff(cu_k)), scale)

    def ref_fn(a, b, c):
        return ref_flash_attn_unpadded(
            a, b, c, jnp.asarray(cu_q, jnp.int32),
            jnp.asarray(cu_k, jnp.int32), *args, causal=causal)[0]._data

    ref, vjp = jax.vjp(ref_fn, *map(jnp.asarray, (q, k, v)))
    before = PF.flash_attn_unpadded.composed_calls
    ts = [_t(a).clone().requires_grad_() for a in (q, k, v)]
    got, none = PF.flash_attn_unpadded(*ts, cu_q, cu_k, *args,
                                       causal=causal)
    assert none is None
    assert PF.flash_attn_unpadded.composed_calls - before == \
        (route == "composed")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    got.backward(_t(g))
    for name_, t, b in zip(("dq", "dk", "dv"), ts,
                           vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), **TOL,
                                   err_msg=name_)
