"""Where the port's model-facing attention entries send a call, on the CPU.

The reference sends shapes its Pallas kernels do not take to its XLA twins
(`_shapes_ok_for_pallas`); the port decides the same from shapes alone:
on the card, a head dim outside {64, 128, 256}, or causal attention with
S != Sk, goes to the plain version (`attention_ref`,
`attention_ref_segmented`, `paged_*_ref`), counted in the entry's
`composed_calls`.  On the CPU every entry keeps its plain kernel versions,
which take any shape.  The plain routes are held against the reference's
XLA twins within 1e-5 in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.flash_attention import (
    attention_xla, attention_xla_segmented)
from paddle_tpu_torch.incubate import kernels as K
from paddle_tpu_torch.incubate.kernels.flash_attention import (
    attention_ref, attention_ref_segmented, flash_attention_fused,
    flash_attention_varlen, kernel_takes)
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    _kernel_takes as paged_kernel_takes)

TOL = dict(atol=1e-5, rtol=1e-5)

# (D, S, Sk, causal): whether the attention kernels take the shapes
ATTENTION_SHAPES = {
    "d64_causal": ((64, 128, 128, True), True),
    "d128_causal_one_row": ((128, 1, 1, True), True),
    "d256_cross_full": ((256, 5, 9, False), True),
    "d16_causal": ((16, 8, 8, True), False),
    "d96_full": ((96, 8, 8, False), False),
    "d64_causal_short_q": ((64, 5, 9, True), False),
    "d128_causal_long_q": ((128, 9, 5, True), False),
}


@pytest.mark.parametrize("name", list(ATTENTION_SHAPES))
def test_attention_kernel_takes(name):
    (D, S, Sk, causal), takes = ATTENTION_SHAPES[name]
    q, k = torch.zeros(2, S, 3, D), torch.zeros(2, Sk, 3, D)
    assert kernel_takes(q, k, causal) is takes


@pytest.mark.parametrize("hd,takes", [(16, False), (64, True), (96, False),
                                      (128, True), (256, True)])
def test_paged_kernel_takes(hd, takes):
    for shape in ((4, 1, 8, hd), (4, 8, hd)):      # prefill, decode q
        assert paged_kernel_takes(torch.zeros(shape)) is takes


@pytest.mark.parametrize("name", [n for n, (_, takes) in
                                  ATTENTION_SHAPES.items() if not takes])
def test_plain_routes_match_reference(name):
    """What the card runs for shapes the kernels do not take equals the
    reference's XLA twin (causal: row + (Sk - Sq) >= col; a row that sees
    no key gets the mean of V in both); on the CPU the entries keep their
    plain kernel versions, uncounted, with the same values where every row
    sees a key."""
    (D, S, Sk, causal), _ = ATTENTION_SHAPES[name]
    rng = np.random.RandomState(D + S)
    q = rng.randn(2, S, 3, D).astype(np.float32)
    k, v = (rng.randn(2, Sk, 3, D).astype(np.float32) for _ in range(2))
    seg_q = np.sort(rng.randint(0, 3, (2, S)), axis=1).astype(np.int32)
    seg_k = np.sort(rng.randint(0, 3, (2, Sk)), axis=1).astype(np.int32)
    scale = 0.3
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref = np.asarray(attention_xla(jq, jk, jv, causal=causal, scale=scale))
    np.testing.assert_allclose(
        attention_ref(tq, tk, tv, causal=causal, scale=scale).numpy(), ref,
        **TOL)
    seg_ref = np.asarray(attention_xla_segmented(
        jq, jk, jv, jnp.asarray(seg_q), jnp.asarray(seg_k), causal, scale))
    np.testing.assert_allclose(attention_ref_segmented(
        tq, tk, tv, torch.from_numpy(seg_q), torch.from_numpy(seg_k), causal,
        scale).numpy(), seg_ref, **TOL)
    K.reset_launches()
    got = flash_attention_fused(tq, tk, tv, causal=causal, scale=scale)
    flash_attention_varlen(tq, tk, tv, seg_q, seg_k, causal=causal,
                           scale=scale)
    assert set(K.composed_calls().values()) == {0}
    assert set(K.launches().values()) == {0}
    sees = np.arange(S)[:, None] + (Sk - S) >= np.arange(Sk)[None, :] \
        if causal else np.ones((S, Sk), bool)
    rows = sees.any(1)
    np.testing.assert_allclose(got.numpy()[:, rows], ref[:, rows], **TOL)


def test_composed_counters_cover_the_routed_entries():
    """Four entries route; `reset_launches` zeroes their counts too."""
    assert set(K.composed_calls()) == {
        "flash_attention_fused", "flash_attention_varlen",
        "paged_prefill_attention", "paged_attention_decode"}
    for fn in K.ROUTED:
        fn.composed_calls = 3
    K.reset_launches()
    assert set(K.composed_calls().values()) == {0}
