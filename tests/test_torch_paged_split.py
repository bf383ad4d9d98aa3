"""The paged prefill kernel's split plan and its split-and-merge, on the CPU.

`csrc/paged_attention.cu` splits each slot's key range across blocks of
`ck` keys and merges the per-split partials in the kernel.  The kernel runs
only on the card (`tests/test_torch_cuda_kernels.py`); here the plan that
sizes its grid and workspace is checked, and a torch emulation of its
arithmetic (per-split (m, l, acc) with masked probabilities zeroed after
the exp, merged in split order with weights exp(m_s - M)), driven by that
plan, is held against the port's plain version and the JAX package's
`paged_prefill_attention_xla` on rows t < valid.  Padding rows must be 0.
Tolerance 1e-5 abs/rel in float32: the same math summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.paged_attention import \
    paged_prefill_attention_xla
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    PARTIAL_BYTES, PREFILL_CK, ROW_TILE, _prefill_split_plan,
    paged_prefill_attention_ref)
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("T", [1, 2, 16])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_split_plan(G, T, page):
    B, KVH, hd, max_pages = 3, 2, 64, 40
    plan = _prefill_split_plan(B, T, G * KVH, KVH, hd, page, max_pages)
    S = max_pages * page                       # 320 or 640 positions
    assert plan.ck == PREFILL_CK == 128
    assert plan.nsplit == {320: 3, 640: 5}[S]
    assert plan.gc == {1: 1, 2: 2, 4: 4}.get(G * T, 8)
    assert plan.row_tiles == {1: 1, 2: 1, 4: 1, 8: 1, 16: 1, 32: 2,
                              64: 4, 128: 8}[G * T]
    tiles = B * KVH * plan.row_tiles
    assert plan.ws_acc == (tiles, plan.nsplit, ROW_TILE, hd)
    assert plan.ws_ml == (2, tiles, ROW_TILE, plan.nsplit)
    assert plan.counters == tiles
    assert plan.ws_numel == tiles * plan.nsplit * ROW_TILE * (hd + 2)


def test_split_plan_one_split_needs_no_workspace():
    plan = _prefill_split_plan(8, 1, 32, 8, 128, 16, 8)      # 128 keys
    assert plan.nsplit == 1 and plan.ws_numel == 0


@pytest.mark.parametrize("T,hd", [(512, 128), (2048, 256)])
def test_split_plan_caps_the_workspace(T, hd):
    """Long chunks have many row tiles: blocks walk more keys (ck grows in
    steps of 32) so the partials stay under PARTIAL_BYTES, and the splits
    still cover every position."""
    B, H, KVH, page, max_pages = 8, 32, 8, 16, 128
    plan = _prefill_split_plan(B, T, H, KVH, hd, page, max_pages)
    assert plan.ck > PREFILL_CK and plan.ck % 32 == 0
    assert plan.ck * plan.nsplit >= max_pages * page
    assert plan.ws_numel * 4 <= PARTIAL_BYTES


def _emulate(q, k_pages, v_pages, table, q_offset, valid, plan, scale):
    """The kernel's arithmetic in float32: per (slot, kv head, row tile) the
    lane's rows (stream lane: G * valid <= gc, all in tile 0), the tile's
    kv_end and n = ceil(kv_end / ck) splits; per split (m, l, acc) with
    masked p zeroed; the partials merged in split order.  Padding rows 0."""
    B, T, H, hd = q.shape
    page, KVH = k_pages.shape[1], k_pages.shape[2]
    G, S, ck = H // KVH, table.shape[1] * page, plan.ck
    k = k_pages[table.long()].reshape(B, S, KVH, hd)
    v = v_pages[table.long()].reshape(B, S, KVH, hd)
    out = torch.zeros_like(q)
    for b in range(B):
        qoff, val = int(q_offset[b]), int(valid[b])
        last_q = min(qoff + val - 1, S - 1)
        for kh in range(KVH):
            for x in range(plan.row_tiles):
                r0 = x * ROW_TILE
                rows = min(ROW_TILE, T * G - r0)
                real = min(max(G * val - r0, 0), rows)
                if real == 0:
                    continue
                if G * val <= plan.gc:
                    assert x == 0               # the stream lane's slot
                t = (r0 + torch.arange(real)) // G
                g = (r0 + torch.arange(real)) % G
                qr = q[b, t, kh * G + g]                    # [real, hd]
                hz = torch.clamp(qoff + t, max=last_q)
                kv_end = min(qoff + (r0 + real - 1) // G, last_q) + 1
                n = -(-kv_end // ck)
                assert 1 <= n <= plan.nsplit
                parts = []
                for s in range(n):
                    pos = torch.arange(s * ck, min(s * ck + ck, kv_end))
                    sc = qr @ k[b, pos, kh].T * scale
                    vis = pos[None] <= hz[:, None]
                    sc = torch.where(vis, sc, NEG_INF)
                    m = sc.max(-1).values
                    p = torch.where(vis, torch.exp(sc - m[:, None]), 0.0)
                    parts.append((m, p.sum(-1), p @ v[b, pos, kh]))
                M = torch.stack([m for m, _, _ in parts]).max(0).values
                L = torch.zeros(real)
                A = torch.zeros(real, hd)
                for m, l_, a in parts:                  # split order
                    w = torch.exp(m - M)
                    L = L + l_ * w
                    A = A + a * w[:, None]
                out[b, t, kh * G + g] = A / torch.clamp(L, min=1e-30)[:, None]
    return out


def _case(rng, T, G, q_offset, valid, page=8, max_pages=80, KVH=2, hd=16,
          null=()):
    """Non-contiguous table rows for each slot's positions <= its last real
    query; slots in `null` keep an all-zero (null-page) row."""
    B = len(q_offset)
    table = np.zeros((B, max_pages), np.int32)
    need = [0 if b in null else -(-(q_offset[b] + valid[b]) // page)
            for b in range(B)]
    P = 1 + sum(need)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        table[b, :need[b]] = [free.pop() for _ in range(need[b])]
    H = G * KVH
    return (rng.randn(B, T, H, hd).astype(np.float32),
            rng.randn(P, page, KVH, hd).astype(np.float32),
            rng.randn(P, page, KVH, hd).astype(np.float32), table,
            np.asarray(q_offset, np.int32), np.asarray(valid, np.int32))


# (T, q_offset as (a, c) for a * ck + c, valid, null slots): slot kv_end
# 1, ck and ck + 1 at the test's ck, slots of several and many splits, a
# null-table slot; at T = 16 decode slots at valid 1 beside chunk slots, one
# chunk starting 3 keys below a split, so its first rows see no key of that
# split; at T = 4 verify slots of the stream and the tile lane
CASES = {
    "decode": (1, [(0, 0), (1, -1), (1, 0), (0, 300), (0, 0), (0, 150)],
               [1, 1, 1, 1, 1, 1], (4,)),
    "chunked": (16, [(1, -3), (0, 0), (0, 301), (0, 37), (0, 0), (2, -1)],
                [16, 1, 9, 1, 1, 2], (4,)),
    "verify": (4, [(0, 5), (1, -2), (0, 200), (0, 0)], [4, 3, 1, 1], (3,)),
}


@pytest.mark.parametrize("ck", [32, PREFILL_CK], ids=["ck32", "ck_plan"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_split_merge_matches_plain_and_xla(case, G, ck):
    T, qoff, valid, null = CASES[case]
    qoff = [a * ck + c for a, c in qoff]
    rng = np.random.RandomState(len(case) + G + ck)
    q, k, v, tbl, qo, vl = _case(rng, T, G, qoff, valid, null=null)
    B, _, H, hd = q.shape
    plan = _prefill_split_plan(B, T, H, k.shape[2], hd, k.shape[1],
                               tbl.shape[1], ck)
    scale = 1.0 / np.sqrt(hd)
    ts = [torch.from_numpy(a) for a in (q, k, v, tbl, qo, vl)]
    got = _emulate(*ts, plan, scale).numpy()
    ref = paged_prefill_attention_ref(*ts).numpy()
    xla = np.asarray(paged_prefill_attention_xla(*map(jnp.asarray, (
        q, k, v, tbl, qo, vl))))
    for b, n in enumerate(vl):
        np.testing.assert_allclose(got[b, :n], ref[b, :n], **TOL)
        np.testing.assert_allclose(got[b, :n], xla[b, :n], **TOL)
        assert not got[b, n:].any()             # padding rows are 0
    # the case reaches what it is meant to: several splits, and (chunked)
    # a real row whose horizon lies below a split's first key
    assert max(-(-(o + n) // ck) for o, n in zip(qoff, vl)) >= 2
    if case == "chunked":
        assert qoff[0] < ck <= qoff[0] + valid[0] - 1
