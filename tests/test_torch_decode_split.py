"""The paged decode kernel's split plan and its split-and-merge, on the CPU.

`csrc/paged_decode.cu` splits each slot's key range across blocks of `ck`
keys and merges the per-split partials in the kernel, as the prefill kernel
does (`tests/test_torch_paged_split.py`).  The kernel runs only on the card
(`tests/test_torch_cuda_kernels.py`); here the plan that sizes its grid and
workspace is checked, and a torch emulation of its arithmetic (per split
(m, l, acc) over the block's keys with masked probabilities zeroed after
the exp, merged in split order with weights exp(m_s - M)), driven by that
plan, is held against the port's plain version, the JAX package's
`paged_attention_xla` and its Pallas kernel in interpret mode.  A slot of
length 0 gets 0, as the Pallas kernel's finalize gives (the gather
versions give the mean of V there).  Tolerance 1e-5 abs/rel in float32:
the same math summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.incubate.kernels.paged_attention import (
    paged_attention_pallas, paged_attention_xla)
from paddle_tpu_torch.incubate.kernels.paged_attention import (
    DECODE_CK, PARTIAL_BYTES, ROW_TILE, _decode_split_plan,
    paged_attention_ref)

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -1e30


@pytest.mark.parametrize("page", [8, 16])
@pytest.mark.parametrize("G", [1, 3, 4, 8, 16])
def test_decode_split_plan(G, page):
    B, KVH, hd, max_pages = 3, 2, 64, 40
    plan = _decode_split_plan(B, G * KVH, KVH, hd, page, max_pages)
    S = max_pages * page                       # 320 or 640 positions
    assert plan.ck == DECODE_CK == 256
    assert plan.nsplit == {320: 2, 640: 3}[S]
    assert plan.ck * plan.nsplit >= S
    assert plan.gc == {1: 1, 3: 4, 4: 4}.get(G, 8)
    assert plan.row_tiles == (2 if G == 16 else 1)    # chunks of gc heads
    tiles = B * KVH * plan.row_tiles
    assert plan.ws_acc == (tiles, plan.nsplit, ROW_TILE, hd)
    assert plan.ws_ml == (2, tiles, ROW_TILE, plan.nsplit)
    assert plan.counters == tiles
    assert plan.ws_numel == tiles * plan.nsplit * ROW_TILE * (hd + 2)
    assert plan.ws_numel * 4 <= PARTIAL_BYTES


def test_decode_split_plan_one_split_needs_no_workspace():
    plan = _decode_split_plan(8, 32, 8, 128, 16, 16)          # 256 keys
    assert plan.nsplit == 1 and plan.ws_numel == 0


def test_decode_split_plan_caps_the_workspace():
    """Many slots over a long table: the blocks walk more keys (ck grows in
    steps of 32) so the partials stay under PARTIAL_BYTES, and the splits
    still cover every position."""
    B, H, KVH, hd, page, max_pages = 64, 64, 8, 256, 16, 1024
    plan = _decode_split_plan(B, H, KVH, hd, page, max_pages)
    assert plan.ck > DECODE_CK and plan.ck % 32 == 0
    assert plan.ck * plan.nsplit >= max_pages * page
    assert 0 < plan.ws_numel * 4 <= PARTIAL_BYTES


def _emulate(q, k_pages, v_pages, table, lengths, plan, scale):
    """The kernel's arithmetic in float32: per (slot, kv head, chunk of gc
    heads) n = ceil(length / ck) splits; per split (m, l, acc) over the
    block's keys [s * ck, (s + 1) * ck) with keys at or past the length
    masked and their p zeroed; the partials merged in split order (one
    split: normalised directly).  Length 0: out 0."""
    B, H, hd = q.shape
    page, KVH = k_pages.shape[1], k_pages.shape[2]
    G, S, ck, gc = H // KVH, table.shape[1] * page, plan.ck, plan.gc
    k = k_pages[table.long()].reshape(B, S, KVH, hd)
    v = v_pages[table.long()].reshape(B, S, KVH, hd)
    out = torch.zeros_like(q)
    for b in range(B):
        L = min(int(lengths[b]), S)
        n = -(-L // ck)
        assert n <= plan.nsplit
        for kh in range(KVH):
            for c in range(plan.row_tiles):
                heads = kh * G + torch.arange(c * gc, min(c * gc + gc, G))
                parts = []
                for s in range(n):
                    pos = torch.arange(s * ck, min(s * ck + ck, S))
                    sc = q[b, heads] @ k[b, pos, kh].T * scale
                    vis = (pos < L)[None]
                    sc = torch.where(vis, sc, NEG_INF)
                    m = sc.max(-1).values
                    p = torch.where(vis, torch.exp(sc - m[:, None]), 0.0)
                    parts.append((m, p.sum(-1), p @ v[b, pos, kh]))
                if not parts:
                    continue                            # length 0: out 0
                M = torch.stack([m for m, _, _ in parts]).max(0).values
                Ls = torch.zeros(len(heads))
                A = torch.zeros(len(heads), hd)
                for m, l_, a in parts:                  # split order
                    w = torch.exp(m - M)
                    Ls = Ls + l_ * w
                    A = A + a * w[:, None]
                out[b, heads] = A / torch.clamp(Ls, min=1e-30)[:, None]
    return out


def _case(rng, lengths, G, page=16, KVH=2, hd=16):
    """Non-contiguous table rows over each slot's positions < its length,
    one column to spare past the longest."""
    B = len(lengths)
    need = [-(-n // page) for n in lengths]
    max_pages = max(need) + 1
    P = 1 + sum(need)
    table = np.zeros((B, max_pages), np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        table[b, :need[b]] = [free.pop() for _ in range(need[b])]
    H = G * KVH
    return (rng.randn(B, H, hd).astype(np.float32),
            rng.randn(P, page, KVH, hd).astype(np.float32),
            rng.randn(P, page, KVH, hd).astype(np.float32), table,
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("ck", [32, DECODE_CK], ids=["ck32", "ck_plan"])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_decode_split_merge_matches_plain_xla_and_pallas(G, ck):
    """Lengths 1, ck - 1, ck, ck + 1, several splits (3 ck + 5) and 0; at
    G = 16 two chunks of 8 heads a kv head."""
    lengths = [1, ck - 1, ck, ck + 1, 3 * ck + 5, 0]
    rng = np.random.RandomState(G + ck)
    q, k, v, tbl, lens = _case(rng, lengths, G)
    B, H, hd = q.shape
    plan = _decode_split_plan(B, H, k.shape[2], hd, k.shape[1],
                              tbl.shape[1], ck)
    assert plan.ck == ck and plan.nsplit >= 4
    scale = 1.0 / np.sqrt(hd)
    ts = [torch.from_numpy(a) for a in (q, k, v, tbl, lens)]
    got = _emulate(*ts, plan, scale).numpy()
    ref = paged_attention_ref(*ts).numpy()
    jargs = tuple(map(jnp.asarray, (q, k, v, tbl, lens)))
    xla = np.asarray(paged_attention_xla(*jargs))
    pallas = np.asarray(paged_attention_pallas(*jargs, interpret=True))
    live = lens > 0
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    np.testing.assert_allclose(got[live], xla[live], **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    assert not got[~live].any()
