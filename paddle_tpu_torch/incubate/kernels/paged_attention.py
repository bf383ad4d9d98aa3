"""Paged attention for the serving steps — port of
`paddle_tpu/incubate/kernels/paged_attention.py`, fp and int8 pools, one
device or head-sharded over a serving mesh.

The pool layout is the reference's: one layer's pages `[P, page, KVH, hd]`
with page 0 as the null page, a page table `[B, max_pages]` int32, and per
slot `q_offset`/`valid` `[B]` int32.  Query t of slot b sits at position
`q_offset[b] + t` and sees kv positions `<= q_offset[b] + t`; rows
`t >= valid[b]` are padding whose output the caller ignores.  The unfused
decode step's one query per slot, q `[B, H, hd]`, sees the kv positions
`< lengths[b]` instead.  An int8 pool (`models.gpt.init_paged_cache(...,
kv_dtype="int8")`) comes with `kv_scales=(k_scale, v_scale)`, per-token,
per-kv-head float32 scales `[P, page, KVH]`: every function here then
dequantizes each key row to float32 as it reads it (the reference's
`quantized` lane), weighs the values by p in float32 and returns q's dtype.

- `paged_attention_ref`: the plain PyTorch version of decode (counterpart
  of `paged_attention_xla`).  A slot with length 0 gets the mean of V
  there (every score masked), the kernel 0; the decode step always passes
  lengths >= 1.
- `paged_attention_kernel`: the hand-written CUDA kernel
  `csrc/paged_decode.cu` (the port of `_paged_attn_kernel`) on a CUDA
  tensor, the plain version on a CPU tensor.  `_decode_split_plan` gives
  its grid: each slot's keys split across blocks of `ck` keys, merged in
  the kernel as the prefill kernel's are.  Launches over a float pool count
  in `.launches`, over an int8 pool in `.launches_int8`.
- `paged_attention_decode`: the reference's decode entry, same arguments.

- `paged_prefill_attention_ref`: the plain PyTorch version (counterpart of
  `paged_prefill_attention_xla`): gathers the pool through the table.
- `paged_prefill_attention_kernel`: the hand-written CUDA kernel
  `csrc/paged_attention.cu` (the port of `_paged_prefill_kernel`) on a CUDA
  tensor, the plain version on a CPU tensor.  The kernel writes 0 to padding
  rows (t >= valid), where the plain version attends under the row's
  horizon: compare rows t < valid only.  `_prefill_split_plan` gives its
  grid: each slot's key range split across blocks of `ck` keys, merged in
  the kernel by the last block of each row tile.  Launches count as the
  decode kernel's do (`.launches`, `.launches_int8`).
- `paged_prefill_attention` / `paged_verify_attention` /
  `paged_serve_attention`: the reference's entries, same argument order.
- Tensor-parallel (`mesh=`, a rank of `parallel.tp.ServingMesh`):
  attention never mixes heads, so each rank owns H/mp query heads and
  KVH/mp kv heads of every page (the pool shards on its KVH axis, the
  scale lanes with it) while the table, lengths, q_offset and valid are
  the same on every rank.  `paged_attention_decode_mp` and
  `paged_prefill_attention_mp` run the unmodified kernel on the rank's q
  heads and pool shard: the kernels read KVH from the pool's shape
  (`_decode_split_plan`, `_prefill_split_plan`), so G = H/KVH is what it
  is at mp=1.  `_check_mp_heads` is the divisibility rule.

On the card the entries send a head dim the kernels do not take (hd not
in {64, 128, 256}) to the plain versions, as the reference sends it to its
XLA twins, counted in `paged_prefill_attention.composed_calls` (all three
prefill-contract entries) and `paged_attention_decode.composed_calls`.  An
int8 pool of any page size takes the kernels: the reference's `page % 32`
gate for int8 pools (`_shapes_ok_for_pallas`) follows the TPU's (32, 128)
int8 tiles, which the CUDA kernels do not share.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from . import _cuda
from .flash_attention import _DTYPE_CODE, NEG_INF


def _gathered(pages, scales, tbl, B, S, KVH, hd):
    """A pool gathered through the table: [B, S, KVH, hd], dequantized to
    float32 by its scales for an int8 pool (the reference's
    `_dequant_gathered`)."""
    x = pages[tbl].reshape(B, S, KVH, hd)
    if scales is None:
        return x
    return x.float() * scales[tbl].reshape(B, S, KVH)[..., None]


def paged_prefill_attention_ref(q, k_pages, v_pages, page_table, q_offset,
                                valid, scale=None, kv_scales=None):
    """q [B, T, H, hd]; k/v_pages [P, page, KVH, hd] (int8 with kv_scales
    [P, page, KVH] f32 each); page_table [B, max_pages] int; q_offset/valid
    [B] int.  Returns [B, T, H, hd] in q's dtype."""
    B, T, H, hd = q.shape
    page, KVH = k_pages.shape[1], k_pages.shape[2]
    G = H // KVH
    S = page_table.shape[1] * page
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    tbl = page_table.long()
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    k = _gathered(k_pages, ks, tbl, B, S, KVH, hd)
    v = _gathered(v_pages, vs, tbl, B, S, KVH, hd)
    qg = q.reshape(B, T, KVH, G, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * s
    qpos = q_offset.long()[:, None] + torch.arange(T, device=q.device)
    mask = torch.arange(S, device=q.device)[None, None] <= qpos[:, :, None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype), v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)


INT8_CODE = 2           # the C entries' kv_dtype code of an int8 pool


def _check_card(name, q, k_pages, v_pages, page_table, *per_slot,
                kv_scales=None):
    """The paged kernels' contract on the card: one CUDA device, float32 or
    bfloat16 q, a pool of q's dtype or an int8 pool with float32 scales
    kv_scales [P, page, KVH], hd in {64, 128, 256}, H a multiple of KVH, an
    int32 page_table [B, max_pages] and int32 per-slot vectors [B], 16-byte
    aligned rows.  Returns (the contiguous q, pool, table and vectors; the
    contiguous scales or (None, None); the pool's dtype code)."""
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    P, page, KVH, _ = k_pages.shape
    dev = q.device
    scales = tuple(kv_scales) if kv_scales is not None else ()
    if dev.type != "cuda" or any(t.device != dev for t in (
            k_pages, v_pages, page_table) + per_slot + scales):
        raise ValueError(f"{name}: every tensor must lie on q's CUDA device")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged attention takes float32/bfloat16 q, got "
                        f"{q.dtype}")
    if scales:
        if k_pages.dtype != torch.int8 or v_pages.dtype != torch.int8 or \
                len(scales) != 2 or \
                any(t.dtype != torch.float32 or t.shape != (P, page, KVH)
                    for t in scales):
            raise TypeError(f"{name}: kv_scales take an int8 pool and two "
                            f"float32 scale lanes [P, page, KVH]")
    elif k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"paged attention takes a pool of q's dtype (or int8 "
                        f"with kv_scales), got {q.dtype}/{k_pages.dtype}")
    if hd not in (64, 128, 256) or H % KVH or \
            k_pages.shape != (P, page, KVH, hd) or \
            v_pages.shape != k_pages.shape:
        raise ValueError(f"paged attention: unsupported shapes q "
                         f"{tuple(q.shape)} pool {tuple(k_pages.shape)}")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or \
            page_table.shape[0] != B or \
            any(t.dtype != torch.int32 or t.shape != (B,) for t in per_slot):
        raise ValueError(f"{name}: page_table [B, max_pages] and the "
                         f"per-slot vectors [B] must be int32")
    ts = tuple(t.contiguous() for t in (q, k_pages, v_pages, page_table) +
               per_slot)
    if any(t.data_ptr() % 16 for t in ts[:3]):
        raise ValueError("paged attention needs 16-byte aligned tensors")
    if not scales:
        return ts, (None, None), _DTYPE_CODE[q.dtype]
    return ts, tuple(t.contiguous() for t in scales), INT8_CODE


def _ptr(t):
    return None if t is None else t.data_ptr()


PREFILL_CK = 128        # keys a block walks (tuned on the card, PERF.md;
#                         the int8 lane's sweep too)
DECODE_CK = 256         # the same for the decode kernel (PERF.md)
DECODE_WARPS = 8        # warps a decode block: 4 or 8 (PERF.md)
ROW_TILE = 16           # query rows of the tile lane (kBlockRows)
PARTIAL_BYTES = 64 << 20    # cap on the split workspace


class SplitPlan(NamedTuple):
    """The grid of `csrc/paged_attention.cu` or `csrc/paged_decode.cu`, from
    host-known shapes only.

    The kernel's grid is (nsplit, row_tiles, B * KVH).  ck: keys a block
    walks; nsplit: blocks over one row tile's key range (ceil(max_pages *
    page / ck)); gc: the stream lane's row capacity, the smallest of 1, 2,
    4, 8 that holds min(G * T, 8); row_tiles: the prefill tile lane's
    ceil(T * G / 16), or the decode kernel's chunks of gc query heads,
    ceil(G / gc); ws_acc / ws_ml: the f32 partials [tiles, nsplit, 16, hd]
    and (m, l) [2, tiles, 16, nsplit] (tiles = B * KVH * row_tiles);
    counters: one int32 per tile."""
    ck: int
    nsplit: int
    gc: int
    row_tiles: int
    ws_acc: Tuple[int, int, int, int]
    ws_ml: Tuple[int, int, int, int]
    counters: int

    @property
    def ws_numel(self):
        """f32 elements of the workspace; 0 when no tile splits."""
        if self.nsplit == 1:
            return 0
        return math.prod(self.ws_acc) + math.prod(self.ws_ml)


def _split_plan(B, KVH, hd, S, ck, gc, row_tiles):
    """The plan over S key positions a slot.  Where B * KVH * row_tiles *
    nsplit partials of [16, hd + 2] f32 would pass PARTIAL_BYTES, the
    blocks walk more keys (ck grows in steps of 32) so the workspace stays
    under it."""
    tiles = B * KVH * row_tiles
    cap = max(1, PARTIAL_BYTES // (tiles * ROW_TILE * (hd + 2) * 4))
    nsplit = -(-S // ck)
    if nsplit > cap:
        ck = -(-S // cap)
        ck = -(-ck // 32) * 32
        nsplit = -(-S // ck)
    return SplitPlan(
        ck=ck, nsplit=nsplit, gc=gc, row_tiles=row_tiles,
        ws_acc=(tiles, nsplit, ROW_TILE, hd),
        ws_ml=(2, tiles, ROW_TILE, nsplit), counters=tiles)


def _stream_rows(rows):
    """The stream lane's capacity for `rows` rows: the smallest of 1, 2, 4,
    8 that holds min(rows, 8)."""
    return next(c for c in (1, 2, 4, 8) if c >= min(rows, 8))


@functools.lru_cache(maxsize=64)
def _prefill_split_plan(B, T, H, KVH, hd, page, max_pages, ck=PREFILL_CK):
    """The split plan of the prefill kernel for q [B, T, H, hd] over a
    [*, page, KVH, hd] pool with `max_pages` table columns (long chunks
    have many row tiles, which fill the card anyway, and so walk more keys
    a block under the workspace cap)."""
    G = H // KVH
    return _split_plan(B, KVH, hd, max_pages * page, ck, _stream_rows(G * T),
                       -(-(T * G) // ROW_TILE))


@functools.lru_cache(maxsize=64)
def _decode_split_plan(B, H, KVH, hd, page, max_pages, ck=DECODE_CK):
    """The split plan of the decode kernel for q [B, H, hd]: a block takes
    gc query heads of one kv head over ck keys.  Lengths live on the
    device, so the splits cover the table's max_pages * page positions; a
    block past its slot's length returns at once."""
    G = H // KVH
    gc = _stream_rows(G)
    return _split_plan(B, KVH, hd, max_pages * page, ck, gc, -(-G // gc))


_split_counters = {}    # (device index, stream) -> int32 counters, 0 at rest


def _counters(dev, stream, n):
    """Per-tile arrival counters of the split merge on `stream`, shared by
    the prefill and decode kernels (stream order keeps their calls apart):
    zeroed once, reset to 0 by the kernels' merging blocks, replaced only
    when a call needs more of them.  A CUDA graph bakes in the counters it
    saw at capture, so a capture must find them sized (an eager call of the
    same shapes on the capturing stream first) and its owner keeps them
    alive (`split_counters`) should a later call replace them."""
    key = (dev.index, stream.cuda_stream)
    c = _split_counters.get(key)
    if c is None or c.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged attention: the split counters of the capturing stream "
                "are not sized; run the captured step once eagerly on that "
                "stream before capture")
        c = torch.zeros(n, dtype=torch.int32, device=dev)
        _split_counters[key] = c
    return c


def split_counters(dev, stream):
    """The merge counters the paged kernels use on `stream` now (None before
    their first call there)."""
    index = torch.cuda._get_device_index(dev, optional=True)
    return _split_counters.get((index, stream.cuda_stream))


def paged_prefill_attention_kernel(q, k_pages, v_pages, page_table, q_offset,
                                   valid, scale=None, kv_scales=None):
    """Same contract as `paged_prefill_attention_ref` on rows t < valid;
    the kernel writes 0 to padding rows.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (hd in {64, 128, 256}, float32
    or bfloat16 q, a pool of q's dtype or int8 with kv_scales, any page
    size and T) or raise.  `paged_prefill_attention_kernel.launches` counts
    launches over a float pool, `.launches_int8` over an int8 pool."""
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pages, v_pages, page_table,
                                           q_offset, valid, scale, kv_scales)
    (q, k_pages, v_pages, page_table, q_offset, valid), (ks, vs), kv_code = \
        _check_card("paged_prefill_attention_kernel", q, k_pages, v_pages,
                    page_table, q_offset, valid, kv_scales=kv_scales)
    B, T, H, hd = q.shape
    page, KVH = k_pages.shape[1], k_pages.shape[2]
    max_pages = page_table.shape[1]
    plan = _prefill_split_plan(B, T, H, KVH, hd, page, max_pages,
                               PREFILL_CK)
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device)
    out = torch.empty_like(q)
    ws = torch.empty(plan.ws_numel, dtype=torch.float32, device=q.device)
    count = _counters(q.device, stream, plan.counters)
    fn = _cuda.entry("paged_attention", "paged_prefill_attention")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), _ptr(ks),
             _ptr(vs), page_table.data_ptr(), q_offset.data_ptr(),
             valid.data_ptr(), out.data_ptr(), ws.data_ptr(),
             count.data_ptr(), B, T, H, KVH, hd, page, max_pages, plan.ck,
             plan.nsplit, plan.gc, float(s), _DTYPE_CODE[q.dtype], kv_code,
             stream.cuda_stream)
    _cuda.check(err, "paged_prefill_attention")
    if ks is None:
        paged_prefill_attention_kernel.launches += 1
    else:
        paged_prefill_attention_kernel.launches_int8 += 1
    return out


paged_prefill_attention_kernel.launches = 0
paged_prefill_attention_kernel.launches_int8 = 0


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                        scale=None, kv_scales=None):
    """q [B, H, hd]; k/v_pages [P, page, KVH, hd] (int8 with kv_scales
    [P, page, KVH] f32 each); page_table [B, max_pages] int; lengths [B]
    int (keys at positions < lengths[b]).  Returns [B, H, hd] in q's
    dtype."""
    B, H, hd = q.shape
    page, KVH = k_pages.shape[1], k_pages.shape[2]
    G = H // KVH
    S = page_table.shape[1] * page
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    tbl = page_table.long()
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    k = _gathered(k_pages, ks, tbl, B, S, KVH, hd)
    v = _gathered(v_pages, vs, tbl, B, S, KVH, hd)
    qg = q.reshape(B, KVH, G, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * s
    mask = torch.arange(S, device=q.device)[None] < lengths.long()[:, None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    return out.reshape(B, H, hd).to(q.dtype)


def paged_attention_kernel(q, k_pages, v_pages, page_table, lengths,
                           scale=None, kv_scales=None):
    """Same contract as `paged_attention_ref` for lengths >= 1 (0 gives 0,
    as the TPU kernel does).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (hd in {64, 128, 256}, float32 or bfloat16
    q, a pool of q's dtype or int8 with kv_scales, any page size and G) or
    raise.  `paged_attention_kernel.launches` counts launches over a float
    pool, `.launches_int8` over an int8 pool."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   scale, kv_scales)
    if q.dim() != 3:
        raise ValueError(f"paged_attention_kernel: q must be [B, H, hd], got "
                         f"{tuple(q.shape)}")
    (q, k_pages, v_pages, page_table, lengths), (ks, vs), kv_code = \
        _check_card("paged_attention_kernel", q, k_pages, v_pages,
                    page_table, lengths, kv_scales=kv_scales)
    B, H, hd = q.shape
    page, KVH = k_pages.shape[1], k_pages.shape[2]
    max_pages = page_table.shape[1]
    plan = _decode_split_plan(B, H, KVH, hd, page, max_pages, DECODE_CK)
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream(q.device)
    out = torch.empty_like(q)
    ws = torch.empty(plan.ws_numel, dtype=torch.float32, device=q.device)
    count = _counters(q.device, stream, plan.counters)
    fn = _cuda.entry("paged_decode", "paged_decode_attention")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), _ptr(ks),
             _ptr(vs), page_table.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), ws.data_ptr(), count.data_ptr(), B, H, KVH, hd,
             page, max_pages, plan.ck, plan.nsplit, DECODE_WARPS, float(s),
             _DTYPE_CODE[q.dtype], kv_code, stream.cuda_stream)
    _cuda.check(err, "paged_decode_attention")
    if ks is None:
        paged_attention_kernel.launches += 1
    else:
        paged_attention_kernel.launches_int8 += 1
    return out


paged_attention_kernel.launches = 0
paged_attention_kernel.launches_int8 = 0


def _mp_degree(mesh) -> int:
    """The tensor-parallel degree of a serving mesh rank (1 for None)."""
    return 1 if mesh is None else int(mesh.mp)


def _check_mp_heads(q_heads: int, kv_heads: int, mp: int) -> None:
    """The reference's rule: mp divides the query and the kv heads."""
    if q_heads % mp or kv_heads % mp:
        raise ValueError(
            f"tensor-parallel serving needs num_heads ({q_heads}) and "
            f"kv_heads ({kv_heads}) divisible by mp={mp}")


def _check_rank_shard(q_heads: int, k_pages, mesh) -> None:
    """A rank's q heads over its pool shard: whole groups of G = H/KVH."""
    kvh = k_pages.shape[2]
    if q_heads % kvh:
        raise ValueError(f"rank {mesh.rank}: {q_heads} q heads over {kvh} "
                         f"kv heads of its pool shard")


def paged_attention_decode_mp(q, k_pages, v_pages, page_table, lengths,
                              mesh, scale=None, kv_scales=None):
    """Head-sharded `paged_attention_decode` on one rank of `mesh`: q is the
    rank's heads [B, H/mp, hd], k/v_pages (and kv_scales) its pool shard
    [P, page, KVH/mp, hd]; returns the rank's heads of the output.  No
    collective: the out-projection that follows is row-parallel."""
    _check_rank_shard(q.shape[1], k_pages, mesh)
    return _decode_entry(q, k_pages, v_pages, page_table, lengths, scale,
                         kv_scales)


def paged_prefill_attention_mp(q, k_pages, v_pages, page_table, q_offset,
                               valid, mesh, scale=None, kv_scales=None):
    """Head-sharded `paged_prefill_attention` (and so the verify and fused
    serving lanes) on one rank of `mesh`: q [B, T, H/mp, hd] and the
    rank's pool shard, as `paged_attention_decode_mp`."""
    _check_rank_shard(q.shape[2], k_pages, mesh)
    return _prefill_entry(q, k_pages, v_pages, page_table, q_offset, valid,
                          scale, kv_scales)


def _kernel_takes(q):
    """Whether the paged kernels take q's head dim."""
    return q.shape[-1] in (64, 128, 256)


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_offset, valid,
                            scale=None, mesh=None, kv_scales=None):
    """Chunked-prefill entry (reference `paged_prefill_attention`);
    kv_scales selects the int8 pool's lane; `mesh` (mp > 1) takes the
    rank's heads and pool shard (`paged_prefill_attention_mp`)."""
    if _mp_degree(mesh) > 1:
        return paged_prefill_attention_mp(q, k_pages, v_pages, page_table,
                                          q_offset, valid, mesh, scale=scale,
                                          kv_scales=kv_scales)
    return _prefill_entry(q, k_pages, v_pages, page_table, q_offset, valid,
                          scale, kv_scales)


def _prefill_entry(q, k_pages, v_pages, page_table, q_offset, valid, scale,
                   kv_scales):
    if q.device.type != "cpu" and not _kernel_takes(q):
        paged_prefill_attention.composed_calls += 1
        return paged_prefill_attention_ref(q, k_pages, v_pages, page_table,
                                           q_offset, valid, scale=scale,
                                           kv_scales=kv_scales)
    return paged_prefill_attention_kernel(q, k_pages, v_pages, page_table,
                                          q_offset, valid, scale=scale,
                                          kv_scales=kv_scales)


paged_prefill_attention.composed_calls = 0


def paged_verify_attention(q, k_pages, v_pages, page_table, lengths, valid,
                           scale=None, mesh=None, kv_scales=None):
    """Spec-verify entry: the prefill contract with q_offset = lengths."""
    return paged_prefill_attention(q, k_pages, v_pages, page_table, lengths,
                                   valid, scale=scale, mesh=mesh,
                                   kv_scales=kv_scales)


def paged_serve_attention(q, k_pages, v_pages, page_table, q_offset, valid,
                          scale=None, mesh=None, kv_scales=None):
    """Entry of the fused serving step (`models.gpt.serve_step_paged`):
    decode (valid 1), verify and prefill-chunk slots in one batch, each
    slot's mode implied by its (q_offset, valid, table row)."""
    return paged_prefill_attention(q, k_pages, v_pages, page_table, q_offset,
                                   valid, scale=scale, mesh=mesh,
                                   kv_scales=kv_scales)


def paged_attention_decode(q, k_pages, v_pages, page_table, lengths,
                           scale=None, mesh=None, kv_scales=None):
    """Entry of the unfused decode step (`models.gpt.decode_step_paged`,
    reference `paged_attention_decode`): one query per slot over its
    lengths[b] cached positions; kv_scales selects the int8 pool's lane;
    `mesh` (mp > 1) takes the rank's heads and pool shard
    (`paged_attention_decode_mp`)."""
    if _mp_degree(mesh) > 1:
        return paged_attention_decode_mp(q, k_pages, v_pages, page_table,
                                         lengths, mesh, scale=scale,
                                         kv_scales=kv_scales)
    return _decode_entry(q, k_pages, v_pages, page_table, lengths, scale,
                         kv_scales)


def _decode_entry(q, k_pages, v_pages, page_table, lengths, scale,
                  kv_scales):
    if q.device.type != "cpu" and not _kernel_takes(q):
        paged_attention_decode.composed_calls += 1
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   scale=scale, kv_scales=kv_scales)
    return paged_attention_kernel(q, k_pages, v_pages, page_table, lengths,
                                  scale=scale, kv_scales=kv_scales)


paged_attention_decode.composed_calls = 0
