"""Paged attention for the serving steps — port of the fp, `mp=1` part of
`paddle_tpu/incubate/kernels/paged_attention.py`.

The pool layout is the reference's: one layer's pages `[P, page, KVH, hd]`
with page 0 as the null page, a page table `[B, max_pages]` int32, and per
slot `q_offset`/`valid` `[B]` int32.  Query t of slot b sits at position
`q_offset[b] + t` and sees kv positions `<= q_offset[b] + t`; rows
`t >= valid[b]` are padding whose output the caller ignores.  The unfused
decode step's one query per slot, q `[B, H, hd]`, sees the kv positions
`< lengths[b]` instead.

- `paged_attention_ref`: the plain PyTorch version of decode (counterpart
  of `paged_attention_xla`).  A slot with length 0 gets the mean of V
  there (every score masked), the kernel 0; the decode step always passes
  lengths >= 1.
- `paged_attention_kernel`: the hand-written CUDA kernel
  `csrc/paged_decode.cu` (the port of `_paged_attn_kernel`) on a CUDA
  tensor, the plain version on a CPU tensor.
- `paged_attention_decode`: the reference's decode entry, same arguments.

- `paged_prefill_attention_ref`: the plain PyTorch version (counterpart of
  `paged_prefill_attention_xla`): gathers the pool through the table.
- `paged_prefill_attention_kernel`: the hand-written CUDA kernel
  `csrc/paged_attention.cu` (the port of `_paged_prefill_kernel`) on a CUDA
  tensor, the plain version on a CPU tensor.  The kernel skips keys past a
  slot's last real query, so padding rows differ from the plain version by
  design: compare rows t < valid only.
- `paged_prefill_attention` / `paged_verify_attention` /
  `paged_serve_attention`: the reference's entries, same argument order.
  `mesh` (tensor-parallel) and `kv_scales` (int8 pool) belong to later
  slices and raise.

On the card the entries send a head dim the kernels do not take (hd not
in {64, 128, 256}) to the plain versions, as the reference sends it to its
XLA twins, counted in `paged_prefill_attention.composed_calls` (all three
prefill-contract entries) and `paged_attention_decode.composed_calls`.
"""
from __future__ import annotations

import math

import torch

from . import _cuda
from .flash_attention import _DTYPE_CODE, NEG_INF


def paged_prefill_attention_ref(q, k_pages, v_pages, page_table, q_offset,
                                valid, scale=None):
    """q [B, T, H, hd]; k/v_pages [P, page, KVH, hd]; page_table
    [B, max_pages] int; q_offset/valid [B] int.  Returns [B, T, H, hd]."""
    B, T, H, hd = q.shape
    page, KVH = k_pages.shape[1], k_pages.shape[2]
    G = H // KVH
    S = page_table.shape[1] * page
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    tbl = page_table.long()
    k = k_pages[tbl].reshape(B, S, KVH, hd)
    v = v_pages[tbl].reshape(B, S, KVH, hd)
    qg = q.reshape(B, T, KVH, G, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * s
    qpos = q_offset.long()[:, None] + torch.arange(T, device=q.device)
    mask = torch.arange(S, device=q.device)[None, None] <= qpos[:, :, None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->bkgtd", p.to(v.dtype), v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd)


def _check_card(name, q, k_pages, v_pages, page_table, *per_slot):
    """The paged kernels' contract on the card: one CUDA device, float32 or
    bfloat16 q and pool of one dtype, hd in {64, 128, 256}, H a multiple of
    KVH, an int32 page_table [B, max_pages] and int32 per-slot vectors [B],
    16-byte aligned rows.  Returns the contiguous q, pool, table and
    vectors."""
    B, H, hd = q.shape[0], q.shape[-2], q.shape[-1]
    P, page, KVH, _ = k_pages.shape
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (
            k_pages, v_pages, page_table) + per_slot):
        raise ValueError(f"{name}: every tensor must lie on q's CUDA device")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"paged attention takes float32/bfloat16 q and pool "
                        f"of one dtype, got {q.dtype}/{k_pages.dtype}")
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
    return ts


def paged_prefill_attention_kernel(q, k_pages, v_pages, page_table, q_offset,
                                   valid, scale=None):
    """Same contract as `paged_prefill_attention_ref` (valid rows).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (hd in
    {64, 128, 256}, float32 or bfloat16, any page size and T) or raise.
    `paged_prefill_attention_kernel.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pages, v_pages, page_table,
                                           q_offset, valid, scale)
    q, k_pages, v_pages, page_table, q_offset, valid = _check_card(
        "paged_prefill_attention_kernel", q, k_pages, v_pages, page_table,
        q_offset, valid)
    B, T, H, hd = q.shape
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _cuda.entry("paged_attention", "paged_prefill_attention")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), q_offset.data_ptr(), valid.data_ptr(),
             out.data_ptr(), B, T, H, k_pages.shape[2], hd, k_pages.shape[1],
             page_table.shape[1], float(s), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "paged_prefill_attention")
    paged_prefill_attention_kernel.launches += 1
    return out


paged_prefill_attention_kernel.launches = 0


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                        scale=None):
    """q [B, H, hd]; k/v_pages [P, page, KVH, hd]; page_table
    [B, max_pages] int; lengths [B] int (keys at positions < lengths[b]).
    Returns [B, H, hd]."""
    B, H, hd = q.shape
    page, KVH = k_pages.shape[1], k_pages.shape[2]
    G = H // KVH
    S = page_table.shape[1] * page
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    tbl = page_table.long()
    k = k_pages[tbl].reshape(B, S, KVH, hd)
    v = v_pages[tbl].reshape(B, S, KVH, hd)
    qg = q.reshape(B, KVH, G, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * s
    mask = torch.arange(S, device=q.device)[None] < lengths.long()[:, None]
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v)
    return out.reshape(B, H, hd)


def paged_attention_kernel(q, k_pages, v_pages, page_table, lengths,
                           scale=None):
    """Same contract as `paged_attention_ref` for lengths >= 1 (0 gives 0,
    as the TPU kernel does).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (hd in {64, 128, 256}, float32 or bfloat16,
    any page size and G) or raise.  `paged_attention_kernel.launches`
    counts kernel launches."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   scale)
    if q.dim() != 3:
        raise ValueError(f"paged_attention_kernel: q must be [B, H, hd], got "
                         f"{tuple(q.shape)}")
    q, k_pages, v_pages, page_table, lengths = _check_card(
        "paged_attention_kernel", q, k_pages, v_pages, page_table, lengths)
    B, H, hd = q.shape
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _cuda.entry("paged_decode", "paged_decode_attention")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), B, H,
             k_pages.shape[2], hd, k_pages.shape[1], page_table.shape[1],
             float(s), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "paged_decode_attention")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0


def _single_chip_fp(mesh, kv_scales):
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel paged attention (mesh=) arrives with a later "
            "slice (ROADMAP Queue 1: tensor-parallel serving)")
    if kv_scales is not None:
        raise NotImplementedError(
            "int8 KV pools (kv_scales=) arrive with a later slice (ROADMAP "
            "Queue 1: int8 weights and KV)")


def _kernel_takes(q):
    """Whether the paged kernels take q's head dim."""
    return q.shape[-1] in (64, 128, 256)


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_offset, valid,
                            scale=None, mesh=None, kv_scales=None):
    """Chunked-prefill entry (reference `paged_prefill_attention`)."""
    _single_chip_fp(mesh, kv_scales)
    if q.device.type != "cpu" and not _kernel_takes(q):
        paged_prefill_attention.composed_calls += 1
        return paged_prefill_attention_ref(q, k_pages, v_pages, page_table,
                                           q_offset, valid, scale=scale)
    return paged_prefill_attention_kernel(q, k_pages, v_pages, page_table,
                                          q_offset, valid, scale=scale)


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
    lengths[b] cached positions."""
    _single_chip_fp(mesh, kv_scales)
    if q.device.type != "cpu" and not _kernel_takes(q):
        paged_attention_decode.composed_calls += 1
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths,
                                   scale=scale)
    return paged_attention_kernel(q, k_pages, v_pages, page_table, lengths,
                                  scale=scale)


paged_attention_decode.composed_calls = 0
