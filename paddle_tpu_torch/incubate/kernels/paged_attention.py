"""Paged attention for the fused serving step — port of the fp, `mp=1` part
of `paddle_tpu/incubate/kernels/paged_attention.py`.

The pool layout is the reference's: one layer's pages `[P, page, KVH, hd]`
with page 0 as the null page, a page table `[B, max_pages]` int32, and per
slot `q_offset`/`valid` `[B]` int32.  Query t of slot b sits at position
`q_offset[b] + t` and sees kv positions `<= q_offset[b] + t`; rows
`t >= valid[b]` are padding whose output the caller ignores.

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


def paged_prefill_attention_kernel(q, k_pages, v_pages, page_table, q_offset,
                                   valid, scale=None):
    """Same contract as `paged_prefill_attention_ref` (valid rows).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (hd in
    {64, 128, 256}, float32 or bfloat16, any page size and T) or raise.
    `paged_prefill_attention_kernel.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pages, v_pages, page_table,
                                           q_offset, valid, scale)
    B, T, H, hd = q.shape
    P, page, KVH, _ = k_pages.shape
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (
            k_pages, v_pages, page_table, q_offset, valid)):
        raise ValueError("paged_prefill_attention_kernel: every tensor must "
                         "lie on q's CUDA device")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise TypeError(f"paged attention takes float32/bfloat16 q and pool "
                        f"of one dtype, got {q.dtype}/{k_pages.dtype}")
    if hd not in (64, 128, 256) or H % KVH or \
            k_pages.shape != (P, page, KVH, hd) or \
            v_pages.shape != k_pages.shape:
        raise ValueError(f"paged attention: unsupported shapes q "
                         f"{tuple(q.shape)} pool {tuple(k_pages.shape)}")
    if page_table.dtype != torch.int32 or q_offset.dtype != torch.int32 or \
            valid.dtype != torch.int32 or page_table.shape[0] != B or \
            q_offset.shape != (B,) or valid.shape != (B,):
        raise ValueError("paged attention: page_table [B, max_pages], "
                         "q_offset [B] and valid [B] must be int32")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    page_table = page_table.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged attention needs 16-byte aligned tensors")
    s = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _cuda.entry("paged_attention", "paged_prefill_attention")
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             page_table.data_ptr(), q_offset.contiguous().data_ptr(),
             valid.contiguous().data_ptr(), out.data_ptr(), B, T, H, KVH, hd,
             page, page_table.shape[1], float(s), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "paged_prefill_attention")
    paged_prefill_attention_kernel.launches += 1
    return out


paged_prefill_attention_kernel.launches = 0


def _single_chip_fp(mesh, kv_scales):
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel paged attention (mesh=) arrives with a later "
            "slice (ROADMAP Queue 1: tensor-parallel serving)")
    if kv_scales is not None:
        raise NotImplementedError(
            "int8 KV pools (kv_scales=) arrive with a later slice (ROADMAP "
            "Queue 1: int8 weights and KV)")


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_offset, valid,
                            scale=None, mesh=None, kv_scales=None):
    """Chunked-prefill entry (reference `paged_prefill_attention`)."""
    _single_chip_fp(mesh, kv_scales)
    return paged_prefill_attention_kernel(q, k_pages, v_pages, page_table,
                                          q_offset, valid, scale=scale)


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
