"""Fused softmax-mask ops and CSR sparse attention — port of
`paddle_tpu/nn/functional/sparse_ops.py` (reference
`incubate/softmax_mask_fuse*`, `sparse_attention`).

The softmaxes of the two mask fusions run in float32 and cast back;
`sparse_attention` makes the CSR pattern a dense [B, H, T, T] mask, scores
outside it -1e30, and zeroes their weights after the softmax, so a row
with no entries gives 0.
"""
from __future__ import annotations

import math

import torch

from ...core.tensor import apply


def softmax_mask_fuse(x, mask, name=None):
    return apply("softmax_mask_fuse",
                 lambda a, m: torch.softmax(a.float() + m.float(), dim=-1)
                 .to(a.dtype), x, mask)


def softmax_mask_fuse_upper_triangle(x):
    def f(a):
        L = a.shape[-1]
        keep = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
        scores = torch.where(keep, a.float(), -1e30)
        return torch.softmax(scores, dim=-1).to(a.dtype)
    return apply("softmax_mask_fuse_upper_triangle", f, x)


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """Attention restricted to a CSR pattern (offsets [B, H, T + 1],
    columns [B, H, nnz]) over [B, H, T, D] inputs."""
    def f(q, k, v, off, cols):
        B, H, T, D = q.shape
        scores = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(D)
        # nnz j belongs to row r iff off[r] <= j < off[r + 1]
        nnz = cols.shape[-1]
        j = torch.arange(nnz, device=q.device)
        r = (j[..., None, :] >= off[..., 1:, None]).sum(-2)      # [B, H, nnz]
        mask = torch.zeros((B, H, T + 1, T), dtype=torch.bool,
                           device=q.device)
        bi = torch.arange(B, device=q.device)[:, None, None]
        hi = torch.arange(H, device=q.device)[None, :, None]
        mask[bi, hi, torch.clamp(r, max=T), cols.long()] = True
        mask = mask[:, :, :T]
        scores = torch.where(mask, scores, -1e30)
        w = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
        return torch.einsum("bhts,bhsd->bhtd", w, v)
    return apply("sparse_attention", f, query, key, value, sparse_csr_offset,
                 sparse_csr_columns)
