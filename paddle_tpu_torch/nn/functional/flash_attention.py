"""Flash attention API — port of
`paddle_tpu/nn/functional/flash_attention.py` (reference
`python/paddle/nn/functional/flash_attention.py`).

Layout [batch, seqlen, nheads, headdim] as in the reference.  The functions
take torch tensors (the Paddle `Tensor` wrapper is a later slice) and
return `(out, None)`.

- `flash_attention`: with `segment_ids` and no dropout, the segment-masked
  kernels (`flash_attention_varlen`); with `segment_ids` and dropout, the
  masked-dropout lane, plain attention under the segment mask, which
  raises on the card as `flash_attention_fused`'s mask and dropout lanes
  do; otherwise the dense flash kernels through `flash_attention_fused`.
- `flash_attn_unpadded`: packed `[total, H, D]` sequences given by
  cumulative offsets.  Routed as the reference routes it: the segment
  kernels over `[1, total, H, D]` (no padding: the CUDA kernels mask ragged
  tiles) where D is 64, 128 or 256, dropout is 0 and either the q and k
  layouts are equal or attention is not causal; elsewhere the reference's
  composed route, per-sequence local causality in plain torch, counted in
  `flash_attn_unpadded.composed_calls`.  Like the reference's, that route
  ignores `dropout`.
"""
from __future__ import annotations

import torch

from ...incubate.kernels.flash_attention import (flash_attention_fused,
                                                 flash_attention_varlen)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None, rng_name="",
                    training=True, segment_ids=None, name=None):
    """segment_ids [B, S]: when given, tokens attend only within their own
    segment.  Dropout draws from torch's default generator (on the CPU; the
    card raises on it)."""
    p = dropout if training else 0.0
    if segment_ids is not None:
        if dropout == 0.0:
            return flash_attention_varlen(query, key, value, segment_ids,
                                          causal=causal), None
        seg = torch.as_tensor(segment_ids, device=query.device)
        mask = seg[:, None, :, None] == seg[:, None, None, :]
        return flash_attention_fused(query, key, value, mask=mask,
                                     causal=causal, dropout_p=p,
                                     generator=torch.default_generator), None
    return flash_attention_fused(query, key, value, causal=causal,
                                 dropout_p=p,
                                 generator=torch.default_generator), None


def _segment_ids(cu, total):
    """Segment id of each packed token from cumulative offsets cu [n + 1]."""
    return torch.searchsorted(cu[1:], torch.arange(total, device=cu.device),
                              right=True)


def _unpadded_composed(q, k, v, cu_q, cu_k, causal, scale):
    """The reference's composed route: [total, H, D] attention in f32 under
    segment equality and, when causal, each sequence's LOCAL causality."""
    seg_q = _segment_ids(cu_q, q.shape[0])
    seg_k = _segment_ids(cu_k, k.shape[0])
    scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(q.shape[0], device=q.device) - cu_q[seg_q]
        pos_k = torch.arange(k.shape[0], device=k.device) - cu_k[seg_k]
        mask = mask & (pos_q[:, None] >= pos_k[None, :])
    scores = torch.where(mask[None], scores, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("hqk,khd->qhd", p, v.float()).to(q.dtype)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Varlen attention over packed [total, H, D] tokens with cumulative
    sequence offsets cu_seqlens_q/k [n + 1]."""
    cu_q = torch.as_tensor(cu_seqlens_q).long()
    cu_k = torch.as_tensor(cu_seqlens_k).long()
    # the kernels mask causality in packed-global coordinates, which equals
    # per-sequence local causality only when q and k share one layout
    # (compared on the host, as the reference does)
    same_layout = cu_q.shape == cu_k.shape and \
        bool(torch.equal(cu_q.cpu(), cu_k.cpu()))
    cu_q, cu_k = cu_q.to(query.device), cu_k.to(query.device)
    use_kernel = query.shape[-1] in (64, 128, 256) and dropout == 0.0 and \
        (same_layout or not causal)
    if not use_kernel:
        flash_attn_unpadded.composed_calls += 1
        return _unpadded_composed(query, key, value, cu_q, cu_k, causal,
                                  scale), None
    seg_q = _segment_ids(cu_q, query.shape[0])
    seg_k = _segment_ids(cu_k, key.shape[0])
    out = flash_attention_varlen(query[None], key[None], value[None],
                                 seg_q[None], seg_k[None], causal=causal,
                                 scale=scale)
    return out[0], None


flash_attn_unpadded.composed_calls = 0
