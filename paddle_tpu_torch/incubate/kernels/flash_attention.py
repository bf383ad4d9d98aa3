"""Dense attention — port of `paddle_tpu/incubate/kernels/flash_attention.py`
(forward only: the backward and varlen kernels belong to later slices).

- `attention_ref`: the plain PyTorch version, counterpart of `attention_xla`.
- `flash_attention_fwd`: `(out, lse)` through the hand-written CUDA kernel
  `csrc/flash_attention.cu` (the port of `_flash_fwd_kernel`) on a CUDA
  tensor, or its plain version on a CPU tensor.
- `flash_attention_fused`: the entry the model calls.
"""
from __future__ import annotations

import math

import torch

from . import _cuda

NEG_INF = -1e30


def _scores(q, k, causal, scale):
    """f32 scores [B, H, Sq, Sk]; causal keeps row + (Sk - Sq) >= col."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        row = torch.arange(Lq, device=q.device)[:, None]
        col = torch.arange(Lk, device=q.device)[None, :]
        logits = torch.where(row + (Lk - Lq) >= col, logits, NEG_INF)
    return logits


def attention_ref(q, k, v, mask=None, causal=False, scale=None, dropout_p=0.0,
                  generator=None):
    """q,k,v: [B, S, H, D].  Scores and softmax in f32; the probabilities
    enter the PV product in v's dtype (as `attention_xla` does)."""
    D = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = _scores(q, k, causal, s)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, NEG_INF)
        else:
            logits = logits + mask.float()
    p = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and generator is not None:
        keep = torch.rand(p.shape, generator=generator,
                          device=p.device) < 1.0 - dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _flash_fwd_ref(q, k, v, causal, scale):
    """Plain version of the kernel: (out [B,S,H,D], lse [B*H, S, 1] f32)."""
    B, S, H, _ = q.shape
    logits = _scores(q, k, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)                      # [B, H, S]
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out, lse.reshape(B * H, S, 1)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd(q, k, v, causal, scale):
    """[B,S,H,D] -> (out [B,S,H,D], lse [B*H, S, 1] f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (D in {64, 128, 256}, float32 or bfloat16, causal needs S == Sk) or
    raise.  `flash_attention_fwd.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return _flash_fwd_ref(q, k, v, causal, scale)
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError("flash_attention_fwd: q, k, v must share one CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes float32/bfloat16 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in (64, 128, 256) or k.shape != (B, Sk, H, D) or \
            v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd: unsupported shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}")
    if causal and Sk != S:
        raise ValueError(f"causal flash attention needs S == Sk, got {S} "
                         f"and {Sk}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd needs 16-byte aligned tensors")
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S, 1), dtype=torch.float32, device=q.device)
    fn = _cuda.entry("flash_attention", "flash_attention_fwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, S, Sk, H, D, int(bool(causal)), float(scale),
             _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device)
             .cuda_stream)
    _cuda.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_fused(q, k, v, mask=None, causal=False, scale=None,
                          dropout_p=0.0, generator=None):
    """Entry used by the model.  q,k,v: [B, S, H, D].  On the card a mask or
    dropout is not on the serving path and raises; the CPU keeps the plain
    `attention_ref` for them."""
    D = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    if mask is None and dropout_p == 0.0:
        return flash_attention_fwd(q, k, v, causal, s)[0]
    if q.device.type != "cpu":
        raise NotImplementedError(
            "flash_attention_fused with mask/dropout on the card arrives "
            "with a later slice (ROADMAP Queue 1: training path)")
    return attention_ref(q, k, v, mask=mask, causal=causal, scale=s,
                         dropout_p=dropout_p, generator=generator)
