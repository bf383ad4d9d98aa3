"""Rotary position embedding — port of `paddle_tpu/incubate/kernels/rope.py`.

Plain torch: elementwise muls/adds computed in f32 and cast back, as the
reference does; no dedicated kernel (the reference has none either).
"""
from __future__ import annotations

import torch


def apply_rope(x, sin, cos, neox_style=True):
    """x: [B, S, H, D]; sin/cos: [S, D/2] (or [B, S, D/2] per-slot)."""
    D = x.shape[-1]
    half = D // 2
    if sin.ndim == 2:
        sin_b = sin[None, :, None, :]
        cos_b = cos[None, :, None, :]
    else:
        sin_b = sin[:, :, None, :]
        cos_b = cos[:, :, None, :]
    x32 = x.float()
    if neox_style:
        x1 = x32[..., :half]
        x2 = x32[..., half:]
        out = torch.cat([x1 * cos_b - x2 * sin_b, x2 * cos_b + x1 * sin_b],
                        dim=-1)
    else:
        x1 = x32[..., 0::2]
        x2 = x32[..., 1::2]
        out = torch.stack([x1 * cos_b - x2 * sin_b, x2 * cos_b + x1 * sin_b],
                          dim=-1).reshape(x.shape)
    return out.to(x.dtype)
