"""RMSNorm — port of `paddle_tpu/incubate/kernels/rms_norm.py`.

`rms_norm_fused` launches the Triton kernel in `_rms_norm_triton.py` (the
port of the TPU kernel `_rms_kernel`) on a CUDA tensor and runs the plain
`_rms_ref` on a CPU tensor.  The f32 normalized row is cast to x's dtype
BEFORE the multiply by w, as `_rms_kernel` and `_rms_ref` do.
"""
from __future__ import annotations

import torch


def _rms_ref(x, w, eps):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def rms_norm_fused(x, w, eps=1e-6):
    """x: [..., D]; w: [D].  `rms_norm_fused.launches` counts kernel
    launches."""
    if x.device.type == "cpu":
        return _rms_ref(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rms_norm_fused: x on {x.device}, w on {w.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rms_norm_fused takes float32/bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    from ._rms_norm_triton import rms_norm_rows   # imports triton
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w {tuple(w.shape)} does not match D={D}")
    x2d = x.reshape(-1, D).contiguous()
    out = torch.empty(x2d.shape, dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    rms_norm_rows(x2d, w.contiguous(), out, eps)
    rms_norm_fused.launches += 1
    return out.reshape(*x.shape[:-1], D)


rms_norm_fused.launches = 0
