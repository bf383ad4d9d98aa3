"""Triton RMSNorm kernel, imported only by `rms_norm.rms_norm_fused` when it
is handed a CUDA tensor (this module imports triton, which only the GPU
machine has).

Replaces the TPU kernel paddle_tpu/incubate/kernels/rms_norm.py::_rms_kernel
(launched by _rms_fwd_impl).  One program per row: load the row once,
reduce sum(x^2) in f32, cast the normalized row to x's dtype, multiply by w,
store once.

Bound on the H100: bytes.  It does ~4 flops per element against 4 bytes
moved per bf16 element (read x, write out), far below the card's
~295 flops/byte ridge, so the floor is (2*N*D + D) * itemsize / 3.35 TB/s.
The design reads x exactly once (the whole row sits in registers:
BLOCK = next power of two >= D) and never writes the f32 intermediate.
"""
from __future__ import annotations

import torch
import triton
import triton.language as tl


@triton.jit
def _rms_kernel(x_ptr, w_ptr, o_ptr, D, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK)
    mask = cols < D
    x = tl.load(x_ptr + row * D + cols, mask=mask, other=0.0)
    x32 = x.to(tl.float32)
    var = tl.sum(x32 * x32, axis=0) / D
    y = (x32 * tl.rsqrt(var + eps)).to(x_ptr.dtype.element_ty)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    out = y.to(tl.float32) * w.to(tl.float32)
    tl.store(o_ptr + row * D + cols, out.to(o_ptr.dtype.element_ty),
             mask=mask)


def rms_norm_rows(x2d: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                  eps: float) -> None:
    """out[n] = cast(x[n] * rsqrt(mean(x[n]^2) + eps)) * w, for contiguous
    [N, D] x/out on the card (launches on the current stream)."""
    N, D = x2d.shape
    BLOCK = triton.next_power_of_2(D)
    num_warps = min(16, max(1, BLOCK // 256))
    _rms_kernel[(N,)](x2d, w, out, D, eps, BLOCK=BLOCK, num_warps=num_warps)
