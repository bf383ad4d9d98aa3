"""RMSNorm — port of `paddle_tpu/incubate/kernels/rms_norm.py`.

`rms_norm_fused` launches the CUDA kernel `csrc/rms_norm.cu` (the port of
the TPU kernel `_rms_kernel`) on a CUDA tensor and runs the plain `_rms_ref`
on a CPU tensor.  The f32 normalized row is cast to x's dtype BEFORE the
multiply by w, as `_rms_kernel` and `_rms_ref` do; the product is in
`promote_types(x, w)`.  Where a gradient is wanted (grad mode on and x or w
requiring grad) it goes through `RMSNorm`, whose backward is the vjp of
`_rms_ref` in plain PyTorch, as the reference's `_rms_bwd` is the vjp of its
jnp version (the reference has no backward kernel); otherwise, as when
serving, the forward runs directly, with no autograd node.

The launch path is kept short, since at the serving step's [8, 4096] the
kernel runs a few microseconds and the host's work is most of the cost: the
C entry is fetched once, the launch shape (`_rms_launch`) is cached by
width and dtype, and a contiguous x is not copied.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _cuda


def _rms_ref(x, w, eps):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


# (x dtype, w dtype) -> (x code, w code, out dtype) of the C entry
_DTYPES = {
    (torch.float32, torch.float32): (0, 0, torch.float32),
    (torch.bfloat16, torch.bfloat16): (1, 1, torch.bfloat16),
    (torch.bfloat16, torch.float32): (1, 0, torch.float32),
    (torch.float32, torch.bfloat16): (0, 1, torch.float32),
}
RMS_NARROW = (32, 8)    # D <= 1024: threads a row, rows a block
RMS_WIDE = (256, 1)     # D > 1024 (tuned on the card, PERF.md)
RMS_STAGES = 2          # rows of x in flight a ring block (PERF.md)
MAX_PIECES = 8          # pieces a thread holds in registers (NV)
MAX_STAGES = 8          # the ring kernel's kMaxStages
RING_BYTES = 200 << 10  # shared memory a ring block may take


class RmsLaunch(NamedTuple):
    """The launch of `csrc/rms_norm.cu`.  stages > 0: the ring kernel, one
    row a block of `threads` threads, `stages` rows of x in flight in
    shared memory (bulk copies), pieces of 16 bytes.  stages 0: the
    register kernel; a thread owns pieces of `vec` elements (16 bytes of x,
    or 1 element where D is not a multiple or a pointer is not 16-byte
    aligned), holds `nv` of them in registers (0: the row is read twice),
    and a block has `rows` rows of `threads` threads each.  The kernel
    sizes its grid to what the card holds."""
    vec: int
    nv: int
    threads: int
    rows: int
    stages: int


def _max_threads(elems):
    """Threads a block of the register kernel may have when each holds
    `elems` elements of w, of x and of the next row's x in registers: its
    launch bounds (`max_threads`)."""
    return 1024 if elems <= 4 else 512 if elems <= 16 else 256


def _padded(nbytes):
    return -(-nbytes // 128) * 128


@functools.lru_cache(maxsize=64)
def _rms_launch(D, itemsize, w_itemsize, aligned=True, narrow=RMS_NARROW,
                wide=RMS_WIDE, stages=RMS_STAGES):
    """The launch shape for rows of D elements of `itemsize` bytes (w's of
    `w_itemsize`).  Wide rows (D > 1024) of 16-byte pieces, with w in
    16-byte multiples, take the ring kernel with as many stages (up to
    `stages`) as fit RING_BYTES beside w, if at least 2 do.  Otherwise,
    narrow rows take one warp a row and several rows a block, wide rows one
    row a block; threads a row double until each thread holds at most
    MAX_PIECES pieces, then halve while they pass the launch bounds for the
    pieces they hold; a row that fits no such shape is read twice (nv 0,
    1024 threads).  Rows a block shrink to the bounds."""
    vec = 16 // itemsize
    if not aligned or D % vec:
        vec = 1
    if D > 1024 and vec > 1 and D * w_itemsize % 16 == 0:
        fit = (RING_BYTES - _padded(D * w_itemsize)) // _padded(D * itemsize)
        fit = min(stages, MAX_STAGES, fit)
        if fit >= 2:
            return RmsLaunch(vec, 0, max(64, wide[0]), 1, fit)
    pieces = D // vec
    threads, rows = narrow if D <= 1024 else wide

    def depth(t):           # pieces a thread holds, rounded up to 1/2/4/8
        need = -(-pieces // t)
        return next((n for n in (1, 2, 4, 8) if n >= need), 0)

    while depth(threads) == 0 and threads < 1024:
        threads *= 2
    while depth(threads) and threads > _max_threads(depth(threads) * vec):
        threads //= 2
    nv = depth(threads)
    if nv == 0:
        threads = 1024
    cap = _max_threads(nv * vec)
    return RmsLaunch(vec, nv, threads, max(1, min(rows, cap // threads)), 0)


@functools.cache
def _entry():
    return _cuda.entry("rms_norm", "rms_norm")


def _rms_fwd(x, w, eps):
    """The forward: the plain version on the CPU, the CUDA kernel on the
    card (counted on `rms_norm_fused.launches`)."""
    if x.device.type == "cpu":
        return _rms_ref(x, w, eps)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rms_norm_fused: x on {x.device}, w on {w.device}")
    codes = _DTYPES.get((x.dtype, w.dtype))
    if codes is None:
        raise TypeError(f"rms_norm_fused takes float32/bfloat16, got "
                        f"{x.dtype}/{w.dtype}")
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w {tuple(w.shape)} does not match D={D}")
    if not x.is_contiguous():
        x = x.contiguous()
    if not w.is_contiguous():
        w = w.contiguous()
    out = torch.empty(x.shape, dtype=codes[2], device=x.device)
    N = x.numel() // D if D else 0
    if N == 0:
        return out
    xp, wp = x.data_ptr(), w.data_ptr()
    plan = _rms_launch(D, x.element_size(), w.element_size(),
                       (xp | wp) % 16 == 0, RMS_NARROW, RMS_WIDE, RMS_STAGES)
    err = _entry()(xp, wp, out.data_ptr(), N, D, plan.vec, plan.nv,
                   plan.threads, plan.rows, plan.stages, eps, codes[0],
                   codes[1],
                   torch._C._cuda_getCurrentRawStream(x.get_device()))
    if err:
        _cuda.check(err, f"rms_norm {plan} at [{N}, {D}] {x.dtype}/{w.dtype}")
    rms_norm_fused.launches += 1
    return out


class RMSNorm(torch.autograd.Function):
    """`_rms_fwd` forward; backward is autograd's vjp of `_rms_ref`."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _rms_fwd(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            dx, dw = torch.autograd.grad(_rms_ref(x, w, ctx.eps), (x, w), g)
        return dx, dw, None


def rms_norm_fused(x, w, eps=1e-6):
    """x: [..., D]; w: [D].  Differentiable: through `RMSNorm` where grad
    mode is on and x or w requires grad, the forward alone otherwise.
    `rms_norm_fused.launches` counts kernel launches."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    return _rms_fwd(x, w, eps)


rms_norm_fused.launches = 0
