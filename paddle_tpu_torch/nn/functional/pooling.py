"""Pooling functionals — port of `paddle_tpu/nn/functional/pooling.py`
(reference `python/paddle/nn/functional/pooling.py`).

The reference is `lax.reduce_window` over an explicitly padded window,
which differs from torch's own pools in ways the port keeps: the padding
is put on with `F.pad` first and the window then reduced unpadded.

- ceil_mode widens the high padding to what the last window needs
  (torch drops a last window that starts in the padding), and a padding
  wider than half the kernel is taken (torch refuses it);
- max pooling pads with -inf (`iinfo.min` for integers); average pooling
  sums in float32 and casts back, dividing by prod(k) with
  `exclusive=False` (over ceil_mode's added padding too), by the count of
  real elements otherwise, and always by the count under a string
  padding; `divisor_override` divides the sum;
- `return_mask` is 2-D only: the flat index `row * W + col` of each
  window's first maximum over the input padded with -inf on both sides
  by the low padding (ceil_mode and string padding aside), where a window
  that holds a value that is not finite in any channel gives its first
  position (the reference extracts patches by a one-hot convolution, so
  -inf * 0 makes the whole window NaN); 1-D, 3-D and the adaptive max
  pools return the values twice, as the reference does;
- adaptive bins run from floor(i * in / out) to ceil((i + 1) * in / out),
  a reshape where in % out == 0;
- the unpools scatter into zeros of their output-size formulas; a
  negative index counts from the end and one out of range is dropped,
  as JAX's scatter does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as _F

from ...core.tensor import Tensor, apply
from ...ops._common import data as _to_data
from .conv import _CHANNEL_LAST, _padding, _same_pads, _torch_pad, _tup

_MAX = (None, _F.max_pool1d, _F.max_pool2d, _F.max_pool3d)


def _window_pads(pad, sizes, k, s, ceil_mode):
    """(low, high) a spatial axis: lax's "SAME"/"VALID", or the given
    pairs with ceil_mode's high side widened."""
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        return _same_pads(sizes, k, s, (1,) * len(k))
    out = []
    for (lo, hi), size, ki, si in zip(pad, sizes, k, s):
        if ceil_mode:
            n_out = -(-(size + lo + hi - ki) // si) + 1
            hi = max(hi, (n_out - 1) * si + ki - size - lo)
        out.append((lo, hi))
    return out


def _window_sum(a, k, s):
    """Unpadded window sums over the trailing len(k) axes of a float32
    NC... tensor (`avg_pool` dividing by 1; 1-D as 2-D)."""
    n = len(k)
    if n == 1:
        return _F.avg_pool2d(a[..., None, :], (1, k[0]), (1, s[0]),
                             divisor_override=1)[..., 0, :]
    pool = _F.avg_pool2d if n == 2 else _F.avg_pool3d
    return pool(a, k, s, divisor_override=1)


def _window_max(a, k, s):
    """Unpadded window maxima over the trailing len(k) axes (integers
    through strided windows, which torch's max pools do not take)."""
    n = len(k)
    if a.is_floating_point():
        return _MAX[n](a, k, s)
    for i in range(n):
        a = a.unfold(2 + i, k[i], s[i])
    return a.amax(dim=tuple(range(-n, 0)))


def _pool(x, ksize, stride, padding, n, reducer, data_format,
          ceil_mode=False, count_include_pad=True, divisor_override=None,
          name="pool"):
    k = _tup(ksize, n)
    s = _tup(stride if stride is not None else ksize, n)
    channel_last = data_format in _CHANNEL_LAST
    pad = _padding(padding, n)

    def f(a):
        if channel_last:
            a = torch.movedim(a, -1, 1)
        pads = _window_pads(pad, a.shape[2:], k, s, ceil_mode)
        flat = _torch_pad(pads)
        if reducer == "max":
            low = -math.inf if a.is_floating_point() else \
                torch.iinfo(a.dtype).min
            out = _window_max(_F.pad(a, flat, value=low), k, s)
        else:
            summed = _window_sum(_F.pad(a.float(), flat), k, s)
            if divisor_override:
                out = summed / divisor_override
            elif count_include_pad and not isinstance(pad, str):
                out = summed / float(np.prod(k))
            else:
                ones = torch.ones((1, 1) + tuple(a.shape[2:]),
                                  dtype=torch.float32, device=a.device)
                out = summed / _window_sum(_F.pad(ones, flat), k, s)
            out = out.to(a.dtype)
        return torch.movedim(out, 1, -1) if channel_last else out
    return apply(name, f, x)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    df = "NWC" if data_format == "NLC" else "NCW"
    out = _pool(x, kernel_size, stride, padding, 1, "max", df, ceil_mode,
                name="max_pool1d")
    return (out, _pool_mask(x, out, kernel_size, stride, padding, 1)) \
        if return_mask else out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 2, "max", data_format,
                ceil_mode, name="max_pool2d")
    return (out, _pool_mask(x, out, kernel_size, stride, padding, 2)) \
        if return_mask else out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 3, "max", data_format,
                ceil_mode, name="max_pool3d")
    return (out, _pool_mask(x, out, kernel_size, stride, padding, 3)) \
        if return_mask else out


@torch.no_grad()
def _pool_mask(x, out, ksize, stride, padding, n):
    """The int32 flat index of each window's maximum (module docstring);
    the values themselves for 1-D and 3-D."""
    if n != 2:
        return out
    data = _to_data(x).detach()
    kh, kw = _tup(ksize, 2)
    sh, sw = _tup(stride if stride is not None else ksize, 2)
    pad = _padding(padding, 2)
    ph, pw = (pad[0][0], pad[1][0]) if not isinstance(pad, str) else (0, 0)
    a = _F.pad(data, [pw, pw, ph, ph], value=-math.inf)
    win = a.unfold(2, kh, sh).unfold(3, kw, sw)        # [N, C, oh, ow, kh, kw]
    nb, c, oh, ow = win.shape[:4]
    win = win.reshape(nb, c, oh, ow, kh * kw)
    idx = torch.argmax(win, dim=-1)
    bad = (~torch.isfinite(win)).any(-1).any(1, keepdim=True)
    idx = torch.where(bad, 0, idx)
    rows = torch.arange(oh, device=a.device).reshape(1, 1, -1, 1) * sh - ph \
        + idx // kw
    cols = torch.arange(ow, device=a.device).reshape(1, 1, 1, -1) * sw - pw \
        + idx % kw
    return Tensor._wrap((rows * data.shape[3] + cols).to(torch.int32))


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    df = "NWC" if data_format == "NLC" else "NCW"
    return _pool(x, kernel_size, stride, padding, 1, "avg", df, ceil_mode,
                 count_include_pad=not exclusive, name="avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg", data_format,
                 ceil_mode, count_include_pad=not exclusive,
                 divisor_override=divisor_override, name="avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg", data_format,
                 ceil_mode, count_include_pad=not exclusive,
                 divisor_override=divisor_override, name="avg_pool3d")


def _adaptive(x, output_size, n, mode, data_format):
    channel_last = data_format in _CHANNEL_LAST
    osize = _tup(output_size, n)

    def f(a):
        spatial = list(range(1, 1 + n)) if channel_last \
            else list(range(2, 2 + n))
        out = a
        for i, ax in enumerate(spatial):
            out = _adaptive_1axis(out, ax, osize[i], mode)
        return out
    return apply(f"adaptive_{mode}_pool{n}d", f, x)


def _reduce(a, axis, mode, keepdim=False):
    if mode == "max":
        return torch.amax(a, dim=axis, keepdim=keepdim)
    return torch.mean(a, dim=axis, keepdim=keepdim)


def _adaptive_1axis(a, axis, out_size, mode):
    in_size = a.shape[axis]
    if in_size % out_size == 0:
        shape = list(a.shape)
        shape[axis:axis + 1] = [out_size, in_size // out_size]
        return _reduce(a.reshape(shape), axis + 1, mode)
    pieces = []
    for i in range(out_size):
        lo = int(np.floor(i * in_size / out_size))
        hi = int(np.ceil((i + 1) * in_size / out_size))
        pieces.append(_reduce(a.narrow(axis, lo, hi - lo), axis, mode,
                              keepdim=True))
    return torch.cat(pieces, dim=axis)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = _adaptive(x, output_size, 1, "max", "NCL")
    return (out, out) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive(x, output_size, 2, "max", "NCHW")
    return (out, out) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive(x, output_size, 3, "max", "NCDHW")
    return (out, out) if return_mask else out


def _unpool(a, idx, size):
    """Scatter a [N, C, ...] into zeros [N, C, size] at the flat indices
    idx (int, same shape as a): negative ones count from the end, those
    still out of range are dropped (a spare slot, sliced off)."""
    n, c = a.shape[:2]
    idx = idx.reshape(n, c, -1).long()
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    out = torch.zeros((n, c, size + 1), dtype=a.dtype, device=a.device)
    return out.scatter(2, idx, a.reshape(n, c, -1))[..., :size]


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    k = _tup(kernel_size, 2)
    s = _tup(stride if stride is not None else kernel_size, 2)

    def f(a, idx):
        n, c, h, w = a.shape
        if output_size is not None:
            oh, ow = _tup(output_size, 2)[-2:]
        else:
            p = padding if isinstance(padding, int) else 0
            oh = (h - 1) * s[0] + k[0] - 2 * p
            ow = (w - 1) * s[1] + k[1] - 2 * p
        return _unpool(a, idx, oh * ow).reshape(n, c, oh, ow)
    return apply("max_unpool2d", f, x, indices)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    k = kernel_size if isinstance(kernel_size, int) else kernel_size[0]
    s = (stride if isinstance(stride, int) else stride[0]) \
        if stride is not None else k
    p = padding if isinstance(padding, int) else padding[0]

    def f(a, idx):
        n, c, length = a.shape
        ol = output_size[-1] if output_size is not None \
            else (length - 1) * s + k - 2 * p
        return _unpool(a, idx, ol)
    return apply("max_unpool1d", f, x, indices)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    k = _tup(kernel_size, 3)
    s = _tup(stride if stride is not None else kernel_size, 3)
    p = padding if isinstance(padding, int) else 0

    def f(a, idx):
        n, c, d, h, w = a.shape
        if output_size is not None:
            od, oh, ow = _tup(output_size, 3)[-3:]
        else:
            od = (d - 1) * s[0] + k[0] - 2 * p
            oh = (h - 1) * s[1] + k[1] - 2 * p
            ow = (w - 1) * s[2] + k[2] - 2 * p
        return _unpool(a, idx, od * oh * ow).reshape(n, c, od, oh, ow)
    return apply("max_unpool3d", f, x, indices)
