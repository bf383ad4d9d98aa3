"""Common functionals: linear, dropout, interpolate, one_hot, pad ... —
port of `paddle_tpu/nn/functional/common.py` (reference
`python/paddle/nn/functional/common.py`).

Dropout draws its keep mask from the port's generator for the input's
device (`uniform < 1 - p`, as `jax.random.bernoulli` keeps).
`interpolate` is the reference's `jax.image.resize`, written out: "nearest"
takes input index floor((i + 0.5) * in / out) (half-pixel centres, not
torch's floor(i * in / out)); "linear"/"cubic" are a weight matrix a
resized axis (triangle kernel, or Keys' cubic with a = -0.5 where torch's
bicubic takes -0.75), widened by in / out when downsampling (antialiased),
columns normalised, zero where the sample falls outside the input; "area"
is "linear"; `align_corners` takes the reference's own per-axis linear map.
`unfold`/`fold` keep `conv_general_dilated_patches`' (c, kh, kw) order,
which is torch's `F.unfold`/`F.fold` order too.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as _F

from ...core import generator as _gen
from ...core.tensor import Tensor, apply
from ...ops._common import data as _to_data
from ...ops.manipulation import pad as _pad_op


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W stored [in, out]."""
    if bias is None:
        return apply("linear", torch.matmul, x, weight)
    return apply("linear", lambda a, w, b: torch.matmul(a, w) + b, x, weight,
                 bias)


def _keep(shape, device, p):
    """A boolean keep mask of `shape`: uniform draws < 1 - p."""
    g = _gen.default_generator().torch_generator(device)
    return torch.rand(shape, generator=g, device=device) < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return apply("dropout_scale", lambda a: a * (1.0 - p), x)
        return x
    if isinstance(p, Tensor):
        p = float(p.item())

    def f(a):
        shape = list(a.shape)
        if axis is not None:
            axes = [axis] if isinstance(axis, int) else list(axis)
            shape = [s if i in axes else 1 for i, s in enumerate(shape)]
        keep = _keep(shape, a.device, p)
        if mode == "upscale_in_train":
            return torch.where(keep, a / (1.0 - p), 0.0).to(a.dtype)
        return torch.where(keep, a, 0.0).to(a.dtype)
    return apply("dropout", f, x)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    if not training or p == 0.0:
        return x

    def f(a):
        alpha = 1.6732632423543772
        scale = 1.0507009873554805
        alpha_p = -alpha * scale
        keep = _keep(a.shape, a.device, p)
        a_scale = float(np.float32(1.0 / np.sqrt(
            (1 - p) * (1 + p * alpha_p ** 2))))
        b = -a_scale * alpha_p * p
        return (torch.where(keep, a, alpha_p) * a_scale + b).to(a.dtype)
    return apply("alpha_dropout", f, x)


def _one_hot(ids, n, dtype=torch.float32):
    """`jax.nn.one_hot`: a row of zeros for an index outside [0, n)."""
    return (ids.long()[..., None] == torch.arange(n, device=ids.device)) \
        .to(dtype)


def one_hot(x, num_classes, name=None):
    return apply("one_hot", lambda a: _one_hot(a, num_classes), x)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    def f(lab, *rest):
        if rest:
            return (1 - epsilon) * lab + epsilon * rest[0]
        return (1 - epsilon) * lab + epsilon / lab.shape[-1]
    args = (label,) if prior_dist is None else (label, prior_dist)
    return apply("label_smooth", f, *args)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def f(a, b):
        dot = torch.sum(a * b, dim=axis)
        na = torch.sqrt(torch.sum(a * a, dim=axis))
        nb = torch.sqrt(torch.sum(b * b, dim=axis))
        return dot / torch.clamp(na * nb, min=eps)
    return apply("cosine_similarity", f, x1, x2)


def bilinear(x1, x2, weight, bias=None, name=None):
    def f(a, b, w, *rest):
        out = torch.einsum("bm,omn,bn->bo", a, w, b)
        return out + rest[0] if rest else out
    args = (x1, x2, weight) + ((bias,) if bias is not None else ())
    return apply("bilinear", f, *args)


pad = _pad_op


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return _pad_op(x, padding, mode="constant", value=0.0,
                   data_format=data_format)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize NC... or N...C data by the reference's `jax.image.resize`
    semantics (module docstring)."""
    shape_in = tuple(_to_data(x).shape)
    channel_last = data_format in ("NHWC", "NDHWC", "NLC")
    spatial = len(shape_in) - 2
    if size is not None:
        if isinstance(size, Tensor):
            size = [int(v) for v in size.numpy().reshape(-1)]
        out_sp = [int(v.item()) if isinstance(v, Tensor) else int(v) for v in
                  (size if isinstance(size, (list, tuple))
                   else [size] * spatial)]
    else:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * spatial
        in_sp = shape_in[1:-1] if channel_last else shape_in[2:]
        out_sp = [int(s * f) for s, f in zip(in_sp, scale_factor)]
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]

    def f(a):
        if channel_last:
            shape = (a.shape[0],) + tuple(out_sp) + (a.shape[-1],)
        else:
            shape = tuple(a.shape[:2]) + tuple(out_sp)
        if method == "nearest":
            return _resize_nearest(a, shape)
        if align_corners:
            return _resize_align_corners(a, shape, channel_last)
        return _resize(a, shape, method)
    return apply("interpolate", f, x)


def _resize_nearest(a, shape):
    for d, (m, n) in enumerate(zip(a.shape, shape)):
        if m != n:
            pos = (torch.arange(n, dtype=torch.float32, device=a.device)
                   + 0.5) * m / n
            a = torch.index_select(a, d, torch.floor(pos).long())
    return a


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _weight_mat(m, n, kernel, device):
    """[m, n] weights of `jax.image.compute_weight_mat` (scale n / m, no
    translation, antialias on), in float32."""
    inv = 1.0 / (n / m)
    kernel_scale = max(inv, 1.0)
    sample = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) \
        * inv - 0.5
    src = torch.arange(m, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize(a, shape, method):
    if not (a.is_floating_point() or a.is_complex()):
        a = a.float()
    kernel = _triangle if method == "linear" else _keys_cubic
    for d, (m, n) in enumerate(zip(a.shape, shape)):
        if m != n:
            w = _weight_mat(m, n, kernel, a.device).to(a.dtype)
            a = torch.movedim(torch.tensordot(a, w, dims=([d], [0])), -1, d)
    return a


def _resize_align_corners(a, shape, channel_last):
    nd = a.ndim
    axes = range(1, nd - 1) if channel_last else range(2, nd)
    out = a
    for ax in axes:
        n_in, n_out = out.shape[ax], shape[ax]
        if n_in == n_out:
            continue
        if n_out == 1:
            lo = hi = torch.zeros(1, dtype=torch.long, device=a.device)
            w = torch.zeros(1, dtype=out.dtype, device=a.device)
        else:
            pos = torch.arange(n_out, dtype=torch.float32, device=a.device) \
                * (n_in - 1) / (n_out - 1)
            lo = torch.floor(pos).long()
            hi = torch.clamp(lo + 1, max=n_in - 1)
            w = (pos - lo).to(out.dtype)
        bshape = [1] * out.ndim
        bshape[ax] = n_out
        w = w.reshape(bshape)
        out = torch.index_select(out, ax, lo) * (1 - w) + \
            torch.index_select(out, ax, hi) * w
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode,
                       data_format)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C*kh*kw, L], (c, kh, kw) order; a 4-list of paddings
    pads (paddings[0], paddings[1]) on both sides, as the reference does."""
    ph, pw = _pair(paddings) if not (isinstance(paddings, (list, tuple))
                                     and len(paddings) == 4) \
        else (paddings[0], paddings[1])
    return apply("unfold", lambda a: _F.unfold(
        a, _pair(kernel_sizes), dilation=_pair(dilations), padding=(ph, pw),
        stride=_pair(strides)), x)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    return apply("fold", lambda a: _F.fold(
        a, _pair(output_sizes), _pair(kernel_sizes),
        dilation=_pair(dilations), padding=_pair(paddings),
        stride=_pair(strides)), x)
