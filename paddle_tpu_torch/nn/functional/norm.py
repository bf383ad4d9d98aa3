"""Normalization functionals — port of `paddle_tpu/nn/functional/norm.py`
(reference `python/paddle/nn/functional/norm.py`).

Every norm computes in float32 and casts back to the input's dtype, as the
reference does.  `batch_norm` in training moves the running statistics
outside the tape (the reference writes their `_data`): a rebind under
`no_grad` that bumps no version.  `rms_norm` is plain torch here, as the
reference's is plain jnp; the fused one is the RMSNorm kernel's entry.
"""
from __future__ import annotations

import torch

from ...core.tensor import Tensor, apply
from ...ops._common import data as _to_data


def _affine(out, rest, weight, bias, shape=None):
    it = iter(rest)
    if weight is not None:
        w = next(it)
        out = out * (w if shape is None else w.reshape(shape))
    if bias is not None:
        b = next(it)
        out = out + (b if shape is None else b.reshape(shape))
    return out


def _present(*ts):
    return tuple(t for t in ts if t is not None)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    ns = (normalized_shape,) if isinstance(normalized_shape, int) \
        else tuple(normalized_shape)
    axes = tuple(range(-len(ns), 0))

    def f(a, *rest):
        a32 = a.float()
        mean = a32.mean(axes, keepdim=True)
        var = a32.var(axes, unbiased=False, keepdim=True)
        out = ((a32 - mean) * torch.rsqrt(var + epsilon)).to(a.dtype)
        return _affine(out, rest, weight, bias)
    return apply("layer_norm", f, x, *_present(weight, bias))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """BatchNorm; in training (without `use_global_stats`) the batch
    statistics normalise and move the running buffers."""
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    use_stats = use_global_stats if use_global_stats is not None \
        else not training
    data = _to_data(x)
    ch_axis = data.ndim - 1 if channel_last else (1 if data.ndim > 1 else 0)
    red = tuple(i for i in range(data.ndim) if i != ch_axis)
    shape = [1] * data.ndim
    shape[ch_axis] = data.shape[ch_axis]

    if not use_stats:
        if isinstance(running_mean, Tensor):
            with torch.no_grad():
                d32 = data.detach().float()
                bm, bv = d32.mean(red), d32.var(red, unbiased=False)
                for buf, stat in ((running_mean, bm), (running_var, bv)):
                    buf._replace((momentum * buf._t + (1 - momentum) * stat)
                                 .to(buf._t.dtype))

        def f(a, *rest):
            a32 = a.float()
            m = a32.mean(red).reshape(shape)
            v = a32.var(red, unbiased=False).reshape(shape)
            out = ((a32 - m) * torch.rsqrt(v + epsilon)).to(a.dtype)
            return _affine(out, rest, weight, bias, shape)
        return apply("batch_norm", f, x, *_present(weight, bias))

    def g(a, m, v, *rest):
        out = (a.float() - m.float().reshape(shape)) * \
            torch.rsqrt(v.float().reshape(shape) + epsilon)
        return _affine(out.to(a.dtype), rest, weight, bias, shape)
    return apply("batch_norm", g, x, running_mean, running_var,
                 *_present(weight, bias))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    def f(a, *rest):
        red = tuple(range(2, a.ndim))
        a32 = a.float()
        m = a32.mean(red, keepdim=True)
        v = a32.var(red, unbiased=False, keepdim=True)
        out = ((a32 - m) * torch.rsqrt(v + eps)).to(a.dtype)
        shape = [1] * a.ndim
        shape[1] = a.shape[1]
        return _affine(out, rest, weight, bias, shape)
    return apply("instance_norm", f, x, *_present(weight, bias))


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    channel_last = data_format.endswith("C") and data_format != "NC"

    def f(a, *rest):
        a_cf = torch.movedim(a, -1, 1) if channel_last else a
        n, c = a_cf.shape[0], a_cf.shape[1]
        grouped = a_cf.reshape((n, num_groups, c // num_groups)
                               + tuple(a_cf.shape[2:])).float()
        red = tuple(range(2, grouped.ndim))
        m = grouped.mean(red, keepdim=True)
        v = grouped.var(red, unbiased=False, keepdim=True)
        out = ((grouped - m) * torch.rsqrt(v + epsilon)) \
            .reshape(a_cf.shape).to(a.dtype)
        shape = [1] * a_cf.ndim
        shape[1] = c
        out = _affine(out, rest, weight, bias, shape)
        return torch.movedim(out, 1, -1) if channel_last else out
    return apply("group_norm", f, x, *_present(weight, bias))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def f(a):
        if p == 2:
            nrm = torch.sqrt(torch.sum(a * a, dim=axis, keepdim=True))
        else:
            nrm = torch.pow(torch.sum(torch.pow(a.abs(), p), dim=axis,
                                      keepdim=True), 1.0 / p)
        return a / torch.clamp(nrm, min=epsilon)
    return apply("normalize", f, x)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    def f(a):
        c_axis = 1 if data_format.startswith("NC") else a.ndim - 1
        sq = torch.movedim(a * a, c_axis, 0)
        c, half = sq.shape[0], size // 2
        padded = torch.cat([sq.new_zeros((half,) + sq.shape[1:]), sq,
                            sq.new_zeros((size - half - 1,) + sq.shape[1:])])
        acc = torch.zeros_like(sq)
        for i in range(size):
            acc = acc + padded[i:i + c]
        acc = torch.movedim(acc, 0, c_axis)
        return a / torch.pow(k + alpha * acc / size, beta)
    return apply("local_response_norm", f, x)


def rms_norm(x, weight, epsilon=1e-6, name=None):
    """Plain RMSNorm (f32 statistics, cast back, times the weight)."""
    def f(a, w):
        var = torch.mean(a.float() ** 2, dim=-1, keepdim=True)
        return (a.float() * torch.rsqrt(var + epsilon)).to(a.dtype) * w
    return apply("rms_norm", f, x, weight)
