"""Activation functionals — port of `paddle_tpu/nn/functional/activation.py`
(reference `python/paddle/nn/functional/activation.py`).

Torch inside `apply`, on the tensors' device, each the formula the
reference's jax function computes (Paddle's `hardsigmoid` slope, `gelu`'s
erf default, `leaky_relu`'s slope 1 at 0).  `rrelu` (training) and
`gumbel_softmax` draw from the port's generator for the input's device.
The in-place variants rebind through `Tensor._inplace` (a version bump,
then the rebind).
"""
from __future__ import annotations

import torch
import torch.nn.functional as _F

from ...core import dtype as _dt
from ...core import generator as _gen
from ...core.tensor import apply


def _draws(a):
    """An empty float tensor like `a`'s (float32 when a is not floating)
    and the port's generator for a's device."""
    buf = torch.empty(a.shape, device=a.device,
                      dtype=a.dtype if a.is_floating_point() else torch.float32)
    return buf, _gen.default_generator().torch_generator(a.device)


def relu(x, name=None):
    return apply("relu", torch.relu, x)


def relu_(x, name=None):
    return x._inplace(lambda: relu(x))


def relu6(x, name=None):
    return apply("relu6", _F.relu6, x)


def elu(x, alpha=1.0, name=None):
    return apply("elu", lambda a: _F.elu(a, alpha), x)


def celu(x, alpha=1.0, name=None):
    return apply("celu", lambda a: _F.celu(a, alpha), x)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply("selu", lambda a: scale * torch.where(
        a > 0, a, alpha * torch.expm1(a)), x)


def gelu(x, approximate=False, name=None):
    return apply("gelu", lambda a: _F.gelu(
        a, approximate="tanh" if approximate else "none"), x)


def silu(x, name=None):
    return apply("silu", _F.silu, x)


swish = silu


def sigmoid(x, name=None):
    return apply("sigmoid", torch.sigmoid, x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply("hardsigmoid",
                 lambda a: torch.clamp(slope * a + offset, 0.0, 1.0), x)


def hardswish(x, name=None):
    return apply("hardswish",
                 lambda a: a * torch.clamp(a + 3.0, 0.0, 6.0) / 6.0, x)


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply("hardtanh", lambda a: torch.clamp(a, min, max), x)


def hardshrink(x, threshold=0.5, name=None):
    return apply("hardshrink",
                 lambda a: torch.where(a.abs() > threshold, a, 0.0), x)


def softshrink(x, threshold=0.5, name=None):
    return apply("softshrink", lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, 0.0)), x)


def tanhshrink(x, name=None):
    return apply("tanhshrink", lambda a: a - torch.tanh(a), x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply("thresholded_relu",
                 lambda a: torch.where(a > threshold, a, value), x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply("leaky_relu",
                 lambda a: torch.where(a >= 0, a, negative_slope * a), x)


def prelu(x, weight, data_format="NCHW", name=None):
    def f(a, w):
        if w.numel() == 1:
            return torch.where(a > 0, a, w.reshape(()) * a)
        shape = [1] * a.ndim
        shape[1 if data_format[1] == "C" else a.ndim - 1] = w.numel()
        return torch.where(a > 0, a, w.reshape(shape) * a)
    return apply("prelu", f, x, weight)


def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    if training:
        def f(a):
            buf, g = _draws(a)
            slope = buf.uniform_(lower, upper, generator=g).to(a.dtype)
            return torch.where(a >= 0, a, slope * a)
        return apply("rrelu", f, x)
    mid = (lower + upper) / 2.0
    return apply("rrelu", lambda a: torch.where(a >= 0, a, mid * a), x)


def maxout(x, groups, axis=1, name=None):
    def f(a):
        ax = axis % a.ndim
        c = a.shape[ax]
        shape = a.shape[:ax] + (c // groups, groups) + a.shape[ax + 1:]
        return torch.amax(a.reshape(shape), dim=ax + 1)
    return apply("maxout", f, x)


def mish(x, name=None):
    return apply("mish", lambda a: a * torch.tanh(_F.softplus(a)), x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    return apply("softplus", lambda a: _F.softplus(a, beta, threshold), x)


def softsign(x, name=None):
    return apply("softsign", _F.softsign, x)


def tanh(x, name=None):
    return apply("tanh", torch.tanh, x)


def tanh_(x, name=None):
    return x._inplace(lambda: tanh(x))


def log_sigmoid(x, name=None):
    return apply("log_sigmoid", _F.logsigmoid, x)


def _cast(a, dtype):
    return a if dtype is None else a.to(_dt.to_torch(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    return apply("softmax", lambda a: torch.softmax(_cast(a, dtype), axis), x)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x._inplace(lambda: softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply("log_softmax",
                 lambda a: torch.log_softmax(_cast(a, dtype), axis), x)


def glu(x, axis=-1, name=None):
    return apply("glu", lambda a: _F.glu(a, axis), x)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """Gumbel noise -log(-log(u)), u uniform on [tiny, 1), as
    `jax.random.gumbel` draws it; `hard` keeps the straight-through
    gradient of the soft sample."""
    def f(a):
        buf, g = _draws(a)
        u = buf.uniform_(torch.finfo(buf.dtype).tiny, 1.0, generator=g)
        y = torch.softmax((a + (-torch.log(-torch.log(u))).to(a.dtype))
                          / temperature, axis)
        if hard:
            onehot = torch.zeros_like(y).scatter_(
                axis, y.argmax(axis, keepdim=True), 1.0)
            y = onehot + y - y.detach()
        return y
    return apply("gumbel_softmax", f, x)


# ---- in-place variants (ref activation.py elu_ etc.) ----

def elu_(x, alpha=1.0, name=None):
    return x._inplace(lambda: elu(x, alpha))


def hardtanh_(x, min=-1.0, max=1.0, name=None):
    return x._inplace(lambda: hardtanh(x, min, max))


def leaky_relu_(x, negative_slope=0.01, name=None):
    return x._inplace(lambda: leaky_relu(x, negative_slope))


def thresholded_relu_(x, threshold=1.0, value=0.0, name=None):
    return x._inplace(lambda: thresholded_relu(x, threshold, value))
