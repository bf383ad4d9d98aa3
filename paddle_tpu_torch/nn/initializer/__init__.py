"""Initializers (reference: `python/paddle/nn/initializer/` — 12 initializers).

Each initializer is a callable applied to a Parameter in place (its value
rebound, `Tensor._replace`), drawing float32 values from the default
generator on the parameter's device (`core.generator`) and casting them to
the parameter's dtype, so `paddle.seed` makes them reproducible.  The draws
are the port's own stream, not the reference's numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core import generator as _gen
from ...core.tensor import Tensor


def _draw(param, fn):
    """fn(shape, generator, device) -> float32 values for `param`."""
    t = param._t
    return fn(tuple(t.shape), _gen.default_generator().torch_generator(
        t.device), t.device)


def _uniform(param, low, high):
    return _draw(param, lambda s, g, d: torch.rand(
        s, generator=g, device=d) * (high - low) + low)


def _normal(param, mean, std):
    return _draw(param, lambda s, g, d: torch.randn(
        s, generator=g, device=d) * std + mean)


class Initializer:
    def __call__(self, param, block=None):
        raise NotImplementedError

    def _set(self, param, data):
        with torch.no_grad():
            param._replace(torch.as_tensor(data))


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param, block=None):
        self._set(param, torch.full(tuple(param._t.shape), self.value,
                                    dtype=torch.float32,
                                    device=param._t.device))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, param, block=None):
        v = self.value
        if isinstance(v, Tensor):
            v = v._t
        elif not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        self._set(param, v.reshape(tuple(param._t.shape)))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, param, block=None):
        self._set(param, _uniform(param, self.low, self.high))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, param, block=None):
        self._set(param, _normal(param, self.mean, self.std))


class TruncatedNormal(Initializer):
    """mean + std * z, z a standard normal truncated to [a, b] (inverse
    CDF of a uniform draw between the bounds' CDFs)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, param, block=None):
        def cdf(x):
            return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
        lo, hi = 2 * cdf(self.a) - 1, 2 * cdf(self.b) - 1
        u = _uniform(param, lo, hi)
        z = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(self.a, self.b)
        self._set(param, self.mean + self.std * z)


def _fans(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fans(param._t.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        self._set(param, _uniform(param, -limit, limit))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, param, block=None):
        fi, fo = _fans(param._t.shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        self._set(param, _normal(param, 0.0, std))


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu", name=None):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _gain(self):
        if self.nonlinearity == "relu":
            return math.sqrt(2.0)
        if self.nonlinearity == "leaky_relu":
            return math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return 1.0

    def __call__(self, param, block=None):
        fi, _ = _fans(param._t.shape)
        fi = self.fan_in or fi
        limit = self._gain() * math.sqrt(3.0 / fi)
        self._set(param, _uniform(param, -limit, limit))


class KaimingNormal(KaimingUniform):
    def __call__(self, param, block=None):
        fi, _ = _fans(param._t.shape)
        fi = self.fan_in or fi
        std = self._gain() / math.sqrt(fi)
        self._set(param, _normal(param, 0.0, std))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, param, block=None):
        shape = tuple(param._t.shape)
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = (max(rows, cols), min(rows, cols))
        a = _draw(param, lambda s, g, d: torch.randn(flat, generator=g,
                                                     device=d))
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        self._set(param, self.gain * q[:rows, :cols].reshape(shape))


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, param, block=None):
        shape = tuple(param._t.shape)
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        for g in range(self.groups):
            for i in range(min(per, ic)):
                idx = (g * per + i, i) + tuple(s // 2 for s in shape[2:])
                out[idx] = 1.0
        self._set(param, torch.from_numpy(out))


class Bilinear(Initializer):
    def __call__(self, param, block=None):
        shape = tuple(param._t.shape)
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects 4-D conv weight")
        kh, kw = shape[2], shape[3]
        fh = (kh + 1) // 2
        ch = (kh - 1) / (2.0 * fh) if kh % 2 == 1 else (kh) / (2.0 * fh) - 0.5
        yy = (1 - np.abs(np.arange(kh) / fh - ch))
        fw = (kw + 1) // 2
        cw = (kw - 1) / (2.0 * fw) if kw % 2 == 1 else (kw) / (2.0 * fw) - 0.5
        xx = (1 - np.abs(np.arange(kw) / fw - cw))
        filt = np.outer(yy, xx).astype(np.float32)
        out = np.zeros(shape, np.float32)
        for i in range(shape[0]):
            out[i, min(i, shape[1] - 1)] = filt
        self._set(param, torch.from_numpy(out))


def calculate_gain(nonlinearity, param=None):
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0, "conv3d": 1.0,
             "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
             "leaky_relu": math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             "selu": 3.0 / 4}
    return gains.get(nonlinearity, 1.0)


def set_global_initializer(weight_init, bias_init=None):
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


_global_weight_init = None
_global_bias_init = None
