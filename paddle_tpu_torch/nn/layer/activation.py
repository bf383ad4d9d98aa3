"""Activation layers — port of `paddle_tpu/nn/layer/activation.py`
(reference `python/paddle/nn/layer/activation.py`): each a Layer over its
functional, positional arguments mapped onto the functional's parameters
in order."""
from __future__ import annotations

import inspect

from .. import functional as F
from ..initializer import Constant
from .layers import Layer


def _mk(fname, **fixed):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = dict(fixed)
            params = [p for p in inspect.signature(getattr(F, fname)).parameters
                      if p not in ("x", "name")]
            for i, a in enumerate(args):
                self._kwargs[params[i]] = a
            for k, v in kwargs.items():
                if k != "name":
                    self._kwargs[k] = v

        def forward(self, x):
            return getattr(F, fname)(x, **self._kwargs)
    _Act.__name__ = fname
    return _Act


CELU = _mk("celu")
ELU = _mk("elu")
GELU = _mk("gelu")
Hardshrink = _mk("hardshrink")
Hardsigmoid = _mk("hardsigmoid")
Hardswish = _mk("hardswish")
Hardtanh = _mk("hardtanh")
LeakyReLU = _mk("leaky_relu")
LogSigmoid = _mk("log_sigmoid")
LogSoftmax = _mk("log_softmax")
Maxout = _mk("maxout")
Mish = _mk("mish")
ReLU = _mk("relu")
ReLU6 = _mk("relu6")
RReLU = _mk("rrelu")
SELU = _mk("selu")
Sigmoid = _mk("sigmoid")
Silu = _mk("silu")
Softmax = _mk("softmax")
Softplus = _mk("softplus")
Softshrink = _mk("softshrink")
Softsign = _mk("softsign")
Swish = _mk("swish")
Tanh = _mk("tanh")
Tanhshrink = _mk("tanhshrink")
ThresholdedReLU = _mk("thresholded_relu")


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)


class Softmax2D(Layer):
    """Softmax over the channel dim of NCHW/CHW."""

    def forward(self, x):
        assert x.ndim in (3, 4), f"Softmax2D expects 3D/4D input, got {x.ndim}D"
        return F.softmax(x, axis=-3)
