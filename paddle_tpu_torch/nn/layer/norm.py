"""Norm layers — port of `paddle_tpu/nn/layer/norm.py` (reference
`python/paddle/nn/layer/norm.py`).  `SpectralNorm` draws its u and v at
init from the port's generator (the reference from its own stream, so a
twin carries them across as buffers); `SyncBatchNorm` on one process is
`BatchNorm`, as in the reference."""
from __future__ import annotations

import numpy as np
import torch

from ...core import generator as _gen
from ...core.place import expected_device
from ...core.tensor import Tensor, apply
from .. import functional as F
from ..initializer import Constant
from .layers import Layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = "NHWC" if data_format in ("NHWC", "NLC", "NDHWC") \
            else "NCHW"
        self._use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)
        dev = expected_device()
        self.register_buffer("_mean", Tensor(torch.zeros(num_features,
                                                         device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(num_features,
                                                            device=dev)))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    """The legacy `paddle.nn.BatchNorm` (on `num_channels`, an optional
    relu after)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", **kw):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act == "relu":
            out = F.relu(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BatchNorm: on one process, local statistics."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      None, None, layer._data_format)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        for name, sub in list(layer._sub_layers.items()):
            out._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return out


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=[num_channels], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """Spectral normalization of a weight (power iteration from the u, v
    buffers; the buffers are not updated, as in the reference)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        dev = expected_device()
        g = _gen.default_generator().torch_generator(dev)
        self.register_buffer("weight_u", Tensor(
            torch.randn(h, generator=g, device=dev)))
        self.register_buffer("weight_v", Tensor(
            torch.randn(w, generator=g, device=dev)))

    def forward(self, weight):
        dim, iters, eps = self._dim, self._power_iters, self._eps
        u0, v0 = self.weight_u._t, self.weight_v._t

        def f(w):
            wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
            u, v = u0, v0
            for _ in range(iters):
                v = wm.T @ u
                v = v / (torch.linalg.norm(v) + eps)
                u = wm @ v
                u = u / (torch.linalg.norm(u) + eps)
            return w / (u @ wm @ v)
        return apply("spectral_norm", f, weight)
