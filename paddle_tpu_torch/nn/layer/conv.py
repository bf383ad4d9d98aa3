"""Conv layers — port of `paddle_tpu/nn/layer/conv.py` (reference
`python/paddle/nn/layer/conv.py`).  Weights are `[out, in / groups, *k]`,
transposes' `[in, out / groups, *k]`, drawn `KaimingUniform` from the
port's generator; the bias is `Uniform(+-1 / sqrt(fan_in))`.
`padding_mode` is accepted and ignored, as in the reference."""
from __future__ import annotations

import numpy as np

from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from .layers import Layer


class _ConvND(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, n,
                 transpose=False, stride=1, padding=0, output_padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._n = n
        self._transpose = transpose
        self._stride = stride
        self._padding = padding
        self._output_padding = output_padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        k = (kernel_size,) * n if isinstance(kernel_size, int) \
            else tuple(kernel_size)
        if transpose:
            wshape = [in_channels, out_channels // groups] + list(k)
        else:
            wshape = [out_channels, in_channels // groups] + list(k)
        fan_in = in_channels * int(np.prod(k)) // groups
        self.weight = self.create_parameter(
            shape=wshape, attr=weight_attr,
            default_initializer=KaimingUniform())
        bound = 1.0 / np.sqrt(fan_in)
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound)) \
            if bias_attr is not False else None

    def forward(self, x):
        if self._transpose:
            fn = [F.conv1d_transpose, F.conv2d_transpose,
                  F.conv3d_transpose][self._n - 1]
            return fn(x, self.weight, self.bias, stride=self._stride,
                      padding=self._padding,
                      output_padding=self._output_padding,
                      groups=self._groups, dilation=self._dilation,
                      data_format=self._data_format)
        fn = [F.conv1d, F.conv2d, F.conv3d][self._n - 1]
        return fn(x, self.weight, self.bias, stride=self._stride,
                  padding=self._padding, dilation=self._dilation,
                  groups=self._groups, data_format=self._data_format)


class Conv1D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv2D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv3D(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, False,
                         stride, padding, 0, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv1DTranspose(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)


class Conv2DTranspose(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)


class Conv3DTranspose(_ConvND):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, True,
                         stride, padding, output_padding, dilation, groups,
                         "zeros", weight_attr, bias_attr, data_format)
