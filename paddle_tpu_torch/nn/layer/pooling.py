"""Pooling layers — port of `paddle_tpu/nn/layer/pooling.py` (reference
`python/paddle/nn/layer/pooling.py`): each a Layer over its functional."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class _Pool(Layer):
    def __init__(self, fn, **kwargs):
        super().__init__()
        self._fn = fn
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return self._fn(x, **self._kwargs)


class MaxPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(F.max_pool1d, kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask, ceil_mode=ceil_mode)


class MaxPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(F.max_pool2d, kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class MaxPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(F.max_pool3d, kernel_size=kernel_size, stride=stride,
                         padding=padding, return_mask=return_mask, ceil_mode=ceil_mode,
                         data_format=data_format)


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(F.avg_pool1d, kernel_size=kernel_size, stride=stride,
                         padding=padding, exclusive=exclusive, ceil_mode=ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__(F.avg_pool2d, kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode, exclusive=exclusive,
                         divisor_override=divisor_override, data_format=data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
        super().__init__(F.avg_pool3d, kernel_size=kernel_size, stride=stride,
                         padding=padding, ceil_mode=ceil_mode, exclusive=exclusive,
                         divisor_override=divisor_override, data_format=data_format)


class AdaptiveAvgPool1D(_Pool):
    def __init__(self, output_size, name=None):
        super().__init__(F.adaptive_avg_pool1d, output_size=output_size)


class AdaptiveAvgPool2D(_Pool):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(F.adaptive_avg_pool2d, output_size=output_size,
                         data_format=data_format)


class AdaptiveAvgPool3D(_Pool):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(F.adaptive_avg_pool3d, output_size=output_size,
                         data_format=data_format)


class AdaptiveMaxPool1D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool1d, output_size=output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool2D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool2d, output_size=output_size,
                         return_mask=return_mask)


class AdaptiveMaxPool3D(_Pool):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(F.adaptive_max_pool3d, output_size=output_size,
                         return_mask=return_mask)


class MaxUnPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return F.max_unpool2d(x, indices, k, s, p, df, osz)


class MaxUnPool1D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return F.max_unpool1d(x, indices, k, s, p, df, osz)


class MaxUnPool3D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCDHW",
                 output_size=None, name=None):
        super().__init__()
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return F.max_unpool3d(x, indices, k, s, p, df, osz)
