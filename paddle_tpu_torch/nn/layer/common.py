"""Common layers — port of `paddle_tpu/nn/layer/common.py` (reference
`python/paddle/nn/layer/common.py`): `Linear` (Paddle's [in, out] weight),
`Embedding` (its `padding_idx` row zeroed at init), the dropouts,
`Flatten`/`Unflatten`, the upsamplers, `Bilinear`, the pads, the distances,
`Unfold` and `Fold`."""
from __future__ import annotations

from ...core.tensor import Parameter  # noqa: F401  (the reference's name)
from .. import functional as F
from ..initializer import Constant, Normal, XavierNormal  # noqa: F401
from .layers import Layer


class Identity(Layer):
    def forward(self, x):
        return x


class Linear(Layer):
    """y = xW + b, W: [in, out]."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=XavierNormal())
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self._in_features}, out_features={self._out_features}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training,
                         mode=self.mode)


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, training=self.training,
                           data_format=self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, training=self.training)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = (padding_idx if padding_idx is None or padding_idx >= 0
                             else num_embeddings + padding_idx)
        self._sparse = sparse
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=Normal(0.0, 1.0))
        if self._padding_idx is not None:
            w = self.weight._t.detach().clone()
            w[self._padding_idx] = 0.0
            self.weight._replace(w)

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        from ...ops.manipulation import flatten
        return flatten(x, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class Bilinear(Layer):
    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features], attr=weight_attr)
        self.bias = self.create_parameter(shape=[out_features], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _PadND(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self._pad = padding
        self._mode = mode
        self._value = value
        self._data_format = data_format

    def forward(self, x):
        return F.pad(x, self._pad, mode=self._mode, value=self._value,
                     data_format=self._data_format)


class Pad1D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadND):
    pass


class Pad3D(_PadND):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(_PadND):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p = p
        self.epsilon = epsilon
        self.keepdim = keepdim

    def forward(self, x, y):
        return F.pairwise_distance(x, y, self.p, self.epsilon, self.keepdim)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class Unflatten(Layer):
    """Split one axis into a shape."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis = axis
        self._shape = shape

    def forward(self, x):
        from ...ops.manipulation import unflatten
        return unflatten(x, self.axis, self._shape)
