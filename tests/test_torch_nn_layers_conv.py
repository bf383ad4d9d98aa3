"""The port's conv, pooling and vision Layers (`paddle_tpu_torch/nn/layer/`
conv, pooling and vision) against the JAX package's, on the CPU.

Each case builds the layer in both packages, carries the reference's
weights into the port's (`tests/torch_nn_cases.py::carry`), runs the same
numpy inputs through both and holds the outputs, the input gradients and
every parameter's gradient at float32 2e-5 abs and rel
(`tests/test_torch_nn_layers.py::layer_twin`).  The conv layers also hold
their shapes and the reference's initializers' bounds, and a transpose
whose in / groups differs from out / groups raises ValueError in both, as
lax does.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from test_torch_nn_layers import layer_twin
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

_r = np.random.RandomState(29)


def f32(*shape):
    return _r.randn(*shape).astype(np.float32)


X1, X2, X3 = f32(2, 4, 9), f32(2, 4, 6, 7), f32(1, 2, 4, 5, 4)

CONV = {
    "Conv1D": (lambda ns: ns.nn.Conv1D(4, 6, 3, stride=2, padding=1), X1),
    "Conv1D_nlc_groups": (lambda ns: ns.nn.Conv1D(
        4, 6, 3, padding="SAME", groups=2, data_format="NLC"),
        np.moveaxis(X1, 1, -1).copy()),
    "Conv2D": (lambda ns: ns.nn.Conv2D(4, 6, [3, 2], stride=[1, 2],
                                       padding=[1, 0, 2, 1], dilation=2), X2),
    "Conv2D_nhwc_no_bias": (lambda ns: ns.nn.Conv2D(
        4, 3, 3, padding=1, bias_attr=False, data_format="NHWC",
        padding_mode="reflect"), np.moveaxis(X2, 1, -1).copy()),
    "Conv3D": (lambda ns: ns.nn.Conv3D(2, 3, 2, stride=2, padding=1), X3),
    "Conv1DTranspose": (lambda ns: ns.nn.Conv1DTranspose(
        4, 4, 3, stride=2, padding=1, output_padding=1), X1),
    "Conv2DTranspose": (lambda ns: ns.nn.Conv2DTranspose(
        4, 4, 3, stride=2, padding="SAME", groups=2), X2),
    "Conv2DTranspose_nhwc": (lambda ns: ns.nn.Conv2DTranspose(
        4, 4, [2, 3], stride=[2, 1], dilation=2, data_format="NHWC"),
        np.moveaxis(X2, 1, -1).copy()),
    "Conv3DTranspose": (lambda ns: ns.nn.Conv3DTranspose(
        2, 2, 3, stride=2, padding=1), X3),
}


@pytest.mark.parametrize("name", sorted(CONV))
def test_conv_layer(name):
    build, x = CONV[name]
    layer_twin(build, [x])


def test_conv_layers_shapes_and_initial_bounds():
    for ns in (R, P):
        ns.seed(3)
        conv = ns.nn.Conv2D(4, 6, 3, groups=2)
        convt = ns.nn.Conv2DTranspose(4, 4, 3, groups=2)
        assert conv.weight.shape == [6, 2, 3, 3]
        assert convt.weight.shape == [4, 2, 3, 3]
        assert conv.bias.shape == [6] and convt.bias.shape == [4]
        fan_in = 4 * 9 // 2
        # KaimingUniform's limit sqrt(6 / fan_in); the bias 1 / sqrt(fan_in)
        assert np.abs(conv.weight.numpy()).max() <= np.sqrt(6 / fan_in)
        assert np.abs(conv.bias.numpy()).max() <= 1 / np.sqrt(fan_in)
        assert np.abs(conv.weight.numpy()).max() > 0.5 * np.sqrt(6 / fan_in)


def test_transpose_with_unequal_group_widths_raises_in_both():
    for ns in (R, P):
        layer = ns.nn.Conv2DTranspose(4, 6, 3)
        with pytest.raises(ValueError, match="feature_group_count"):
            layer(ns.to_tensor(X2))


P1, P2, P3 = f32(2, 3, 9), f32(2, 3, 7, 8), f32(1, 2, 5, 6, 4)

POOL = {
    "MaxPool1D": (lambda ns: ns.nn.MaxPool1D(3, 2, 1, return_mask=True), P1),
    "MaxPool2D": (lambda ns: ns.nn.MaxPool2D(3, 2, 1, ceil_mode=True), P2),
    "MaxPool2D_mask": (lambda ns: ns.nn.MaxPool2D(2, return_mask=True), P2),
    "MaxPool2D_nhwc": (lambda ns: ns.nn.MaxPool2D(
        2, 1, 1, data_format="NHWC"), np.moveaxis(P2, 1, -1).copy()),
    "MaxPool3D": (lambda ns: ns.nn.MaxPool3D(2, ceil_mode=True), P3),
    "AvgPool1D": (lambda ns: ns.nn.AvgPool1D(3, 2, 1, exclusive=False), P1),
    "AvgPool2D": (lambda ns: ns.nn.AvgPool2D(3, 2, 1, ceil_mode=True), P2),
    "AvgPool2D_divisor": (lambda ns: ns.nn.AvgPool2D(
        2, divisor_override=3), P2),
    "AvgPool3D": (lambda ns: ns.nn.AvgPool3D(2, padding=1,
                                             exclusive=False), P3),
    "AdaptiveAvgPool1D": (lambda ns: ns.nn.AdaptiveAvgPool1D(4), P1),
    "AdaptiveAvgPool2D": (lambda ns: ns.nn.AdaptiveAvgPool2D([3, 4]), P2),
    "AdaptiveAvgPool2D_nhwc": (lambda ns: ns.nn.AdaptiveAvgPool2D(
        2, data_format="NHWC"), np.moveaxis(P2, 1, -1).copy()),
    "AdaptiveAvgPool3D": (lambda ns: ns.nn.AdaptiveAvgPool3D(2), P3),
    "AdaptiveMaxPool1D": (lambda ns: ns.nn.AdaptiveMaxPool1D(
        4, return_mask=True), P1),
    "AdaptiveMaxPool2D": (lambda ns: ns.nn.AdaptiveMaxPool2D(3), P2),
    "AdaptiveMaxPool3D": (lambda ns: ns.nn.AdaptiveMaxPool3D([2, 3, 2]), P3),
}


@pytest.mark.parametrize("name", sorted(POOL))
def test_pool_layer(name):
    build, x = POOL[name]
    layer_twin(build, [x])


def _unpool_2d(ns, layer, x):
    out, mask = ns.nn.MaxPool2D(2, return_mask=True)(x)
    return layer(out, mask)


UNPOOL = {
    "MaxUnPool1D": (lambda ns: ns.nn.MaxUnPool1D(2),
                    [f32(2, 3, 4), np.stack([np.stack(
                        [_r.permutation(8)[:4] for _ in range(3)])
                        for _ in range(2)]).astype(np.int32)]),
    "MaxUnPool3D": (lambda ns: ns.nn.MaxUnPool3D(2, output_size=[4, 4, 5]),
                    [f32(1, 2, 2, 2, 2), np.stack(
                        [_r.permutation(80)[:8] for _ in range(2)])
                     .reshape(1, 2, 2, 2, 2).astype(np.int32)]),
}


@pytest.mark.parametrize("name", sorted(UNPOOL))
def test_unpool_layer(name):
    build, inputs = UNPOOL[name]
    layer_twin(build, inputs)


def test_unpool_2d_layer_after_the_pool_mask():
    x = P2[..., :6]
    layer_twin(lambda ns: ns.nn.MaxUnPool2D(2), [x],
               call=lambda layer, t: _unpool_2d(
                   R if isinstance(t, R.Tensor) else P, layer, t))


VISION = {
    "PixelShuffle": (lambda ns: ns.nn.PixelShuffle(2), f32(2, 8, 2, 3)),
    "PixelShuffle_nhwc": (lambda ns: ns.nn.PixelShuffle(
        2, data_format="NHWC"), f32(2, 2, 3, 8)),
    "PixelUnshuffle": (lambda ns: ns.nn.PixelUnshuffle(2), f32(2, 2, 4, 6)),
    "ChannelShuffle": (lambda ns: ns.nn.ChannelShuffle(3), f32(2, 6, 2, 3)),
}


@pytest.mark.parametrize("name", sorted(VISION))
def test_vision_layer(name):
    build, x = VISION[name]
    layer_twin(build, [x])


def test_every_new_layer_class_has_a_case():
    names = {n.split("_")[0] for n in
             list(CONV) + list(POOL) + list(UNPOOL) + list(VISION)} | \
        {"MaxUnPool2D"}
    from paddle_tpu_torch.nn.layer import conv, pooling, vision
    classes = {n for m in (conv, pooling, vision) for n in dir(m)
               if not n.startswith("_") and isinstance(getattr(m, n), type)
               and issubclass(getattr(m, n), P.nn.Layer) and n != "Layer"}
    assert classes == names
