"""Vision layers — port of `paddle_tpu/nn/layer/vision.py` (reference
`python/paddle/nn/layer/vision.py`)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor = upscale_factor
        self._data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self._factor, self._data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self._factor = downscale_factor
        self._data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self._factor, self._data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self._groups = groups
        self._data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self._groups, self._data_format)
