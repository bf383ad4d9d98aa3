"""Convolutions — port of `paddle_tpu/nn/functional/conv.py` (reference
`python/paddle/nn/functional/conv.py`).

The reference lowers to `lax.conv_general_dilated` / `lax.conv_transpose`,
no Pallas kernel; the port calls `F.conv{1,2,3}d` and
`F.conv_transpose{1,2,3}d` (cuDNN on the card), with what lax does and
torch does not written out:

- padding: an int, one per spatial axis, or `2n` (low, high) pairs, put
  on with `F.pad` where they are not symmetric; "SAME"/"VALID" at any
  stride as lax computes them (total = max((ceil(in / s) - 1) * s +
  d * (k - 1) + 1 - in, 0), the low side total // 2);
- channel-last data (`NLC`, `NHWC`, `NDHWC`) is moved to channel-first
  around the call; the weight stays `[out, in / groups, *k]`;
- transposes follow `lax.conv_transpose(transpose_kernel=True)` over the
  reference's `IO...` weight spec: the weight's two leading axes are
  swapped within each group, so they run only where in / groups equals
  out / groups (lax raises otherwise, and so does the port), and the
  output is the full transposed convolution padded (or cropped) to
  `_transpose_one`'s (d * (k - 1) - lo, d * (k - 1) - hi +
  output_padding); "SAME" gives in * s and "VALID" in * s + max(d * (k -
  1) + 1 - s, 0), lax's `_conv_transpose_padding`;
- `output_size` is accepted and ignored, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from ...core.tensor import apply

_CHANNEL_LAST = ("NHWC", "NLC", "NDHWC", "NWC")
_CONV = (None, _F.conv1d, _F.conv2d, _F.conv3d)
_CONV_T = (None, _F.conv_transpose1d, _F.conv_transpose2d,
           _F.conv_transpose3d)


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(int(x) for x in v)
    if len(v) == 1:
        return v * n
    return v


def _padding(padding, n):
    """Paddle's padding spec -> "SAME"/"VALID" or n (low, high) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _same_pads(sizes, ks, strides, dilations):
    """lax's "SAME" pads of a window over `sizes`."""
    pads = []
    for size, k, s, d in zip(sizes, ks, strides, dilations):
        out = -(-size // s)
        total = max((out - 1) * s + d * (k - 1) + 1 - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads):
    """(low, high) pairs in axis order -> `F.pad`'s last-axis-first list."""
    return [v for lo, hi in reversed(pads) for v in (lo, hi)]


def _channels_first(a, channel_last):
    return torch.movedim(a, -1, 1) if channel_last else a


def _channels_back(a, channel_last):
    return torch.movedim(a, 1, -1) if channel_last else a


def _add_bias(out, rest):
    if not rest:
        return out
    b = rest[0]
    return out + b.reshape([1, b.numel()] + [1] * (out.ndim - 2))


def _conv(x, weight, bias, stride, padding, dilation, groups, n, data_format):
    strides = _tup(stride, n)
    dilations = _tup(dilation, n)
    channel_last = data_format in _CHANNEL_LAST
    pad = _padding(padding, n)

    def f(a, w, *rest):
        a = _channels_first(a, channel_last)
        ks = w.shape[2:]
        if pad == "VALID":
            pads = [(0, 0)] * n
        elif pad == "SAME":
            pads = _same_pads(a.shape[2:], ks, strides, dilations)
        else:
            pads = pad
        if all(lo == hi for lo, hi in pads):
            sym = [lo for lo, _ in pads]
        else:
            a = _F.pad(a, _torch_pad(pads))
            sym = 0
        out = _CONV[n](a, w, None, strides, sym, dilations, groups)
        return _channels_back(_add_bias(out, rest), channel_last)
    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply(f"conv{n}d", f, *args)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    df = "NWC" if data_format in ("NLC",) else "NCW"
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1, df)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _transpose_pads(pad, ks, strides, dilations, opad):
    """The (low, high) padding of the stride-dilated input that lax's
    conv_transpose convolves: `_transpose_one`'s list, or lax's
    `_conv_transpose_padding` for "SAME"/"VALID"."""
    out = []
    for i, (k, s, d) in enumerate(zip(ks, strides, dilations)):
        ke = d * (k - 1) + 1
        if pad == "SAME":
            total = ke + s - 2
            lo = ke - 1 if s > ke - 1 else int(math.ceil(total / 2))
        elif pad == "VALID":
            total = ke + s - 2 + max(ke - s, 0)
            lo = ke - 1
        else:
            lo, hi = pad[i]
            out.append((d * (k - 1) - lo, d * (k - 1) - hi + opad[i]))
            continue
        out.append((lo, total - lo))
    return out


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format, output_size):
    strides = _tup(stride, n)
    dilations = _tup(dilation, n)
    channel_last = data_format in _CHANNEL_LAST
    pad = _padding(padding, n)
    opad = _tup(output_padding, n) if output_padding else (0,) * n

    def f(a, w, *rest):
        a = _channels_first(a, channel_last)
        cin, per_group = w.shape[0] // groups, w.shape[1]
        if a.shape[1] // groups != per_group:
            raise ValueError(
                "conv_general_dilated lhs feature dimension size divided by "
                "feature_group_count must equal the rhs input feature "
                f"dimension size, but {a.shape[1] // groups} // 1 != "
                f"{per_group}.")
        ks = w.shape[2:]
        # the reference's IO spec under transpose_kernel: each group's two
        # leading axes swapped
        wt = w.reshape((groups, cin, per_group) + tuple(ks)).transpose(1, 2) \
            .reshape(w.shape)
        full = _CONV_T[n](a, wt, None, strides, 0, 0, groups, dilations)
        pads = _transpose_pads(pad, ks, strides, dilations, opad)
        # the full output is the one of padding d * (k - 1) a side
        grow = [(lo - d * (k - 1), hi - d * (k - 1))
                for (lo, hi), k, d in zip(pads, ks, dilations)]
        out = _F.pad(full, _torch_pad(grow)) if any(
            v for g in grow for v in g) else full
        return _channels_back(_add_bias(out, rest), channel_last)
    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply(f"conv{n}d_transpose", f, *args)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    df = "NWC" if data_format == "NLC" else "NCW"
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, df, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size)
