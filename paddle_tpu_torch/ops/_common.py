"""Helpers shared by the op modules: argument normalisation."""
from __future__ import annotations

import numpy as np
import torch

from ..core.place import expected_device
from ..core.tensor import Tensor, _to_torch


def data(x, device=None) -> torch.Tensor:
    """A Tensor's torch tensor as it is; numpy, Python data and torch
    tensors as a torch tensor on `device` (default: the expected place).
    The reference's `_to_data`."""
    if isinstance(x, Tensor):
        return x._t
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return _to_torch(x, place=device if device is not None
                     else expected_device())


def shape(shape) -> tuple:
    """A shape given as an int, a list of ints and 0-d Tensors, or a Tensor
    -> a tuple of ints."""
    if isinstance(shape, Tensor):
        return tuple(int(s) for s in shape._t.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) if not isinstance(s, Tensor) else int(s.item())
                 for s in shape)


ints = shape


def axis(axis):
    """None, an int, a list/tuple of ints or a Tensor -> None, an int or a
    tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        return tuple(int(a) for a in axis._t.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(ax, ndim: int) -> tuple:
    """`axis()`'s result -> the explicit tuple of dims torch's reductions
    take (None: every dim)."""
    if ax is None:
        return tuple(range(ndim))
    if isinstance(ax, tuple):
        return ax
    return (ax,)


def item(v):
    """A one-element Tensor -> its Python number; anything else as it is."""
    return v.item() if isinstance(v, Tensor) else v
