"""Helpers shared by the op modules: argument normalisation and the
in-place rebind with its version bump."""
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


def inplace(x: Tensor, out_of_place) -> Tensor:
    """Rebind `x` to `out_of_place()`, an op's result on `x`'s value, as the
    reference's `_inplace_from` does, and bump the old value's version
    first: a node recorded earlier that saved that value then raises
    torch's "modified by an inplace operation" error at backward (the
    reference's version check), while the op's own node, recorded after
    the bump, does not.  A view's version counter is its base's, so a view
    is not bumped (its base's readers must not raise)."""
    t = x._t
    if not t._is_view():
        torch.autograd.graph.increment_version(t)
    return x._inplace_from(out_of_place())
