"""Shape/layout manipulation ops (reference: `python/paddle/tensor/manipulation.py`).

`unique`, `nonzero` and `masked_select` have data-dependent shapes; they
run eagerly on the tensor's device.  Index outputs are int64.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as _F

from ..core import dtype as _dt
from ..core.tensor import Tensor, apply
from ._common import data as _to_data, ints as _ints

builtins_sum = builtins.sum


def reshape(x, shape, name=None):
    s = _ints(shape)
    return apply("reshape", lambda a: torch.reshape(a, s), x)


def reshape_(x, shape, name=None):
    return x._inplace(lambda: reshape(x, shape))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    def f(a):
        nd = a.ndim
        st = start_axis % nd if nd else 0
        sp = stop_axis % nd if nd else 0
        new_shape = a.shape[:st] + (-1,) + a.shape[sp + 1:]
        return torch.reshape(a, new_shape)
    return apply("flatten", f, x)


def squeeze(x, axis=None, name=None):
    def f(a):
        if axis is None:
            return torch.squeeze(a)
        axes = _ints(axis)
        axes = tuple(ax % a.ndim for ax in axes if a.shape[ax % a.ndim] == 1)
        return torch.squeeze(a, axes) if axes else a
    return apply("squeeze", f, x)


def squeeze_(x, axis=None, name=None):
    return x._inplace(lambda: squeeze(x, axis))


def _expand_dims(a, axes):
    """jnp.expand_dims: each axis names a position of the output."""
    nd = a.ndim + len(axes)
    for ax in sorted(ax % nd for ax in axes):
        a = a.unsqueeze(ax)
    return a


def unsqueeze(x, axis, name=None):
    axes = _ints(axis)
    return apply("unsqueeze", lambda a: _expand_dims(a, axes), x)


def unsqueeze_(x, axis, name=None):
    return x._inplace(lambda: unsqueeze(x, axis))


def transpose(x, perm, name=None):
    p = _ints(perm)
    return apply("transpose", lambda a: a.permute(*p), x)


def moveaxis(x, source, destination, name=None):
    return apply("moveaxis", lambda a: torch.movedim(a, _ints(source),
                                                     _ints(destination)), x)


def swapaxes(x, axis1, axis2, name=None):
    return apply("swapaxes", lambda a: torch.swapaxes(a, int(axis1), int(axis2)), x)


transpose_ = None
concat_list = None


def concat(x, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    tensors = list(x)
    return apply("concat", lambda *arrs: torch.cat(arrs, ax), *tensors)


def stack(x, axis=0, name=None):
    tensors = list(x)
    return apply("stack", lambda *arrs: torch.stack(arrs, axis), *tensors)


def unstack(x, axis=0, num=None, name=None):
    n = num if num is not None else x.shape[axis]
    outs = apply("unstack", lambda a: tuple(torch.movedim(a, axis, 0)[i]
                                            for i in range(n)), x)
    return list(outs)


def split(x, num_or_sections, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)

    def f(a):
        total = a.shape[ax]
        if isinstance(num_or_sections, int):
            if total % num_or_sections:
                raise ValueError(f"split: {total} does not divide into "
                                 f"{num_or_sections} equal sections")
            return tuple(torch.split(a, total // num_or_sections, ax))
        secs = [int(s.item()) if isinstance(s, Tensor) else int(s)
                for s in num_or_sections]
        known = builtins_sum(s for s in secs if s >= 0)
        secs = [s if s >= 0 else total - known for s in secs]
        return tuple(torch.split(a, secs, ax))
    return list(apply("split", f, x))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    def f(a):
        arg = num_or_indices if isinstance(num_or_indices, int) \
            else list(num_or_indices)
        return tuple(torch.tensor_split(a, arg, axis))
    return list(apply("tensor_split", f, x))


def tile(x, repeat_times, name=None):
    reps = _ints(repeat_times)
    return apply("tile", lambda a: torch.tile(a, reps), x)


def repeat_interleave(x, repeats, axis=None, name=None):
    def f(a):
        r = repeats if isinstance(repeats, int) else _to_data(repeats, a.device)
        return torch.repeat_interleave(a, r, axis)
    return apply("repeat_interleave", f, x)


def expand(x, shape, name=None):
    s = _ints(shape)

    def f(a):
        tgt = list(s)
        src = [1] * (len(tgt) - a.ndim) + list(a.shape)
        tgt = [src[i] if tgt[i] == -1 else tgt[i] for i in range(len(tgt))]
        return a.reshape(src).expand(tgt)
    return apply("expand", f, x)


def expand_as(x, y, name=None):
    return apply("expand_as", lambda a, b: torch.broadcast_to(a, b.shape), x, y)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    outs = apply("broadcast_tensors", lambda *arrs: tuple(torch.broadcast_tensors(*arrs)),
                 *inputs)
    return list(outs)


def flip(x, axis, name=None):
    axes = _ints(axis)
    return apply("flip", lambda a: torch.flip(a, axes), x)


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply("rot90", lambda a: torch.rot90(a, k, tuple(axes)), x)


def roll(x, shifts, axis=None, name=None):
    sh = _ints(shifts) if not isinstance(shifts, int) else shifts
    ax = _ints(axis) if axis is not None and not isinstance(axis, int) else axis
    return apply("roll", lambda a: torch.roll(a, sh, ax), x)


def _take(a, idx, ax):
    """jnp.take along `ax`: the index's shape replaces that axis."""
    ax = ax % a.ndim
    out = torch.index_select(a, ax, idx.reshape(-1).long())
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


def gather(x, index, axis=0, name=None):
    ax = int(axis.item()) if isinstance(axis, Tensor) else int(axis)
    return apply("gather", lambda a, idx: _take(a, idx, ax), x, index)


def _nd(idx):
    return tuple(torch.movedim(idx.long(), -1, 0))


def gather_nd(x, index, name=None):
    return apply("gather_nd", lambda a, idx: a[_nd(idx)], x, index)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply("take_along_axis",
                 lambda a, idx: torch.take_along_dim(a, idx.long(), axis),
                 arr, indices)


def put_along_axis(arr, indices, values, axis, reduce="assign", include_self=True,
                   broadcast=True, name=None):
    def f(a, idx, v):
        idx = idx.long()
        v = torch.broadcast_to(v, idx.shape).to(a.dtype)
        if reduce == "assign":
            return a.scatter(axis, idx, v)
        if reduce == "add":
            return a.scatter_add(axis, idx, v)
        red = {"mul": "prod", "multiply": "prod", "amax": "amax",
               "amin": "amin"}.get(reduce)
        if red is None:
            raise ValueError(f"unknown reduce {reduce}")
        return a.scatter_reduce(axis, idx, v, red, include_self=True)
    return apply("put_along_axis", f, arr, indices, values)


def scatter(x, index, updates, overwrite=True, name=None):
    def f(a, idx, upd):
        ii = (idx.long().reshape(-1),)
        upd = upd.to(a.dtype)
        if overwrite:
            return a.index_put(ii, upd)
        # paddle semantics: zero the rows then accumulate
        zeroed = a.index_put(ii, torch.zeros_like(upd))
        return zeroed.index_put(ii, upd, accumulate=True)
    return apply("scatter", f, x, index, updates)


def scatter_(x, index, updates, overwrite=True, name=None):
    return x._inplace(lambda: scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    return apply("scatter_nd_add", lambda a, idx, upd: a.index_put(
        _nd(idx), upd.to(a.dtype), accumulate=True), x, index, updates)


def scatter_nd(index, updates, shape, name=None):
    s = _ints(shape)

    def f(idx, upd):
        out = torch.zeros(s, dtype=upd.dtype, device=upd.device)
        return out.index_put(_nd(idx), upd, accumulate=True)
    return apply("scatter_nd", f, index, updates)


def index_select(x, index, axis=0, name=None):
    return apply("index_select", lambda a, idx: _take(a, idx, axis), x, index)


def index_sample(x, index, name=None):
    return apply("index_sample",
                 lambda a, idx: torch.take_along_dim(a, idx.long(), 1), x, index)


def index_add(x, index, axis, value, name=None):
    return apply("index_add", lambda a, idx, v: torch.index_add(
        a, axis, idx.long(), v.to(a.dtype)), x, index, value)


def index_put(x, indices, value, accumulate=False, name=None):
    def f(a, v, *idx):
        ii = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
        if accumulate:
            return a.index_put(ii, v.to(a.dtype), accumulate=True)
        return a.index_put(ii, torch.broadcast_to(v, a[ii].shape).to(a.dtype))
    return apply("index_put", f, x, value, *indices)


def masked_select(x, mask, name=None):
    # a new tensor outside the graph, as the reference's host gather gives
    return Tensor._wrap(torch.masked_select(_to_data(x).detach(),
                                            _to_data(mask).bool()))


def masked_fill(x, mask, value, name=None):
    v = value.item() if isinstance(value, Tensor) and value.size == 1 else value

    def f(a, m):
        return torch.where(m.bool(), torch.as_tensor(v, dtype=a.dtype, device=a.device), a)
    return apply("masked_fill", f, x, mask)


def masked_fill_(x, mask, value, name=None):
    return x._inplace(lambda: masked_fill(x, mask, value))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return apply("where", lambda c, a, b: torch.where(c.bool(), a, b), condition, x, y)


def where_(condition, x, y, name=None):
    return x._inplace(lambda: where(condition, x, y))


def nonzero(x, as_tuple=False):
    nz = torch.nonzero(_to_data(x))                     # [N, ndim] int64
    if as_tuple:
        return tuple(Tensor._wrap(nz[:, i:i + 1].clone())
                     for i in range(nz.shape[1]))
    return Tensor._wrap(nz)


def _pad_widths(p, nd, data_format):
    if len(p) == 2 * nd:
        return [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    # paddle NCHW convention: pad applies to last len(p)//2 spatial dims, reversed
    width = [(0, 0)] * nd
    np_ = len(p) // 2
    if data_format.endswith("HWC") or data_format in ("NLC", "NHWC", "NDHWC"):
        dims = list(range(1, 1 + np_))
    else:
        dims = list(range(nd - np_, nd))
    for i, d in enumerate(dims):
        width[d] = (p[2 * i], p[2 * i + 1])
    return width


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    p = _ints(pad)
    np_mode = {"constant": "constant", "reflect": "reflect", "replicate": "edge",
               "circular": "wrap"}[mode]

    def f(a):
        width = _pad_widths(p, a.ndim, data_format)
        if np_mode == "constant":
            flat = [w for lo_hi in reversed(width) for w in lo_hi]
            return _F.pad(a, flat, "constant", value)
        # numpy's index map of each padded dim, gathered on the device
        for d, (lo, hi) in enumerate(width):
            if lo or hi:
                src = np.pad(np.arange(a.shape[d]), (lo, hi), mode=np_mode)
                a = torch.index_select(a, d, torch.from_numpy(src).to(a.device))
        return a
    return apply("pad", f, x)


def cast(x, dtype):
    td = _dt.to_torch(dtype)
    return apply("cast", lambda a: a.to(td), x)


def _slice_dim(a, d, sl):
    """a[..., sl, ...] at dim d; a negative step (which torch slicing
    refuses) as an index_select of numpy's positions."""
    if sl.step is None or sl.step > 0:
        idx = [builtins.slice(None)] * a.ndim
        idx[d] = sl
        return a[tuple(idx)]
    pos = np.ascontiguousarray(np.arange(a.shape[d])[sl])
    return torch.index_select(a, d, torch.from_numpy(pos).to(a.device))


def slice(input, axes, starts, ends):
    ax, st, en = _ints(axes), _ints(starts), _ints(ends)

    def f(a):
        for i, axis in enumerate(ax):
            a = _slice_dim(a, axis, builtins.slice(st[i], en[i]))
        return a
    return apply("slice", f, input)


def strided_slice(x, axes, starts, ends, strides, name=None):
    ax, st, en, sr = _ints(axes), _ints(starts), _ints(ends), _ints(strides)

    def f(a):
        for i, axis in enumerate(ax):
            a = _slice_dim(a, axis, builtins.slice(st[i], en[i], sr[i]))
        return a
    return apply("strided_slice", f, x)


def unbind(input, axis=0):
    n = input.shape[axis]
    outs = apply("unbind", lambda a: tuple(torch.movedim(a, axis, 0)[i]
                                           for i in range(n)), input)
    return list(outs)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None,
           dtype="int64", name=None):
    """numpy's `unique` on the device: sorted values, and on request the
    first index of each, the inverse (the input's shape when `axis` is
    None, as numpy 2 gives it) and the counts, all int64."""
    a = _to_data(x).detach()
    src = a.reshape(-1) if axis is None else a
    vals, inv, cnt = torch.unique(src, sorted=True, return_inverse=True,
                                  return_counts=True, dim=axis)
    outs = [vals]
    if return_index:
        pos = torch.arange(inv.numel(), device=a.device)
        first = torch.full((cnt.numel(),), inv.numel(), dtype=torch.int64,
                           device=a.device)
        outs.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        outs.append(inv.reshape(a.shape) if axis is None else inv)
    if return_counts:
        outs.append(cnt)
    if len(outs) == 1:
        return Tensor._wrap(vals)
    return tuple(Tensor._wrap(o) for o in outs)


def unique_consecutive(x, return_inverse=False, return_counts=False, axis=None,
                       dtype="int64", name=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    flat = _to_data(x).detach().reshape(-1)
    out, inv, cnt = torch.unique_consecutive(flat, return_inverse=True,
                                             return_counts=True)
    outs = [out] + ([inv] if return_inverse else []) + \
        ([cnt] if return_counts else [])
    outs = [Tensor._wrap(o) for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def as_complex(x, name=None):
    return apply("as_complex", lambda a: torch.complex(a[..., 0], a[..., 1]), x)


def as_real(x, name=None):
    return apply("as_real", lambda a: torch.stack([torch.real(a), torch.imag(a)], -1), x)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.astype(shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, other.shape)


def as_strided(x, shape, stride, offset=0, name=None):
    """`torch.as_strided` over a contiguous copy: `offset` counts elements
    from the start of `x`'s data, as the reference's flat-index
    emulation does."""
    shp, st = _ints(shape), _ints(stride)

    def f(a):
        c = a.contiguous()
        return torch.as_strided(c, shp, st, c.storage_offset() + int(offset))
    return apply("as_strided", f, x)


def atleast_1d(*inputs, name=None):
    outs = [apply("atleast_1d", torch.atleast_1d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [apply("atleast_2d", torch.atleast_2d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [apply("atleast_3d", torch.atleast_3d, x) for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    def f(a):
        size = (index_num + nshards - 1) // nshards
        lo = shard_id * size
        inshard = (a >= lo) & (a < lo + size)
        return torch.where(inshard, a - lo, ignore_value)
    return apply("shard_index", f, input)


def crop(x, shape=None, offsets=None, name=None):
    s = _ints(shape)
    off = _ints(offsets) if offsets is not None else (0,) * len(s)

    def f(a):
        idx = tuple(builtins.slice(off[i], off[i] + (s[i] if s[i] != -1 else a.shape[i] - off[i]))
                    for i in range(a.ndim))
        return a[idx]
    return apply("crop", f, x)


def _scalar(v, dtype, like):
    return Tensor._wrap(torch.tensor(v, dtype=dtype, device=like.device))


def numel(x, name=None):
    a = _to_data(x)
    return _scalar(a.numel(), torch.int64, a)


def rank(input):
    a = _to_data(input)
    return _scalar(a.ndim, torch.int32, a)


def shape(input):
    a = _to_data(input)
    return _scalar(list(a.shape), torch.int32, a)


def is_tensor(x):
    return isinstance(x, Tensor)


def is_empty(x, name=None):
    a = _to_data(x)
    return _scalar(a.numel() == 0, torch.bool, a)


def is_complex(x):
    return _to_data(x).is_complex()


def is_floating_point(x):
    return _to_data(x).is_floating_point()


def is_integer(x):
    a = _to_data(x)
    return not (a.is_floating_point() or a.is_complex() or a.dtype == torch.bool)


def rad2deg_(x):
    return x._inplace(lambda: apply("rad2deg", torch.rad2deg, x))


# ---- breadth additions (reference python/paddle/tensor/manipulation.py) ----

def unflatten(x, axis, shape, name=None):
    """Split one axis into the given shape (ref manipulation.py unflatten)."""
    shape = [int(s) for s in shape]

    def f(a):
        ax = axis % a.ndim
        new = list(a.shape[:ax]) + shape + list(a.shape[ax + 1:])
        # resolve a single -1
        if -1 in shape:
            known = int(np.prod([s for s in shape if s != -1]))
            new[new.index(-1, ax)] = a.shape[ax] // known
        return a.reshape(new)
    return apply("unflatten", f, x)


def unfold(x, axis, size, step, name=None):
    """Sliding windows along axis (ref tensor.unfold): returns [..., n, size]."""
    return apply("unfold", lambda a: a.unfold(axis % a.ndim, size, step), x)


def vsplit(x, num_or_indices, name=None):
    """Split along axis 0 (ref manipulation.py vsplit)."""
    return tensor_split(x, num_or_indices, axis=0)


def reverse(x, axis, name=None):
    """Deprecated alias of flip (ref legacy reverse op)."""
    return flip(x, axis)
