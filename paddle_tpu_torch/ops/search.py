"""Search/sort ops (reference: `python/paddle/tensor/search.py`).

Ties keep the reference's order on every device: `argsort` and `topk` run
a stable sort (`lax.top_k` puts the lower index first among equal values;
`torch.topk` promises no order for them on the card), `argmax`/`argmin`
take the first extreme, as torch and jnp both do.  Indices are int64.
"""
from __future__ import annotations

import torch

from ..core import dtype as _dt
from ..core.tensor import Tensor, apply


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    def f(a):
        if axis is None:
            out = torch.argmax(a.reshape(-1))
        else:
            out = torch.argmax(a, axis, keepdim)
        return out.to(_dt.to_torch(dtype))
    return apply("argmax", f, x)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    def f(a):
        if axis is None:
            out = torch.argmin(a.reshape(-1))
        else:
            out = torch.argmin(a, axis, keepdim)
        return out.to(_dt.to_torch(dtype))
    return apply("argmin", f, x)


def _stable_order(a, axis, descending):
    """Indices of a stable sort along `axis`; descending sorts `-a`
    ascending, as the reference does, so NaN goes last either way."""
    if descending and (a.is_floating_point() or a.is_complex()):
        return torch.argsort(-a, dim=axis, stable=True)
    return torch.argsort(a, dim=axis, descending=descending, stable=True)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return apply("argsort", lambda a: _stable_order(a, axis, descending), x)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    def f(a):
        out = torch.take_along_dim(a, _stable_order(a, axis, False), axis)
        return torch.flip(out, (axis,)) if descending else out
    return apply("sort", f, x)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    kk = int(k.item()) if isinstance(k, Tensor) else int(k)

    def f(a):
        ax = axis if axis is not None else a.ndim - 1
        moved = torch.movedim(a, ax, -1)
        idx = _stable_order(moved, -1, largest)[..., :kk]
        vals = torch.take_along_dim(moved, idx, -1)
        return torch.movedim(vals, -1, ax), torch.movedim(idx, -1, ax)
    return apply("topk", f, x)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    def f(a):
        ids = _stable_order(a, axis, False)
        srt = torch.take_along_dim(a, ids, axis)
        vals = srt.select(axis, k - 1)
        inds = ids.select(axis, k - 1)
        if keepdim:
            vals, inds = vals.unsqueeze(axis), inds.unsqueeze(axis)
        return vals, inds
    return apply("kthvalue", f, x)


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the smallest among equally
    frequent ones) and the first index where it occurs, as the reference
    picks them."""
    def f(a):
        moved = torch.movedim(a, axis, -1)
        srt = torch.sort(moved, -1).values
        runs = torch.ones_like(srt, dtype=torch.bool)
        runs[..., 1:] = srt[..., 1:] != srt[..., :-1]
        run_id = torch.cumsum(runs, -1) - 1                  # 0-based run
        per_run = torch.zeros_like(run_id).scatter_add_(
            -1, run_id, torch.ones_like(run_id))
        counts = torch.gather(per_run, -1, run_id)
        best = torch.argmax(counts, -1, keepdim=True)
        vals = torch.gather(srt, -1, best)[..., 0]
        idx = torch.argmax((moved == vals[..., None]).to(torch.uint8), -1)
        if keepdim:
            vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
        return vals, idx
    return apply("mode", f, x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False, name=None):
    return apply("searchsorted", lambda seq, v: torch.searchsorted(
        seq, v, out_int32=out_int32, right=right), sorted_sequence, values)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return apply("bucketize", lambda v, seq: torch.bucketize(
        v, seq, out_int32=out_int32, right=right), x, sorted_sequence)
