"""Statistics ops (reference: `python/paddle/tensor/stat.py`).

`median`, `nanmedian`, `quantile` and `nanquantile` sort and interpolate
themselves, as `jnp.median`/`jnp.quantile` do: `torch.median` returns the
lower middle value (only `mode="min"`'s answer) and `torch.quantile`
refuses inputs above 2**24 elements, while these hold the reference's
answer at any size.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, apply  # noqa: F401
from ._common import axis as _axis, data as _to_data, dims as _dims
from .math import mean  # noqa: F401  (the reference's stat.mean is math's)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("var", lambda a: torch.var(a, _dims(ax, a.ndim),
                                            correction=1 if unbiased else 0,
                                            keepdim=keepdim), x)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("std", lambda a: torch.std(a, _dims(ax, a.ndim),
                                            correction=1 if unbiased else 0,
                                            keepdim=keepdim), x)


def _to_last(a, ax):
    """`a` with the reduced dims `ax` (None: all) flattened into one last
    dim, and a function putting a result over the other dims back into
    `keepdim` shape."""
    red = sorted(d % a.ndim for d in _dims(ax, a.ndim)) if a.ndim else []
    keep = [d for d in range(a.ndim) if d not in red]
    moved = a.permute(*keep, *red).reshape(*[a.shape[d] for d in keep], -1)

    def keepdims(out):
        lead = list(out.shape[:out.ndim - len(keep)])   # quantile's q dim
        full = [1 if d in red else a.shape[d] for d in range(a.ndim)]
        return out.reshape(lead + full)
    return moved, keepdims


def _middle(srt, count):
    """The mean of the two middle values of the first `count` sorted
    values of each row (the one middle value when `count` is odd)."""
    lo = torch.clamp((count - 1) // 2, min=0).unsqueeze(-1)
    hi = torch.clamp(count // 2, min=0).unsqueeze(-1)
    return ((torch.gather(srt, -1, lo) + torch.gather(srt, -1, hi)) / 2)[..., 0]


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = _axis(axis)

    def f(a):
        flat, keepdims = _to_last(a, ax)
        srt = torch.sort(flat, dim=-1, stable=True).values
        n = flat.shape[-1]
        if mode == "avg":
            count = torch.full(flat.shape[:-1], n, device=a.device)
            out = _middle(srt, count)
            out = torch.where(torch.isnan(flat).any(-1),
                              torch.full_like(out, float("nan")), out)
            return keepdims(out) if keepdim else out
        # min mode: lower of the two middles (keepdim only along an axis)
        out = srt[..., (n - 1) // 2]
        return keepdims(out) if keepdim and ax is not None else out
    return apply("median", f, x)


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    ax = _axis(axis)

    def f(a):
        flat, keepdims = _to_last(a, ax)
        srt = torch.sort(flat, dim=-1, stable=True).values    # NaN last
        count = (~torch.isnan(flat)).sum(-1)
        out = _middle(srt, count)
        out = torch.where(count == 0, torch.full_like(out, float("nan")), out)
        return keepdims(out) if keepdim else out
    return apply("nanmedian", f, x)


def _quantile(a, q, ax, keepdim, method, ignore_nan):
    """jnp's quantile (the methods linear, lower, higher, nearest,
    midpoint) over the dims `ax` of float32 `a`; a q vector adds a
    leading dim."""
    flat, keepdims = _to_last(a.float(), ax)
    srt = torch.sort(flat, dim=-1, stable=True).values        # NaN last
    n = flat.shape[-1]
    if ignore_nan:
        count = (~torch.isnan(flat)).sum(-1, keepdim=True)
    else:
        count = torch.full(flat.shape[:-1] + (1,), n, device=a.device)
    qs = q.float().reshape(-1)
    pos = qs.reshape((-1,) + (1,) * srt.ndim) * (count - 1).float()  # [Q, ..., 1]
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    last = torch.clamp(count - 1, min=0)
    src = srt.expand((qs.numel(),) + srt.shape)
    v_lo = torch.gather(src, -1, torch.clamp(lo.long(), min=0).minimum(last))
    v_hi = torch.gather(src, -1, torch.clamp(hi.long(), min=0).minimum(last))
    if method == "linear":
        out = v_lo * (1 - w_hi) + v_hi * w_hi
    elif method == "lower":
        out = v_lo
    elif method == "higher":
        out = v_hi
    elif method == "nearest":       # jnp: a half goes to the lower value
        out = torch.where(w_hi <= 0.5, v_lo, v_hi)
    elif method == "midpoint":
        out = (v_lo + v_hi) * 0.5
    else:
        raise ValueError(f"unknown interpolation {method!r}")
    out = out[..., 0]
    bad = (count == 0)[..., 0] if ignore_nan else torch.isnan(flat).any(-1)
    out = torch.where(bad, torch.full_like(out, float("nan")), out)
    if keepdim:
        out = keepdims(out)
    return out if q.ndim else out[0]


def quantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    ax = _axis(axis)
    return apply("quantile", lambda a: _quantile(
        a, _to_data(q, a.device), ax, keepdim, interpolation, False), x)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear", name=None):
    ax = _axis(axis)
    return apply("nanquantile", lambda a: _quantile(
        a, _to_data(q, a.device), ax, keepdim, interpolation, True), x)
