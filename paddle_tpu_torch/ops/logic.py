"""Logical/comparison ops (reference: `python/paddle/tensor/logic.py`)."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor, apply  # noqa: F401


def _out(r, out):
    if out is not None:
        out._rebind(r._t)
        return out
    return r


def _bin(name, tfn):
    def op(x, y, out=None, name=None):
        return _out(apply(nm, tfn, x, y), out)
    nm = name
    op.__name__ = name
    return op


equal = _bin("equal", torch.eq)
not_equal = _bin("not_equal", torch.ne)
less_than = _bin("less_than", torch.lt)
less_equal = _bin("less_equal", torch.le)
greater_than = _bin("greater_than", torch.gt)
greater_equal = _bin("greater_equal", torch.ge)
logical_and = _bin("logical_and", torch.logical_and)
logical_or = _bin("logical_or", torch.logical_or)
logical_xor = _bin("logical_xor", torch.logical_xor)
bitwise_and = _bin("bitwise_and", torch.bitwise_and)
bitwise_or = _bin("bitwise_or", torch.bitwise_or)
bitwise_xor = _bin("bitwise_xor", torch.bitwise_xor)


def logical_not(x, out=None, name=None):
    return _out(apply("logical_not", torch.logical_not, x), out)


def bitwise_not(x, out=None, name=None):
    return apply("bitwise_not", torch.bitwise_not, x)


def equal_all(x, y, name=None):
    def f(a, b):
        if a.shape != b.shape:
            return torch.zeros((), dtype=torch.bool, device=a.device)
        return torch.all(a == b)
    return apply("equal_all", f, x, y)


def _promoted(a, b):
    d = torch.promote_types(a.dtype, b.dtype)
    return a.to(d), b.to(d)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("allclose", lambda a, b: torch.all(torch.isclose(
        *_promoted(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan)), x, y)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return apply("isclose", lambda a, b: torch.isclose(
        *_promoted(a, b), rtol=rtol, atol=atol, equal_nan=equal_nan), x, y)
