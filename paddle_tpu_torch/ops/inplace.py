"""Trailing-underscore in-place op variants.

Reference parity: `python/paddle/tensor/math.py` etc. register `<op>_` dygraph-only
in-place APIs (inplace_apis_in_dygraph_only).  Each variant computes the op
out of place and rebinds the tensor to the result (`Tensor._inplace`), after
bumping the tensor's version: a node recorded before that read it raises
"modified by an inplace operation" at backward, as the reference's inplace
version check does; the op's own node does not.
"""
from __future__ import annotations

from . import logic, manipulation, math


def _inplace(fn, name):
    def op_(x, *args, **kwargs):
        return x._inplace(lambda: fn(x, *args, **kwargs))
    op_.__name__ = name
    op_.__qualname__ = name
    op_.__doc__ = f"In-place variant of `{fn.__module__.split('.')[-1]}.{fn.__name__}`."
    return op_


_SPECS = {
    math: [
        "abs", "acos", "asin", "atan", "ceil", "clip", "cos", "cosh", "digamma",
        "erf", "erfinv", "exp", "expm1", "floor", "frac", "i0", "lerp", "lgamma",
        "log", "log10", "log1p", "log2", "logit", "multiply", "neg", "polygamma",
        "pow", "reciprocal", "remainder", "round", "rsqrt", "sigmoid", "sin",
        "sinh", "sqrt", "square", "subtract", "tan", "tanh", "trunc", "addmm",
        "divide", "floor_divide", "mod", "nan_to_num",
    ],
    logic: [
        "greater_equal", "greater_than", "less_equal", "less_than", "not_equal",
        "equal", "logical_and", "logical_not", "logical_or", "logical_xor",
        "bitwise_and", "bitwise_not", "bitwise_or", "bitwise_xor",
    ],
    manipulation: [
        "flatten", "index_put", "put_along_axis", "cast",
    ],
}

__all__ = []
for _mod, _names in _SPECS.items():
    for _n in _names:
        _fn = getattr(_mod, _n, None)
        if _fn is None:
            continue
        _name = _n + "_"
        globals()[_name] = _inplace(_fn, _name)
        __all__.append(_name)


def tril_(x, diagonal=0, name=None):
    from .creation import tril
    return x._inplace(lambda: tril(x, diagonal))


def triu_(x, diagonal=0, name=None):
    from .creation import triu
    return x._inplace(lambda: triu(x, diagonal))


def renorm_(x, p, axis, max_norm, name=None):
    return x._inplace(lambda: math.renorm(x, p, axis, max_norm))


__all__ += ["tril_", "triu_", "renorm_"]


def add_(x, y, name=None):
    return x.add_(y)


def scale_(x, scale=1.0, bias=0.0, name=None):
    return x.scale_(scale, bias)


__all__ += ["add_", "scale_"]
