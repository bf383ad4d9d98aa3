"""Tensor creation ops (reference: `python/paddle/tensor/creation.py`).

New tensors go on the expected place (`set_device`), never on torch's
default CPU; dtypes default as `core/dtype.py` says.  Integer ranges and
index lists are int64, as in Paddle (the reference's JAX runs with 64-bit
types off and gives int32).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as _dt
from ..core.place import expected_device
from ..core.tensor import Tensor, apply, to_tensor  # noqa: F401
from ._common import data as _to_data, item as _val, shape as _shape


def _tdt(dtype, default=None):
    d = dtype if dtype is not None else default
    return None if d is None else _dt.to_torch(d)


def _new(t: torch.Tensor) -> Tensor:
    return Tensor._wrap(t)


def zeros(shape, dtype=None, name=None):
    return _new(torch.zeros(_shape(shape), dtype=_tdt(dtype, _dt._default_dtype),
                            device=expected_device()))


def ones(shape, dtype=None, name=None):
    return _new(torch.ones(_shape(shape), dtype=_tdt(dtype, _dt._default_dtype),
                           device=expected_device()))


def full(shape, fill_value, dtype=None, name=None):
    fv = _val(fill_value)
    if dtype is None:
        dtype = _dt._default_dtype if isinstance(fv, float) else None
    return _new(torch.full(_shape(shape), fv, dtype=_tdt(dtype),
                           device=expected_device()))


def zeros_like(x, dtype=None, name=None):
    return _new(torch.zeros_like(_to_data(x), dtype=_tdt(dtype)))


def ones_like(x, dtype=None, name=None):
    return _new(torch.ones_like(_to_data(x), dtype=_tdt(dtype)))


def full_like(x, fill_value, dtype=None, name=None):
    return _new(torch.full_like(_to_data(x), _val(fill_value),
                                dtype=_tdt(dtype)))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _val(start), _val(end), _val(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = _dt._default_dtype if any(isinstance(v, float) for v in (start, end, step)) \
            else _dt.int64
    return _new(torch.arange(start, end, step, dtype=_tdt(dtype),
                             device=expected_device()))


def linspace(start, stop, num, dtype=None, name=None):
    return _new(torch.linspace(_val(start), _val(stop), int(_val(num)),
                               dtype=_tdt(dtype, _dt._default_dtype),
                               device=expected_device()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return _new(torch.logspace(_val(start), _val(stop), int(_val(num)),
                               base=base, dtype=_tdt(dtype, _dt._default_dtype),
                               device=expected_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return _new(torch.eye(n, m, dtype=_tdt(dtype, _dt._default_dtype),
                          device=expected_device()))


def meshgrid(*args, **kwargs):
    # new tensors outside the graph, as the reference's are
    datas = [_to_data(a).detach() for a in args]
    return [_new(o.clone()) for o in torch.meshgrid(*datas, indexing="ij")]


def diag(x, offset=0, padding_value=0, name=None):
    def f(a):
        if a.ndim == 1:
            out = torch.diag(a, offset)
            if padding_value != 0:
                mask = torch.diag(torch.ones(a.shape[0], dtype=torch.bool,
                                             device=a.device), offset)
                out = torch.where(mask, out, torch.as_tensor(
                    padding_value, dtype=out.dtype, device=out.device))
            return out
        return torch.diagonal(a, offset)
    return apply("diag", f, x)


def diagflat(x, offset=0, name=None):
    return apply("diagflat", lambda a: torch.diagflat(a, offset), x)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return apply("diag_embed",
                 lambda a: torch.diag_embed(a, offset, dim1, dim2), x)


def tril(x, diagonal=0, name=None):
    return apply("tril", lambda a: torch.tril(a, diagonal), x)


def triu(x, diagonal=0, name=None):
    return apply("triu", lambda a: torch.triu(a, diagonal), x)


def tril_indices(row, col, offset=0, dtype="int64"):
    r, c = np.tril_indices(row, offset, col)
    return _new(torch.from_numpy(np.stack([r, c])).to(
        device=expected_device(), dtype=_tdt(dtype)))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    r, c = np.triu_indices(row, offset, col if col is not None else row)
    return _new(torch.from_numpy(np.stack([r, c])).to(
        device=expected_device(), dtype=_tdt(dtype)))


def assign(x, output=None):
    d = _to_data(x).detach()
    if output is None:
        return _new(d.clone())
    return output._replace(d)


def clone(x, name=None):
    return x.clone() if isinstance(x, Tensor) else _new(_to_data(x).clone())


def complex(real, imag, name=None):
    return apply("complex", torch.complex, real, imag)


def polar(abs_t, angle, name=None):
    return apply("polar", torch.polar, abs_t, angle)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..core.tensor import Parameter
    p = Parameter(torch.zeros(_shape(shape), dtype=_tdt(dtype),
                              device=expected_device()), name=name)
    if default_initializer is not None:
        default_initializer(p)
    return p


# ---- breadth additions (reference python/paddle/tensor/creation.py) ----

def vander(x, n=None, increasing=False, name=None):
    """Vandermonde matrix (ref creation.py vander)."""
    def f(a):
        cols = a.shape[0] if n is None else int(n)
        p = torch.arange(cols, device=a.device)
        if not increasing:
            p = p.flip(0)
        return a[:, None].to(torch.promote_types(a.dtype, torch.float32)) ** p[None]
    return apply("vander", f, x)


def create_tensor(dtype, name=None, persistable=False):
    """ref creation.py create_tensor: an empty typed tensor handle."""
    return _new(torch.zeros((0,), dtype=_tdt(dtype), device=expected_device()))
