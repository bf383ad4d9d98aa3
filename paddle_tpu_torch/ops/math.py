"""Math ops (reference: `python/paddle/tensor/math.py`, `ops.py`).

Every function dispatches through `core.tensor.apply`, so torch autograd
records it and AMP casts its inputs, exactly like a generated ad_func in
the reference.  The reference's `jax.scipy.special` functions are
`torch.special`'s.  Integer sums, cumulative sums, products and counts are
int64, as torch and Paddle give them (the reference's JAX, with 64-bit
types off, gives int32).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import dtype as _dt
from ..core.tensor import Tensor, apply
from ._common import axis as _axis, data as _to_data, dims as _dims


def _unary(name, tfn):
    def op(x, name=None):
        return apply(name_, tfn, x)
    name_ = name
    op.__name__ = name
    return op


def _binary(name, tfn):
    def op(x, y, name=None):
        return apply(name_, tfn, x, y)
    name_ = name
    op.__name__ = name
    return op


def _tdt(dtype):
    return _dt.to_torch(dtype) if dtype is not None else None


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _sign(x):
    """jnp.sign: x/|x| for complex x, NaN for NaN (torch's sign gives 0)."""
    s = torch.sgn(x)
    return torch.where(torch.isnan(x), x, s) if x.is_floating_point() else s


# ---- unary elementwise ----
abs = _unary("abs", torch.abs)
acos = _unary("acos", torch.acos)
acosh = _unary("acosh", torch.acosh)
asin = _unary("asin", torch.asin)
asinh = _unary("asinh", torch.asinh)
atan = _unary("atan", torch.atan)
atanh = _unary("atanh", torch.atanh)
ceil = _unary("ceil", torch.ceil)
conj = _unary("conj", torch.conj_physical)
cos = _unary("cos", torch.cos)
cosh = _unary("cosh", torch.cosh)
digamma = _unary("digamma", torch.special.digamma)
erf = _unary("erf", torch.special.erf)
erfinv = _unary("erfinv", torch.special.erfinv)
exp = _unary("exp", torch.exp)
expm1 = _unary("expm1", torch.expm1)
floor = _unary("floor", torch.floor)
frac = _unary("frac", lambda x: x - torch.trunc(x))
i0 = _unary("i0", torch.special.i0)
i0e = _unary("i0e", torch.special.i0e)
i1 = _unary("i1", torch.special.i1)
i1e = _unary("i1e", torch.special.i1e)
lgamma = _unary("lgamma", torch.special.gammaln)
log = _unary("log", torch.log)
log10 = _unary("log10", torch.log10)
log1p = _unary("log1p", torch.log1p)
log2 = _unary("log2", torch.log2)
neg = _unary("neg", torch.neg)
reciprocal = _unary("reciprocal", torch.reciprocal)
round = _unary("round", torch.round)
rsqrt = _unary("rsqrt", torch.rsqrt)
sgn = _unary("sgn", _sign)
sign = _unary("sign", _sign)
sin = _unary("sin", torch.sin)
sinh = _unary("sinh", torch.sinh)
sqrt = _unary("sqrt", torch.sqrt)
square = _unary("square", torch.square)
tan = _unary("tan", torch.tan)
tanh = _unary("tanh", torch.tanh)
trunc = _unary("trunc", torch.trunc)
angle = _unary("angle", torch.angle)
real = _unary("real", torch.real)
imag = _unary("imag", _imag)
isfinite = _unary("isfinite", torch.isfinite)
isinf = _unary("isinf", torch.isinf)
isnan = _unary("isnan", torch.isnan)
isneginf = _unary("isneginf", torch.isneginf)
isposinf = _unary("isposinf", torch.isposinf)
isreal = _unary("isreal", torch.isreal)
deg2rad = _unary("deg2rad", torch.deg2rad)
rad2deg = _unary("rad2deg", torch.rad2deg)
exponential_ = None  # random module provides

# ---- binary elementwise ----
add = _binary("add", torch.add)
subtract = _binary("subtract", torch.sub)
multiply = _binary("multiply", torch.mul)
divide = _binary("divide", torch.true_divide)
floor_divide = _binary("floor_divide", torch.floor_divide)
mod = _binary("remainder", torch.remainder)
remainder = mod
floor_mod = mod
pow = _binary("pow", torch.pow)
maximum = _binary("maximum", torch.maximum)
minimum = _binary("minimum", torch.minimum)
fmax = _binary("fmax", torch.fmax)
fmin = _binary("fmin", torch.fmin)
atan2 = _binary("atan2", torch.atan2)
logaddexp = _binary("logaddexp", torch.logaddexp)
hypot = _binary("hypot", lambda x, y: torch.sqrt(x * x + y * y))
copysign = _binary("copysign", torch.copysign)
nextafter = _binary("nextafter", torch.nextafter)
ldexp = _binary("ldexp", lambda x, y: x * torch.pow(2.0, y).to(x.dtype)
                if x.is_floating_point() else x * (2 ** y))
gammaln = lgamma
polygamma = lambda x, n, name=None: apply(  # noqa: E731
    "polygamma", lambda a: torch.special.polygamma(n, a), x)
heaviside = _binary("heaviside", lambda x, y: torch.where(
    x < 0, 0.0, torch.where(x > 0, 1.0, y)).to(x.dtype))
inner = _binary("inner", torch.inner)
outer = _binary("outer", lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)))
kron = _binary("kron", torch.kron)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    s = scale.item() if isinstance(scale, Tensor) else scale
    if bias_after_scale:
        out = apply("scale", lambda a: a * s + bias, x)
    else:
        out = apply("scale", lambda a: (a + bias) * s, x)
    return out


def clip(x, min=None, max=None, name=None):
    lo = min.item() if isinstance(min, Tensor) else min
    hi = max.item() if isinstance(max, Tensor) else max
    if lo is None and hi is None:
        return apply("clip", lambda a: a, x)
    return apply("clip", lambda a: torch.clamp(a, lo, hi), x)


def lerp(x, y, weight, name=None):
    if isinstance(weight, (int, float)):
        return apply("lerp", lambda a, b: a + weight * (b - a), x, y)
    return apply("lerp", lambda a, b, w: a + w * (b - a), x, y, weight)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply("stanh", lambda a: scale_b * torch.tanh(scale_a * a), x)


def multiplex(inputs, index, name=None):
    def f(idx, *ins):
        stacked = torch.stack(ins, 0)
        ii = idx.reshape((1, -1) + (1,) * (stacked.ndim - 2)).long()
        return torch.take_along_dim(stacked, ii, 0)[0]
    return apply("multiplex", f, index, *inputs)


# ---- matmul family ----
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        if transpose_x:
            a = a.transpose(-1, -2) if a.ndim > 1 else a
        if transpose_y:
            b = b.transpose(-1, -2) if b.ndim > 1 else b
        return torch.matmul(a, b)
    return apply("matmul", f, x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return apply("bmm", torch.matmul, x, y)


def dot(x, y, name=None):
    return apply("dot", lambda a, b: torch.sum(a * b, -1), x, y)


def mv(x, vec, name=None):
    return apply("mv", torch.matmul, x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return apply("addmm", lambda i, a, b: beta * i + alpha * torch.matmul(a, b),
                 input, x, y)


def t(x, name=None):
    return apply("t", lambda a: a.t() if a.ndim == 2 else a, x)


# ---- reductions ----
def _float(a):
    """Integer and bool data as the default float dtype (jnp's mean of
    integers is a float)."""
    if a.is_floating_point() or a.is_complex():
        return a
    return a.to(_dt._default_dtype.torch_dtype)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _axis(axis)
    td = _tdt(dtype)
    return apply("sum", lambda a: torch.sum(a, _dims(ax, a.ndim), keepdim,
                                            dtype=td), x)


def mean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("mean", lambda a: torch.mean(_float(a), _dims(ax, a.ndim),
                                              keepdim), x)


def _prod(a, ax, keepdim, dtype):
    if dtype is not None:
        a = a.to(dtype)
    if ax is None and not keepdim:
        return torch.prod(a)
    for d in sorted((d % a.ndim for d in _dims(ax, a.ndim)), reverse=True):
        a = torch.prod(a, d, keepdim)
    return a


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    ax = _axis(axis)
    td = _tdt(dtype)
    return apply("prod", lambda a: _prod(a, ax, keepdim, td), x)


def max(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("max", lambda a: torch.amax(a, _dims(ax, a.ndim), keepdim), x)


def min(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("min", lambda a: torch.amin(a, _dims(ax, a.ndim), keepdim), x)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("logsumexp", lambda a: torch.logsumexp(
        _float(a), _dims(ax, a.ndim), keepdim), x)


def all(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("all", lambda a: torch.all(a.bool(), _dims(ax, a.ndim), keepdim), x)


def any(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("any", lambda a: torch.any(a.bool(), _dims(ax, a.ndim), keepdim), x)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("count_nonzero", lambda a: torch.sum(
        a != 0, _dims(ax, a.ndim), keepdim), x)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    ax = _axis(axis)
    td = _tdt(dtype)
    return apply("nansum", lambda a: torch.nansum(a, _dims(ax, a.ndim), keepdim,
                                                  dtype=td), x)


def nanmean(x, axis=None, keepdim=False, name=None):
    ax = _axis(axis)
    return apply("nanmean", lambda a: torch.nanmean(
        _float(a), _dims(ax, a.ndim), keepdim), x)


# ---- cumulative ----
def cumsum(x, axis=None, dtype=None, name=None):
    td = _tdt(dtype)

    def f(a):
        if axis is None:
            return torch.cumsum(a.reshape(-1), 0, dtype=td)
        return torch.cumsum(a, int(axis), dtype=td)
    return apply("cumsum", f, x)


def cumprod(x, dim=None, dtype=None, name=None):
    td = _tdt(dtype)

    def f(a):
        if dim is None:
            return torch.cumprod(a.reshape(-1), 0, dtype=td)
        return torch.cumprod(a, int(dim), dtype=td)
    return apply("cumprod", f, x)


def _cum_extreme(a, axis, dtype, scan):
    """(running max or min, the last index at which it was reached) along
    `axis` (None: the flattened data), as the reference's two associative
    scans compute them: a tie takes the later index."""
    arr = a.reshape(-1) if axis is None else a
    ax = 0 if axis is None else axis % arr.ndim
    vals = scan(arr, ax).values
    idx = torch.arange(arr.shape[ax], device=arr.device).reshape(
        [-1 if i == ax else 1 for i in range(arr.ndim)])
    hit = torch.where(arr == vals, idx, -1)
    inds = torch.cummax(hit, ax).values
    return vals, inds.to(_dt.to_torch(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    return apply("cummax", lambda a: _cum_extreme(a, axis, dtype, torch.cummax), x)


def cummin(x, axis=None, dtype="int64", name=None):
    return apply("cummin", lambda a: _cum_extreme(a, axis, dtype, torch.cummin), x)


def logcumsumexp(x, axis=None, name=None):
    def f(a):
        arr = a.reshape(-1) if axis is None else a
        return torch.logcumsumexp(arr, 0 if axis is None else axis)
    return apply("logcumsumexp", f, x)


# ---- misc ----
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("trace", lambda a: torch.diagonal(a, offset, axis1, axis2).sum(-1), x)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return apply("diagonal", lambda a: torch.diagonal(a, offset, axis1, axis2), x)


def _edge(v, a, axis):
    """diff's prepend/append: a constant (the reference reads its data
    outside the graph), a scalar broadcast to one slice of `a`."""
    v = _to_data(v, a.device).detach().to(a.dtype)
    if v.ndim == 0:
        shape = list(a.shape)
        shape[axis] = 1
        v = v.expand(shape)
    return v


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    def f(a):
        pre = None if prepend is None else _edge(prepend, a, axis)
        app = None if append is None else _edge(append, a, axis)
        return torch.diff(a, n, axis, pre, app)
    return apply("diff", f, x)


def cross(x, y, axis=9, name=None):
    ax = axis if axis != 9 else None

    def f(a, b):
        use_ax = ax
        if use_ax is None:
            use_ax = next(i for i, s in enumerate(a.shape) if s == 3)
        return torch.linalg.cross(a, b, dim=use_ax)
    return apply("cross", f, x, y)


def gcd(x, y, name=None):
    return apply("gcd", torch.gcd, x, y)


def lcm(x, y, name=None):
    return apply("lcm", torch.lcm, x, y)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply("nan_to_num", lambda a: torch.nan_to_num(a, nan, posinf, neginf), x)


def take(x, index, mode="raise", name=None):
    def f(a, idx):
        flat = a.reshape(-1)
        n = flat.shape[0]
        ii = idx.long()
        if mode == "wrap":
            ii = torch.remainder(ii, n)
        else:
            ii = torch.clamp(torch.where(ii < 0, ii + n, ii), 0, n - 1)
        return flat[ii]
    return apply("take", f, x, index)


def increment(x, value=1.0, name=None):
    return x._replace(x._t + value)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    def f(pred, lab):
        topk = torch.argsort(-pred, dim=-1, stable=True)[:, :k]
        match = torch.any(topk == lab.reshape(-1, 1), -1)
        return torch.mean(match.float())
    return apply("accuracy", f, input, label)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


# ---- breadth additions (reference python/paddle/tensor/math.py) ----

sigmoid = _unary("sigmoid", torch.sigmoid)


def logit(x, eps=None, name=None):
    """ref `tensor/math.py` logit: log(p/(1-p)) with optional eps clamp."""
    def f(a):
        p = a if eps is None else torch.clamp(a, eps, 1.0 - eps)
        return torch.log(p) - torch.log1p(-p)
    return apply("logit", f, x)


def add_n(inputs, name=None):
    """Sum a list of same-shape tensors (ref `sum` op / add_n)."""
    if isinstance(inputs, Tensor):
        return inputs
    return apply("add_n", lambda *ts: functools.reduce(torch.add, ts), *inputs)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """Trapezoidal rule integral (ref tensor/math.py trapezoid)."""
    if x is not None:
        return apply("trapezoid", lambda yy, xx: torch.trapezoid(yy, xx, dim=axis),
                     y, x)
    d = 1.0 if dx is None else dx
    return apply("trapezoid", lambda yy: torch.trapezoid(yy, dx=d, dim=axis), y)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """Cumulative trapezoidal integral (ref tensor/math.py)."""
    def cum(yy, spacing):
        a = torch.movedim(yy, axis, -1)
        avg = (a[..., 1:] + a[..., :-1]) / 2.0
        seg = avg * spacing
        return torch.movedim(torch.cumsum(seg, -1), -1, axis)

    if x is not None:
        def f(yy, xx):
            xs = torch.movedim(xx, axis, -1) if xx.ndim == yy.ndim else xx
            return cum(yy, torch.diff(xs, dim=-1))
        return apply("cumulative_trapezoid", f, y, x)
    d = 1.0 if dx is None else dx
    return apply("cumulative_trapezoid", lambda yy: cum(yy, d), y)


def frexp(x, name=None):
    """Decompose x = m * 2**e with 0.5 <= |m| < 1 (ref tensor/math.py frexp)."""
    def f(a):
        zero = a == 0
        e = torch.where(zero, 0.0, torch.floor(torch.log2(torch.abs(
            torch.where(zero, 1.0, a)))) + 1)
        m = torch.where(zero, 0.0, a / torch.exp2(e))
        # normalize edge cases where |m| == 1 (log2 exactness)
        fix = torch.abs(m) >= 1.0
        e = torch.where(fix, e + 1, e)
        m = torch.where(fix, m / 2, m)
        return m, e.to(a.dtype)
    return apply("frexp", f, x)


def renorm(x, p, axis, max_norm, name=None):
    """Renormalize sub-tensors along axis to p-norm <= max_norm (ref renorm op)."""
    def f(a):
        red = tuple(i for i in range(a.ndim) if i != (axis % a.ndim))
        norms = torch.sum(torch.abs(a) ** p, red, keepdim=True) ** (1.0 / p)
        scale = torch.where(norms > max_norm, max_norm / (norms + 1e-7), 1.0)
        return a * scale
    return apply("renorm", f, x)
