"""The op cases that the port's op twins share (numpy only, so that a
machine without jax can load it).

A case names an op call as `fn(ns, *tensors)`, where `ns` is the package
(`paddle_tpu` or `paddle_tpu_torch`), its numpy inputs (seeded), a numpy
oracle where there is one, whether its gradient is held too, and its
tolerance: float32 2e-5 abs and rel, as the reference sweep uses, and
DECOMP_TOL where a decomposition is compared through a reconstruction.
`tests/torch_op_test.py` runs a case through both packages on the CPU;
`port_on_device` runs it through the port on a CUDA card against the port
on the CPU (the cuda-marked twin and `chip_smoke.py`'s phase 8d).

Tables: SWEEP mirrors `tests/test_ops_sweep.py`'s ALL_CASES row for row,
MATH `tests/test_ops_math.py`, BREADTH the ops-only cases of
`tests/test_ops_breadth.py`, and TROUBLE the spots where torch and jnp
differ by default (ties, even-count medians, pivots, strides, drivers)
and the rest of the namespace, a few ops a case.
"""
import numpy as np

TOL = 2e-5
DECOMP_TOL = 1e-4


class Case:
    def __init__(self, name, fn, inputs, oracle=None, grad=False, tol=TOL):
        self.name, self.fn, self.inputs = name, fn, list(inputs)
        self.oracle, self.grad, self.tol = oracle, grad, tol

    def __repr__(self):
        return self.name


def call(name):
    """A case fn calling the op `name` of the namespace on the tensors."""
    def fn(ns, *ts):
        return getattr(ns, name)(*ts)
    return fn


# ---------------------------------------------------------------------------
# SWEEP: tests/test_ops_sweep.py's ALL_CASES, same data (RandomState(7))
# ---------------------------------------------------------------------------

_rng = np.random.RandomState(7)
POS = _rng.rand(3, 4).astype(np.float32) + 0.5
UNIT = (_rng.rand(3, 4).astype(np.float32) * 1.6 - 0.8)
ANY = _rng.randn(3, 4).astype(np.float32)
ANY2 = _rng.randn(3, 4).astype(np.float32)
POSB = _rng.rand(3, 4).astype(np.float32) + 0.5
INTS = _rng.randint(0, 5, (3, 4)).astype(np.int64)
_LOGIT = _rng.rand(3, 4).astype(np.float32) * 0.8 + 0.1


def _sweep(name, op, oracle, inputs, grad):
    return Case(name, op if callable(op) else call(op), inputs, oracle, grad)


SWEEP_UNARY = [
    _sweep("abs", "abs", np.abs, [ANY], True),
    _sweep("acos", "acos", np.arccos, [UNIT], True),
    _sweep("acosh", "acosh", np.arccosh, [POS + 1.0], True),
    _sweep("asin", "asin", np.arcsin, [UNIT], True),
    _sweep("asinh", "asinh", np.arcsinh, [ANY], True),
    _sweep("atan", "atan", np.arctan, [ANY], True),
    _sweep("atanh", "atanh", np.arctanh, [UNIT], True),
    _sweep("ceil", "ceil", np.ceil, [ANY], False),
    _sweep("cos", "cos", np.cos, [ANY], True),
    _sweep("cosh", "cosh", np.cosh, [ANY], True),
    _sweep("erf", "erf", None, [ANY], True),
    _sweep("exp", "exp", np.exp, [ANY], True),
    _sweep("expm1", "expm1", np.expm1, [ANY], True),
    _sweep("floor", "floor", np.floor, [ANY], False),
    _sweep("log", "log", np.log, [POS], True),
    _sweep("log10", "log10", np.log10, [POS], True),
    _sweep("log1p", "log1p", np.log1p, [POS], True),
    _sweep("log2", "log2", np.log2, [POS], True),
    _sweep("reciprocal", "reciprocal", np.reciprocal, [POS], True),
    _sweep("round", "round", np.round, [ANY], False),
    _sweep("rsqrt", "rsqrt", lambda a: 1 / np.sqrt(a), [POS], True),
    _sweep("sigmoid", "sigmoid", lambda a: 1 / (1 + np.exp(-a)), [ANY], True),
    _sweep("sign", "sign", np.sign, [ANY], False),
    _sweep("sin", "sin", np.sin, [ANY], True),
    _sweep("sinh", "sinh", np.sinh, [ANY], True),
    _sweep("sqrt", "sqrt", np.sqrt, [POS], True),
    _sweep("square", "square", np.square, [ANY], True),
    _sweep("tan", "tan", np.tan, [UNIT], True),
    _sweep("tanh", "tanh", np.tanh, [ANY], True),
    _sweep("trunc", "trunc", np.trunc, [ANY], False),
    _sweep("deg2rad", "deg2rad", np.deg2rad, [ANY], True),
    _sweep("rad2deg", "rad2deg", np.rad2deg, [ANY], True),
    _sweep("digamma", "digamma", None, [POS], True),
    _sweep("lgamma", "lgamma", None, [POS], True),
    _sweep("i0", "i0", None, [ANY], True),
    _sweep("frac", "frac", lambda a: a - np.trunc(a), [ANY], True),
    _sweep("logit", "logit", lambda a: np.log(a / (1 - a)), [_LOGIT], True),
    _sweep("angle", "angle", np.angle, [ANY], False),
    _sweep("neg", "neg", np.negative, [ANY], True),
]

SWEEP_BINARY = [
    _sweep("add", "add", np.add, [ANY, ANY2], True),
    _sweep("subtract", "subtract", np.subtract, [ANY, ANY2], True),
    _sweep("multiply", "multiply", np.multiply, [ANY, ANY2], True),
    _sweep("divide", "divide", np.divide, [ANY, POSB], True),
    _sweep("maximum", "maximum", np.maximum, [ANY, ANY2], True),
    _sweep("minimum", "minimum", np.minimum, [ANY, ANY2], True),
    _sweep("pow", "pow", np.power, [POS, POSB], True),
    _sweep("fmax", "fmax", np.fmax, [ANY, ANY2], False),
    _sweep("fmin", "fmin", np.fmin, [ANY, ANY2], False),
    _sweep("atan2", "atan2", np.arctan2, [ANY, POSB], True),
    _sweep("hypot", "hypot", np.hypot, [ANY, ANY2], True),
    _sweep("logaddexp", "logaddexp", np.logaddexp, [ANY, ANY2], True),
    _sweep("floor_divide", "floor_divide", np.floor_divide, [POS, POSB], False),
    _sweep("mod", "mod", np.mod, [POS, POSB], False),
    _sweep("copysign", "copysign", np.copysign, [ANY, ANY2], False),
    _sweep("nextafter", "nextafter", np.nextafter, [ANY, ANY2], False),
    _sweep("heaviside", "heaviside", np.heaviside, [ANY, POSB], False),
]

SWEEP_REDUCTION = [
    _sweep("sum", "sum", np.sum, [ANY], True),
    _sweep("mean", "mean", np.mean, [ANY], True),
    _sweep("max", "max", np.max, [ANY], True),
    _sweep("min", "min", np.min, [ANY], True),
    _sweep("prod", "prod", np.prod, [POS], True),
    _sweep("logsumexp", "logsumexp", lambda a: np.log(np.sum(np.exp(a))),
           [ANY], True),
    _sweep("amax", "amax", np.amax, [ANY], False),
    _sweep("amin", "amin", np.amin, [ANY], False),
    _sweep("all", "all", np.all, [ANY > 0], False),
    _sweep("any", "any", np.any, [ANY > 0], False),
    _sweep("count_nonzero", "count_nonzero", np.count_nonzero, [ANY], False),
    _sweep("median", "median", np.median, [ANY], False),
    _sweep("std", "std", lambda a: np.std(a, ddof=1), [ANY], True),
    _sweep("var", "var", lambda a: np.var(a, ddof=1), [ANY], True),
    _sweep("nansum", "nansum", np.nansum, [ANY], True),
    _sweep("nanmean", "nanmean", np.nanmean, [ANY], True),
]

SWEEP_SHAPE = [
    _sweep("transpose", lambda ns, x: ns.transpose(x, [1, 0]), np.transpose,
           [ANY], True),
    _sweep("reshape", lambda ns, x: ns.reshape(x, [4, 3]),
           lambda a: np.reshape(a, (4, 3)), [ANY], True),
    _sweep("flatten", "flatten", np.ravel, [ANY], True),
    _sweep("flip", lambda ns, x: ns.flip(x, 0), lambda a: np.flip(a, 0),
           [ANY], True),
    _sweep("roll", lambda ns, x: ns.roll(x, 1), lambda a: np.roll(a, 1),
           [ANY], True),
    _sweep("tril", "tril", np.tril, [ANY], True),
    _sweep("triu", "triu", np.triu, [ANY], True),
    _sweep("rot90", "rot90", np.rot90, [ANY], False),
    _sweep("cumsum", "cumsum", lambda a: np.cumsum(a), [ANY], True),
    _sweep("cumprod", lambda ns, x: ns.cumprod(x, 0),
           lambda a: np.cumprod(a, 0), [POS], True),
    _sweep("diff", "diff", np.diff, [ANY], True),
    _sweep("kron", "kron", np.kron, [ANY, ANY2], True),
    _sweep("diagonal", "diagonal", np.diagonal, [ANY], True),
    _sweep("trace", "trace", np.trace, [ANY], True),
]

SWEEP_LINALG = [
    _sweep("matmul", "matmul", np.matmul, [ANY, ANY2.T.copy()], True),
    _sweep("dot", "dot", lambda a, b: np.sum(a * b, -1), [ANY[0], ANY2[0]],
           True),
    _sweep("outer", "outer", np.outer, [ANY[0], ANY2[0]], True),
    _sweep("inner", "inner", np.inner, [ANY, ANY2], True),
    _sweep("cross", lambda ns, x, y: ns.cross(x, y, axis=1),
           lambda a, b: np.cross(a, b, axis=1),
           [ANY[:, :3].copy(), ANY2[:, :3].copy()], True),
    _sweep("bmm", "bmm", np.matmul,
           [_rng.randn(2, 3, 4).astype(np.float32),
            _rng.randn(2, 4, 5).astype(np.float32)], True),
    _sweep("mv", "mv", lambda a, b: a @ b, [ANY, ANY2[0]], True),
]

SWEEP = SWEEP_UNARY + SWEEP_BINARY + SWEEP_REDUCTION + SWEEP_SHAPE + \
    SWEEP_LINALG

# ---------------------------------------------------------------------------
# MATH: tests/test_ops_math.py (its shapes, ops and oracles; RandomState(42))
# ---------------------------------------------------------------------------

_m = np.random.RandomState(42)


def _data(*shape):
    return _m.rand(*shape).astype(np.float32)


_MATH_UNARY = [
    ("exp", np.exp), ("log", lambda x: np.log(x + 1.0)), ("sqrt", np.sqrt),
    ("tanh", np.tanh), ("abs", np.abs), ("floor", np.floor),
    ("ceil", np.ceil), ("sin", np.sin), ("cos", np.cos),
    ("square", np.square), ("rsqrt", lambda x: 1.0 / np.sqrt(x)),
    ("reciprocal", lambda x: 1.0 / x), ("expm1", np.expm1),
    ("log1p", np.log1p), ("sign", np.sign),
]


def _math_unary(name, oracle):
    if name == "log":
        return Case("unary_log", lambda ns, t: ns.log(t + 1.0), [_data(3, 4) + 0.1],
                    oracle, grad=True)
    return Case("unary_" + name, call(name), [_data(3, 4) + 0.1], oracle,
                grad=name not in ("floor", "ceil", "sign"))


MATH = [_math_unary(n, o) for n, o in _MATH_UNARY] + [
    Case("binary_" + n, call(n), [_data(3, 4) + 0.5, _data(3, 4) + 0.5], o,
         grad=True)
    for n, o in (("add", np.add), ("subtract", np.subtract),
                 ("multiply", np.multiply), ("divide", np.divide),
                 ("maximum", np.maximum), ("minimum", np.minimum),
                 ("pow", np.power), ("atan2", np.arctan2))] + [
    Case("broadcasting", call("add"), [_data(3, 1, 4), _data(2, 1)], np.add,
         grad=True),
    Case("matmul", call("matmul"), [_data(4, 5), _data(5, 6)], np.matmul,
         grad=True),
    Case("matmul_transpose_y",
         lambda ns, a, b: ns.matmul(a, b, transpose_y=True),
         [_data(4, 5), _data(6, 5)], lambda a, b: a @ b.T, grad=True),
    Case("matmul_batched", call("matmul"), [_data(2, 3, 4), _data(2, 4, 5)],
         np.matmul, grad=True),
]
_R = _data(3, 4, 5)
MATH += [
    Case("reduce_sum", lambda ns, t: ns.sum(t), [_R], np.sum, grad=True),
    Case("reduce_sum_axis", lambda ns, t: ns.sum(t, axis=1), [_R],
         lambda a: np.sum(a, 1), grad=True),
    Case("reduce_mean_axes", lambda ns, t: ns.mean(t, axis=[0, 2]), [_R],
         lambda a: np.mean(a, (0, 2)), grad=True),
    Case("reduce_max_keepdim", lambda ns, t: ns.max(t, axis=1, keepdim=True),
         [_R], lambda a: np.max(a, 1, keepdims=True), grad=True),
    Case("reduce_prod", lambda ns, t: ns.prod(t, axis=-1), [_R],
         lambda a: np.prod(a, -1), grad=True),
    Case("reduce_logsumexp", lambda ns, t: ns.logsumexp(t, axis=1), [_R],
         lambda a: np.log(np.sum(np.exp(a), 1)), grad=True),
]
_C = _data(3, 4)
MATH += [
    Case("cumsum_axis", lambda ns, t: ns.cumsum(t, axis=1), [_C],
         lambda a: np.cumsum(a, 1), grad=True),
    Case("cumsum_flat", lambda ns, t: ns.cumsum(t), [_C],
         lambda a: np.cumsum(a.reshape(-1)), grad=True),
    Case("clip", lambda ns, t: ns.clip(t, 0.2, 0.8), [_C],
         lambda a: np.clip(a, 0.2, 0.8), grad=True),
    Case("scale", lambda ns, t: ns.scale(t, 2.0, 1.0), [_C],
         lambda a: a * 2 + 1, grad=True),
]
_S = _data(4, 5)
MATH += [
    Case("stat_var", lambda ns, t: ns.var(t, axis=1), [_S],
         lambda a: np.var(a, 1, ddof=1), grad=True),
    Case("stat_std", lambda ns, t: ns.std(t), [_S],
         lambda a: np.std(a, ddof=1), grad=True, tol=1e-4),
    Case("stat_median", lambda ns, t: ns.median(t, axis=1), [_S],
         lambda a: np.median(a, 1), grad=True),
    Case("grad_tanh", call("tanh"), [_data(3, 3)], np.tanh, grad=True),
    Case("grad_exp", call("exp"), [_data(3, 3)], np.exp, grad=True),
    Case("grad_sqrt", lambda ns, t: ns.sqrt(t + 0.5), [_data(3, 3)],
         lambda a: np.sqrt(a + 0.5), grad=True),
    Case("grad_matmul", call("matmul"), [_data(3, 4), _data(4, 2)],
         np.matmul, grad=True),
    Case("grad_mean_axis", lambda ns, t: ns.mean(t, axis=0), [_data(4, 3)],
         lambda a: np.mean(a, 0), grad=True),
    Case("grad_max_axis", lambda ns, t: ns.max(t, axis=1), [_data(4, 3)],
         lambda a: np.max(a, 1), grad=True),
]

# ---------------------------------------------------------------------------
# BREADTH: the ops-only cases of tests/test_ops_breadth.py
# ---------------------------------------------------------------------------

_b = np.random.RandomState(0)
_BX = _b.rand(3, 4).astype(np.float32) * 0.8 + 0.1
_BY = _b.randn(3, 5).astype(np.float32)


def _trapz(a, **kw):
    return (np.trapezoid if hasattr(np, "trapezoid") else np.trapz)(a, **kw)


def _recon_plu(ns, m):
    lu, piv = ns.linalg.lu(m)
    P, L, U = ns.linalg.lu_unpack(lu, piv)
    return ns.matmul(ns.matmul(P, L), U)


def _pca(ns, x):
    U, S, V = ns.linalg.pca_lowrank(x, q=3)
    return ns.matmul(ns.matmul(U, ns.diag(S)), V.T)


_BA = np.random.RandomState(0)
_TA = _BA.randn(3, 4, 5).astype(np.float32)
_TB = _BA.randn(4, 5, 6).astype(np.float32)
_M4 = _BA.randn(4, 4).astype(np.float32)
_PCA = np.random.RandomState(0).randn(20, 5).astype(np.float32)
_LUB = np.random.RandomState(0).randn(2, 4, 4).astype(np.float32)


def _pca_oracle(x):
    xc = x - x.mean(0)
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    return u[:, :3] @ np.diag(s[:3]) @ vt[:3]


BREADTH = [
    Case("logit", call("logit"), [_BX], lambda a: np.log(a / (1 - a)),
         grad=True),
    Case("trapezoid", lambda ns, t: ns.trapezoid(t, dx=0.5), [_BY],
         lambda a: _trapz(a, dx=0.5, axis=-1), grad=True),
    Case("cumulative_trapezoid",
         lambda ns, t: ns.cumulative_trapezoid(t, dx=0.5), [_BY], grad=True),
    Case("frexp", call("frexp"),
         [np.array([0.0, 4.0, -3.5, 0.1], np.float32)],
         lambda a: tuple(np.frexp(a))),
    Case("vander", call("vander"), [np.array([1.0, 2.0, 3.0], np.float32)],
         np.vander, grad=True),
    Case("vander_n2_increasing",
         lambda ns, t: ns.vander(t, n=2, increasing=True),
         [np.array([1.0, 2.0, 3.0], np.float32)],
         lambda a: np.vander(a, 2, increasing=True), grad=True),
    Case("add_n", lambda ns, a, b, c: ns.add_n([a, b, c]),
         [np.full((2, 2), float(i), np.float32) for i in range(3)],
         lambda a, b, c: a + b + c, grad=True),
    Case("renorm", lambda ns, t: ns.renorm(t, p=2.0, axis=0, max_norm=1.0),
         [np.array([[3.0, 4.0], [0.3, 0.4]], np.float32)],
         lambda a: np.array([[0.6, 0.8], [0.3, 0.4]], np.float32), grad=True,
         tol=1e-4),
    Case("unflatten", lambda ns, t: ns.unflatten(t, 1, [3, 4]),
         [np.arange(24, dtype=np.float32).reshape(2, 12)],
         lambda a: a.reshape(2, 3, 4), grad=True),
    Case("unfold", lambda ns, t: ns.unfold(t, 0, 4, 2),
         [np.arange(8, dtype=np.float32)],
         lambda a: np.array([[0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6, 7]],
                            np.float32), grad=True),
    Case("vsplit", lambda ns, t: ns.vsplit(t, 2),
         [np.arange(24, dtype=np.float32).reshape(4, 6)],
         lambda a: (a[:2], a[2:]), grad=True),
    Case("reverse", lambda ns, t: ns.reverse(t, axis=1),
         [np.arange(24, dtype=np.float32).reshape(2, 12)],
         lambda a: a[:, ::-1], grad=True),
    Case("tensordot", lambda ns, a, b: ns.tensordot(a, b, axes=2), [_TA, _TB],
         lambda a, b: np.tensordot(a, b, axes=2), grad=True, tol=1e-3),
    Case("lu_unpack_reconstructs", _recon_plu, [_M4], lambda m: m,
         tol=DECOMP_TOL),
    Case("pca_lowrank_reconstructs", _pca, [_PCA], _pca_oracle,
         tol=DECOMP_TOL),
    Case("lu_unpack_batched", _recon_plu, [_LUB], lambda m: m,
         tol=DECOMP_TOL),
]

# ---------------------------------------------------------------------------
# TROUBLE: where torch's defaults and jnp's differ
# ---------------------------------------------------------------------------

TIES = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0],
                 [0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                 [2.0, 7.0, 7.0, 1.0, 2.0, 7.0]], np.float32)
EVEN = np.random.RandomState(3).randn(4, 6).astype(np.float32)
_nan = EVEN.copy()
_nan[0, 1] = np.nan
_nan[2, :] = np.nan
_nan[3, 0] = _nan[3, 5] = np.nan
EVEN_NAN = _nan
_t = np.random.RandomState(5)
SPD = (lambda a: a @ a.T + 4 * np.eye(4, dtype=np.float32))(
    _t.randn(4, 4).astype(np.float32))
TALL = _t.randn(6, 3).astype(np.float32)
RHS = _t.randn(6, 2).astype(np.float32)
PIVOTY = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0], [7.0, 8.0, 10.0]],
                  np.float32)
SEQ = np.array([0.0, 1.0, 1.0, 2.0, 5.0], np.float32)
VALS = np.array([[-1.0, 1.0, 1.5], [2.0, 5.0, 9.0]], np.float32)
INTV = np.array([3, 1, 3, 2, 1, 3, 0], np.int64)


def _take(i):
    return lambda ns, *ts: ns.linalg.svd(*ts)[i]


def _svd_recon(ns, a):
    u, s, vh = ns.linalg.svd(a)
    return ns.matmul(u * s.unsqueeze(0), vh)


def _qr_recon(ns, a):
    q, r = ns.linalg.qr(a)
    return ns.matmul(q, r)


def _eigh_recon(ns, a):
    w, v = ns.linalg.eigh(a)
    return ns.matmul(v * w.unsqueeze(0), v.T)


TROUBLE = [
    # ties: the reference's order (lower index first; cummax/cummin the later)
    Case("topk_ties", lambda ns, t: ns.topk(t, 3), [TIES]),
    Case("topk_ties_smallest", lambda ns, t: ns.topk(t, 2, largest=False),
         [TIES]),
    Case("topk_axis0_grad", lambda ns, t: ns.topk(t, 2, axis=0)[0], [ANY],
         grad=True),
    Case("argsort_ties", lambda ns, t: ns.argsort(t), [TIES],
         lambda a: np.argsort(a, -1, kind="stable")),
    Case("argsort_ties_descending",
         lambda ns, t: ns.argsort(t, descending=True), [TIES],
         lambda a: np.argsort(-a, -1, kind="stable")),
    Case("sort_descending", lambda ns, t: ns.sort(t, descending=True),
         [TIES], lambda a: -np.sort(-a, -1)),
    Case("sort_grad", lambda ns, t: ns.sort(t, axis=0), [ANY],
         lambda a: np.sort(a, 0), grad=True),
    Case("cummax_ties", lambda ns, t: ns.cummax(t, axis=1), [TIES]),
    Case("cummin_ties_flat", lambda ns, t: ns.cummin(t), [TIES]),
    Case("kthvalue_ties", lambda ns, t: ns.kthvalue(t, 2), [TIES]),
    Case("mode_ties", lambda ns, t: ns.mode(t), [TIES]),
    Case("argmax_ties", lambda ns, t: ns.argmax(t, axis=1), [TIES]),
    Case("argmin_flat", lambda ns, t: ns.argmin(t), [TIES]),
    Case("argmax_keepdim", lambda ns, t: ns.argmax(t, axis=0, keepdim=True),
         [ANY]),
    # medians at even counts: the mean of the two middle values
    Case("median_even_axis", lambda ns, t: ns.median(t, axis=1), [EVEN],
         lambda a: np.median(a, 1), grad=True),
    Case("median_even_all", lambda ns, t: ns.median(t), [EVEN],
         np.median, grad=True),
    Case("median_even_keepdim",
         lambda ns, t: ns.median(t, axis=0, keepdim=True), [EVEN],
         lambda a: np.median(a, 0, keepdims=True), grad=True),
    Case("median_min_mode", lambda ns, t: ns.median(t, axis=1, mode="min"),
         [EVEN], lambda a: np.sort(a, 1)[:, 2], grad=True),
    Case("median_nan", lambda ns, t: ns.median(t, axis=1), [EVEN_NAN],
         lambda a: np.median(a, 1)),
    Case("nanmedian_even", lambda ns, t: ns.nanmedian(t, axis=1), [EVEN_NAN],
         lambda a: np.nanmedian(a, 1)),
    Case("nanmedian_all", lambda ns, t: ns.nanmedian(t), [EVEN_NAN],
         np.nanmedian),
    Case("quantile_linear", lambda ns, t: ns.quantile(t, 0.3, axis=1),
         [EVEN], lambda a: np.quantile(a, 0.3, axis=1)),
    Case("quantile_vector", lambda ns, t: ns.quantile(t, [0.1, 0.5, 0.9]),
         [EVEN], lambda a: np.quantile(a, [0.1, 0.5, 0.9])),
    Case("quantile_keepdim",
         lambda ns, t: ns.quantile(t, [0.25, 0.75], axis=0, keepdim=True),
         [EVEN], lambda a: np.quantile(a, [0.25, 0.75], axis=0, keepdims=True)),
    Case("quantile_lower", lambda ns, t: ns.quantile(
        t, 0.3, axis=1, interpolation="lower"), [EVEN],
        lambda a: np.quantile(a, 0.3, axis=1, method="lower")),
    Case("quantile_higher", lambda ns, t: ns.quantile(
        t, 0.3, axis=1, interpolation="higher"), [EVEN],
        lambda a: np.quantile(a, 0.3, axis=1, method="higher")),
    Case("quantile_midpoint", lambda ns, t: ns.quantile(
        t, 0.3, axis=1, interpolation="midpoint"), [EVEN],
        lambda a: np.quantile(a, 0.3, axis=1, method="midpoint")),
    # jnp's nearest takes the lower value at a half (numpy: the even one)
    Case("quantile_nearest", lambda ns, t: ns.quantile(
        t, [0.3, 0.5, 0.7], axis=1, interpolation="nearest"), [EVEN]),
    Case("nanquantile", lambda ns, t: ns.nanquantile(t, 0.4, axis=1),
         [EVEN_NAN], lambda a: np.nanquantile(a, 0.4, axis=1)),
    # lu: LAPACK's 1-based int32 pivots, packed factors
    Case("lu_pivots", lambda ns, t: ns.linalg.lu(t), [PIVOTY],
         tol=DECOMP_TOL),
    Case("lu_get_infos", lambda ns, t: ns.linalg.lu(t, get_infos=True)[1:],
         [PIVOTY]),
    Case("lu_batched_pivots", lambda ns, t: ns.linalg.lu(t)[1], [_LUB]),
    # as_strided: offset counts elements from the data's start
    Case("as_strided_offset",
         lambda ns, t: ns.as_strided(t, [3, 2], [4, 1], offset=1),
         [np.arange(12, dtype=np.float32)],
         lambda a: np.lib.stride_tricks.as_strided(
             a[1:], (3, 2), (16, 4)).copy(), grad=True),
    Case("as_strided_overlap",
         lambda ns, t: ns.as_strided(t, [4, 3], [2, 1], offset=2),
         [np.arange(12, dtype=np.float32).reshape(3, 4)],
         lambda a: np.lib.stride_tricks.as_strided(
             a.reshape(-1)[2:], (4, 3), (8, 4)).copy(), grad=True),
    # lstsq: the reference's SVD solve with no driver
    Case("lstsq_full_rank", lambda ns, a, b: ns.linalg.lstsq(a, b), [TALL, RHS],
         tol=1e-4),
    Case("lstsq_rank_deficient", lambda ns, a, b: ns.linalg.lstsq(a, b),
         [np.concatenate([TALL[:, :2], TALL[:, :1]], 1), RHS], tol=1e-4),
    # decompositions through their reconstructions
    Case("svd_reconstructs", _svd_recon, [TALL], lambda a: a,
         tol=DECOMP_TOL, grad=True),
    Case("svd_values", _take(1), [TALL], tol=DECOMP_TOL),
    Case("qr_reconstructs", _qr_recon, [TALL], lambda a: a, tol=DECOMP_TOL,
         grad=True),
    Case("eigh_reconstructs", _eigh_recon, [SPD], lambda a: a,
         tol=DECOMP_TOL),
    Case("cholesky", lambda ns, t: ns.linalg.cholesky(t), [SPD],
         np.linalg.cholesky, tol=DECOMP_TOL, grad=True),
    Case("cholesky_solve", lambda ns, b, a: ns.linalg.cholesky_solve(
        b, ns.linalg.cholesky(a)), [RHS[:4], SPD],
        lambda b, a: np.linalg.solve(a, b), tol=DECOMP_TOL, grad=True),
    Case("triangular_solve_transpose",
         lambda ns, a, b: ns.linalg.triangular_solve(
             ns.triu(a), b, upper=True, transpose=True), [SPD, RHS[:4]],
         lambda a, b: np.linalg.solve(np.triu(a).T, b), tol=DECOMP_TOL,
         grad=True),
    Case("solve", lambda ns, a, b: ns.linalg.solve(a, b), [SPD, RHS[:4]],
         np.linalg.solve, tol=DECOMP_TOL, grad=True),
    Case("inv", lambda ns, a: ns.linalg.inv(a), [SPD], np.linalg.inv,
         tol=DECOMP_TOL, grad=True),
    Case("det_slogdet", lambda ns, a: (ns.linalg.det(a), ns.linalg.slogdet(a)),
         [SPD], lambda a: (np.linalg.det(a), np.array(np.linalg.slogdet(a))),
         tol=DECOMP_TOL, grad=True),
    Case("pinv", lambda ns, a: ns.linalg.pinv(a), [TALL], np.linalg.pinv,
         tol=DECOMP_TOL),
    Case("matrix_rank", lambda ns, a: ns.linalg.matrix_rank(a),
         [np.concatenate([TALL, TALL[:, :1]], 1)],
         lambda a: np.linalg.matrix_rank(a)),
    Case("matrix_power", lambda ns, a: ns.linalg.matrix_power(a, 3), [SPD],
         lambda a: np.linalg.matrix_power(a, 3), tol=DECOMP_TOL, grad=True),
    Case("norms", lambda ns, a: (ns.linalg.norm(a), ns.linalg.norm(a, p=1, axis=1),
                                 ns.linalg.norm(a, p=np.inf, axis=0),
                                 ns.linalg.matrix_norm(a, p="nuc"),
                                 ns.dist(a, a * 2.0, p=3)),
         [TALL], lambda a: (np.linalg.norm(a), np.abs(a).sum(1),
                            np.abs(a).max(0), np.linalg.norm(a, "nuc"),
                            np.sum(np.abs(a) ** 3) ** (1 / 3)),
         tol=DECOMP_TOL, grad=True),
    Case("multi_dot_householder", lambda ns, a, t: (
        ns.linalg.multi_dot([a, a.T, a]),
        ns.linalg.householder_product(a, t)), [TALL, np.float32([1.2, 0.5, 1.7])],
        tol=DECOMP_TOL),
    Case("cdist_pdist_cov", lambda ns, a, b: (ns.cdist(a, b), ns.pdist(a),
                                              ns.linalg.cov(a),
                                              ns.linalg.corrcoef(a)),
         [TALL, RHS[:, :1] * np.ones((1, 3), np.float32)], tol=1e-4,
         grad=False),
    Case("einsum", lambda ns, a, b: ns.einsum("ij,kj->ik", a, b), [TALL, TALL],
         lambda a, b: a @ b.T, grad=True),
    # data-dependent shapes and host-free index ops
    Case("unique_all", lambda ns, t: ns.unique(
        t, return_index=True, return_inverse=True, return_counts=True),
        [INTV], lambda a: tuple(np.unique(a, return_index=True,
                                          return_inverse=True,
                                          return_counts=True))),
    Case("unique_axis", lambda ns, t: ns.unique(t, return_counts=True, axis=0),
         [np.array([[1, 2], [0, 5], [1, 2]], np.int64)]),
    Case("unique_consecutive", lambda ns, t: ns.unique_consecutive(
        t, return_inverse=True, return_counts=True),
        [np.array([1, 1, 2, 2, 2, 3, 1, 1], np.int64)]),
    Case("nonzero", lambda ns, t: (ns.nonzero(t), ns.nonzero(t, as_tuple=True)),
         [ANY > 0.3]),
    Case("masked_select", lambda ns, t, m: ns.masked_select(t, m),
         [ANY, ANY2 > 0], lambda a, m: a[m], grad=True),
    Case("where_scalar", lambda ns, t: ns.where(t > 0, t, 0.0), [ANY],
         lambda a: np.where(a > 0, a, 0.0), grad=True),
    Case("searchsorted_bucketize", lambda ns, s, v: (
        ns.searchsorted(s, v), ns.searchsorted(s, v, right=True),
        ns.bucketize(v, s), ns.searchsorted(s, v, out_int32=True)),
        [SEQ, VALS], lambda s, v: (np.searchsorted(s, v),
                                   np.searchsorted(s, v, "right"),
                                   np.searchsorted(s, v),
                                   np.searchsorted(s, v))),
    Case("gather_scatter", lambda ns, a, i, u: (
        ns.gather(a, i), ns.index_select(a, i, axis=1),
        ns.scatter(a, i[:2], u), ns.scatter(a, i[:2], u, overwrite=False),
        ns.index_add(a, i, 0, a[:3] * 0.0 + 1.0)),
        [ANY, np.array([2, 0, 1], np.int64), ANY2[:2]], grad=True),
    Case("take_put_along_axis", lambda ns, a, i: (
        ns.take_along_axis(a, i, 1),
        ns.put_along_axis(a, i, 9.0, 1),
        ns.put_along_axis(a, i, 2.0, 1, reduce="add")),
        [ANY, np.array([[0, 3], [1, 1], [2, 0]], np.int64)], grad=True),
    # jax has no gradient of a multiplying scatter with repeated indices
    Case("put_along_axis_reduce", lambda ns, a, i: tuple(
        ns.put_along_axis(a, i, 2.0, 1, reduce=r) for r in ("mul", "amax",
                                                             "amin")),
        [ANY, np.array([[0, 3], [1, 1], [2, 0]], np.int64)]),
    Case("gather_nd_scatter_nd", lambda ns, a, i: (
        ns.gather_nd(a, i), ns.scatter_nd_add(a, i, ns.ones([2])),
        ns.scatter_nd(i, ns.ones([2]), [3, 4])),
        [ANY, np.array([[0, 1], [2, 3]], np.int64)], grad=True),
    Case("index_put_masked_fill", lambda ns, a, m: (
        ns.index_put(a, (ns.to_tensor(np.array([0, 2])),), ns.full([4], 7.0)),
        ns.masked_fill(a, m, -1.0)), [ANY, ANY2 > 0], grad=True),
    Case("pad_modes", lambda ns, a: tuple(
        ns.pad(a, [1, 2], mode=m) for m in ("constant", "reflect",
                                            "replicate", "circular")),
        [ANY.reshape(1, 3, 4)], lambda a: tuple(
            np.pad(a, [(0, 0), (0, 0), (1, 2)], mode=m)
            for m in ("constant", "reflect", "edge", "wrap")), grad=True),
    Case("slices", lambda ns, a: (
        ns.slice(a, [1], [1], [3]),
        ns.strided_slice(a, [0, 1], [2, 3], [0, 0], [-1, -2]),
        ns.crop(a, [2, 2], [1, 1])), [ANY],
        lambda a: (a[:, 1:3], a[2:0:-1, 3:0:-2], a[1:3, 1:3]), grad=True),
    Case("shape_ops", lambda ns, a: (
        ns.squeeze(ns.unsqueeze(a, [0, 3]), [0]),
        ns.expand(a[:1], [3, 4]), ns.tile(a, [2, 1]),
        ns.repeat_interleave(a, 2, axis=0), ns.concat([a, a], 1),
        ns.stack([a, a], 0), ns.moveaxis(ns.unsqueeze(a, 0), 0, 2),
        ns.atleast_3d(a[0])), [ANY], grad=False),
    Case("splits", lambda ns, a: tuple(
        ns.split(a, [1, -1], axis=0) + ns.chunk(a, 2, axis=1) +
        ns.tensor_split(a, 3, axis=1) + ns.unbind(a, 1) + ns.unstack(a)),
        [ANY], grad=False),
    Case("complex_ops", lambda ns, a, b: (
        ns.real(ns.complex(a, b)), ns.imag(ns.as_complex(ns.stack([a, b], -1))),
        ns.as_real(ns.complex(a, b)), ns.angle(ns.complex(a, b)),
        ns.abs(ns.polar(ns.abs(a), b))), [ANY, ANY2]),
    Case("creation_like", lambda ns, a: (
        ns.zeros_like(a), ns.ones_like(a, dtype="int32"),
        ns.full_like(a, 3.5), ns.empty_like(a), ns.diag(a[0]),
        ns.diag(a[0], offset=1, padding_value=2.0), ns.diagflat(a[0]),
        ns.diag_embed(a), ns.tril(a, -1), ns.triu(a, 1)), [ANY]),
    Case("logic", lambda ns, a, b: (
        ns.equal(a, b), ns.less_than(a, b), ns.greater_equal(a, b),
        ns.logical_xor(a > 0, b > 0), ns.logical_not(a > 0),
        ns.isclose(a, a + 1e-7), ns.allclose(a, a * 1.5), ns.equal_all(a, a),
        ns.bitwise_and(ns.cast(a > 0, "int32"), ns.cast(b > 0, "int32")),
        ns.bitwise_not(a > 0)), [ANY, ANY2]),
    Case("int_math", lambda ns, a, b: (
        ns.gcd(a, b), ns.lcm(a, b), ns.floor_divide(a + 1, b + 1),
        ns.remainder(a, b + 1), ns.bincount(a), ns.shard_index(
            a.reshape([-1, 1]), 20, 2, 0)),
        [INTV, INTV[::-1].copy()]),
    Case("elementwise_more", lambda ns, a, b: (
        ns.lerp(a, b, 0.3), ns.stanh(a), ns.ldexp(a, ns.to_tensor(
            np.float32([1.0, 2.0, 3.0, 0.0]))), ns.i0e(a), ns.i1(a),
        ns.i1e(a), ns.erfinv(a * 0.5), ns.polygamma(ns.abs(a) + 1, 1),
        ns.nan_to_num(ns.log(a)), ns.take(a, ns.to_tensor(
            np.array([0, -1, 14], np.int64)), mode="wrap")),
        [ANY, ANY2], grad=False, tol=1e-4),
    Case("cumulative_more", lambda ns, a: (
        ns.logcumsumexp(a, axis=1), ns.cumprod(a), ns.cumsum(a, axis=0),
        ns.diff(a, axis=0, prepend=0.0, append=a[:1])), [ANY], grad=True,
        tol=1e-4),
    Case("reductions_more", lambda ns, a: (
        ns.sum(a > 0, axis=1), ns.prod(a, axis=[0, 1]),
        ns.amax(a, axis=[0, 1], keepdim=True), ns.logsumexp(a, axis=[0, 1]),
        ns.nanmean(a, axis=0), ns.count_nonzero(a > 0, axis=0),
        ns.var(a, axis=0, unbiased=False), ns.std(a, axis=[0, 1]),
        ns.all(a > -10, axis=1), ns.any(a > 1, axis=0)), [ANY], grad=False,
        tol=1e-4),
    Case("mm_family", lambda ns, a, b: (
        ns.mm(a, b.T), ns.addmm(a[:, :3], a, b.T[:, :3], beta=0.5, alpha=2.0),
        ns.t(a), ns.matmul(a, b, transpose_x=True), ns.multiplex(
            [a, b], ns.to_tensor(np.array([[1], [0], [1]], np.int32)))),
        [ANY, ANY2], grad=True, tol=1e-4),
    Case("creation_ops", lambda ns: (
        ns.arange(5), ns.arange(0.0, 1.0, 0.25), ns.linspace(0, 1, 5),
        ns.logspace(0, 2, 3), ns.eye(3, 4), ns.full([2, 3], 7),
        ns.full([2], 1.5), ns.zeros([2, 2]), ns.ones([3], dtype="int64"),
        ns.tril_indices(4, 4, -1), ns.triu_indices(3, 4, 1)), []),
    Case("meshgrid_vander", lambda ns, a, b: tuple(ns.meshgrid(a, b)) + (
        ns.vander(a, n=3),), [ANY[0], ANY2[1, :3].copy()], grad=True),
    Case("fmax_nan", lambda ns, a, b: (ns.fmax(a, b), ns.fmin(a, b),
                                       ns.maximum(a, b)),
         [EVEN_NAN[0], EVEN[0]], lambda a, b: (np.fmax(a, b), np.fmin(a, b),
                                               np.maximum(a, b))),
    # the rest of the namespace, a few ops a case
    Case("predicates", lambda ns, a: (
        ns.isfinite(a), ns.isinf(a), ns.isnan(a), ns.isneginf(a),
        ns.isposinf(a), ns.isreal(a), ns.sgn(a), ns.is_floating_point(a),
        ns.is_integer(a), ns.is_complex(a), ns.is_tensor(a), ns.is_empty(a),
        ns.numel(a), ns.rank(a), ns.shape(a)),
        [np.float32([[1.0, np.inf, -np.inf], [np.nan, -2.0, 0.0]])]),
    Case("complex_more", lambda ns, a, b: (
        ns.conj(ns.complex(a, b)), ns.imag(ns.conj(ns.complex(a, b))),
        ns.real(a), ns.imag(a), ns.as_real(ns.as_complex(
            ns.stack([a, b], -1)))), [ANY, ANY2]),
    Case("histograms", lambda ns, a, w: (
        ns.histogram(a, bins=5, min=-2, max=2), ns.histogram(a, bins=4),
        ns.bincount(ns.cast(ns.abs(a) * 3, "int64").reshape([-1]), weights=w),
        ns.histogramdd(ns.reshape(a, [6, 2]), bins=3)),
        [ANY, np.abs(ANY2.reshape(-1))]),
    Case("eig_family", lambda ns, a: (
        ns.linalg.eigvalsh(a), ns.sort(ns.real(ns.linalg.eigvals(a))),
        ns.linalg.cond(a), ns.linalg.cond(a, "fro")), [SPD],
        lambda a: (np.linalg.eigvalsh(a), np.sort(np.linalg.eigvals(a).real),
                   np.linalg.cond(a), np.linalg.cond(a, "fro")),
        tol=DECOMP_TOL),
    Case("shape_more", lambda ns, a, b, i: (
        ns.view(a, [4, 3]), ns.view_as(a, ns.reshape(b, [6, 2])),
        ns.atleast_1d(a[0, 0]), ns.atleast_2d(a[0]),
        ns.broadcast_tensors([a[:1], b]), ns.expand_as(a[:1], b),
        ns.broadcast_to(a[:, :1], [3, 4]), ns.swapaxes(a, 0, 1),
        ns.index_sample(a, i), ns.flatten(ns.unsqueeze(a, 0), 1, 2),
        ns.squeeze(ns.unsqueeze(a, [0, 2])), ns.flip(a, [0, 1]),
        ns.roll(a, [1, -1], [0, 1])),
        [ANY, ANY2, np.array([[1, 3], [0, 0], [2, 1]], np.int64)], grad=True),
    Case("math_more", lambda ns, x, y, lab: (
        ns.accuracy(x, lab, k=2), ns.trapezoid(y, x=x),
        ns.cumulative_trapezoid(y, x=x), ns.logit(ns.sigmoid(y), eps=0.2),
        ns.take(y, ns.to_tensor(np.array([0, 13, -2], np.int64)), mode="clip"),
        ns.increment(ns.assign(y), 2.0), ns.clone(y),
        ns.scale(y, 2.0, 1.0, bias_after_scale=False), ns.clip(y, min=0.0),
        ns.lerp(x, y, ns.full_like(x, 0.25)), ns.kron(x[0], y[1]),
        ns.heaviside(y, x), ns.copysign(x, y), ns.hypot(x, y)),
        [np.sort(ANY, 1), ANY2, np.array([[1], [3], [0]], np.int64)],
        grad=True),
]

TABLES = {"sweep": SWEEP, "math": MATH, "breadth": BREADTH,
          "trouble": TROUBLE}
ALL = SWEEP + MATH + BREADTH + TROUBLE


# ---------------------------------------------------------------------------
# running a case
# ---------------------------------------------------------------------------

def flat_outputs(out):
    """An op's result (a Tensor, a Python value, or nested tuples/lists of
    them) -> a flat list."""
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in flat_outputs(x)]
    return [out]


def as_numpy(o):
    return np.asarray(o.numpy() if hasattr(o, "numpy") else o)


def is_float(a):
    return np.issubdtype(np.asarray(a).dtype, np.floating) or \
        np.issubdtype(np.asarray(a).dtype, np.complexfloating)


def run(ns, case, grad=False):
    """(outputs as numpy arrays, the outputs themselves, input gradients
    (None where an input has none)) of the case through `ns`, on its
    expected place."""
    ts = [ns.to_tensor(a, stop_gradient=not (grad and is_float(a)))
          for a in case.inputs]
    out = flat_outputs(case.fn(ns, *ts))
    grads = None
    if grad:
        loss = None
        for o in out:
            if hasattr(o, "numpy") and is_float(o.numpy()) and \
                    not o.stop_gradient and o.size:
                s = ns.sum(o)
                loss = s if loss is None else loss + s
        if loss is not None:
            loss.backward()
        grads = [None if t.grad is None else t.grad.numpy() for t in ts]
    return [as_numpy(o) for o in out], out, grads


def assert_close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    if is_float(want) or is_float(got):
        np.testing.assert_allclose(got.astype(np.complex128 if np.iscomplexobj(got)
                                              else np.float64),
                                   want.astype(np.complex128 if np.iscomplexobj(want)
                                               else np.float64),
                                   rtol=tol, atol=tol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def port_on_device(P, case, device):
    """The case through the port with `device` (a CUDA place name) set
    against the port with the CPU set: every output a tensor on that
    device, values within the case's `tol` (integer, bool and index outputs
    equal), gradients within it too.  Returns the largest float difference
    seen."""
    prev = P.get_device()
    try:
        P.set_device("cpu")
        want, _, want_g = run(P, case, grad=case.grad)
        P.set_device(device)
        got, outs, got_g = run(P, case, grad=case.grad)
    finally:
        P.set_device(prev)
    worst = 0.0
    for i, (o, g, w) in enumerate(zip(outs, got, want)):
        if hasattr(o, "place"):
            assert o.place.device_type == "gpu", f"{case.name}[{i}] on {o.place}"
        assert_close(g, w, case.tol, f"{case.name}[{i}]")
        if is_float(w) and np.asarray(w).size:
            worst = max(worst, float(np.nanmax(np.abs(
                np.asarray(g, np.complex128) - np.asarray(w, np.complex128)))))
    if case.grad:
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            assert (g is None) == (w is None), f"{case.name} grad[{i}]"
            if w is not None:
                assert_close(g, w, case.tol, f"{case.name} grad[{i}]")
    return worst
