"""Linear algebra ops (reference: `python/paddle/tensor/linalg.py`).

The reference's `jnp.linalg` and `jax.scipy.linalg` calls are
`torch.linalg`'s.  `lu` returns LAPACK's 1-based int32 pivots, as the
reference does, so `lu_unpack` agrees.  `lstsq` with no `driver` is the
reference's SVD solve, written in torch, on any device; a named driver
goes to `torch.linalg.lstsq`, which on the card takes `gels` only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, apply
from ._common import data as _to_data
from .math import matmul  # noqa: F401


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    def f(a):
        if axis is None:
            if p in ("fro", 2):
                return torch.sqrt(torch.sum(torch.square(a)))
            if p == "nuc":
                return torch.sum(torch.linalg.svdvals(a))
            if p == np.inf:
                return torch.amax(torch.abs(a))
            if p == -np.inf:
                return torch.amin(torch.abs(a))
            return torch.pow(torch.sum(torch.pow(torch.abs(a), p)), 1.0 / p)
        ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
        if isinstance(ax, tuple) and p == "fro":
            return torch.sqrt(torch.sum(torch.square(a), ax, keepdim))
        if p == np.inf:
            return torch.amax(torch.abs(a), ax, keepdim)
        if p == -np.inf:
            return torch.amin(torch.abs(a), ax, keepdim)
        if p == 0:
            return torch.sum((a != 0).to(a.dtype), ax, keepdim)
        pp = 2 if p == "fro" else p
        return torch.pow(torch.sum(torch.pow(torch.abs(a), pp), ax, keepdim), 1.0 / pp)
    return apply("norm", f, x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p, axis, keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return apply("matrix_norm", lambda a: torch.linalg.matrix_norm(
        a, ord=p, dim=tuple(axis), keepdim=keepdim), x)


def dist(x, y, p=2, name=None):
    return norm(x - y if isinstance(x, Tensor) else Tensor(_to_data(x)) - y, p)


def cond(x, p=None, name=None):
    return apply("cond", lambda a: torch.linalg.cond(a, p), x)


def dot(x, y, name=None):
    return apply("dot", lambda a, b: torch.sum(a * b, -1), x, y)


def cholesky(x, upper=False, name=None):
    return apply("cholesky", lambda a: torch.linalg.cholesky(a, upper=upper), x)


def cholesky_solve(x, y, upper=False, name=None):
    return apply("cholesky_solve", lambda b, L: torch.cholesky_solve(b, L, upper),
                 x, y)


def inverse(x, name=None):
    return apply("inverse", torch.linalg.inv, x)


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return apply("pinv", lambda a: torch.linalg.pinv(a, rtol=rcond,
                                                     hermitian=hermitian), x)


def det(x, name=None):
    return apply("det", torch.linalg.det, x)


def slogdet(x, name=None):
    def f(a):
        sign, logdet = torch.linalg.slogdet(a)
        return torch.stack([sign, logdet])
    return apply("slogdet", f, x)


def matrix_power(x, n, name=None):
    return apply("matrix_power", lambda a: torch.linalg.matrix_power(a, n), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    # the reference passes `tol` to jnp's second parameter, rtol
    return apply("matrix_rank", lambda a: torch.linalg.matrix_rank(
        a, rtol=tol, hermitian=hermitian), x)


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return apply("qr", lambda a: torch.linalg.qr(a, mode="r")[1], x)
    return apply("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)), x)


def lu(x, pivot=True, get_infos=False, name=None):
    outs = apply("lu", lambda a: tuple(torch.linalg.lu_factor(a)), x)
    if get_infos:
        return outs[0], outs[1], Tensor._wrap(torch.zeros(
            (), dtype=torch.int32, device=outs[0]._t.device))
    return outs


def svd(x, full_matrices=False, name=None):
    return apply("svd", lambda a: tuple(torch.linalg.svd(a, full_matrices=full_matrices)), x)


def eig(x, name=None):
    return apply("eig", lambda a: tuple(torch.linalg.eig(a)), x)


def eigh(x, UPLO="L", name=None):
    return apply("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)), x)


def eigvals(x, name=None):
    return apply("eigvals", torch.linalg.eigvals, x)


def eigvalsh(x, UPLO="L", name=None):
    return apply("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO), x)


def solve(x, y, name=None):
    return apply("solve", torch.linalg.solve, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False, name=None):
    def f(a, b):
        if transpose:       # A^T X = B: the transpose is triangular the other way
            a, up = a.mT, not upper
        else:
            up = upper
        return torch.linalg.solve_triangular(a, b, upper=up,
                                             unitriangular=unitriangular)
    return apply("triangular_solve", f, x, y)


def _lstsq_svd(a, b, rcond):
    """jnp.linalg.lstsq: the SVD solve, with its rank, singular values and
    residuals (the squared column norms of b - a x, at every rank, as jnp
    returns them)."""
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    m, n = a.shape[-2:]
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    eps = torch.finfo(a.dtype).eps
    rcond = eps * max(m, n) if rcond is None else (eps if rcond < 0 else rcond)
    mask = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(mask, 1.0 / torch.where(mask, s, 1.0), 0.0)
    sol = vh.mT @ (s_inv[..., None] * (u.mT @ bb))
    rank = mask.sum(-1).to(torch.int32)
    resid = torch.sum(torch.abs(bb - a @ sol) ** 2, -2)
    return (sol[:, 0] if vec else sol), resid, rank, s


def lstsq(x, y, rcond=None, driver=None, name=None):
    def f(a, b):
        if driver is None:
            return _lstsq_svd(a, b, rcond)
        if a.is_cuda and driver != "gels":
            raise ValueError(f"lstsq: driver {driver!r} is not available on "
                             "the CUDA device, which takes 'gels' only")
        sol, res, rank_, sv = torch.linalg.lstsq(a, b, rcond=rcond, driver=driver)
        return sol, res, rank_.to(torch.int32), sv
    return apply("lstsq", f, x, y)


def multi_dot(x, name=None):
    return apply("multi_dot", lambda *arrs: torch.linalg.multi_dot(arrs), *x)


def bincount(x, weights=None, minlength=0, name=None):
    a = _to_data(x)
    w = None if weights is None else _to_data(weights, a.device)
    out = torch.bincount(a, w, minlength)
    return Tensor._wrap(out if w is None else out.to(w.dtype))


def histogram(input, bins=100, min=0, max=0, name=None):
    a = _to_data(input).detach()
    lo, hi = (min, max) if (min != 0 or max != 0) else \
        (float(a.min()), float(a.max()))
    return Tensor._wrap(_hist_counts(a.reshape(-1, 1), [bins], [(lo, hi)])[0]
                        .to(torch.int64))


def _edges(col, bins, rng):
    """numpy's bin edges of one column: `bins` evenly spaced over `rng` (or
    the data's range, widened by 0.5 each way when it is one value), or the
    given edges."""
    if not isinstance(bins, (int, np.integer)):
        return _to_data(bins, col.device).to(torch.float64)
    lo, hi = (float(col.min()), float(col.max())) if rng is None else \
        (float(rng[0]), float(rng[1]))
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, int(bins) + 1, dtype=torch.float64,
                          device=col.device)


def _hist_counts(x, bins, ranges, weights=None):
    """(counts, edges) of numpy's histogramdd over the rows of x [N, D]:
    bins close on the left, the last also on the right, values outside
    the edges are dropped."""
    d = x.shape[1]
    edges = [_edges(x[:, i], bins[i], None if ranges is None else ranges[i])
             for i in range(d)]
    sizes = [len(e) - 1 for e in edges]
    flat = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    keep = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for i, e in enumerate(edges):
        v = x[:, i].to(torch.float64)
        b = torch.searchsorted(e, v, right=True) - 1
        b = torch.where(v == e[-1], sizes[i] - 1, b)
        keep &= (b >= 0) & (b < sizes[i])
        flat = flat * sizes[i] + b.clamp(0, sizes[i] - 1)
    w = keep.to(torch.float64) if weights is None else \
        torch.where(keep, weights.to(torch.float64), 0.0)
    counts = torch.zeros(int(np.prod(sizes)), dtype=torch.float64,
                         device=x.device).index_add_(0, flat, w)
    return counts.reshape(sizes), edges


def histogramdd(x, bins=10, ranges=None, density=False, weights=None, name=None):
    a = _to_data(x).detach()
    d = a.shape[-1]
    bins_l = list(bins) if isinstance(bins, (list, tuple)) else [bins] * d
    rng = None if ranges is None else [tuple(ranges[2 * i:2 * i + 2])
                                       if not isinstance(ranges[0], (list, tuple))
                                       else tuple(ranges[i]) for i in range(d)]
    w = None if weights is None else _to_data(weights, a.device).reshape(-1)
    hist, edges = _hist_counts(a.reshape(-1, d), bins_l, rng, w)
    if density:
        vol = torch.ones_like(hist)
        for i, e in enumerate(edges):
            shape = [1] * d
            shape[i] = -1
            vol = vol * torch.diff(e).reshape(shape)
        hist = hist / hist.sum() / vol
    dt = a.dtype if a.is_floating_point() else torch.float32
    return Tensor._wrap(hist.to(dt)), [Tensor._wrap(e.to(dt)) for e in edges]


def householder_product(x, tau, name=None):
    """Q = H_0 ... H_{n-1} from the Householder vectors below the diagonal
    of x [m, n] (m x m, as the reference returns it)."""
    def f(a, t):
        m, n = a.shape[-2], a.shape[-1]
        q = torch.eye(m, dtype=a.dtype, device=a.device)
        rows = torch.arange(m, device=a.device)
        for i in range(n - 1, -1, -1):
            v = torch.where(rows < i, 0.0, a[:, i])
            v = torch.where(rows == i, 1.0, v)
            q = q - t[i] * torch.outer(v, v @ q)
        return q
    return apply("householder_product", f, x, tau)


def corrcoef(x, rowvar=True, name=None):
    return apply("corrcoef", lambda a: torch.corrcoef(a if rowvar else a.mT), x)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return apply("cov", lambda a: torch.cov(a if rowvar or a.ndim < 2 else a.mT,
                                            correction=1 if ddof else 0), x)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary", name=None):
    def f(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(diff * diff, -1) + 1e-30)
        return torch.pow(torch.sum(torch.pow(torch.abs(diff), p), -1), 1.0 / p)
    return apply("cdist", f, x, y)


def pdist(x, p=2.0, name=None):
    def f(a):
        n = a.shape[0]
        d = a[:, None, :] - a[None, :, :]
        full = torch.pow(torch.sum(torch.pow(torch.abs(d), p), -1), 1.0 / p) if p != 2.0 \
            else torch.sqrt(torch.sum(d * d, -1) + 1e-30)
        iu = torch.triu_indices(n, n, 1, device=a.device)
        return full[iu[0], iu[1]]
    return apply("pdist", f, x)


# ---- breadth additions (reference python/paddle/tensor/linalg.py) ----

def tensordot(x, y, axes=2, name=None):
    """ref linalg.py tensordot; axes int or (list, list)."""
    if isinstance(axes, Tensor):
        axes = axes.numpy().tolist()
    if isinstance(axes, (list, tuple)):
        axes = tuple(list(a.numpy().tolist()) if isinstance(a, Tensor)
                     else list(a) if isinstance(a, (list, tuple)) else [a]
                     for a in axes)
        if len(axes) == 1:
            axes = (axes[0], axes[0])
    return apply("tensordot", lambda a, b: torch.tensordot(a, b, dims=axes), x, y)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """Unpack lu()'s packed LU + 1-based pivots into P, L, U (ref lu_unpack)."""
    P, L, U = apply("lu_unpack", lambda lu_, piv: tuple(torch.lu_unpack(
        lu_, piv.to(torch.int32), unpack_ludata, unpack_pivots)), x, y)
    return P, L, U


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Low-rank PCA (ref linalg.py pca_lowrank): returns (U, S, V)."""
    def f(a):
        m, n = a.shape[-2:]
        k = q if q is not None else min(6, m, n)
        c = a - torch.mean(a, -2, keepdim=True) if center else a
        u, s, vt = torch.linalg.svd(c, full_matrices=False)
        return u[..., :k], s[..., :k], vt.mT[..., :k]
    return apply("pca_lowrank", f, x)
