"""PyTorch/CUDA port of `paddle_tpu`: the eager Tensor, autograd and Layer
API with the op namespace (`paddle.*`, `paddle.linalg` and the `Tensor`
methods bound from the ops), `nn` and `optimizer` (with `optimizer.lr`),
the serving path, the trainer (one device or a
mesh), the auto-parallel Engine and the flash-attention API.

The JAX package `paddle_tpu` stays the reference; this package mirrors its
module paths (`core/*`, `autograd/*`, `ops/*`, `linalg.py`, `nn/*`,
`optimizer/*`, `incubate/nn/functional`, `models/gpt.py`,
`incubate/kernels/*`, `inference/*`, `parallel/hybrid.py`,
`distributed/auto_parallel/engine.py`) and keeps its layouts at every
public function.  It imports torch and numpy, never jax and nothing of
`paddle_tpu`.  Entry points run on the CUDA card unless the caller passes
`device="cpu"` (or, for the eager API, `set_device("cpu")`), which takes
every kernel's plain PyTorch version.

Top-level names of the reference whose modules are not ported yet are
absent: `save`/`load`, `to_static`, `enable_static`/`disable_static`,
`DataParallel`, `Model`, `summary`, `flops`, `to_dlpack`/`from_dlpack` and
the subpackages `amp`, `audio`, `fft`, ... (ROADMAP Queue 1, item 13).
"""
# ---- core ----
from .core import dtype as _dtype_mod
from .core.dtype import (bool_ as bool, uint8, int8, int16, int32, int64,  # noqa
                         float16, bfloat16, float32, float64, complex64,
                         complex128, set_default_dtype, get_default_dtype)
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace,  # noqa
                         Place, TPUPlace, XPUPlace, set_device, get_device,
                         device_count, is_compiled_with_cuda,
                         is_compiled_with_rocm, is_compiled_with_tpu,
                         is_compiled_with_xpu)
from .core.tensor import Tensor, to_tensor  # noqa
from .core.autograd import (no_grad, enable_grad, set_grad_enabled,  # noqa
                            is_grad_enabled)
from .core.generator import seed, get_rng_state_tracker  # noqa
from .core.flags import get_flags, set_flags  # noqa

# ---- ops: flatten the functional namespace like paddle.* ----
from .ops.creation import (arange, assign, clone, complex, create_parameter, diag,  # noqa
                           diag_embed, diagflat, empty, empty_like, eye, full,
                           full_like, linspace, logspace, meshgrid, ones, ones_like,
                           polar, tril, tril_indices, triu, triu_indices, zeros,
                           zeros_like)
from .ops.math import (abs, acos, acosh, accuracy, add, addmm, all, amax, amin,  # noqa
                       angle, any, asin, asinh, atan, atan2, atanh, bmm,
                       broadcast_shape, ceil, clip, conj, copysign, cos, cosh,
                       count_nonzero, cross, cumprod, cummax, cummin, cumsum,
                       deg2rad, diagonal, diff, digamma, divide, dot,
                       erf, erfinv, exp, expm1, floor, floor_divide, floor_mod, fmax,
                       fmin, frac, gcd, heaviside, hypot, i0, i0e, i1, i1e, imag,
                       increment, inner, isfinite, isinf, isnan, isneginf, isposinf,
                       isreal, kron, lcm, ldexp, lerp, lgamma, log, log10, log1p,
                       log2, logaddexp, logcumsumexp, logsumexp, matmul, max, maximum,
                       mean, min, minimum, mm, mod, multiplex, multiply, mv, nan_to_num,
                       nanmean, nansum, neg, nextafter, outer, polygamma, pow, prod,
                       rad2deg, real, reciprocal, remainder, round, rsqrt, scale, sgn,
                       sign, sin, sinh, sqrt, square, stanh, subtract, sum, t, take,
                       tan, tanh, trace, trunc)
from .ops.manipulation import (as_complex, as_real, as_strided, atleast_1d,  # noqa
                               atleast_2d, atleast_3d, broadcast_tensors, broadcast_to,
                               cast, chunk, concat, crop, expand, expand_as, flatten,
                               flip, gather, gather_nd, index_add, index_put,
                               index_sample, index_select, is_complex, is_empty,
                               is_floating_point, is_integer, is_tensor, masked_fill,
                               masked_fill_, masked_select, moveaxis, nonzero, numel,
                               pad, put_along_axis, rank, repeat_interleave, reshape,
                               reshape_, roll, rot90, scatter, scatter_, scatter_nd,
                               scatter_nd_add, shape, shard_index, slice, split,
                               squeeze, squeeze_, stack, strided_slice, swapaxes,
                               take_along_axis, tensor_split, tile, transpose, unbind,
                               unique, unique_consecutive, unsqueeze, unsqueeze_,
                               unstack, view, view_as, where, where_)
from .ops.logic import (allclose, bitwise_and, bitwise_not, bitwise_or, bitwise_xor,  # noqa
                        equal, equal_all, greater_equal, greater_than, isclose,
                        less_equal, less_than, logical_and, logical_not, logical_or,
                        logical_xor, not_equal)
from .ops.random import (bernoulli, bernoulli_, binomial, cauchy_, exponential_,  # noqa
                         gaussian, geometric_, get_cuda_rng_state, get_rng_state,
                         log_normal_, multinomial, normal, normal_, poisson, rand,
                         rand_like, randint, randint_like, randn, randn_like, randperm,
                         set_cuda_rng_state, set_rng_state, standard_normal, uniform,
                         uniform_)
from .ops.search import (argmax, argmin, argsort, bucketize, kthvalue, mode,  # noqa
                         searchsorted, sort, topk)
from .ops.stat import median, nanmedian, nanquantile, quantile, std, var  # noqa
from .ops.linalg import (bincount, cdist, cholesky, cholesky_solve, cond, corrcoef,  # noqa
                         cov, det, dist, eig, eigh, eigvals, eigvalsh, histogram,
                         histogramdd, householder_product, inverse, lstsq, lu,
                         matrix_power, matrix_rank, multi_dot, norm, pdist, pinv, qr,
                         slogdet, solve, svd, triangular_solve)
from .ops.einsum import einsum  # noqa
from .ops.math import (add_n, cumulative_trapezoid, frexp, logit, renorm,  # noqa
                       sigmoid, trapezoid)
from .ops.manipulation import reverse, unflatten, unfold, vsplit  # noqa
from .ops.linalg import lu_unpack, pca_lowrank, tensordot  # noqa
from .ops.creation import create_tensor, vander  # noqa
from .ops.inplace import *  # noqa  (trailing-underscore in-place variants)

from .param_attr import ParamAttr  # noqa
from .autograd import grad, backward  # noqa

from . import (analysis, autograd, distributed, incubate, inference,  # noqa
               linalg, models, nn, ops, optimizer, parallel, utils)

# the port is always eager until `jit/` and `static/` (item 13.8) arrive
_in_dynamic = True


def in_dynamic_mode():
    return _in_dynamic


def disable_signal_handler():
    pass


def device(dev):
    return set_device(dev)


class finfo:
    """ref paddle.finfo: floating-point type limits."""

    def __init__(self, dtype):
        import torch
        td = _dtype_mod.to_torch(dtype)
        fi = torch.finfo(td)
        self.min = float(fi.min)
        self.max = float(fi.max)
        self.eps = float(fi.eps)
        self.tiny = float(fi.tiny)
        self.smallest_normal = float(fi.tiny)
        # 10**-precision as a value of the dtype, as numpy's finfo gives it
        self.resolution = torch.tensor(fi.resolution, dtype=td).item()
        self.bits = int(fi.bits)
        self.dtype = str(fi.dtype)


class iinfo:
    """ref paddle.iinfo: integer type limits."""

    def __init__(self, dtype):
        import torch
        ii = torch.iinfo(_dtype_mod.to_torch(dtype))
        self.min = int(ii.min)
        self.max = int(ii.max)
        self.bits = int(ii.bits)
        self.dtype = str(ii.dtype)


dtype = _dtype_mod.DType  # paddle.dtype type object (ref VarType alias)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """ref paddle.set_printoptions — forwards to numpy's print options,
    which `Tensor.__repr__` prints with."""
    import numpy as _np
    kw = {}
    if precision is not None:
        kw["precision"] = precision
    if threshold is not None:
        kw["threshold"] = threshold
    if edgeitems is not None:
        kw["edgeitems"] = edgeitems
    if linewidth is not None:
        kw["linewidth"] = linewidth
    if sci_mode is not None:
        kw["suppress"] = not sci_mode
    _np.set_printoptions(**kw)


def tolist(x):
    """ref paddle.tolist: nested python list of tensor values."""
    import numpy as _np
    return _np.asarray(x.numpy() if hasattr(x, "numpy") else x).tolist()


class LazyGuard:
    """ref paddle.LazyGuard: delayed parameter init context.  Parameters
    materialize at once (eager init is cheap), so this is a transparent
    shim."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """ref paddle.batch (legacy reader decorator)."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf
    return batched


def check_shape(x):
    """ref static nn.check_shape helper (shape sanity assert shim)."""
    return x


def _to_sparse(self, *args, **kwargs):
    raise NotImplementedError(
        "Tensor.to_sparse_coo/to_sparse_csr arrive with a later slice of the "
        "port (ROADMAP Queue 1: item 13, sub-item 11, `sparse/`)")


def _patch_tensor_methods():
    """Attach the functional namespace as Tensor methods, like the reference's
    monkey-patch in `python/paddle/fluid/dygraph/tensor_patch_methods.py`:
    every public callable of the op modules where `Tensor` has no such
    attribute, then the reference's explicit overrides."""
    from .ops import (creation, inplace, linalg as _linalg, logic,
                      manipulation, math, random, search, stat)

    method_sources = [math, manipulation, logic, search, stat, _linalg, creation,
                      random, inplace]
    skip = {"broadcast_shape", "create_parameter", "meshgrid", "is_tensor",
            "get_rng_state", "set_rng_state", "get_cuda_rng_state", "set_cuda_rng_state"}
    for src in method_sources:
        for name in dir(src):
            if name.startswith("_") or name in skip:
                continue
            fn = getattr(src, name)
            if not callable(fn):
                continue
            if not hasattr(Tensor, name):
                setattr(Tensor, name, fn)
    # explicit overrides where method semantics differ slightly
    Tensor.norm = _linalg.norm
    Tensor.matmul = math.matmul
    Tensor.reshape = manipulation.reshape
    Tensor.cast = manipulation.cast

    # sparse conversions wait for `sparse/`; a dense Tensor is its own dense form
    Tensor.to_sparse_coo = _to_sparse
    Tensor.to_sparse_csr = _to_sparse
    Tensor.to_dense = lambda self: self
    Tensor.is_sparse = lambda self: False
    Tensor.is_sparse_coo = lambda self: False
    Tensor.is_sparse_csr = lambda self: False


_patch_tensor_methods()

__version__ = "0.1.0"
version = type("version", (), {"full_version": __version__,
                               "commit": "torch-port",
                               "cuda": staticmethod(lambda: __import__("torch").version.cuda),
                               "show": staticmethod(lambda: print(__version__))})
