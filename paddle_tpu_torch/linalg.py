"""paddle.linalg namespace (re-exports; reference `python/paddle/linalg.py`)."""
from .ops.linalg import *  # noqa
from .ops.linalg import (cholesky, cholesky_solve, cond, corrcoef, cov, det, eig,  # noqa
                         eigh, eigvals, eigvalsh, householder_product, inv, inverse,
                         lstsq, lu, matrix_norm, matrix_power, matrix_rank, multi_dot,
                         norm, pdist, pinv, qr, slogdet, solve, svd,
                         triangular_solve, vector_norm)
from .ops.math import matmul  # noqa
