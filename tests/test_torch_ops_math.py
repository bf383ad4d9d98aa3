"""The port's ops against the JAX package's: the twins of
`tests/test_ops_math.py`, on the CPU.

The same ops, shapes and numpy oracles as the reference file (unary,
binary, broadcasting, matmul, reductions, cumsum, clip/scale, stat and
the gradient cases), on seeded numpy data: values at float32 2e-5 abs
and rel (the reference's 1e-4 for `std`), and the port's `backward()`
against the reference's in place of its numeric gradient loops.
"""
import pytest

from torch_op_cases import MATH
from torch_op_test import on_cpu, twin  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", MATH, ids=[c.name for c in MATH])
def test_math_twin(case):
    twin(case)
