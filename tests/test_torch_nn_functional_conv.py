"""The port's conv, pooling, vision and sparse-op functionals
(`paddle_tpu_torch/nn/functional/` conv, pooling, vision, sparse_ops)
against the JAX package's, on the CPU: every case of the CONV, POOL and
VISION tables of `tests/torch_nn_cases.py` through both packages on the
same numpy inputs (`tests/torch_op_test.py::twin`), values and input
gradients at float32 2e-5 abs and rel, integer outputs (the 2-D pools'
masks) equal.  `tests/test_torch_nn_functional.py` holds the other tables
and the check that every public function has a case.
"""
import pytest

from test_torch_nn_functional import OWN_FILE
from torch_nn_cases import TABLES
from torch_op_test import on_cpu, twin  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", [c for name in OWN_FILE
                                  for c in TABLES[name]],
                         ids=lambda c: c.name)
def test_functional_twin(case):
    twin(case)
