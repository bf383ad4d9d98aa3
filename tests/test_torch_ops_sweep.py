"""The port's ops against the JAX package's: every row of
`tests/test_ops_sweep.py`'s ALL_CASES (93 rows), on the CPU.

Each row runs through both packages on the same numpy inputs (the
reference's own data, RandomState(7)): values at float32 2e-5 abs and rel,
as the reference sweep uses, and against its numpy oracle where it has
one; where it checks gradients, the port's `backward()` against the
reference's at the same tolerance.  The reference's `to_static` half waits
for `jit/` (ROADMAP Queue 1 item 13.8).  The dtypes that differ from the
reference's are exactly those `tests/torch_op_test.py` lists (each twin
checks its case's entry).
"""
import pytest

import paddle_tpu_torch as P
import test_ops_sweep
from torch_op_cases import ALL, SWEEP, run
from torch_nn_cases import ALL as NN_ALL
from torch_op_test import DTYPE_DIFFERS, on_cpu, twin  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_the_table_mirrors_the_reference_sweep_row_for_row():
    assert [c.name for c in SWEEP] == [c[0] for c in test_ops_sweep.ALL_CASES]
    assert [c.grad for c in SWEEP] == [c[4] for c in test_ops_sweep.ALL_CASES]


@pytest.mark.parametrize("case", SWEEP, ids=[c.name for c in SWEEP])
def test_op_twin(case):
    twin(case)


def test_the_dtype_differences_listed_are_int64_outputs_of_real_cases():
    """DTYPE_DIFFERS lists, with its reasons, every output whose dtype is
    not the reference's (each twin holds its case to its entry exactly):
    each names a twin case and int64 outputs of the port."""
    by_name = {c.name: c for c in ALL + NN_ALL}
    for name, (idx, why) in DTYPE_DIFFERS.items():
        assert why, name
        got = run(P, by_name[name])[0]
        assert {got[i].dtype.name for i in idx} == {"int64"}, name
