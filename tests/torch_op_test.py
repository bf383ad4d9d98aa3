"""The op twin harness (beside `tests/op_test.py`, which stays as it is).

`twin(case)` runs one op case (`tests/torch_op_cases.py`) through
`paddle_tpu` and through `paddle_tpu_torch` on the CPU, on the same numpy
inputs: values against each other at the case's tolerance (integers, bools
and indices equal), each against the numpy oracle where there is one, and
the gradients of the port's `backward()` against the reference's.  Dtype
names must agree too, but for exactly the outputs listed in
DTYPE_DIFFERS.  The reference's `to_static` half waits for the port's
`jit/` (ROADMAP Queue 1 item 13.8); its numeric-gradient loops are not run
(the reference's analytic gradients are the yardstick).
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core import place as place_mod
from torch_op_cases import assert_close, run

# Every case whose output dtypes differ from the reference's: {case:
# (output indices, why)}.  Each such output is int32 in the reference and
# int64 in the port: the reference runs JAX with 64-bit types off, so
# where Paddle gives int64 it gives int32, and its int64 inputs arrive as
# int32; the port keeps Paddle's int64 (as `core/tensor.py` keeps 64-bit
# data).
_INDEX = "indices are int64, as in Paddle"
_COUNT = "counts are int64 (torch's and Paddle's sums of integers)"
DTYPE_DIFFERS = {
    "count_nonzero": ({0}, _COUNT),
    "topk_ties": ({1}, _INDEX),
    "topk_ties_smallest": ({1}, _INDEX),
    "argsort_ties": ({0}, _INDEX),
    "argsort_ties_descending": ({0}, _INDEX),
    "cummax_ties": ({1}, _INDEX),
    "cummin_ties_flat": ({1}, _INDEX),
    "kthvalue_ties": ({1}, _INDEX),
    "mode_ties": ({1}, _INDEX),
    "argmax_ties": ({0}, _INDEX),
    "argmin_flat": ({0}, _INDEX),
    "argmax_keepdim": ({0}, _INDEX),
    "matrix_rank": ({0}, "torch.linalg.matrix_rank's int64 rank"),
    "unique_all": ({0, 1, 2, 3}, "int64 data stays int64; indices and "
                   "counts are int64"),
    "unique_axis": ({0, 1}, "int64 data stays int64; counts are int64"),
    "unique_consecutive": ({0, 1, 2}, "int64 data stays int64; the inverse "
                           "and counts are int64"),
    "nonzero": ({0, 1, 2}, _INDEX),
    "searchsorted_bucketize": ({0, 1, 2}, _INDEX + " (out_int32=True "
                               "gives int32 in both)"),
    "int_math": ({0, 1, 2, 3, 4, 5}, "int64 data stays int64; bincount's "
                 "counts are int64"),
    "reductions_more": ({0, 5}, _COUNT),
    "creation_ops": ({0, 5, 8, 9, 10}, "integer ranges, integer fills and "
                     "the int64 dtype asked for are int64"),
    "predicates": ({12}, "numel is int64, as in Paddle"),
    "histograms": ({0, 1}, "histogram counts are int64 (the reference "
                   "casts to int64, which its JAX makes int32)"),
    # nn.functional (tests/torch_nn_cases.py)
    "sequence_mask": ({0}, "the mask's default dtype, int64, is int64"),
    "class_center_sample": ({0, 1}, "the remapped labels and the sampled "
                            "class ids are int64"),
    "gather_tree": ({0}, "int64 ids stay int64"),
    "dynamic_decode_beam": ({0, 4}, "token ids and lengths are int64"),
}


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = place_mod._expected_place
    P.set_device("cpu")
    yield
    place_mod._expected_place = prev


def dtype_name(a):
    return np.asarray(a).dtype.name


def twin(case):
    """Hold the port to the reference (and to the case's oracle) on one
    case; returns the port's outputs as numpy arrays."""
    want, _, want_g = run(R, case, grad=case.grad)
    got, _, got_g = run(P, case, grad=case.grad)
    assert len(got) == len(want), (case.name, len(got), len(want))
    differs = {i for i, (g, w) in enumerate(zip(got, want))
               if dtype_name(g) != dtype_name(w)}
    assert differs == DTYPE_DIFFERS.get(case.name, (set(), ""))[0], \
        (case.name, differs)
    for i, (g, w) in enumerate(zip(got, want)):
        what = f"{case.name}[{i}]"
        if i in differs:
            assert (dtype_name(w), dtype_name(g)) == ("int32", "int64"), what
        assert_close(g, w, case.tol, what)
    if case.oracle is not None:
        expect = case.oracle(*case.inputs)
        expect = list(expect) if isinstance(expect, (tuple, list)) else [expect]
        assert len(expect) == len(got), case.name
        for i, (g, e) in enumerate(zip(got, expect)):
            assert_close(g, np.asarray(e, g.dtype) if not np.iscomplexobj(e)
                         else e, case.tol, f"{case.name}[{i}] vs numpy")
    if case.grad:
        for i, (g, w) in enumerate(zip(got_g, want_g)):
            assert (g is None) == (w is None), f"{case.name} grad[{i}]"
            if w is not None:
                assert_close(g, w, case.tol, f"{case.name} grad[{i}]")
    return got
