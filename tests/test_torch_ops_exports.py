"""The port's top-level namespace and `Tensor` methods against the JAX
package's.

Every name `paddle_tpu/__init__.py` imports from `paddle_tpu.ops` exists
at the top of `paddle_tpu_torch` and is callable; every `Tensor` method
the reference's `_patch_tensor_methods` binds (its `hasattr` rule over
the nine op modules, its four overrides and the sparse conversions) exists
on the port's `Tensor`; and the reference's public top-level names the
port lacks are exactly LEFT_OUT, each with the ROADMAP Queue 1 item it
waits for, so the list cannot grow quietly.  `paddle.optimizer` exports
the reference's `__all__`, and `optimizer`, `optimizer.lr` and
`incubate.distributed.models.moe` exactly the reference's public names.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu.ops import (creation, inplace, linalg, logic, manipulation,
                            math, random, search, stat)
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# the reference's public top-level names the port does not have yet, by
# the ROADMAP Queue 1 item (13.n: item 13, sub-item n) each waits for
LEFT_OUT = {
    "amp": "13.5", "io": "13.6",
    "save": "13.7", "load": "13.7", "framework": "13.7",
    "jit": "13.8", "static": "13.8", "to_static": "13.8",
    "enable_static": "13.8", "disable_static": "13.8",
    "DataParallel": "13.9",
    "hapi": "13.10", "Model": "13.10", "summary": "13.10", "flops": "13.10",
    "metric": "13.10",
    "vision": "13.11", "audio": "13.11", "text": "13.11",
    "geometric": "13.11", "sparse": "13.11", "distribution": "13.11",
    "fft": "13.12", "signal": "13.12", "onnx": "13.12",
    "to_dlpack": "13.12", "from_dlpack": "13.12",
}
# not an API name: the reference module's `from __future__ import annotations`
NOT_API = {"annotations"}


def reference_op_exports():
    """The names `paddle_tpu/__init__.py` imports from its `ops` package
    (the in-place module's star import: its `__all__`)."""
    tree = ast.parse((ROOT / "paddle_tpu" / "__init__.py").read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1 and \
                (node.module or "").startswith("ops"):
            for alias in node.names:
                if alias.name == "*":
                    names += list(inplace.__all__)
                else:
                    names.append(alias.asname or alias.name)
    return names


OP_EXPORTS = reference_op_exports()


def test_the_reference_exports_its_ops_as_read():
    assert len(OP_EXPORTS) > 300
    assert all(hasattr(R, n) for n in OP_EXPORTS)


@pytest.mark.parametrize("name", sorted(set(OP_EXPORTS)))
def test_every_op_export_is_a_callable_of_the_port(name):
    assert callable(getattr(P, name)), name


def reference_bound_methods():
    """The Tensor methods the reference's `_patch_tensor_methods` binds:
    each public callable of the op modules (its `skip` set aside) and the
    explicit ones."""
    skip = {"broadcast_shape", "create_parameter", "meshgrid", "is_tensor",
            "get_rng_state", "set_rng_state", "get_cuda_rng_state",
            "set_cuda_rng_state"}
    names = set()
    for src in (math, manipulation, logic, search, stat, linalg, creation,
                random, inplace):
        names |= {n for n in dir(src) if not n.startswith("_") and
                  n not in skip and callable(getattr(src, n))}
    return names | {"norm", "matmul", "reshape", "cast", "to_sparse_coo",
                    "to_sparse_csr", "to_dense", "is_sparse", "is_sparse_coo",
                    "is_sparse_csr"}


def test_every_bound_tensor_method_exists_on_the_port():
    missing = sorted(n for n in reference_bound_methods()
                     if not hasattr(P.Tensor, n))
    assert missing == []


def test_the_top_level_names_left_out_are_exactly_the_listed_ones():
    public = {n for n in dir(R) if not n.startswith("_")} - NOT_API
    assert sorted(n for n in public if not hasattr(P, n)) == sorted(LEFT_OUT)
    assert all(LEFT_OUT.values())


def test_bound_methods_and_the_overrides_run():
    x = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_allclose(x.norm().numpy(), np.linalg.norm(x.numpy()),
                               rtol=1e-6)
    assert x.reshape([3, 2]).shape == [3, 2]
    assert x.cast("int32").dtype == P.int32
    np.testing.assert_allclose(x.matmul(x, transpose_y=True).numpy(),
                               x.numpy() @ x.numpy().T)
    assert x.sum(axis=1).numpy().tolist() == [3.0, 12.0]
    assert x.topk(1)[1].numpy().tolist() == [[2], [2]]
    assert x.to_dense() is x and not x.is_sparse()
    assert not x.is_sparse_coo() and not x.is_sparse_csr()
    for conv in (x.to_sparse_coo, x.to_sparse_csr):
        with pytest.raises(NotImplementedError, match="item 13, sub-item 11"):
            conv()


def test_the_top_level_helpers():
    fi, rf = P.finfo(P.bfloat16), R.finfo(R.bfloat16)
    for k in ("min", "max", "eps", "tiny", "smallest_normal", "resolution",
              "bits", "dtype"):
        assert getattr(fi, k) == getattr(rf, k), k
    ii, ri = P.iinfo("int16"), R.iinfo("int16")
    assert (ii.min, ii.max, ii.bits, ii.dtype) == (ri.min, ri.max, ri.bits,
                                                   ri.dtype)
    assert isinstance(P.float32, P.dtype)
    assert P.in_dynamic_mode() and P.disable_signal_handler() is None
    assert P.tolist(P.to_tensor(np.float32([[1, 2]]))) == [[1.0, 2.0]]
    assert P.check_shape([2, 3]) == [2, 3]
    with P.LazyGuard() as g:
        assert isinstance(g, P.LazyGuard)
    batches = list(P.batch(lambda: iter(range(5)), 2)())
    assert batches == [[0, 1], [2, 3], [4]]
    assert list(P.batch(lambda: iter(range(5)), 2, drop_last=True)()) == \
        [[0, 1], [2, 3]]
    P.set_printoptions(precision=3)
    assert "1.235" in repr(P.to_tensor(np.float32([1.23456])))
    P.set_printoptions(precision=8)
    prev = P.get_device()
    assert P.device("cpu") == P.CPUPlace() and P.get_device() == "cpu"
    P.set_device(prev)


def test_creation_lands_on_the_set_device():
    for t in (P.zeros([2]), P.arange(3), P.full([2], 1.5), P.eye(2),
              P.linspace(0, 1, 3), P.tril_indices(3, 3), P.rand([2]),
              P.randint(0, 3, [2]), P.create_parameter([2], "float32")):
        assert t.place == P.CPUPlace()


def test_paddle_linalg_is_the_references_namespace():
    from paddle_tpu import linalg as ref_linalg
    want = {n for n in dir(ref_linalg) if not n.startswith("_") and
            callable(getattr(ref_linalg, n))}
    got = {n for n in dir(P.linalg) if not n.startswith("_") and
           callable(getattr(P.linalg, n))}
    assert want <= got, sorted(want - got)


def test_optimizer_all_is_the_references():
    assert P.optimizer.__all__ == R.optimizer.__all__
    assert all(hasattr(P.optimizer, n) for n in R.optimizer.__all__)


@pytest.mark.parametrize("path", ["optimizer", "optimizer.lr",
                                  "incubate.distributed.models.moe"])
def test_namespace_names_are_the_references(path):
    import inspect
    ref, port = R, P
    for part in path.split("."):
        ref, port = getattr(ref, part), getattr(port, part)

    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_") and
                n != "annotations" and not inspect.ismodule(getattr(mod, n))}
    assert names(port) == names(ref)
