"""The port's autograd (`core/autograd.py`, `autograd/`) against the JAX
package's, on the CPU.

Each case of `tests/test_autograd.py` has a twin here that runs the same
code on the same values through both packages and holds the port's
gradients to the reference's (float32, rtol 1e-6).  Where a reference case
calls an op that the port's `ops/` will bring (`sum`, `topk`), both reach it
through their own `apply` (`apply("sum", torch.sum, y)` against
`apply("sum", jnp.sum, y)`).  Then: double backward through
`create_graph`, hooks and `retain_grads` on tensors that in-place ops
rebind, PyLayer with non-tensor arguments, two outputs and an integer
output, saved-tensor hooks, `grad`'s unused inputs, the post-backward
callbacks, and `jacobian`/`hessian` against the reference's.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu.autograd import PyLayer as RPyLayer
from paddle_tpu.core.tensor import apply as rapply
from paddle_tpu_torch.autograd import PyLayer as PPyLayer
from paddle_tpu_torch.core import autograd as pag
from paddle_tpu_torch.core import place as place_mod
from paddle_tpu_torch.core.tensor import apply as papply
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6

REF = types.SimpleNamespace(
    pkg=R, PyLayer=RPyLayer, autograd=R.autograd,
    sum=lambda y: rapply("sum", jnp.sum, y),
    topk=lambda x, k: rapply("topk", lambda a: tuple(jax.lax.top_k(a, k)),
                             x),
    exp=lambda y: rapply("exp", jnp.exp, y))
PORT = types.SimpleNamespace(
    pkg=P, PyLayer=PPyLayer, autograd=P.autograd,
    sum=lambda y: papply("sum", torch.sum, y),
    topk=lambda x, k: papply("topk", lambda a: torch.topk(a, k), x),
    exp=lambda y: papply("exp", torch.exp, y))


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = place_mod._expected_place
    P.set_device("cpu")
    yield
    place_mod._expected_place = prev


def twin(case):
    """Run case(ns) -> {name: array or None} through both packages and hold
    the port's results to the reference's."""
    want, got = case(REF), case(PORT)
    assert want.keys() == got.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), rtol=RTOL,
                                       err_msg=k)
    return got


def t(ns, a, sg=False):
    return ns.pkg.to_tensor(np.asarray(a, np.float32), stop_gradient=sg)


def g(x):
    return None if x.grad is None else x.grad.numpy()


# ---- the twins of tests/test_autograd.py ----

def test_simple_chain():
    def case(ns):
        x = t(ns, [2.0])
        y = x * x + 3.0 * x
        y.backward()
        return {"x": g(x)}
    assert twin(case)["x"] == [7.0]


def test_fanout_accumulation():
    def case(ns):
        x = t(ns, [3.0])
        (x * 2 + x * 5).backward()
        return {"x": g(x)}
    assert twin(case)["x"] == [7.0]


def test_grad_accumulates_across_backwards():
    def case(ns):
        x = t(ns, [1.0])
        (x * 2).backward()
        (x * 3).backward()
        return {"x": g(x)}
    assert twin(case)["x"] == [5.0]


def test_stop_gradient():
    def case(ns):
        x = t(ns, [1.0])
        y = t(ns, [2.0], sg=True)
        (x * y).backward()
        return {"x": g(x), "y": g(y)}
    assert twin(case)["y"] is None


def test_detach():
    def case(ns):
        x = t(ns, [2.0])
        d = (x * 3).detach()
        assert d.stop_gradient
        (d * x).backward()
        return {"x": g(x)}
    assert twin(case)["x"] == [6.0]


def test_retain_graph_error():
    for ns in (REF, PORT):
        x = t(ns, [2.0])
        y = x * x
        y.backward(retain_graph=True)
        y.backward()
        with pytest.raises(RuntimeError):
            y.backward()
        np.testing.assert_allclose(g(x), [8.0])


def test_no_grad():
    for ns in (REF, PORT):
        x = t(ns, [2.0])
        with ns.pkg.no_grad():
            y = x * x
        assert y.stop_gradient
        assert not (x * x).stop_gradient


def test_partial_grad():
    def case(ns):
        x, y = t(ns, [3.0]), t(ns, [4.0])
        gx, = ns.pkg.grad(x * y, [x])
        assert x.grad is None             # grad() writes no .grad
        return {"gx": gx.numpy()}
    assert twin(case)["gx"] == [4.0]


def test_partial_grad_intermediate():
    def case(ns):
        x = t(ns, [2.0])
        h = x * x
        gh, = ns.pkg.grad(h * 3.0, [h])
        return {"gh": gh.numpy()}
    assert twin(case)["gh"] == [3.0]


def test_multi_output_op():
    def case(ns):
        x = t(ns, [[3.0, 1.0, 2.0]])
        vals, idx = ns.topk(x, 2)
        assert idx.stop_gradient
        ns.sum(vals).backward()
        return {"x": g(x), "idx": idx.numpy().astype(np.int64)}
    np.testing.assert_array_equal(twin(case)["x"], [[1.0, 0.0, 1.0]])


def test_hook():
    def case(ns):
        x = t(ns, [2.0])
        seen = []

        def hook(grad):
            seen.append(grad.numpy().copy())
            return grad * 2
        x.register_hook(hook)
        (x * 3).backward()
        assert len(seen) == 1
        return {"x": g(x), "seen": seen[0]}
    assert twin(case)["x"] == [6.0]


def test_backward_nonscalar_with_grad_tensor():
    def case(ns):
        x = t(ns, [1.0, 2.0])
        (x * x).backward(t(ns, [1.0, 0.5], sg=True))
        return {"x": g(x)}
    np.testing.assert_array_equal(twin(case)["x"], [2.0, 2.0])


def test_pylayer():
    def case(ns):
        class Double(ns.PyLayer):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                return x * 2

            @staticmethod
            def backward(ctx, grad):
                (x,) = ctx.saved_tensor()
                return grad * 2

        x = t(ns, [3.0])
        y = Double.apply(x)
        y.backward()
        return {"y": y.numpy(), "x": g(x)}
    got = twin(case)
    assert got["y"] == [6.0] and got["x"] == [2.0]


def test_setitem_grad():
    def case(ns):
        x = t(ns, [1.0, 2.0, 3.0])
        v = t(ns, [10.0])
        y = x * 1.0
        y[1] = v
        ns.sum(y).backward()
        return {"x": g(x), "v": g(v), "y": y.numpy()}
    got = twin(case)
    np.testing.assert_array_equal(got["x"], [1.0, 0.0, 1.0])
    assert got["v"] == [1.0]


def test_indexing_grad():
    def case(ns):
        x = t(ns, [[1.0, 2.0], [3.0, 4.0]])
        ns.sum(x[0]).backward()
        return {"x": g(x)}
    np.testing.assert_array_equal(twin(case)["x"], [[1.0, 1.0], [0.0, 0.0]])


# ---- beyond the reference's cases ----

def test_setitem_on_a_leaf_that_needs_grad():
    """x[i] = v on a leaf: no in-place-on-leaf error, v.grad fills, and x
    becomes a non-leaf (its old value's gradient goes nowhere), as in the
    reference."""
    def case(ns):
        x = t(ns, [1.0, 2.0, 3.0])
        v = t(ns, [5.0, 6.0])
        x[::2] = v
        assert not x.is_leaf
        ns.sum(x * x).backward()
        return {"v": g(v), "x": g(x), "val": x.numpy()}
    np.testing.assert_array_equal(twin(case)["v"], [10.0, 12.0])


def test_create_graph_double_backward():
    def case(ns):
        x = t(ns, [1.5, -2.0])
        y = ns.sum(x * x * x)
        gx, = ns.pkg.grad(y, [x], create_graph=True)
        assert not gx.stop_gradient
        ggx, = ns.pkg.grad(ns.sum(gx), [x])
        gx2, = ns.pkg.grad(ns.sum(x * x * x), [x], create_graph=False)
        assert gx2.stop_gradient
        return {"gx": gx.numpy(), "ggx": ggx.numpy()}
    got = twin(case)
    np.testing.assert_allclose(got["ggx"], [9.0, -12.0])


def test_hooks_and_retain_grads_follow_a_rebound_tensor():
    """A hook and the retain_grads mark on y move with y when add_ rebinds
    it: the port's hook fires once, with the gradient at y's current value
    (the reference's fires once for the old node and once for the new)."""
    seen = {}

    def case(ns):
        x = t(ns, [2.0])
        y = x * 2
        calls = seen[ns.pkg.__name__] = []
        y.register_hook(lambda grad: calls.append(grad.numpy().copy()))
        y.add_(1.0)
        (y * 3).backward()
        return {"x": g(x), "seen": calls[-1], "y": y.numpy()}
    got = twin(case)
    assert got["seen"] == [3.0] and got["x"] == [6.0]
    assert len(seen["paddle_tpu_torch"]) == 1
    # the port: the mark and a doubling hook on the rebound tensor
    x = t(PORT, [2.0])
    y = x * 2
    h = y.register_hook(lambda grad: grad * 2)
    y.retain_grads()
    y.multiply_(5.0)
    (y * 3).backward()
    np.testing.assert_allclose(g(y), [6.0])
    np.testing.assert_allclose(g(x), [60.0])
    h.remove()
    x.clear_grad()
    y2 = x * 2
    y2.backward()
    np.testing.assert_allclose(g(x), [2.0])


def test_value_ops_keep_a_leaf_and_pass_a_non_leafs_gradient():
    def case(ns):
        x = t(ns, [2.0, 3.0])
        (x * x).backward(t(ns, [1.0, 1.0], sg=True))
        x.set_value(np.float32([7.0, 8.0]))
        assert x.is_leaf and not x.stop_gradient
        kept = g(x)
        y = x * 1.0
        y.zero_()
        ns.sum(y * 4.0).backward()
        return {"kept": kept, "x": g(x), "val": x.numpy()}
    got = twin(case)
    np.testing.assert_array_equal(got["kept"], [4.0, 6.0])
    np.testing.assert_array_equal(got["x"], [8.0, 10.0])


def test_earlier_reader_keeps_the_old_value():
    """An in-place op on an input a recorded reader holds: both packages
    raise at that reader's backward (the version check), and the value
    itself is the new one."""
    for ns in (REF, PORT):
        x, w = t(ns, [2.0]), t(ns, [3.0])
        y = x * w
        w.add_(1.0)
        np.testing.assert_allclose(w.numpy(), [4.0])
        with pytest.raises(RuntimeError, match="inplace"):
            y.backward()


# every in-place entry of the Tensor and the top-level namespace, applied
# to an input `w` that a reader recorded
INPLACE_ON_SAVED = {
    "bound_add_": lambda ns, w: w.add_(t(ns, [1.0], sg=True)),
    "bound_multiply_": lambda ns, w: w.multiply_(t(ns, [2.0], sg=True)),
    "paddle_add_": lambda ns, w: ns.pkg.add_(w, t(ns, [1.0], sg=True)),
    "paddle_multiply_": lambda ns, w: ns.pkg.multiply_(w, t(ns, [2.0],
                                                            sg=True)),
    "paddle_scale_": lambda ns, w: ns.pkg.scale_(w, 2.0, 1.0),
    "zero_": lambda ns, w: w.zero_(),
    "fill_": lambda ns, w: w.fill_(5.0),
    "set_value": lambda ns, w: w.set_value(np.float32([5.0])),
    "setitem": lambda ns, w: w.__setitem__(0, 5.0),
}


# readers that save w for their backward (mul) and that do not (add)
READERS = {"mul": lambda x, w: x * w, "add": lambda x, w: x + w}


@pytest.mark.parametrize("reader", sorted(READERS))
@pytest.mark.parametrize("op", sorted(INPLACE_ON_SAVED))
def test_inplace_on_a_saved_value_raises_at_backward(op, reader):
    """Each of these bumps the wrapper's `_version` in both packages, and
    the version check raises at the backward of a reader recorded before,
    whether or not it saved w, while a reader recorded after the op
    differentiates through the new value."""
    for ns in (REF, PORT):
        x, w = t(ns, [2.0]), t(ns, [3.0])
        y = READERS[reader](x, w)
        INPLACE_ON_SAVED[op](ns, w)
        with pytest.raises(RuntimeError, match="inplace"):
            y.backward()
        x.clear_grad()
        z = x * w
        z.backward()
        np.testing.assert_allclose(g(x), w.numpy(), err_msg=op)


# chains of in-place ops on one non-leaf `x`, with `w` a leaf: each op's
# own node reads the value before its bump, so none fails a later bump
INPLACE_CHAINS = {
    "bound_add_add_": lambda ns, x, w: (x.add_(1.0), x.add_(1.0)),
    "bound_multiply_add_": lambda ns, x, w: (x.multiply_(w), x.add_(w)),
    "paddle_add_multiply_": lambda ns, x, w: (ns.pkg.add_(x, w),
                                              ns.pkg.multiply_(x, w)),
    "paddle_scale_twice": lambda ns, x, w: (ns.pkg.scale_(x, 2.0, 1.0),
                                            ns.pkg.scale_(x, 0.5)),
    "relu_then_scale_": lambda ns, x, w: (ns.pkg.nn.functional.relu_(x),
                                          x.scale_(2.0)),
    "reshape_then_unsqueeze_": lambda ns, x, w: (ns.pkg.reshape_(x, [3, 2]),
                                                 ns.pkg.unsqueeze_(x, 0)),
    "add_self_then_multiply_": lambda ns, x, w: (x.add_(x), x.multiply_(w)),
    "setitem_twice": lambda ns, x, w: (x.__setitem__(0, 5.0),
                                       x.__setitem__(1, w[1])),
    "add_then_zero_": lambda ns, x, w: (x.add_(1.0), x.zero_()),
}


@pytest.mark.parametrize("chain", sorted(INPLACE_CHAINS))
def test_chained_inplace_ops_differentiate(chain):
    """Two in-place ops on one tensor before backward: both packages
    differentiate through the chain (the reference swaps a snapshot into
    each op's node), with equal gradients."""
    def case(ns):
        a = t(ns, np.arange(1.0, 7.0).reshape(2, 3))
        w = t(ns, np.full((2, 3), 2.0))
        x = a * w
        INPLACE_CHAINS[chain](ns, x, w)
        ns.sum(x * x).backward()
        return {"a": g(a), "w": g(w), "x": x.numpy()}
    twin(case)


def test_a_bump_still_counts_after_the_bumped_wrapper_is_gone():
    """A reader recorded before an in-place op raises at backward even
    when nothing holds the rebound tensor any more, in both packages."""
    for ns in (REF, PORT):
        a, w = t(ns, [2.0]), t(ns, [3.0])
        x = a * w
        y = x * w
        x.add_(1.0)
        del x
        with pytest.raises(RuntimeError, match="inplace"):
            y.backward()


def test_inplace_on_a_view_raises_for_its_own_readers_only():
    """A view is a wrapper of its own: an in-place op on it raises at its
    readers' backward and leaves its base's readers alone, in both
    packages."""
    for ns in (REF, PORT):
        a = t(ns, [[1.0, 2.0], [3.0, 4.0]])
        base_reader = a * 2.0
        v = a.reshape([4])
        view_reader = v * 3.0
        v.exp_()
        with pytest.raises(RuntimeError, match="inplace"):
            ns.sum(view_reader).backward()
        ns.sum(base_reader).backward()
        np.testing.assert_allclose(g(a), np.full((2, 2), 2.0))


def test_pylayer_with_non_tensor_arguments_and_two_outputs():
    def case(ns):
        class Mix(ns.PyLayer):
            @staticmethod
            def forward(ctx, x, scale, y, tag="t"):
                assert tag == "kw"
                ctx.save_for_backward(x, y)
                ctx.scale = scale
                return x * scale, x * y

            @staticmethod
            def backward(ctx, g1, g2):
                x, y = ctx.saved_tensor()
                return g1 * ctx.scale + g2 * y, g2 * x

        x, y = t(ns, [1.0, 2.0]), t(ns, [3.0, -1.0])
        a, b = Mix.apply(x, 4.0, y, tag="kw")
        ns.sum(a * a + b).backward()
        return {"x": g(x), "y": g(y), "a": a.numpy(), "b": b.numpy()}
    got = twin(case)
    np.testing.assert_allclose(got["x"], [35.0, 63.0])


def test_pylayer_integer_output_and_saved_tensor_hooks():
    packed = []

    class ArgAndDouble(PPyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            ctx.set_materialize_grads(True)
            ctx.mark_not_inplace(x)
            return x * 2, papply("argmax", torch.argmax, x)

        @staticmethod
        def backward(ctx, grad, grad_idx):
            (x,) = ctx.saved_tensor()
            assert x.shape == [3]
            return grad * 2

    x = t(PORT, [1.0, 5.0, 2.0])
    with P.autograd.saved_tensors_hooks(
            lambda s: packed.append("pack") or s,
            lambda s: packed.append("unpack") or s):
        y, idx = ArgAndDouble.apply(x)
        assert idx.stop_gradient and int(idx) == 1 and not y.stop_gradient
        PORT.sum(y).backward()
    assert packed == ["pack", "unpack"]
    np.testing.assert_array_equal(g(x), [2.0, 2.0, 2.0])
    assert ArgAndDouble._torch_function is ArgAndDouble._torch_function
    with P.no_grad():
        assert ArgAndDouble.apply(x)[0].stop_gradient


def test_grad_unused_inputs_and_no_grad_vars():
    for ns in (REF, PORT):
        x, z = t(ns, [1.0]), t(ns, [2.0])
        y = x * 3
        with pytest.raises(ValueError, match="allow_unused"):
            ns.pkg.grad(y, [x, z], retain_graph=True)
        gx, gz = ns.pkg.grad(y, [x, z], allow_unused=True, no_grad_vars=[z])
        assert gz is None
        np.testing.assert_allclose(gx.numpy(), [3.0])


def test_post_backward_callbacks_and_backward():
    calls = []
    cb = pag.register_post_backward_callback(lambda: calls.append(1))
    try:
        x = t(PORT, [2.0])
        P.autograd.backward([x * x], [None])
        x.grad.numpy()
        P.grad(x * 2, [x])                      # partial: no callback
        assert calls == [1]
        np.testing.assert_allclose(g(x), [4.0])
        P.autograd.backward(t(PORT, [1.0], sg=True))  # nothing to do
        assert calls == [1, 1]
    finally:
        pag.unregister_post_backward_callback(cb)


def test_grad_mode_is_torchs():
    assert P.is_grad_enabled() and torch.is_grad_enabled()
    with P.no_grad():
        assert not torch.is_grad_enabled()
        with P.enable_grad():
            assert P.is_grad_enabled()
    with P.set_grad_enabled(False):
        assert not P.is_grad_enabled()
    assert P.is_grad_enabled()

    @P.no_grad()
    def f(x):
        return x * 2
    assert f(t(PORT, [1.0])).stop_gradient


def test_jacobian_and_hessian_match_the_reference():
    x0 = np.float32([0.5, -1.0, 2.0])

    def case(ns):
        x = t(ns, x0)
        fn = (lambda v: ns.exp(v) * v)
        jf = ns.autograd.jacobian(fn, t(ns, x0, sg=True))
        y = ns.exp(x) * x
        jt = ns.autograd.jacobian(y, x)
        h = ns.autograd.hessian(lambda v: v * v * v, t(ns, x0, sg=True))
        return {"jf": jf.numpy(), "jt": jt.numpy(), "h": h.numpy()}
    got = twin(case)
    assert got["jt"].shape == (3, 3)
    np.testing.assert_allclose(np.diag(got["h"]), 6 * x0, rtol=1e-6)
