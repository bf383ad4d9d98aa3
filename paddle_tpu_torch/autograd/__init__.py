"""paddle.autograd parity: grad, backward, PyLayer, hooks, jacobian and
hessian (the last two over `torch.autograd.functional`)."""
import torch

from ..core.autograd import (grad, no_grad, enable_grad,  # noqa: F401
                             set_grad_enabled, is_grad_enabled)
from ..core import autograd as _ag
from ..core.tensor import Tensor
from .py_layer import LegacyPyLayer, PyLayer, PyLayerContext  # noqa: F401


def backward(tensors, grad_tensors=None, retain_graph=False):
    """paddle.autograd.backward."""
    _ag.run_backward(tensors, grad_tensors, retain_graph)


class saved_tensors_hooks:
    """API-compat context (`paddle.autograd.saved_tensors_hooks`): registers
    pack/unpack hooks for the tensors a PyLayer saves for backward (PyLayer
    saved tensors only, as the reference has it)."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def __enter__(self):
        from . import py_layer
        py_layer._saved_hooks.append((self.pack_hook, self.unpack_hook))
        return self

    def __exit__(self, *exc):
        from . import py_layer
        py_layer._saved_hooks.pop()
        return False


def _data(x):
    return x._t.detach() if isinstance(x, Tensor) else torch.as_tensor(x)


def jacobian(ys, xs, batch_axis=None):
    """ref autograd/autograd.py jacobian: the full Jacobian of ys w.r.t. xs,
    a Tensor [*ys.shape, *xs.shape].  `ys` is either a function of one
    Tensor (evaluated at xs) or a Tensor computed from the leaf xs."""
    if callable(ys):
        fn = ys
        jac = torch.autograd.functional.jacobian(
            lambda a: fn(Tensor._wrap(a))._t, _data(xs))
        return Tensor._wrap(jac)
    flat = ys._t.reshape(-1)
    rows = []
    for i in range(flat.numel()):
        g, = torch.autograd.grad(flat[i], xs._t, retain_graph=True,
                                 allow_unused=True)
        rows.append(torch.zeros_like(xs._t) if g is None else g)
    return Tensor._wrap(torch.stack(rows).reshape(
        tuple(ys.shape) + tuple(xs.shape)))


def hessian(func, xs, batch_axis=None):
    """ref autograd/autograd.py hessian (function form): the Hessian of the
    sum of func(xs)."""
    h = torch.autograd.functional.hessian(
        lambda a: func(Tensor._wrap(a))._t.sum(), _data(xs))
    return Tensor._wrap(h)
