"""PyLayer: user-defined autograd functions.

Reference parity: `paddle.autograd.PyLayer` (`paddle/fluid/eager/pylayer/`,
`fluid/pybind/eager_py_layer.cc`).  The user supplies `forward(ctx, ...)`
and `backward(ctx, *out_grads)` static methods over Tensors; each subclass
runs as one `torch.autograd.Function`, made at its first `apply`, whose
forward and backward hand the user's methods Tensors.  The grads `backward`
returns map to the positional Tensor inputs in order (non-Tensor arguments
get None); integer outputs are marked non-differentiable.
"""
from __future__ import annotations

from typing import List

import torch

from ..core.tensor import Tensor

_saved_hooks: List = []


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self._packed = False
        self._materialize_grads = True
        self._fn_ctx = None
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        if _saved_hooks:
            pack, _ = _saved_hooks[-1]
            self._saved = tuple(pack(t) for t in tensors)
            self._packed = True
        else:
            self._saved = tensors
            self._packed = False

    def saved_tensor(self):
        if self._packed:
            _, unpack = _saved_hooks[-1] if _saved_hooks else (None, lambda x: x)
            return tuple(unpack(t) for t in self._saved)
        return self._saved

    saved_tensors = property(lambda self: self.saved_tensor())

    def mark_not_inplace(self, *tensors):
        self.not_inplace_tensors = tensors

    def set_materialize_grads(self, value: bool):
        self._materialize_grads = bool(value)
        if self._fn_ctx is not None:
            self._fn_ctx.set_materialize_grads(self._materialize_grads)


def _function(layer_cls):
    """The torch Function of a PyLayer subclass, made once per subclass."""
    fn = layer_cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(fctx, pctx, kwargs, *raw):
            pctx._fn_ctx = fctx
            fctx.set_materialize_grads(pctx._materialize_grads)
            args = [Tensor._wrap(a) if isinstance(a, torch.Tensor) else a
                    for a in raw]
            outs = layer_cls.forward(pctx, *args, **kwargs)
            fctx.pctx, fctx.tensor_slots = pctx, [
                isinstance(a, torch.Tensor) for a in raw]
            fctx.single = not isinstance(outs, (tuple, list))
            res = [o._t if isinstance(o, Tensor) else o
                   for o in ([outs] if fctx.single else outs)]
            ints = [o for o in res if isinstance(o, torch.Tensor)
                    and not (o.is_floating_point() or o.is_complex())]
            if ints:
                fctx.mark_non_differentiable(*ints)
            return res[0] if fctx.single else tuple(res)

        @staticmethod
        def backward(fctx, *grads):
            gins = layer_cls.backward(fctx.pctx, *[
                None if g is None else Tensor._wrap(g) for g in grads])
            if not isinstance(gins, (tuple, list)):
                gins = (gins,)
            gi = iter(gins)
            out = [None, None]
            for is_tensor in fctx.tensor_slots:
                g = next(gi, None) if is_tensor else None
                out.append(g._t if isinstance(g, Tensor) else g)
            return tuple(out)

    Fn.__name__ = Fn.__qualname__ = layer_cls.__name__ + "Function"
    layer_cls._torch_function = Fn
    return Fn


class PyLayerMeta(type):
    pass


class PyLayer(metaclass=PyLayerMeta):
    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        raw = [a._t if isinstance(a, Tensor) else a for a in args]
        outs = _function(cls).apply(PyLayerContext(), kwargs, *raw)
        if isinstance(outs, tuple):
            return tuple(Tensor._wrap(o) if isinstance(o, torch.Tensor)
                         else o for o in outs)
        return Tensor._wrap(outs) if isinstance(outs, torch.Tensor) else outs


LegacyPyLayer = PyLayer
