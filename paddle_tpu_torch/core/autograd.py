"""Eager autograd over torch autograd.

Reference parity: the eager GradNode DAG and backward engine —
`egr::Backward` / `RunBackward` (`paddle/fluid/eager/backward.cc:421,:104`)
and partial `paddle.grad` (`general_grad.h`).  The reference keeps a tape of
its own (`paddle_tpu/core/autograd.py`); the port keeps none: every op of a
`Tensor` is a torch op on the wrapper's tensor, so torch's autograd graph is
the graph, its thread-local grad mode is the grad mode, and the functions
below run `torch.autograd.backward` / `torch.autograd.grad` on the wrappers'
tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

# grad mode is torch's (thread-local; context managers and decorators)
no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _raw(x):
    from .tensor import Tensor
    if x is None or isinstance(x, torch.Tensor):
        return x
    if isinstance(x, Tensor):
        return x._t
    return torch.as_tensor(x)


# callbacks invoked when a full (non-partial) backward traversal completes
_post_backward_callbacks = []


def register_post_backward_callback(cb):
    _post_backward_callbacks.append(cb)
    return cb


def unregister_post_backward_callback(cb):
    try:
        _post_backward_callbacks.remove(cb)
    except ValueError:
        pass


def run_backward(tensors: Sequence, grad_tensors: Optional[Sequence] = None,
                 retain_graph: bool = False) -> None:
    """Full backward from seeds, accumulating into the leaves' `.grad`
    (`RunBackward` parity).  A seed that needs no gradient is skipped, as
    the reference's engine skips it; then the post-backward callbacks
    run."""
    tensors = _as_list(tensors)
    grad_tensors = _as_list(grad_tensors) or [None] * len(tensors)
    if len(grad_tensors) != len(tensors):
        raise ValueError("grad_tensors length must match tensors")
    seeds, grads = [], []
    for t, g in zip(tensors, grad_tensors):
        if not hasattr(t, "_t"):
            raise TypeError("backward seeds must be Tensors")
        if t._t.requires_grad:
            seeds.append(t._t)
            grads.append(_raw(g))
    if seeds:
        torch.autograd.backward(seeds, grads, retain_graph=retain_graph)
    for t in tensors:
        # minimize() consults this, as the reference's does
        t._backward_ran = True
    for cb in list(_post_backward_callbacks):
        cb()


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Partial gradient (paddle.grad / `general_grad.h` parity): the grads
    of `outputs` w.r.t. `inputs` as Tensors, written to no `.grad`.
    `retain_graph` defaults to `create_graph`.  An input the outputs do not
    reach raises ValueError unless `allow_unused`, which gives None for it.
    `no_grad_vars` is accepted and ignored, as the reference ignores it."""
    from .tensor import Tensor
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    grad_outputs = _as_list(grad_outputs) or [None] * len(outputs)
    if retain_graph is None:
        retain_graph = create_graph
    pairs = [(o._t, _raw(g)) for o, g in zip(outputs, grad_outputs)
             if o._t.requires_grad]
    want = [i for i, x in enumerate(inputs) if x._t.requires_grad]
    got = [None] * len(inputs)
    if pairs and want:
        res = torch.autograd.grad(
            [o for o, _ in pairs], [inputs[i]._t for i in want],
            [g for _, g in pairs], retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(want, res):
            got[i] = g
    if not allow_unused and any(g is None for g in got):
        raise ValueError(
            "one of the input tensors was not used in the graph; set "
            "allow_unused=True to return None for it")
    return [None if g is None else Tensor._wrap(g) for g in got]
