"""nn.utils — port of `paddle_tpu/nn/utils/__init__.py` (reference
`python/paddle/nn/utils/`).  Where the reference writes a tensor's `_data`
(the clipped grads, `vector_to_parameters`), the port assigns under
`no_grad`: no version is bumped."""
from __future__ import annotations

import torch

from ...core.tensor import Parameter, Tensor


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    params = [p for p in parameters if p._t.grad is not None]
    if not params:
        return Tensor(torch.zeros(()))
    with torch.no_grad():
        grads = [p._t.grad for p in params]
        if norm_type == float("inf"):
            total = torch.max(torch.stack([g.abs().max() for g in grads]))
        else:
            total = torch.pow(sum(torch.sum(torch.pow(g.float().abs(),
                                                      norm_type))
                                  for g in grads), 1.0 / norm_type)
        if error_if_nonfinite and not bool(torch.isfinite(total)):
            raise RuntimeError("non-finite grad norm")
        coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for p, g in zip(params, grads):
            p._t.grad = (g * coef).to(g.dtype)
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    with torch.no_grad():
        for p in parameters:
            if p._t.grad is not None:
                p._t.grad = torch.clamp(p._t.grad, -clip_value, clip_value)


def parameters_to_vector(parameters, name=None):
    return Tensor(torch.cat([p._t.detach().reshape(-1) for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p._t.numel()
            p._replace(vec._t[offset:offset + n].reshape(p._t.shape))
            offset += n


def weight_norm(layer, name="weight", dim=0):
    """Weight normalization: `name` becomes `name_g` (the norms along
    `dim`) and `name_v`, and a forward pre-hook recomputes the weight
    g * v / |v| before each call, as a stop-gradient tensor (as in the
    reference)."""
    w = getattr(layer, name)._t.detach()
    vm = torch.movedim(w, dim, 0)
    g_data = torch.linalg.norm(vm.reshape(w.shape[dim], -1), dim=1)
    layer.add_parameter(name + "_g", Parameter(g_data))
    layer.add_parameter(name + "_v", Parameter(w.clone()))
    del layer._parameters[name]

    def hook(lyr, inputs):
        v = lyr._parameters[name + "_v"]._t.detach()
        g = lyr._parameters[name + "_g"]._t.detach()
        vm = torch.movedim(v, dim, 0)
        norm = torch.linalg.norm(vm.reshape(vm.shape[0], -1), dim=1)
        shape = [-1] + [1] * (v.ndim - 1)
        new_w = torch.movedim(vm / norm.reshape(shape) * g.reshape(shape), 0,
                              dim)
        object.__setattr__(lyr, "_wn_cache", Tensor(new_w, stop_gradient=True))
        lyr.__dict__[name] = lyr._wn_cache
    layer.register_forward_pre_hook(hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    return layer
