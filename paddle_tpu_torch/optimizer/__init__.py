"""Optimizers — port of `paddle_tpu/optimizer/__init__.py` (reference
`python/paddle/optimizer/`: SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
Adadelta, RMSProp, Lamb, LBFGS).

Each update keeps the reference's float32 order of operations, on the
parameter's device.  `multi_precision` is accepted and ignored (no
float32 master copy is kept), as in the reference; `AdamW`'s `lr_ratio`
scales the decoupled decay only.  Only LBFGS reads the device, once a
step, for the reference's curvature check.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from . import lr  # noqa
from .optimizer import Optimizer


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _append_optimize_op(self, p, g):
        lr = self._lr_for(p)
        self._write(p, p._t.float() - lr * g._t.float())

    def _functional_update(self, param, grad, state, lr):
        return param - lr * grad, state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _acc_names(self):
        return ["velocity"]

    def _append_optimize_op(self, p, g):
        lr = self._lr_for(p)
        g32 = g._t.float()
        v = self._momentum * self._acc("velocity", p) + g32
        upd = g32 + self._momentum * v if self._use_nesterov else v
        self._set_acc("velocity", p, v)
        self._write(p, p._t.float() - lr * upd)

    def _init_functional_state(self, param):
        return {"velocity": torch.zeros_like(param, dtype=torch.float32)}

    def _functional_update(self, param, grad, state, lr):
        v = self._momentum * state["velocity"] + grad
        upd = grad + self._momentum * v if self._use_nesterov else v
        return param - lr * upd, {"velocity": v}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, name=None, amsgrad=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _acc_names(self):
        return ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def _beta(self, b):
        return float(b.item()) if isinstance(b, Tensor) else float(b)

    def _append_optimize_op(self, p, g):
        self._adam(p, g, self._lr_for(p), p._t)

    def _adam(self, p, g, lr, value):
        """One Adam step of p from `value` (p's value, or AdamW's decayed
        one)."""
        b1 = self._beta(self._beta1)
        b2 = self._beta(self._beta2)
        g32 = g._t.float()
        m = b1 * self._acc("moment1", p) + (1 - b1) * g32
        v = b2 * self._acc("moment2", p) + (1 - b2) * g32 * g32
        b1p = self._acc_pow("beta1_pow", p) * b1
        b2p = self._acc_pow("beta2_pow", p) * b2
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        upd = mhat / (torch.sqrt(vhat) + self._epsilon)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        self._set_acc("beta1_pow", p, b1p)
        self._set_acc("beta2_pow", p, b2p)
        self._write(p, value.float() - lr * upd)

    def _init_functional_state(self, param):
        dev = param.device
        return {"m": torch.zeros_like(param, dtype=torch.float32),
                "v": torch.zeros_like(param, dtype=torch.float32),
                "b1p": torch.ones((), dtype=torch.float32, device=dev),
                "b2p": torch.ones((), dtype=torch.float32, device=dev)}

    def _functional_update(self, param, grad, state, lr):
        b1 = self._beta(self._beta1)
        b2 = self._beta(self._beta2)
        g32 = grad.float()
        m = b1 * state["m"] + (1 - b1) * g32
        v = b2 * state["v"] + (1 - b2) * g32 * g32
        b1p = state["b1p"] * b1
        b2p = state["b2p"] * b2
        upd = (m / (1 - b1p)) / (torch.sqrt(v / (1 - b2p)) + self._epsilon)
        new_p = (param.float() - lr * upd).to(param.dtype)
        return new_p, {"m": m, "v": v, "b1p": b1p, "b2p": b2p}


class AdamW(Adam):
    """Decoupled weight decay (reference `optimizer/adamw.py`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None,
                 amsgrad=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         name=name)
        if isinstance(weight_decay, Tensor):
            self._coeff = float(weight_decay.item())
        else:
            self._coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _append_optimize_op(self, p, g):
        lr = self._lr_for(p)
        value = p._t
        decay_lr = lr * self._lr_ratio(p) if self._lr_ratio is not None \
            else lr
        if self._apply_decay_param_fun is None or \
                self._apply_decay_param_fun(p.name):
            # the reference writes the decayed value, then steps from it
            value = (value.float() * (1.0 - decay_lr * self._coeff)) \
                .to(value.dtype)
        self._adam(p, g, lr, value)

    def _functional_update(self, param, grad, state, lr):
        decayed = param.float() * (1.0 - lr * self._coeff)
        return super()._functional_update(decayed.to(param.dtype), grad,
                                          state, lr)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _acc_names(self):
        return ["moment", "inf_norm", "beta1_pow"]

    def _append_optimize_op(self, p, g):
        lr = self._lr_for(p)
        g32 = g._t.float()
        m = self._beta1 * self._acc("moment", p) + (1 - self._beta1) * g32
        u = torch.maximum(self._beta2 * self._acc("inf_norm", p),
                          torch.abs(g32) + self._epsilon)
        b1p = self._acc_pow("beta1_pow", p) * self._beta1
        self._set_acc("moment", p, m)
        self._set_acc("inf_norm", p, u)
        self._set_acc("beta1_pow", p, b1p)
        self._write(p, p._t.float() - lr / (1 - b1p) * (m / u))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc_value = initial_accumulator_value

    def _acc_names(self):
        return ["moment"]

    def _append_optimize_op(self, p, g):
        lr = self._lr_for(p)
        acc = self._accumulators["moment"].get(id(p))
        if acc is None:
            acc = torch.full(p._t.shape, self._init_acc_value,
                             dtype=torch.float32, device=p._t.device)
        g32 = g._t.float()
        acc = acc + g32 * g32
        self._set_acc("moment", p, acc)
        self._write(p, p._t.float() - lr * g32 / (torch.sqrt(acc) +
                                                   self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _acc_names(self):
        return ["avg_squared_grad", "avg_squared_update"]

    def _append_optimize_op(self, p, g):
        lr = self._lr_for(p)
        Eg = self._acc("avg_squared_grad", p)
        Ex = self._acc("avg_squared_update", p)
        g32 = g._t.float()
        Eg = self._rho * Eg + (1 - self._rho) * g32 * g32
        upd = torch.sqrt(Ex + self._epsilon) / torch.sqrt(Eg + self._epsilon) \
            * g32
        Ex = self._rho * Ex + (1 - self._rho) * upd * upd
        self._set_acc("avg_squared_grad", p, Eg)
        self._set_acc("avg_squared_update", p, Ex)
        self._write(p, p._t.float() - lr * upd)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _acc_names(self):
        return ["mean_square", "mean_grad", "momentum"]

    def _append_optimize_op(self, p, g):
        lr = self._lr_for(p)
        g32 = g._t.float()
        ms = self._rho * self._acc("mean_square", p) + \
            (1 - self._rho) * g32 * g32
        mom = self._acc("momentum", p)
        if self._centered:
            mg = self._rho * self._acc("mean_grad", p) + \
                (1 - self._rho) * g32
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
            self._set_acc("mean_grad", p, mg)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom = self._momentum * mom + lr * g32 / denom
        self._set_acc("mean_square", p, ms)
        self._set_acc("momentum", p, mom)
        self._write(p, p._t.float() - mom)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _acc_names(self):
        return ["moment1", "moment2", "beta1_pow", "beta2_pow"]

    def _append_optimize_op(self, p, g):
        lr = self._lr_for(p)
        g32 = g._t.float()
        m = self._beta1 * self._acc("moment1", p) + (1 - self._beta1) * g32
        v = self._beta2 * self._acc("moment2", p) + \
            (1 - self._beta2) * g32 * g32
        b1p = self._acc_pow("beta1_pow", p) * self._beta1
        b2p = self._acc_pow("beta2_pow", p) * self._beta2
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        wd = 0.0 if (self._exclude_fn is not None and self._exclude_fn(p)) \
            else self._wd
        p32 = p._t.float()
        r = r + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        self._set_acc("moment1", p, m)
        self._set_acc("moment2", p, v)
        self._set_acc("beta1_pow", p, b1p)
        self._set_acc("beta2_pow", p, b2p)
        self._write(p, p32 - lr * trust * r)


class LBFGS(Optimizer):
    """L-BFGS (reference `optimizer/lbfgs.py`): closure-based full-batch
    optimizer."""

    def __init__(self, learning_rate=1.0, max_iter=20, max_eval=None,
                 tolerance_grad=1e-07, tolerance_change=1e-09,
                 history_size=100, line_search_fn=None, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._max_iter = max_iter
        self._tol_grad = tolerance_grad
        self._tol_change = tolerance_change
        self._history = history_size
        self._s, self._y = [], []
        self._prev_flat_grad = None
        self._prev_step = None  # displacement applied at the previous call

    def _gather(self):
        return torch.cat([p.grad._t.float().reshape(-1)
                          for p in self._parameter_list])

    def _distribute(self, flat):
        off = 0
        for p in self._parameter_list:
            n = p._t.numel()
            self._write(p, p._t.float() + flat[off:off + n].reshape(p._t.shape))
            off += n

    @torch.no_grad()
    def step(self, closure=None):
        if closure is None:
            # a plain gradient step
            self._distribute(-self.get_lr() * self._gather())
            return None
        with torch.enable_grad():
            loss = closure()
        g = self._gather()
        # the curvature pair of the previous step: s = x_k - x_{k-1},
        # y = g_k - g_{k-1}
        if self._prev_flat_grad is not None and self._prev_step is not None:
            y_new = g - self._prev_flat_grad
            s_new = self._prev_step
            # the reference's one host read a step: keep B positive-definite
            if float(torch.dot(y_new, s_new)) > 1e-10:
                self._s.append(s_new)
                self._y.append(y_new)
                if len(self._s) > self._history:
                    self._s.pop(0)
                    self._y.pop(0)
        # two-loop recursion
        q = g
        alphas = []
        for s, y in zip(reversed(self._s), reversed(self._y)):
            rho = 1.0 / torch.clamp(torch.dot(y, s), min=1e-10)
            a = rho * torch.dot(s, q)
            q = q - a * y
            alphas.append((rho, a))
        if self._y:
            y_last, s_last = self._y[-1], self._s[-1]
            gamma = torch.dot(s_last, y_last) / torch.clamp(
                torch.dot(y_last, y_last), min=1e-10)
            q = gamma * q
        for (rho, a), s, y in zip(reversed(alphas), self._s, self._y):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        step_dir = -q
        lr = self.get_lr()
        self._distribute(lr * step_dir)
        self._prev_step = lr * step_dir
        self._prev_flat_grad = g
        return loss


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "LBFGS", "lr"]
