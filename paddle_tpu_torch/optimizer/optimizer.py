"""Optimizer base — port of `paddle_tpu/optimizer/optimizer.py` (reference
`python/paddle/optimizer/optimizer.py`: `step` :1583, `_apply_optimize`
:1278).

Eager path: each parameter's update is a few torch ops on its device, in
float32; accumulators live in `_accumulators[name][id(param)]` on the
parameter's device (float32, the pow accumulators 0-d), so a step reads
nothing back to the host.  A parameter's new value goes in through
`Tensor._replace`, as the reference assigns `_data`: it bumps no version.
The clip runs first, then the coupled float decay (grad + coeff * p);
a decay that is not a float reaches `from ..regularizer import L2Decay`,
which neither package has, so it raises ImportError in both.
`_functional_update` is the same math as pure functions of tensors, for
the train-step path of `jit/` (ROADMAP Queue 1 item 13.8).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

from ..core.autograd import no_grad
from ..core.tensor import Tensor, _to_torch
from .lr import LRScheduler


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._learning_rate = learning_rate
        self._parameter_list = self._flatten_params(parameters)
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._accumulators: Dict[str, Dict[int, torch.Tensor]] = \
            defaultdict(dict)
        self._global_step = 0
        self._name = name

    @staticmethod
    def _flatten_params(parameters):
        if parameters is None:
            return None
        out = []
        for p in parameters:
            if isinstance(p, dict):  # param group
                out.extend(p["params"])
            else:
                out.append(p)
        return out

    # ---- lr ----
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    def _lr_for(self, p) -> float:
        base = self.get_lr()
        return base * p._optimize_attrs.get("learning_rate", 1.0) \
            if hasattr(p, "_optimize_attrs") else base

    # ---- accumulators ----
    def _acc(self, name, p, init=None):
        store = self._accumulators[name]
        key = id(p)
        if key not in store:
            store[key] = torch.zeros_like(p._t, dtype=torch.float32) \
                if init is None else init
        return store[key]

    def _acc_pow(self, name, p):
        """A 0-d float32 accumulator on p's device, first 1."""
        store = self._accumulators[name]
        if id(p) not in store:
            store[id(p)] = torch.ones((), dtype=torch.float32,
                                      device=p._t.device)
        return store[id(p)]

    def _set_acc(self, name, p, value):
        self._accumulators[name][id(p)] = value

    @staticmethod
    def _write(p, value32):
        """p's new value (float32, cast to p's dtype), no version bump."""
        p._replace(value32.to(p._t.dtype))

    # ---- main API ----
    @no_grad()
    def step(self):
        params_grads = []
        for p in self._parameter_list or []:
            if p.stop_gradient or p.grad is None:
                continue
            params_grads.append((p, p.grad))
        self._apply_optimize(params_grads)

    def _apply_optimize(self, params_grads):
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        params_grads = self._apply_decay(params_grads)
        self._global_step += 1
        for p, g in params_grads:
            if g is None:
                continue
            self._append_optimize_op(p, g)

    def _apply_decay(self, params_grads):
        """Coupled L2 regularization (the reference's regularizer path):
        grad += coeff * p."""
        wd = self._weight_decay
        if wd is None or isinstance(wd, float) and wd == 0.0:
            return params_grads
        if not isinstance(wd, float):
            from ..regularizer import L2Decay
            if isinstance(wd, L2Decay):
                wd = wd._coeff
            else:
                return params_grads  # L1 etc. handled by the regularizer
        out = []
        for p, g in params_grads:
            reg = p._optimize_attrs.get("regularizer") \
                if hasattr(p, "_optimize_attrs") else None
            if reg is not None or g is None:
                out.append((p, g))
                continue
            out.append((p, Tensor(g._t + wd * p._t.to(g._t.dtype),
                                  stop_gradient=True)))
        return out

    def _append_optimize_op(self, p, g):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list or []:
            p.clear_grad(set_to_zero=set_to_zero and p.grad is not None)

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        from ..core.tensor import _static_recorder
        if _static_recorder[0] is not None:
            # static mode (item 13.8): the train step becomes a program op
            opt = self

            def train_op():
                loss.backward(retain_graph=True)
                opt.step()
                opt.clear_grad()
            _static_recorder[0]._record_py(train_op)
            return None, None
        # skip backward when an explicit loss.backward() already ran, as the
        # reference's minimize only collects the grads in that pattern
        if loss._t.grad_fn is not None and \
                not getattr(loss, "_backward_ran", False):
            loss.backward()
        self.step()
        return None, None

    # ---- state ----
    def state_dict(self):
        state = {}
        for name, store in self._accumulators.items():
            for key, val in store.items():
                state[f"{self._param_name(key)}_{name}"] = Tensor(
                    val, stop_gradient=True)
        if isinstance(self._learning_rate, LRScheduler):
            state["LR_Scheduler"] = self._learning_rate.state_dict()
        state["global_step"] = self._global_step
        return state

    def _param_name(self, key):
        for p in self._parameter_list or []:
            if id(p) == key:
                return p.name
        return str(key)

    def set_state_dict(self, state_dict):
        if "LR_Scheduler" in state_dict and \
                isinstance(self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        self._global_step = int(state_dict.get("global_step", 0))
        for p in self._parameter_list or []:
            for name in list(self._accumulators.keys()) + \
                    list(self._acc_names()):
                k = f"{p.name}_{name}"
                if k in state_dict:
                    self._accumulators[name][id(p)] = _to_torch(
                        state_dict[k], place=p._t.device)

    def _acc_names(self):
        return []

    # ---- functional form (the jit train-step path) ----
    def _functional_update(self, param, grad, state, lr):
        """Pure update: (param, grad, state dict, lr) -> (new_param,
        new_state)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no functional form")

    def _init_functional_state(self, param):
        return {}
