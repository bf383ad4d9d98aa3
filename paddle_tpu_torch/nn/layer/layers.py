"""nn.Layer — the module system.

Reference parity: `python/paddle/nn/layer/layers.py:339` (`Layer`): named
params/buffers/sublayers, forward pre/post hooks, `state_dict`/`set_state_dict`,
train/eval mode, dtype/device casts, `apply`, `register_buffer`.

`Layer` is a plain class, not a `torch.nn.Module`: its parameters are the
port's `Parameter` wrappers, each over one torch leaf tensor.  Loading a
state dict or casting rebinds each wrapper's tensor (`Tensor._replace`,
`_retype`); the wrapper objects stay, so optimizers and hooks holding them
see the new values.  `to(device=)` moves the parameters and buffers (the
reference's accepts the argument and ignores it).
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ...core import dtype as _dt
from ...core.place import expected_device
from ...core.tensor import Parameter, Tensor, _device_of, from_numpy
from ...utils import unique_name


class HookRemoveHelper:
    def __init__(self, hooks, idx):
        self._hooks = hooks
        self._idx = idx

    def remove(self):
        self._hooks.pop(self._idx, None)


def _retype(t: Tensor, dtype=None, device=None):
    """Rebind t to its value in `dtype` on `device`, a leaf as before (its
    grad converted with it)."""
    old = t._t
    device, dtype = device or old.device, dtype or old.dtype
    if (old.device, old.dtype) == (device, dtype):
        return
    new = old.detach().to(device=device, dtype=dtype)
    if old.requires_grad:
        new.requires_grad_(True)
    if old.grad is not None and old.grad_fn is None:
        new.grad = old.grad.to(device=new.device, dtype=new.dtype)
    t._rebind(new)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = _dt.convert_dtype(dtype) if dtype else _dt.float32
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower())
        self._parameters: Dict[str, Parameter] = collections.OrderedDict()
        self._buffers: Dict[str, Tensor] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._sub_layers: Dict[str, "Layer"] = collections.OrderedDict()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0

    # ---- construction helpers ----
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        from ..initializer import Constant, XavierNormal
        from ...param_attr import ParamAttr
        dtype = dtype or self._dtype
        p = Parameter(torch.zeros([int(s) for s in shape],
                                  dtype=_dt.to_torch(dtype),
                                  device=expected_device()))
        init = default_initializer
        learning_rate = 1.0
        regularizer = None
        name = None
        trainable = True
        if isinstance(attr, ParamAttr):
            init = attr.initializer or init
            learning_rate = attr.learning_rate
            regularizer = attr.regularizer
            name = attr.name
            trainable = attr.trainable
        elif attr is False:
            return None
        if init is None:
            init = Constant(0.0) if is_bias else XavierNormal()
        init(p)
        if name:
            p.name = name
        p.stop_gradient = not trainable
        p.trainable = trainable
        p._optimize_attrs = {"learning_rate": learning_rate, "regularizer": regularizer}
        return p

    def create_variable(self, name=None, persistable=False, dtype=None):
        t = Tensor(torch.zeros((), dtype=_dt.to_torch(dtype or self._dtype),
                               device=expected_device()))
        t.persistable = persistable
        return t

    def add_parameter(self, name: str, parameter: Optional[Parameter]):
        if parameter is not None and not isinstance(parameter, Tensor):
            raise TypeError("parameter must be a Tensor/Parameter")
        self._parameters[name] = parameter
        return parameter

    def add_sublayer(self, name: str, sublayer: "Layer"):
        self._sub_layers[str(name)] = sublayer
        return sublayer

    def register_buffer(self, name: str, tensor: Optional[Tensor], persistable=True):
        if tensor is not None and not isinstance(tensor, Tensor):
            tensor = Tensor(tensor)
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        return tensor

    # ---- attribute routing ----
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        layers = self.__dict__.get("_sub_layers")
        buffers = self.__dict__.get("_buffers")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call super().__init__() before assigning parameters")
            for d in (layers, buffers):
                if d is not None:
                    d.pop(name, None)
            params[name] = value
        elif isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call super().__init__() before assigning sublayers")
            for d in (params, buffers):
                if d is not None:
                    d.pop(name, None)
            layers[name] = value
        elif buffers is not None and name in buffers:
            if value is None or isinstance(value, Tensor):
                buffers[name] = value
            else:
                buffers[name].set_value(value)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for store in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(store)
            if d is not None and name in d:
                del d[name]
                return
        object.__delattr__(self, name)

    def __dir__(self):
        return list(super().__dir__()) + list(self._parameters) + list(self._buffers) \
            + list(self._sub_layers)

    # ---- call path ----
    def __call__(self, *inputs, **kwargs):
        for hook in list(self._forward_pre_hooks.values()):
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def register_forward_pre_hook(self, hook) -> HookRemoveHelper:
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook) -> HookRemoveHelper:
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # ---- traversal ----
    def children(self) -> Iterator["Layer"]:
        for _, l in self.named_children():
            yield l

    def named_children(self):
        seen = set()
        for name, layer in self._sub_layers.items():
            if layer is not None and id(layer) not in seen:
                seen.add(id(layer))
                yield name, layer

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, layer in self.named_children():
            if layer is None or id(layer) in layers_set:
                continue
            p = prefix + ("." if prefix else "") + name
            yield from layer.named_sublayers(prefix=p, include_self=True,
                                             layers_set=layers_set)

    def parameters(self, include_sublayers=True):
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True):
        seen = set()
        layers = self.named_sublayers(prefix=prefix, include_self=True) \
            if include_sublayers else [(prefix, self)]
        for lp, layer in layers:
            for name, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (lp + ("." if lp else "") + name, p)

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        layers = self.named_sublayers(prefix=prefix, include_self=True) \
            if include_sublayers else [(prefix, self)]
        for lp, layer in layers:
            for name, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (lp + ("." if lp else "") + name, b)

    def apply(self, fn: Callable[["Layer"], None]) -> "Layer":
        for layer in self.children():
            layer.apply(fn)
        fn(self)
        return self

    def full_name(self):
        return self._full_name

    # ---- modes ----
    def train(self):
        self.training = True
        for l in self.sublayers():
            l.training = True
        return self

    def eval(self):
        self.training = False
        for l in self.sublayers():
            l.training = False
        return self

    # ---- state ----
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else collections.OrderedDict()
        for name, p in self.named_parameters(prefix=structured_name_prefix.rstrip("."),
                                             include_sublayers=include_sublayers):
            dest[name] = p
        non_persist = set()
        for lp, layer in self.named_sublayers(prefix=structured_name_prefix.rstrip("."),
                                              include_self=True):
            for short in layer._non_persistable_buffer_names:
                non_persist.add(lp + ("." if lp else "") + short)
        for name, b in self.named_buffers(prefix=structured_name_prefix.rstrip("."),
                                          include_sublayers=include_sublayers):
            if name not in non_persist:
                dest[name] = b
        return dest

    to_static_state_dict = state_dict

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Load values (Tensors, torch tensors or numpy arrays, an
        `ml_dtypes` bfloat16 array by its bits) into the matching
        parameters and buffers, each in its own dtype and on its device;
        returns (missing, unexpected) keys."""
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            tgt = own[k]
            if isinstance(v, Tensor):
                data = v._t
            elif isinstance(v, torch.Tensor):
                data = v
            else:
                data = from_numpy(np.asarray(v))
            if tuple(data.shape) != tuple(tgt._t.shape):
                raise ValueError(
                    f"shape mismatch for {k}: got {tuple(data.shape)}, expected "
                    f"{tuple(tgt._t.shape)}")
            with torch.no_grad():
                tgt._replace(data)
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # ---- casts ----
    def to(self, device=None, dtype=None, blocking=None):
        if device is not None:
            dev = _device_of(device)
            for t in self.parameters() + self.buffers():
                _retype(t, device=dev)
        if dtype is not None:
            self._cast(dtype)
        return self

    def astype(self, dtype):
        self._cast(dtype)
        return self

    def _cast(self, dtype):
        td = _dt.to_torch(dtype)
        for t in self.parameters() + self.buffers():
            if t is not None and t._t.is_floating_point():
                _retype(t, dtype=td)
        self._dtype = _dt.convert_dtype(dtype)

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = []
        for name, layer in self.named_children():
            mod_str = repr(layer)
            mod_str = "\n  ".join(mod_str.split("\n"))
            lines.append(f"({name}): {mod_str}")
        main = self.__class__.__name__ + "(" + extra
        if lines:
            main += "\n  " + "\n  ".join(lines) + "\n"
        return main + ")"
