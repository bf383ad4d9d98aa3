"""The eager Tensor and the op-dispatch layer.

Reference parity: the public `paddle::Tensor` handle (`paddle/phi/api/include/tensor.h:82`)
plus `AutogradMeta` (`paddle/fluid/eager/autograd_meta.h:61`) and the generated
`*_ad_func` dispatch (`eager/auto_code_generator/generator/eager_gen.py:214`).

`Tensor` wraps one torch tensor (`_t`, the reference's `_data`); it is not a
`torch.Tensor` subclass, because Paddle's `shape` is a list, `size` an int
property, `T` reverses every dim and `stop_gradient` is the inverse of
`requires_grad`, each of which would clash with torch's own.  Autograd is
torch's: `stop_gradient` reads and writes `_t.requires_grad`, `.grad` is the
leaf's `_t.grad`, wrapped, and `backward` runs `torch.autograd.backward`.

`apply(name, fn, *inputs)` is the one dispatch point: `fn` takes and
returns torch tensors (Python scalars among the inputs arrive as 0-d tensors
of the dtype torch's scalar promotion gives them), outputs come back as
Tensors.  It keeps the reference's NaN/Inf check and two slots that later
modules fill: the AMP state and the static-graph recorder.

In-place ops (`add_` ... `set_value`) and `__setitem__` rebind `_t` to a new
torch tensor out of place, as the reference rebinds `_data`; the wrapper's
hooks and its `retain_grads` mark move to the new tensor.  Each bumps the
wrapper's `_version`, as the reference does, and `apply` keeps the
reference's version check (`GradNode.input_versions`): every op records its
Tensor inputs' versions, and when backward reaches the op's outputs an input
rebound in place since raises "modified by an inplace operation", whether
or not the op saved it (`_version_check`).  The in-place op's own nodes do
not check the wrapper they rebind (the reference's snapshot), so a chain of
in-place ops differentiates; a view is a wrapper of its own, so an in-place
op on it leaves its base's readers alone, as in the reference.  A
leaf that needs grad takes `x[i] = v` without torch's in-place-on-leaf
error.  Value-replacing ops (`zero_`, `fill_`, `copy_`, `set_value`) keep a
leaf a leaf, with its `.grad`; on a non-leaf they pass the gradient through
to the old value's graph, as the reference keeps the tensor's node.  Where
the reference writes `_data` itself (initializers, `set_state_dict`,
running statistics, the clip utilities), the port calls `_replace` or
writes under `no_grad`, and bumps nothing.

Dtypes: the reference runs JAX with 64-bit types off, so its int and float64
data arrive as 32-bit; the port keeps them as given (Python ints int64, a
float64 numpy array float64, as Paddle does), and a Python float or a list
of them takes the default dtype, as in the reference.
"""
from __future__ import annotations

import threading
from typing import Any, Callable

import numpy as np
import torch

from . import autograd as _ag
from . import dtype as _dt
from . import flags as _flags
from .place import Place, expected_device, parse_place, place_of

_SCALARS = (bool, int, float, complex)


def from_numpy(a) -> torch.Tensor:
    """A numpy array (an `ml_dtypes` bfloat16 one too, read by its bits) ->
    a CPU torch tensor holding a private copy."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _device_of(place) -> torch.device:
    """None (the expected place), a torch device, a Place or its name ->
    a torch device."""
    if place is None:
        return expected_device()
    if isinstance(place, torch.device):
        return place
    return parse_place(place).torch_device()


def _to_torch(data, dtype=None, place=None) -> torch.Tensor:
    """Constructor data -> a torch tensor detached from any graph: a Tensor
    or torch tensor keeps its device unless `place` names one; numpy and
    Python data go to `place` (default: the expected place)."""
    if isinstance(data, Tensor):
        t = data._t.detach()
    elif isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        if isinstance(data, np.ndarray) or np.isscalar(data) and \
                not isinstance(data, _SCALARS):
            t = from_numpy(data)
        else:
            a = np.asarray(data)
            if dtype is None and a.dtype == np.float64:
                dtype = _dt._default_dtype
            t = from_numpy(a)
        t = t.to(_device_of(place))
        place = None
    if place is not None:
        t = t.to(_device_of(place))
    if dtype is not None:
        t = t.to(_dt.to_torch(dtype))
    return t


def _raw(x):
    return x._t if isinstance(x, Tensor) else x


def _differentiable(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


def _torch_hook(hook):
    """A torch tensor hook running a Paddle hook: it sees a Tensor and may
    return a Tensor (or None, keeping the gradient)."""
    def run(g):
        res = hook(Tensor._wrap(g))
        if res is None:
            return None
        return res._t if isinstance(res, Tensor) else torch.as_tensor(
            res, dtype=g.dtype, device=g.device)
    return run


class _HookHandle:
    def __init__(self, tensor, entry):
        self._tensor, self._entry = tensor, entry

    def remove(self):
        hooks = self._tensor._hooks
        if self._entry in hooks:
            hooks.remove(self._entry)
            if self._entry[1] is not None:
                self._entry[1].remove()
                self._entry[1] = None


class _Rebound(torch.autograd.Function):
    """A non-leaf's value replaced in place: the new value out, the gradient
    passed to the old value's graph unchanged."""

    @staticmethod
    def forward(ctx, old, value):
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Tensor:
    """Eager tensor: one torch tensor and the Paddle surface over it."""

    __slots__ = ("_t", "name", "persistable", "trainable", "is_distributed",
                 "_optimize_attrs", "_hooks", "_retain", "_sg", "_grad_wrap",
                 "_vc", "__weakref__", "__dict__")

    _name_counter = 0

    def __init__(self, data=None, dtype=None, place=None, stop_gradient=True,
                 name=None):
        if data is None:
            t = torch.zeros((), dtype=_dt.to_torch(dtype or _dt._default_dtype),
                            device=_device_of(place))
        else:
            t = _to_torch(data, dtype, place)
        self._init(t, name)
        self.stop_gradient = stop_gradient

    def _init(self, t, name=None):
        self._t = t
        # in-place version counter (ref inplace_version), in a cell that the
        # readers' version checks hold: it outlives the wrapper
        self._vc = [0]
        self._sg = True
        self._hooks = []
        self._retain = False
        self._grad_wrap = None
        self.persistable = False
        self.trainable = True
        self.is_distributed = False
        self._optimize_attrs = {}
        self.name = _generated_name() if name is None else name

    @property
    def _version(self):
        return self._vc[0]

    @_version.setter
    def _version(self, v):
        self._vc[0] = v

    @classmethod
    def _wrap(cls, t: torch.Tensor) -> "Tensor":
        """A Tensor over `t` as it is (no copy, no detach)."""
        self = cls.__new__(cls)
        self._init(t)
        return self

    # ---- structural properties ----
    @property
    def shape(self):
        return list(self._t.shape)

    @property
    def ndim(self):
        return self._t.ndim

    dim = ndim

    @property
    def dtype(self):
        return _dt.convert_dtype(self._t.dtype)

    @property
    def size(self):
        return self._t.numel()

    def numel(self):
        return self._t.numel()

    @property
    def place(self):
        return place_of(self._t.device)

    @property
    def is_leaf(self):
        return self._t.grad_fn is None

    @property
    def T(self):
        # paddle semantics: reverse ALL dimensions (fluid/dygraph/math_op_patch.py:174)
        return apply("t", lambda x: x.permute(*reversed(range(x.ndim))), self)

    @property
    def mT(self):
        return apply("mT", lambda x: x.transpose(-2, -1) if x.ndim >= 2 else x,
                     self)

    # ---- autograd state ----
    @property
    def stop_gradient(self):
        t = self._t
        return not t.requires_grad if _differentiable(t) else self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        t = self._t
        if not _differentiable(t):
            self._sg = bool(value)
        elif value and t.requires_grad:
            if t.grad_fn is None:
                t.requires_grad_(False)
            else:
                self._rebind(t.detach())
        elif not value and not t.requires_grad:
            t.requires_grad_(True)
            self._rebind(t)             # hooks held while it needed none

    @property
    def grad(self):
        t = self._t
        if not (t.grad_fn is None or t.retains_grad) or t.grad is None:
            return None
        w = self._grad_wrap
        if w is None or w._t is not t.grad:
            w = Tensor._wrap(t.grad)
            w.persistable = True
            self._grad_wrap = w
        return w

    @grad.setter
    def grad(self, value):
        self._grad_wrap = None
        self._t.grad = None if value is None else _raw(value)

    def _rebind(self, t: torch.Tensor) -> "Tensor":
        """Point the wrapper at `t`, moving its hooks and `retain_grads`
        mark there."""
        self._t = t
        self._grad_wrap = None
        for entry in self._hooks:
            if entry[1] is not None:
                entry[1].remove()
                entry[1] = None
            if t.requires_grad:
                entry[1] = t.register_hook(_torch_hook(entry[0]))
        if self._retain and t.grad_fn is not None:
            t.retain_grad()
        return self

    def _replace(self, value: torch.Tensor) -> "Tensor":
        """Replace the value, keeping a leaf a leaf (and its grad) and a
        non-leaf's graph (`_Rebound`)."""
        t = self._t
        value = value.detach().to(dtype=t.dtype, device=t.device)
        if t.grad_fn is not None:
            return self._rebind(_Rebound.apply(t, value))
        if t.requires_grad:
            value.requires_grad_(True)
            if t.grad is not None and t.grad.shape == value.shape:
                value.grad = t.grad
        return self._rebind(value)

    # ---- conversion ----
    def numpy(self):
        """The values as a numpy array (a copy); bfloat16 as float32."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.cpu().numpy()
        return a.copy() if self._t.device.type == "cpu" else a

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return self._t.item()

    def tolist(self):
        return self.numpy().tolist()

    def astype(self, dtype):
        td = _dt.to_torch(dtype)
        return apply("cast", lambda x: x.to(td), self)

    cast = astype

    def clone(self):
        return apply("clone", torch.clone, self)

    def detach(self):
        t = Tensor._wrap(self._t.detach())
        t.name = self.name + ".detach"
        return t

    def cpu(self):
        return apply("cpu", lambda x: x.cpu(), self)

    def cuda(self, device_id=None, blocking=True):
        """The card `device_id` (default: the expected place's, or card 0
        when that is the CPU)."""
        if device_id is None:
            dev = _device_of(None)
            device_id = dev.index if dev.type == "cuda" else 0
        dev = parse_place(f"gpu:{device_id}").torch_device()
        return apply("cuda", lambda x: x.to(dev), self)

    tpu = cuda  # the reference's accelerator move

    def pin_memory(self):
        return self.cpu()

    def to(self, *args, **kwargs):
        t = self
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, torch.device) or isinstance(a, Place) or (
                    isinstance(a, str) and a.split(":")[0] in (
                        "cpu", "gpu", "cuda", "tpu", "xpu")):
                dev = _device_of(a)
                t = apply("to", lambda x: x.to(dev), t)
            elif a is not None and not isinstance(a, bool):
                t = t.astype(a)
        return t

    # ---- autograd surface ----
    def backward(self, grad_tensor=None, retain_graph=False):
        _ag.run_backward([self], [grad_tensor], retain_graph)

    def register_hook(self, hook):
        """hook(grad: Tensor) -> Tensor or None, run when this tensor's
        gradient is computed (before a leaf accumulates it)."""
        entry = [hook, None]
        self._hooks.append(entry)
        if self._t.requires_grad:
            entry[1] = self._t.register_hook(_torch_hook(hook))
        return _HookHandle(self, entry)

    def clear_grad(self, set_to_zero=False):
        self._grad_wrap = None
        g = self._t.grad
        self._t.grad = torch.zeros_like(g) if set_to_zero and g is not None \
            else None

    clear_gradient = clear_grad

    def retain_grads(self):
        """Retain .grad on a non-leaf tensor (reference Tensor.retain_grads)."""
        if self._t.grad_fn is None:
            return  # leaf: backward writes .grad anyway
        self._retain = True
        self._t.retain_grad()

    @property
    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def _grad_ivar(self):
        return self.grad

    # ---- python protocol ----
    def __len__(self):
        if self._t.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._t.shape[0]

    def __repr__(self):
        prefix = "Tensor(shape={}, dtype={}, place={}, stop_gradient={},\n       ".format(
            self.shape, self.dtype.name, self.place, self.stop_gradient)
        body = np.array2string(self.numpy(), prefix=" " * 7)
        return prefix + body + ")"

    def __bool__(self):
        if self._t.numel() != 1:
            raise ValueError("The truth value of a multi-element Tensor is ambiguous")
        return bool(self._t.item())

    def __int__(self):
        return int(self._t.item())

    def __float__(self):
        return float(self._t.item())

    def __index__(self):
        return int(self._t.item())

    def __format__(self, spec):
        if self._t.numel() == 1:
            return format(self.item(), spec)
        return object.__format__(self, spec)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __hash__(self):
        return id(self)

    def __dlpack__(self, *args, **kwargs):
        return self._t.detach().__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._t.__dlpack_device__()

    # ---- indexing ----
    def __getitem__(self, idx):
        nidx, flat = _norm_index(idx, self._t)
        if flat is not None:
            return apply("slice", lambda x: x.reshape(-1)[flat], self)
        return apply("slice", lambda x: x[nidx], self)

    def __setitem__(self, idx, value):
        nidx, flat = _norm_index(idx, self._t)

        def setfn(x, v):
            out = x.clone(memory_format=torch.contiguous_format)
            where, dst = (out.view(-1), flat) if flat is not None \
                else (out, nidx)
            shape = where[dst].shape
            v = v.to(x.dtype)
            if v.shape != shape:
                v = v.reshape(shape) if v.numel() == shape.numel() \
                    else v.broadcast_to(shape)
            where[dst] = v
            return out

        self._inplace(lambda: apply("set_value", setfn, self, value))

    # ---- arithmetic dunders (full set; implementations are torch ops) ----
    def __add__(self, o):
        return apply("add", torch.add, self, o)

    def __radd__(self, o):
        return apply("add", torch.add, o, self)

    def __sub__(self, o):
        return apply("subtract", torch.sub, self, o)

    def __rsub__(self, o):
        return apply("subtract", torch.sub, o, self)

    def __mul__(self, o):
        return apply("multiply", torch.mul, self, o)

    def __rmul__(self, o):
        return apply("multiply", torch.mul, o, self)

    def __truediv__(self, o):
        return apply("divide", torch.true_divide, self, o)

    def __rtruediv__(self, o):
        return apply("divide", torch.true_divide, o, self)

    def __floordiv__(self, o):
        return apply("floor_divide", torch.floor_divide, self, o)

    def __rfloordiv__(self, o):
        return apply("floor_divide", torch.floor_divide, o, self)

    def __mod__(self, o):
        return apply("remainder", torch.remainder, self, o)

    def __rmod__(self, o):
        return apply("remainder", torch.remainder, o, self)

    def __pow__(self, o):
        return apply("pow", torch.pow, self, o)

    def __rpow__(self, o):
        return apply("pow", torch.pow, o, self)

    def __matmul__(self, o):
        return apply("matmul", torch.matmul, self, o)

    def __rmatmul__(self, o):
        return apply("matmul", torch.matmul, o, self)

    def __neg__(self):
        return apply("neg", torch.neg, self)

    def __abs__(self):
        return apply("abs", torch.abs, self)

    def __invert__(self):
        return apply("invert", torch.bitwise_not, self)

    # comparison (stop_gradient outputs)
    def __eq__(self, o):
        return apply("equal", torch.eq, self, o)

    def __ne__(self, o):
        return apply("not_equal", torch.ne, self, o)

    def __lt__(self, o):
        return apply("less_than", torch.lt, self, o)

    def __le__(self, o):
        return apply("less_equal", torch.le, self, o)

    def __gt__(self, o):
        return apply("greater_than", torch.gt, self, o)

    def __ge__(self, o):
        return apply("greater_equal", torch.ge, self, o)

    def __and__(self, o):
        return apply("bitwise_and", torch.bitwise_and, self, o)

    def __or__(self, o):
        return apply("bitwise_or", torch.bitwise_or, self, o)

    def __xor__(self, o):
        return apply("bitwise_xor", torch.bitwise_xor, self, o)

    # in-place variants (trailing-underscore, paddle style): rebind _t
    def _inplace(self, compute) -> "Tensor":
        """Rebind to `compute()`, an op on the current value, and bump the
        version (the reference's `_inplace_from`).  The nodes `compute`
        records do not check this wrapper: they read the value before the
        bump, as the reference's snapshot does, so a later in-place op on
        it does not fail them."""
        stack = _exempt.__dict__.setdefault("stack", [])
        stack.append(self)
        try:
            out = compute()
        finally:
            stack.pop()
        self._version += 1
        return self._rebind(out._t)

    def add_(self, o):
        return self._inplace(lambda: self.__add__(o))

    def subtract_(self, o):
        return self._inplace(lambda: self.__sub__(o))

    def multiply_(self, o):
        return self._inplace(lambda: self.__mul__(o))

    def divide_(self, o):
        return self._inplace(lambda: self.__truediv__(o))

    def scale_(self, scale=1.0, bias=0.0):
        return self._inplace(lambda: apply("scale", lambda x: x * scale + bias,
                                           self))

    def _set(self, value: torch.Tensor) -> "Tensor":
        self._version += 1
        return self._replace(value)

    def zero_(self):
        return self._set(torch.zeros_like(self._t))

    def fill_(self, value):
        return self._set(torch.full_like(self._t, value))

    def copy_(self, other, blocking=True):
        return self._set(torch.as_tensor(_raw(other)))

    def set_value(self, value):
        v = value if isinstance(value, (Tensor, torch.Tensor)) else \
            from_numpy(np.asarray(value))
        return self._set(_raw(v))

    # value state used by optimizers/Layer
    def _is_initialized(self):
        return True


def _generated_name() -> str:
    """The next `generated_tensor_N` of the process-wide name counter."""
    Tensor._name_counter += 1
    return f"generated_tensor_{Tensor._name_counter}"


def _norm_index(idx, x: torch.Tensor):
    """A Paddle (numpy-style) index -> (torch index, None), or, where it
    holds a negative-step slice (which torch indexing does not take),
    (None, the flat positions it selects as a long tensor on x's device)."""
    items = idx if isinstance(idx, tuple) else (idx,)
    negative = any(isinstance(i, slice) and i.step is not None and i.step < 0
                   for i in items)

    def conv(i):
        if isinstance(i, Tensor):
            i = i._t
        if isinstance(i, (list, np.ndarray)):
            i = torch.as_tensor(np.asarray(i))
        if isinstance(i, torch.Tensor) and not i.is_floating_point() and \
                i.dtype != torch.bool:
            i = i.long()
        if negative and isinstance(i, torch.Tensor):
            return i.cpu().numpy()
        return i

    conv_items = tuple(conv(i) for i in items)
    if not negative:
        return (conv_items if isinstance(idx, tuple) else conv_items[0]), None
    pos = np.arange(x.numel()).reshape(tuple(x.shape))[
        conv_items if isinstance(idx, tuple) else conv_items[0]]
    return None, torch.from_numpy(np.array(pos)).to(x.device)


class Parameter(Tensor):
    """Trainable tensor (paddle.framework.Parameter parity): stop_gradient=False."""

    def __init__(self, data=None, dtype=None, name=None, trainable=True):
        super().__init__(data, dtype=dtype, stop_gradient=not trainable,
                         name=name)
        self.persistable = True
        self.trainable = trainable


EagerParamBase = Parameter  # reference alias


# ---------------------------------------------------------------------------
# op dispatch
# ---------------------------------------------------------------------------

_amp_state = None  # set by the AMP module to an active autocast state or None


def _set_amp_state(state):
    global _amp_state
    _amp_state = state


# static-graph recorder slot: when static mode is on, every apply() also
# appends (name, fn, inputs, outputs) to the current static Program
_static_recorder = [None]


def _datas(inputs):
    """apply's inputs -> torch tensors: a Tensor's own, numpy and lists
    moved to the first tensor's device, Python scalars as 0-d tensors of
    `torch.result_type(first tensor, scalar)` (torch's and JAX's weak
    scalar typing)."""
    ref = next((_raw(x) for x in inputs
                if isinstance(x, (Tensor, torch.Tensor))), None)
    out = []
    for x in inputs:
        if isinstance(x, Tensor):
            out.append(x._t)
        elif isinstance(x, torch.Tensor) or x is None:
            out.append(x)
        elif isinstance(x, _SCALARS) and ref is not None:
            out.append(torch.tensor(x, dtype=torch.result_type(ref, x),
                                    device=ref.device))
        elif isinstance(x, _SCALARS):
            out.append(torch.as_tensor(x))
        else:
            t = from_numpy(np.asarray(x))
            out.append(t if ref is None else t.to(ref.device))
    return out


def apply(name: str, fn: Callable, *inputs) -> Any:
    """Single dispatch point for every eager op.

    Mirrors the generated ad_func pipeline (`eager_gen.py:214`): AMP cast ->
    forward -> optional NaN check.  torch autograd records the graph when
    grad mode is on and an input requires grad.  `fn` consumes and produces
    torch tensors; attrs are closed over by the caller."""
    given = inputs
    if _amp_state is not None and _amp_state.enabled:
        inputs = _amp_state.cast_inputs(name, inputs)
    datas = _datas(inputs)
    res = _wrap_outputs(name, fn(*datas), datas)
    _version_check(name, given, res)
    if _static_recorder[0] is not None:
        _static_recorder[0]._record(name, fn, inputs, res)
    return res


def _wrap_outputs(name, out, datas):
    if _flags.flag("check_nan_inf"):
        _check_numerics(name, out)
    ids = {id(d) for d in datas}

    def wrap(o):
        if not isinstance(o, torch.Tensor):
            return o
        if id(o) in ids:            # an input handed back: a fresh alias
            o = o.view_as(o)
        return Tensor._wrap(o)

    if isinstance(out, (tuple, list)):
        return tuple(wrap(o) for o in out)
    return wrap(out)


# this thread's wrappers whose in-place op is being recorded
# (`Tensor._inplace`), in `_exempt.stack`
_exempt = threading.local()


def _version_check(name, inputs, outputs):
    """Record the Tensor inputs' versions and check them when backward
    reaches the outputs' nodes (the reference's `input_versions`): an input
    bumped by an in-place op since raises there.  The check holds each
    input's version cell, not the wrapper, so no value is kept alive and a
    bump still counts after the wrapper is gone."""
    outs = outputs if isinstance(outputs, tuple) else (outputs,)
    nodes = {o._t.grad_fn for o in outs
             if isinstance(o, Tensor) and o._t.grad_fn is not None}
    if not nodes:
        return
    skip = getattr(_exempt, "stack", ())
    seen = [(x._vc, x._vc[0]) for x in inputs
            if isinstance(x, Tensor) and not any(x is e for e in skip)]
    if not seen:
        return

    def check(grad_outputs):
        for cell, version in seen:
            if cell[0] != version:
                raise RuntimeError(
                    "one of the variables needed for gradient computation "
                    f"has been modified by an inplace operation: input of "
                    f"'{name}' is at version {cell[0]}, expected {version}")
    for node in nodes:
        node.register_prehook(check)


def _check_numerics(name, out):
    """FLAGS_check_nan_inf parity (`fluid/eager/nan_inf_utils.h:38`)."""
    outs = out if isinstance(out, (tuple, list)) else [out]
    for o in outs:
        if isinstance(o, torch.Tensor) and _differentiable(o) and \
                not bool(torch.isfinite(o).all()):
            msg = f"Operator {name} output contains NaN/Inf"
            if _flags.flag("check_nan_inf_level") == 0:
                raise FloatingPointError(msg)
            print("WARNING:", msg)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a Python float or a float64 list takes the default
    dtype; a float64 numpy array stays float64."""
    if isinstance(data, Tensor):
        t = data.astype(dtype) if dtype is not None else \
            Tensor._wrap(data._t.detach())
        if place is not None:
            t = t.to(place)
        t.stop_gradient = stop_gradient
        return t
    if dtype is None and isinstance(data, float):
        dtype = _dt._default_dtype
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)
