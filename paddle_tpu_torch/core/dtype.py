"""Dtype system.

Reference parity: phi DataType enum (`paddle/phi/common/data_type.h`) exposed as
``paddle.float32`` etc.  A `DType` is a thin singleton naming a torch dtype;
string forms ("float32"), torch dtypes and numpy dtypes are accepted
everywhere.

bfloat16 has no numpy dtype without `ml_dtypes`, which this package does not
import: `numpy_dtype(bfloat16)` is float32, and `Tensor.numpy()` of a bf16
tensor gives its values as float32.  That is exact, since every bf16 value
is a float32 value.  An incoming numpy array whose dtype is named "bfloat16"
(an `ml_dtypes` array) is read by its bits (`core.tensor.from_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch


class DType:
    """A framework dtype: hashable, comparable with strings, torch dtypes
    and numpy dtypes."""

    __slots__ = ("name", "torch_dtype")

    def __init__(self, name: str, torch_dtype: torch.dtype):
        self.name = name
        self.torch_dtype = torch_dtype

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        if isinstance(other, str):
            return self.name == other
        if isinstance(other, torch.dtype):
            return self.torch_dtype == other
        if other is None:
            return False
        try:
            return self.name == np.dtype(other).name
        except TypeError:
            return NotImplemented

    def __hash__(self):
        return hash(self.name)

    @property
    def itemsize(self):
        return self.torch_dtype.itemsize

    def is_floating_point(self):
        return self.torch_dtype.is_floating_point

    def is_integer(self):
        return not (self.torch_dtype.is_floating_point
                    or self.torch_dtype.is_complex or self.name == "bool")

    def is_complex(self):
        return self.torch_dtype.is_complex


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)
float8_e4m3fn = DType("float8_e4m3fn", torch.float8_e4m3fn)
float8_e5m2 = DType("float8_e5m2", torch.float8_e5m2)

_ALL = [bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
        float64, complex64, complex128]
_BY_NAME = {d.name: d for d in _ALL}
_BY_NAME["float"] = float32
_BY_NAME["double"] = float64
_BY_NAME["half"] = float16
_BY_NAME["int"] = int32
_BY_NAME["long"] = int64
_BY_TORCH = {d.torch_dtype: d for d in _ALL + [float8_e4m3fn, float8_e5m2]}


def convert_dtype(dtype) -> DType:
    """Normalise any dtype spec (DType, str, torch dtype, numpy dtype) to a
    DType."""
    if dtype is None:
        return None
    if isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, str):
        if dtype in _BY_NAME:
            return _BY_NAME[dtype]
        raise ValueError(f"unknown dtype string {dtype!r}")
    if isinstance(dtype, torch.dtype):
        if dtype in _BY_TORCH:
            return _BY_TORCH[dtype]
        raise ValueError(f"unsupported dtype {dtype!r}")
    name = np.dtype(dtype).name
    if name in _BY_NAME:
        return _BY_NAME[name]
    raise ValueError(f"unsupported dtype {dtype!r}")


def to_torch(dtype) -> torch.dtype:
    """DType/str/torch/numpy dtype -> torch dtype."""
    d = convert_dtype(dtype)
    return d.torch_dtype if d is not None else None


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype `Tensor.numpy()` returns: the dtype's own, float32
    for bfloat16 (see the module docstring)."""
    d = convert_dtype(dtype)
    if d.name == "bfloat16":
        return np.dtype(np.float32)
    return np.dtype(d.name)


# default dtype machinery (paddle.set_default_dtype)
_default_dtype = float32


def set_default_dtype(dtype):
    global _default_dtype
    d = convert_dtype(dtype)
    if not d.is_floating_point():
        raise TypeError("default dtype must be floating point, got %s" % d)
    _default_dtype = d


def get_default_dtype() -> str:
    return _default_dtype.name
