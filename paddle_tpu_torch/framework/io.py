"""paddle.save / paddle.load — port of `paddle_tpu/framework/io.py`
(reference `python/paddle/framework/io.py`): pickled nested state (dicts,
lists, tuples), Tensors as numpy arrays, to a path or a file object; a
load gives Tensors on the expected place, or the arrays with
`return_numpy=True`.

Float32, float16, float64 and integer Tensors are plain ndarrays, so such
files load in both packages.  bfloat16 has no numpy dtype without
`ml_dtypes`, which the port does not use (and `Tensor.numpy()` widens it to
float32, which would silently turn an O2 checkpoint into float32): the port
writes a bf16 Tensor as the one-key dict `{"__bfloat16_bits__": a uint16
ndarray of its bits}` (the bit-view form of `distributed/checkpoint.py`),
and restores it bit for bit; with `return_numpy=True` it gives the values
as float32, as `Tensor.numpy()` does.  The JAX package reads that dict as a
dict.  A JAX-package file with an `ml_dtypes` bf16 array loads into the
port by its bits (`core.tensor.from_numpy`), wherever it can be unpickled
(`ml_dtypes` importable).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..core.place import expected_device
from ..core.tensor import Tensor

_BF16_BITS = "__bfloat16_bits__"


def _pack(obj):
    if isinstance(obj, Tensor):
        obj = obj._t
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return {_BF16_BITS: t.contiguous().view(torch.int16).numpy()
                    .view(np.uint16)}
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _loaded(data, stop_gradient=True, name=None) -> Tensor:
    """A loaded value as a persistable Tensor on the expected place."""
    t = Tensor(data, stop_gradient=stop_gradient, place=expected_device(),
               name=name)
    t.persistable = True
    return t


def _unpack(obj, return_numpy=False):
    if isinstance(obj, np.ndarray):
        return obj if return_numpy else _loaded(obj)
    if isinstance(obj, dict):
        if len(obj) == 1 and isinstance(obj.get(_BF16_BITS), np.ndarray):
            bits = torch.from_numpy(np.array(obj[_BF16_BITS]).view(np.int16))
            t = bits.view(torch.bfloat16)
            return t.float().numpy() if return_numpy else _loaded(t)
        if obj.get("__ptensor__"):  # the reference's legacy marker format
            if return_numpy:
                return obj["data"]
            return _loaded(obj["data"], obj.get("stop_gradient", True),
                           obj.get("name"))
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    if hasattr(path, "write"):
        pickle.dump(_pack(obj), path, protocol=protocol)
        return
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, **configs):
    return_numpy = configs.get("return_numpy", False)
    if hasattr(path, "read"):
        return _unpack(pickle.load(path), return_numpy)
    with open(str(path), "rb") as f:
        return _unpack(pickle.load(f), return_numpy)
