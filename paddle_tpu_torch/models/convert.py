"""Load weights from the reference's `init_params` tree.

`params_from_numpy(tree, config, device)` maps the JAX pytree, handed over
as nested dicts of numpy arrays (the caller does the `np.asarray`), onto the
port's parameter dictionary.  The layouts match, so it is a copy: no
transposes, only a check of keys and shapes against `gpt.param_spec`.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .gpt import GPTConfig, param_spec, resolve_device


def _to_tensor(a: np.ndarray, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    a = np.array(a)                         # a private, writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], config: GPTConfig,
                      device=None) -> Dict[str, Any]:
    device = resolve_device(device)

    def walk(spec, sub, path):
        if set(spec) != set(sub):
            raise KeyError(f"{path or 'params'}: keys {sorted(sub)} != "
                           f"expected {sorted(spec)}")
        out = {}
        for k, s in spec.items():
            if isinstance(s, dict):
                out[k] = walk(s, sub[k], f"{path}{k}/")
                continue
            a = np.asarray(sub[k])
            if tuple(a.shape) != tuple(s[0]):
                raise ValueError(f"{path}{k}: shape {a.shape} != {s[0]}")
            out[k] = _to_tensor(a, config.dtype, device)
        return out

    return walk(param_spec(config), tree, "")
