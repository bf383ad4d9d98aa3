"""Input functionals — port of `paddle_tpu/nn/functional/input.py`
(reference `python/paddle/nn/functional/input.py`)."""
from __future__ import annotations

import torch

from ...core.tensor import apply
from .common import one_hot  # noqa: F401  (Paddle has it in both modules)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of `weight` at the ids; a `padding_idx` row reads as zeros (and
    takes no gradient).  `sparse` is accepted: gradients are dense
    scatter-adds, as in the reference."""
    def f(ids, w):
        out = w[ids.long()]
        if padding_idx is not None and padding_idx >= 0:
            out = torch.where((ids == padding_idx)[..., None], 0.0, out)
        return out
    return apply("embedding", f, x, weight)

