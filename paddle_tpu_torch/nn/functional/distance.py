"""Distance functionals — port of `paddle_tpu/nn/functional/distance.py`
(reference `python/paddle/nn/functional/distance.py`)."""
from __future__ import annotations

import torch

from ...core.tensor import apply


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    def f(a, b):
        d = a - b + epsilon
        return torch.pow(torch.sum(torch.pow(d.abs(), p), dim=-1,
                                   keepdim=keepdim), 1.0 / p)
    return apply("pairwise_distance", f, x, y)
