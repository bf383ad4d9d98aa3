"""einsum (reference: `python/paddle/tensor/einsum.py`)."""
from __future__ import annotations

import torch

from ..core.tensor import apply


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return apply("einsum", lambda *arrs: torch.einsum(equation, *arrs), *operands)
