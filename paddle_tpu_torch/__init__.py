"""PyTorch/CUDA port of `paddle_tpu`'s serving path, single-device trainer
and flash-attention API.

The JAX package `paddle_tpu` stays the reference; this package mirrors its
module paths (`models/gpt.py`, `incubate/kernels/*`, `inference/*`,
`parallel/hybrid.py`, `nn/functional/flash_attention.py`) and keeps its
layouts at every public function.  It
imports torch and numpy, never jax and nothing of `paddle_tpu`.  Entry
points run on the CUDA card unless the caller passes `device="cpu"`, which
takes every kernel's plain PyTorch version.
"""
from . import analysis, incubate, inference, models, nn, parallel  # noqa: F401

__version__ = "0.1.0"
