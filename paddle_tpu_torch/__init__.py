"""PyTorch/CUDA port of `paddle_tpu`'s serving path, trainer (one device or
a mesh), auto-parallel Engine and flash-attention API.

The JAX package `paddle_tpu` stays the reference; this package mirrors its
module paths (`models/gpt.py`, `incubate/kernels/*`, `inference/*`,
`parallel/hybrid.py`, `distributed/auto_parallel/engine.py`,
`nn/functional/flash_attention.py`) and keeps its
layouts at every public function.  It
imports torch and numpy, never jax and nothing of `paddle_tpu`.  Entry
points run on the CUDA card unless the caller passes `device="cpu"`, which
takes every kernel's plain PyTorch version.
"""
from . import (analysis, distributed, incubate, inference, models,  # noqa
               nn, parallel)

__version__ = "0.1.0"
