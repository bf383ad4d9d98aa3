"""Training — port of `paddle_tpu/parallel` (single device so far)."""
from .hybrid import HybridParallelTrainer, MeshConfig  # noqa: F401
