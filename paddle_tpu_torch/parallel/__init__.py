"""Training (dp, pp and vpp, sharding, mp, ep) and tensor-parallel serving —
port of `paddle_tpu/parallel`."""
from .hybrid import (HybridParallelTrainer, MeshConfig,  # noqa: F401
                     serving_mesh, serving_param_specs)
