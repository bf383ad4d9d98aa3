"""PyTorch/CUDA port of `paddle_tpu`: the eager Tensor, autograd and Layer
API, the serving path, the trainer (one device or a mesh), the
auto-parallel Engine and the flash-attention API.

The JAX package `paddle_tpu` stays the reference; this package mirrors its
module paths (`core/*`, `autograd/*`, `nn/layer/layers.py`,
`nn/initializer`, `models/gpt.py`, `incubate/kernels/*`, `inference/*`,
`parallel/hybrid.py`, `distributed/auto_parallel/engine.py`,
`nn/functional/flash_attention.py`) and keeps its layouts at every public
function.  It imports torch and numpy, never jax and nothing of
`paddle_tpu`.  Entry points run on the CUDA card unless the caller passes
`device="cpu"` (or, for the eager API, `set_device("cpu")`), which takes
every kernel's plain PyTorch version.
"""
# ---- core ----
from .core.dtype import (bool_ as bool, uint8, int8, int16, int32, int64,  # noqa
                         float16, bfloat16, float32, float64, complex64,
                         complex128, set_default_dtype, get_default_dtype)
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace,  # noqa
                         Place, TPUPlace, XPUPlace, set_device, get_device,
                         device_count, is_compiled_with_cuda,
                         is_compiled_with_rocm, is_compiled_with_tpu,
                         is_compiled_with_xpu)
from .core.tensor import Tensor, to_tensor  # noqa
from .core.autograd import (no_grad, enable_grad, set_grad_enabled,  # noqa
                            is_grad_enabled)
from .core.generator import seed, get_rng_state_tracker  # noqa
from .core.flags import get_flags, set_flags  # noqa
from .param_attr import ParamAttr  # noqa
from .autograd import grad, backward  # noqa

from . import (analysis, autograd, distributed, incubate, inference,  # noqa
               models, nn, parallel, utils)

__version__ = "0.1.0"
