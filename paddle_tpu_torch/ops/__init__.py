"""The op namespace of the port (reference: `paddle_tpu/ops/`): torch code
inside `core.tensor.apply`, on the tensors' device."""
from . import creation, einsum, linalg, logic, manipulation, math, random, search, stat  # noqa
