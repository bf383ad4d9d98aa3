from . import kernels  # noqa: F401
from . import nn  # noqa: F401
