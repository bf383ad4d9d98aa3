from . import kernels  # noqa: F401
