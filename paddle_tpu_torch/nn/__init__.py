"""`paddle.nn` of the port: so far `Layer`, the initializers and the
flash-attention functions."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer import Layer  # noqa: F401
