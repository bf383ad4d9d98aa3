"""`paddle.nn` of the port: so far the flash-attention functions."""
from . import functional  # noqa: F401
