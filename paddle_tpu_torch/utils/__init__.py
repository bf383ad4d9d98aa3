"""`paddle.utils` of the port: so far `unique_name`."""
from . import unique_name  # noqa: F401
