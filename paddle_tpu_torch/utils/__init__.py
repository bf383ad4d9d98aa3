"""`paddle.utils` of the port: so far `unique_name` and `cpp_extension`."""
from . import cpp_extension  # noqa: F401
from . import unique_name  # noqa: F401
