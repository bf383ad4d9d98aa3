from . import cache, engine  # noqa: F401
