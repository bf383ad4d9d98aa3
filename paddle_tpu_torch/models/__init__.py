from . import convert, gpt  # noqa: F401
