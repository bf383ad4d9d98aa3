"""paddle.utils.unique_name parity (`python/paddle/utils/unique_name.py`)."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class _Generator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key):
        self.ids[key] += 1
        return f"{key}_{self.ids[key] - 1}"


_generator = _Generator()


def generate(key: str) -> str:
    return _generator(key)


def switch(new_generator=None):
    global _generator
    old = _generator
    _generator = new_generator or _Generator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
