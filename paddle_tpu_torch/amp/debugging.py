"""AMP debugging — port of `paddle_tpu/amp/debugging.py` (reference:
`python/paddle/amp/debugging.py`: tensor checker, low-precision op audit),
over the port's flag registry (`core/flags.py`).  As in the reference,
`_record_op` has no caller yet, so `collect_operator_stats` prints an
empty list."""
from __future__ import annotations

import contextlib
from collections import Counter

from ..core import flags as _flags

_op_counter = Counter()
_checking = False


def enable_operator_stats_collection():
    _op_counter.clear()
    _flags.set_flags({"FLAGS_low_precision_op_list": 1})


def disable_operator_stats_collection():
    _flags.set_flags({"FLAGS_low_precision_op_list": 0})
    print("<------------------- op list -------------------->")
    for op, cnt in _op_counter.most_common():
        print(f"  {op}: {cnt}")


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def _record_op(name, dtype):
    if _flags.flag("low_precision_op_list"):
        _op_counter[f"{name}:{dtype}"] += 1


def enable_tensor_checker(checker_config=None):
    _flags.set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    _flags.set_flags({"FLAGS_check_nan_inf": False})


class TensorCheckerConfig:
    def __init__(self, enable=True, debug_mode=None, output_dir=None, **kw):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
