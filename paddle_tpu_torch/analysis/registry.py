"""The serving program budget — port of `SERVE_PROGRAM_BUDGET` in
`paddle_tpu/analysis/registry.py`, its keys and values copied.

The reference runs a fixed set of executables whatever the traffic: the
decode side is one fused program (vanilla decode, verify and the
interleaved prefill chunk ride it), the prefill budget covers the cold paths
(one-shot bucketed prefill, and the chunk program where it exists), plus
one COW page copy and the swap gather and scatter.  The port's programs are
its CUDA graphs, one per fixed step shape, and each eager bucket shape of
the one-shot prefill; `LLMEngine.stats()` counts them under the reference's
keys, and `program_counts` folds those into the budget's.
"""
from __future__ import annotations

from typing import Dict, Tuple

SERVE_PROGRAM_BUDGET: Dict[str, int] = {
    "decode_side_executables": 1,   # THE fused serve_step_paged program
    "prefill_executables": 2,
    "copy_executables": 1,
    "swap_executables": 2,          # preemption swap-out gather + swap-in
    "total_executables": 6,
}


def program_counts(stats: Dict[str, object]) -> Dict[str, int]:
    """An engine's `stats()` under the budget's keys (decode side: decode
    plus verify programs), as the reference's program-count check sums
    them."""
    got = {"decode_side_executables": stats["decode_executables"] +
           stats["verify_executables"],
           "prefill_executables": stats["prefill_executables"],
           "copy_executables": stats["copy_executables"],
           "swap_executables": stats["swap_executables"]}
    got["total_executables"] = sum(got.values())
    return got


def over_budget(stats: Dict[str, object]) -> Dict[str, Tuple[int, int]]:
    """{key: (count, bound)} for each budget key the engine exceeds."""
    return {k: (n, SERVE_PROGRAM_BUDGET[k])
            for k, n in program_counts(stats).items()
            if n > SERVE_PROGRAM_BUDGET[k]}
