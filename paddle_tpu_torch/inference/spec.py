"""Draft proposers for speculative decoding — the port's copy of
`paddle_tpu/inference/spec.py` (numpy only; the port imports nothing of
the JAX package).

The serving engine's verify lane (`models.gpt.verify_step_paged`, and the
fused step `models.gpt.serve_step_paged`) scores `spec_len + 1` candidate
tokens per slot in one fixed-shape pass; anything that can guess the next
few tokens cheaply is a valid draft source.  This module holds the
host-side proposers:

- `DraftProposer` — the pluggable interface: per-slot, history in, up to
  `max_tokens` proposed continuation tokens out.
- `NgramProposer` — n-gram / prompt-lookup self-drafting: match the
  sequence's trailing n-gram against its own earlier prompt+generated
  history and propose the tokens that followed the most recent previous
  occurrence (the earliest one when every recent hit is cut short by the
  end of the history).  Zero model cost, strong where decode is most
  wasteful: repetitive continuations (code, structured text, loops).

Proposals are guesses: the engine's greedy longest-prefix acceptance only
emits tokens the verify logits argmax to, so a bad proposer costs speed,
never correctness.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class DraftProposer:
    """Interface: propose up to `max_tokens` continuation tokens for one
    slot given its token history (prompt + generated so far)."""

    # History window consulted, in tokens from the END of the context.
    # Part of the interface contract: the engine materializes only this tail
    # of prompt+generated before calling propose() (proposing runs on the
    # host inside every decode iteration, so per-slot work must not grow
    # with sequence length).  0 = unbounded: the full history is built and
    # passed each iteration — O(context) per slot per step.
    max_lookback: int = 0

    def propose(self, context: np.ndarray,
                max_tokens: int) -> Optional[np.ndarray]:
        """context: 1-D int array, the last `max_lookback` tokens of
        prompt + generated (generated last; everything when max_lookback=0).
        Returns int32 [n] with 1 <= n <= max_tokens, or None for no draft
        (the slot falls back to vanilla decode this iteration)."""
        raise NotImplementedError

    # Observability: drafting runs on the host inside every decode iteration,
    # so the engine's step trace wants the proposer's own view of its traffic
    # (how often the scan even finds a match is a victim-selection signal the
    # slot-level acceptance counters cannot recover).  Both hooks are
    # optional — the engine probes with getattr and tolerates proposers that
    # track nothing.
    def stats(self) -> Dict[str, object]:
        """Host-side drafting telemetry; default: nothing tracked."""
        return {}

    def reset_stats(self) -> None:
        """Zero the telemetry (the engine's `reset_counters()` warmup hook);
        default: nothing to zero."""


class _NgramStats:
    """Plain-int telemetry for NgramProposer — kept off the DraftProposer
    hot-path contract so a stats-less custom proposer costs nothing."""

    __slots__ = ("calls", "hits", "tokens_proposed")

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = 0
        self.hits = 0
        self.tokens_proposed = 0


class NgramProposer(DraftProposer):
    """Prompt-lookup / n-gram self-drafting.

    Tries the trailing n-gram for n = max_ngram down to min_ngram; the first n
    with an earlier occurrence in the history wins (longer matches are more
    specific, so their continuations accept more often).  Among the hits, the
    MOST RECENT one with a full max_tokens continuation is proposed (recency
    tracks local structure); when every recent hit is truncated by the end of
    the history — the tight-loop case, where the latest occurrence sits right
    next to the tail — the EARLIEST hit wins instead, maximizing the drafted
    run length.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_lookback: int = 512):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"[{min_ngram}, {max_ngram}]")
        if max_lookback < min_ngram + 1:
            raise ValueError(f"max_lookback {max_lookback} too small for "
                             f"min_ngram {min_ngram}")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        # bounded scan (see DraftProposer.max_lookback): recent history is
        # also where loop/structure matches live
        self.max_lookback = max_lookback
        self._stats = _NgramStats()

    def stats(self) -> Dict[str, object]:
        s = self._stats
        return {
            "propose_calls": s.calls,
            "propose_hits": s.hits,
            "tokens_proposed": s.tokens_proposed,
            "hit_rate": s.hits / s.calls if s.calls else 0.0,
        }

    def reset_stats(self) -> None:
        self._stats.reset()

    def propose(self, context: np.ndarray,
                max_tokens: int) -> Optional[np.ndarray]:
        # the engine already hands over only the window; re-slice so direct
        # callers (tests, other schedulers) get the same bounded contract
        self._stats.calls += 1
        ctx = np.asarray(context).reshape(-1)[-self.max_lookback:]
        L = ctx.size
        if max_tokens < 1 or L < self.min_ngram + 1:
            return None
        # n capped at L-1: the pattern must leave room for an earlier
        # occurrence with at least one continuation token
        for n in range(min(self.max_ngram, L - 1), self.min_ngram - 1, -1):
            pat = ctx[L - n:]
            # candidate starts 0..L-1-n: window ends before the final token,
            # so a hit always has a continuation inside the history
            win = np.lib.stride_tricks.sliding_window_view(ctx[:L - 1], n)
            hits = np.nonzero((win == pat).all(axis=1))[0]
            if hits.size:
                full = hits[hits + n + max_tokens <= L]
                # most recent full-length continuation, else the earliest hit
                # (its continuation is the longest available)
                j = int(full[-1]) if full.size else int(hits[0])
                prop = ctx[j + n:j + n + max_tokens]
                if prop.size:
                    self._stats.hits += 1
                    self._stats.tokens_proposed += prop.size
                    return prop.astype(np.int32, copy=True)
        return None
