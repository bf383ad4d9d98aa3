"""Per-request tracing: a structured event timeline for every `Request` —
port of `paddle_tpu/inference/tracing.py`, copied whole (plain Python).

A p99 outlier is always ONE request's story, so serving stacks treat the
per-request timeline (enqueue -> admit -> prefill chunks -> verify events
-> preempt/swap -> finish) as the primary debug surface for tail latency.
This module is that surface for `inference.engine.LLMEngine`:

- **`RequestTrace`** — an append-only list of plain-dict events stamped
  through the engine's injectable clock.  The hot-path cost of one event is a
  dict literal + a list append (no formatting, no locking, no device access);
  event volume is bounded by construction — admission-, chunk- and
  verify-granular, never per-decode-token.
- **Chrome export** (`RequestTrace.to_chrome()`) — the timeline rendered as a
  chrome-tracing span tree on the request's own track (`tid` = request id):
  a root `request/<rid>` span covering enqueue -> finish, child phase spans
  (`queued`, `prefill`, `decode`) derived from the lifecycle stamps, and one
  instant per raw event carrying its attributes.  Opens in the same
  ``chrome://tracing`` / Perfetto flow as the engine's `trace(dir)` host
  traces — and `LLMEngine.export_request_trace(rid)` serves exactly this
  dict.

Exemplars close the loop from the *aggregate* side: the engine attaches
``{request_id, trace}`` exemplar labels to its latency-histogram observations
(`inference.metrics.Histogram.observe(v, exemplar=...)`), so the request id
behind a p99 TTFT bucket is right on the scrape line — one
`export_request_trace(rid)` away from this timeline.
"""
from __future__ import annotations

from typing import Dict, List, Optional


# Event names the engine stamps (one tuple so tests and dashboards don't
# chase string literals through the scheduler).  `finish` carries the retire
# reason (stop/length/abort/timeout/rejected) — there is deliberately no
# separate abort/timeout event.
REQUEST_EVENTS = (
    "enqueue",          # add_request: prompt_len/max_new_tokens/priority
    "admit",            # popped into a slot: slot, prefix hit, COW
    "prefill",          # bucketed one-shot prefill: n tokens in one pass
    "prefill_chunk",    # one staged chunk: q_offset + n tokens
    "first_token",      # joined the decode set
    "spec_verify",      # one drafted verify event: drafted/accepted/emitted
    "grow_fail",        # optimistic page growth failed (preemption trigger)
    "preempt",          # evicted: kind (swap intent vs recompute), pages
    "swap_out",         # victim KV materialized into the host pool
    "swap_degrade",     # a failed swap copy fell back to recompute
    "swap_in",          # parked KV restored by one h2d scatter
    "finish",           # retired: reason + generated-token count
)


class RequestTrace:
    """The structured event timeline of one request.

    `events` is a list of plain dicts ``{"t": <engine-clock>, "name": <str>,
    ...attrs}``, appended in stamp order (the engine clock is monotonic, so
    the list is time-sorted by construction).  JSON-serializable as-is —
    this IS the `RequestOutput.trace` payload and the obs server's
    ``/requests/<rid>`` source."""

    __slots__ = ("request_id", "events")

    def __init__(self, request_id: int):
        self.request_id = request_id
        self.events: List[Dict[str, object]] = []

    def event(self, t: float, name: str, **attrs) -> None:
        self.events.append({"t": t, "name": name, **attrs})

    def _first(self, name: str) -> Optional[float]:
        for e in self.events:
            if e["name"] == name:
                return e["t"]
        return None

    def to_chrome(self) -> Dict[str, object]:
        """Render the timeline as a chrome-tracing span tree.

        Layout (all on the request's own track, ``tid`` = request id):
        - root ``request/<rid>`` complete span, enqueue -> last event;
        - child phase spans derived from the lifecycle stamps: ``queued``
          (enqueue -> first admit), ``prefill`` (first admit -> first token)
          and ``decode`` (first token -> last event) — phases a request never
          reached are simply absent (an abort while queued has only the
          ``queued`` child);
        - one instant event per raw timeline entry, attributes under
          ``args`` — preemption cycles show as preempt/swap/admit instants
          inside the ``decode`` span rather than re-segmenting the phases.

        Timestamps are microseconds relative to enqueue (chrome-trace
        convention); durations are clamped >= 0 so a fake clock that never
        advances still produces a valid (zero-width) tree."""
        rid = self.request_id
        if not self.events:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        t0 = self.events[0]["t"]

        def us(t):
            return max(0.0, (t - t0) * 1e6)

        t_end = self.events[-1]["t"]
        t_admit = self._first("admit")
        t_first = self._first("first_token")
        out: List[Dict[str, object]] = [{
            "name": f"request/{rid}", "ph": "X", "ts": 0.0, "dur": us(t_end),
            "pid": 0, "tid": rid, "args": {"request_id": rid},
        }]

        def phase(name, a, b):
            out.append({"name": name, "ph": "X", "ts": us(a),
                        "dur": max(0.0, us(b) - us(a)), "pid": 0, "tid": rid})

        phase("queued", t0, t_admit if t_admit is not None else t_end)
        if t_admit is not None:
            phase("prefill", t_admit,
                  t_first if t_first is not None else t_end)
        if t_first is not None:
            phase("decode", t_first, t_end)
        for e in self.events:
            args = {k: v for k, v in e.items() if k not in ("t", "name")}
            out.append({"name": e["name"], "ph": "i", "ts": us(e["t"]),
                        "pid": 0, "tid": rid, "s": "t", "args": args})
        return {"traceEvents": out, "displayTimeUnit": "ms"}
