"""Serving metrics: Counter / Gauge / Histogram + a registry with JSON and
Prometheus export — port of `paddle_tpu/inference/metrics.py`, copied whole
(it is plain Python), names and semantics unchanged, so that a snapshot or
an exposition of the port's engine reads as the reference's does.

Serving fleets are scraped, not traced: request-lifecycle latency
distributions and engine counters are first-class monitoring state.  This
module is that layer for `inference.engine.LLMEngine`:

- **Counter** — monotonic event count (tokens emitted, verify dispatches,
  evictions).  `inc()` only; scrapers derive rates from successive scrapes.
- **Gauge** — an instantaneous level, either `set()` explicitly or backed by
  a zero-argument callback evaluated at snapshot time (pages in use, queue
  depth) so the hot path never pushes gauge updates.
- **Histogram** — fixed log-spaced buckets (latencies span decades: a queue
  wait is 10 us under no load and 10 s under overload; linear buckets waste
  resolution at one end).  The hot path is one `bisect` + three adds, pure
  Python, no numpy allocation.  Percentiles interpolate linearly inside the
  covering bucket (the Prometheus `histogram_quantile` convention); values
  past the last edge report the observed maximum instead of an edge clamp.

The registry owns the **clock** (`now()`), injectable so lifecycle tests can
drive deterministic timestamps through the engine; the default is
`time.perf_counter`, the same monotonic base the engine already stamps
`Request.t_enqueue` with.

Export surfaces:
- `snapshot()` — plain-JSON dict `{counters, gauges, histograms}` (histograms
  as `{count, sum, mean, min, max, p50, p90, p99}` summaries), embedded in
  bench JSON and `engine.trace()` dumps;
- `to_prometheus()` — text exposition format (`# HELP` / `# TYPE` + samples,
  cumulative `_bucket{le=...}` rows ending at `+Inf`, `_sum`/`_count`), ready
  for a scrape endpoint.

One signal-plane extension (the health plane's freshness-weighted input):
- **`RateWindow`** — a ring of ``(t, counter_value)`` samples on the
  registry clock that derives *sliding-window rates* from the monotonic
  counters above (tokens/s, admits/s, preemptions/s over ~10s/1m/5m).
  Counters alone answer "how much since reset"; a router or health probe
  needs "how much *lately*" — `registry.rate_window()` registers one and
  exposes each window as a pull gauge, `sample_rates()` is the engine's
  once-per-step recording hook, and the math is exact under the injectable
  clock (golden-value testable): the live counter value is the window's
  right edge, the newest ring sample at or before ``now - window`` its
  left.  `reset()` clears the rings with the counters (the warmup-exclusion
  contract), and a counter observed DECREASING (reset underneath the ring)
  restarts the window instead of reporting a negative rate.

Two fleet-facing extensions (the dp-group router's input):
- **Exemplars** — `Histogram.observe(v, exemplar={...labels...})` remembers,
  per bucket, the labels of the latest observation that landed there
  (the engine attaches ``{request_id, trace}``), and `to_prometheus()` emits
  them in OpenMetrics ``# {label="v"} value`` exemplar syntax on the
  ``_bucket`` line — so the request behind a p99 latency bucket is one
  ``GET /requests/<rid>`` away from the scrape text itself.
- **`merge()` / `FleetMetrics`** — fold N engines' registries into one
  aggregate with per-type semantics (counters SUM; gauges fold by their
  declared `agg` — sum for levels, max for ratio gauges — queue
  depths and page levels add across replicas; histograms add bucket-wise
  with min/max/count/sum folded and the last-merged exemplar kept per
  bucket), while `FleetMetrics.to_prometheus()` re-exposes every member's
  samples under an ``{engine="<label>"}`` label, grouped per metric family
  so the exposition stays well-formed.
"""
from __future__ import annotations

import math
import re
import time
from bisect import bisect_left
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> List[float]:
    """Geometric bucket edges covering [lo, hi]: `per_decade` edges per 10x,
    computed as lo * r**i (no compounding float drift), last edge >= hi."""
    if not (lo > 0.0 and hi > lo):
        raise ValueError(f"need 0 < lo < hi, got [{lo}, {hi}]")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    ratio = 10.0 ** (1.0 / per_decade)
    n = math.ceil(per_decade * math.log10(hi / lo))
    edges = [lo * ratio ** i for i in range(n + 1)]
    if edges[-1] < hi:          # guard log10 rounding just under hi
        edges.append(edges[-1] * ratio)
    return edges


# 100 us .. 100 s, 4 edges per decade (25 buckets + overflow): spans a CPU
# smoke TTFT (~ms) and an overloaded queue wait (~10 s) at ~78% edge ratio
DEFAULT_LATENCY_BUCKETS = log_buckets(1e-4, 100.0, 4)


class Counter:
    """Monotonic counter.  `.value` for host reads; resets only via the
    registry (bench warmup exclusion), never decrements in between."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        self._value += n

    @property
    def value(self) -> int:
        return self._value

    def __bool__(self) -> bool:
        return self._value != 0

    def reset(self) -> None:
        self._value = 0


class Gauge:
    """Instantaneous level: `set()` pushed, or `fn` pulled at read time (the
    engine registers pull gauges over cache/queue state so the scheduler hot
    path never updates them).

    `agg` declares how the gauge folds across a fleet merge: ``"sum"``
    (default — queue depths and page levels add across replicas) or
    ``"max"`` for ratio/fraction gauges like pool pressure, where a sum of
    per-replica fractions is meaningless and the fleet-wide signal is the
    worst member."""

    __slots__ = ("name", "help", "_value", "_fn", "agg")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None,
                 help: str = "", agg: str = "sum"):
        if agg not in ("sum", "max"):
            raise ValueError(f"gauge {name} agg must be 'sum' or 'max', "
                             f"got {agg!r}")
        self.name = name
        self.help = help
        self._fn = fn
        self._value = 0.0
        self.agg = agg

    def set(self, v: float) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        self._value = v

    @property
    def value(self) -> float:
        return float(self._fn() if self._fn is not None else self._value)

    def reset(self) -> None:
        if self._fn is None:
            self._value = 0.0


class Histogram:
    """Fixed-bucket histogram with le-semantics edges (`counts[i]` holds
    observations in `(edges[i-1], edges[i]]`; larger values land in the
    overflow bucket).  Tracks count/sum/min/max exactly; percentiles are
    bucket-interpolated estimates.

    `observe(v, exemplar={...})` additionally remembers `(labels, v)` for the
    bucket v landed in — the LATEST observation per bucket wins (OpenMetrics
    keeps one exemplar per bucket; the freshest is the debuggable one).
    `reset()` clears exemplars with the counts: a handle pointing at a
    request observed before the reset must not survive into an exposition
    whose bucket counts say nothing was observed."""

    __slots__ = ("name", "help", "edges", "counts", "overflow",
                 "count", "sum", "_min", "_max", "exemplars")

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None,
                 help: str = ""):
        self.name = name
        self.help = help
        edges = [float(e) for e in (buckets if buckets is not None
                                    else DEFAULT_LATENCY_BUCKETS)]
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(f"bucket edges must be strictly increasing "
                             f"and non-empty, got {edges}")
        self.edges = edges
        self.reset()

    def reset(self) -> None:
        self.counts = [0] * len(self.edges)
        self.overflow = 0
        self.count = 0
        self.sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        # one slot per bucket + the overflow bucket: (labels dict, value)
        self.exemplars: List[Optional[tuple]] = [None] * (len(self.edges) + 1)

    def observe(self, v: float,
                exemplar: Optional[Dict[str, str]] = None) -> None:
        v = float(v)
        i = bisect_left(self.edges, v)      # first edge >= v: the le bucket
        if i < len(self.edges):
            self.counts[i] += 1
        else:
            self.overflow += 1
        if exemplar is not None:
            self.exemplars[min(i, len(self.edges))] = (exemplar, v)
        self.count += 1
        self.sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    @property
    def min(self) -> float:
        return self._min if self.count else 0.0

    @property
    def max(self) -> float:
        return self._max if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Estimate the p-th percentile (0..100): linear interpolation inside
        the bucket where the cumulative count crosses rank p/100 * count
        (lower edge of the first bucket taken as 0), clamped to the observed
        [min, max] envelope so a sparse bucket cannot report a quantile
        outside the data.  Ranks landing in the overflow bucket return the
        exact observed maximum."""
        if not 0.0 <= p <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {p}")
        if self.count == 0:
            return 0.0
        rank = p / 100.0 * self.count
        if rank <= 0.0:
            return self.min
        cum = 0
        prev = 0.0
        for edge, c in zip(self.edges, self.counts):
            cum += c
            if c and cum >= rank:
                v = prev + (edge - prev) * (rank - (cum - c)) / c
                return min(max(v, self._min), self._max)
            prev = edge
        return self.max                     # rank falls in the overflow bucket

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50.0),
            "p90": self.percentile(90.0),
            "p99": self.percentile(99.0),
        }


# the serving signal plane's standard windows: fast enough for a health
# probe (~10s), the multi-window burn-rate pair (1m/5m) for SLO alerting
RATE_WINDOWS: Tuple[Tuple[str, float], ...] = \
    (("10s", 10.0), ("1m", 60.0), ("5m", 300.0))


class RateWindow:
    """Sliding-window rates over a monotonic counter: a ring of
    ``(t, value)`` samples on the shared registry clock.

    `sample()` records the counter's current value (throttled to
    `min_interval_s` so a kHz step loop cannot grow the ring past
    ``max_window / min_interval`` entries; samples older than the largest
    window are pruned, always keeping the newest one at or beyond the
    horizon as the reference).  `rate(window_s)` reads LIVE state — the
    counter's value now against the newest sample at or before
    ``now - window_s`` (or the oldest sample while the ring is younger than
    the window) — so an idle engine's rates decay to exactly 0.0 without
    further sampling, and the math is deterministic under a fake clock:

    - empty ring -> 0.0 (no reference, no rate);
    - single sample at ``now`` -> 0.0 (zero elapsed);
    - counter DECREASED vs the reference (reset underneath the ring) ->
      ring restarts, 0.0 — never a negative rate.

    `delta(window_s)` is the raw in-window count increment — what burn-rate
    ratios divide (two windows sampled at the same instants share reference
    timestamps, so the elapsed time cancels exactly)."""

    __slots__ = ("name", "fn", "windows", "min_interval_s", "_clock",
                 "_samples", "_max_window")

    def __init__(self, name: str, fn: Callable[[], float],
                 clock: Callable[[], float],
                 windows: Sequence[Tuple[str, float]] = RATE_WINDOWS,
                 min_interval_s: float = 0.25):
        self.name = name
        self.fn = fn
        self._clock = clock
        self.windows: Tuple[Tuple[str, float], ...] = \
            tuple((str(lbl), float(w)) for lbl, w in windows)
        if not self.windows or any(w <= 0.0 for _, w in self.windows):
            raise ValueError(f"rate window {name!r} needs positive window "
                             f"lengths, got {windows}")
        self.min_interval_s = float(min_interval_s)
        self._max_window = max(w for _, w in self.windows)
        self._samples: deque = deque()      # (t, value), time-ordered

    def sample(self, force: bool = False) -> None:
        """Record ``(now, fn())`` — the engine calls this once per step.
        `force=True` overrides the interval throttle: the engine forces a
        sample on EVENTFUL steps (finishes, preemptions, intake rejects) so
        a burst right before the engine goes idle is anchored at its true
        time — otherwise those unanchored events would decay hyperbolically
        against an old reference instead of dropping to exactly 0.0 once
        the window passes them.  A forced sample inside the throttle
        interval SLIDES the newest ring entry forward instead of appending
        (when that entry is itself within the interval of its predecessor),
        so sustained eventful load keeps the latest anchor exact while the
        ring stays bounded at ~max_window/min_interval entries."""
        now = self._clock()
        v = float(self.fn())
        if self._samples:
            t_last, v_last = self._samples[-1]
            if v < v_last:          # counter reset underneath the ring
                self._samples.clear()
            elif now - t_last < self.min_interval_s:
                if not force:
                    return
                if len(self._samples) >= 2 and \
                        t_last - self._samples[-2][0] < self.min_interval_s:
                    self._samples[-1] = (now, v)    # slide the anchor
                    return
        self._samples.append((now, v))
        horizon = now - self._max_window
        # keep the NEWEST sample at or beyond the horizon: it is the exact
        # reference for the largest window until a closer one ages past
        while len(self._samples) >= 2 and self._samples[1][0] <= horizon:
            self._samples.popleft()

    def _reference(self, now: float, window_s: float) -> Optional[tuple]:
        cut = now - window_s
        for t, v in reversed(self._samples):
            if t <= cut:
                return (t, v)
        return self._samples[0] if self._samples else None

    def _live(self) -> Optional[float]:
        """The counter's current value, with reset detection against the
        NEWEST ring sample (the ring maximum — the source is monotonic):
        a value below it means the counter was reset underneath the ring,
        so the window restarts instead of reporting a phantom rate."""
        v_now = float(self.fn())
        if self._samples and v_now < self._samples[-1][1]:
            self._samples.clear()
            return None
        return v_now

    def delta(self, window_s: float) -> float:
        """Counter increment inside the window (>= 0.0; 0.0 on an empty
        ring or across a counter reset)."""
        v_now = self._live()
        ref = self._reference(self._clock(), window_s)
        if v_now is None or ref is None:
            return 0.0
        return max(0.0, v_now - ref[1])

    def rate(self, window_s: float) -> float:
        """Events/second over the window — see the class docstring for the
        exact reference-sample semantics."""
        now = self._clock()
        v_now = self._live()
        ref = self._reference(now, window_s)
        if v_now is None or ref is None:
            return 0.0
        t_ref, v_ref = ref
        dt = now - t_ref
        return (v_now - v_ref) / dt if dt > 0.0 else 0.0

    def rates(self) -> Dict[str, float]:
        """{window label: rate} over every configured window."""
        return {lbl: self.rate(w) for lbl, w in self.windows}

    def reset(self) -> None:
        self._samples.clear()


def _sanitize(name: str) -> str:
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = re.sub(r"[^a-zA-Z0-9_:]", "_", name)
    return "_" + name if name and name[0].isdigit() else name


def _fmt(v: float) -> str:
    if isinstance(v, int):
        return str(v)
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return f"{v:.10g}"


def _escape(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _render_labels(labels: Optional[Dict[str, str]],
                   le: Optional[str] = None) -> str:
    """`{k="v",...}` label block (extra labels first, `le` last), or ""."""
    parts = [f'{_sanitize(k)}="{_escape(v)}"'
             for k, v in (labels or {}).items()]
    if le is not None:
        parts.append(f'le="{le}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _render_exemplar(ex: Optional[tuple], engine: Optional[str] = None) -> str:
    """OpenMetrics exemplar suffix ``# {labels} value`` (empty when None).

    `engine` is the fleet member label the sample is being re-exposed under:
    request ids are per-engine (every member has a request 0), so a bare
    ``/requests/<rid>`` trace handle is ambiguous fleet-wide — the handle
    gets the member scoped on as ``?engine=<label>``, which the obs server's
    fleet mode resolves to exactly that member's timeline."""
    if ex is None:
        return ""
    labels, value = ex
    if engine is not None and "trace" in labels:
        labels = {**labels, "trace": f'{labels["trace"]}?engine={engine}'}
    return f" # {_render_labels(labels) or '{}'} {_fmt(float(value))}"


class MetricsRegistry:
    """Namespace of metrics sharing one injectable monotonic clock.

    Factory methods are idempotent per name (the same Counter comes back, so
    the engine and the cache manager can both ask for `prefix_evictions`);
    asking for an existing name as a different type raises.

    Readers (snapshot/exposition/merge) copy the metric map before iterating:
    an obs-server thread scrapes concurrently with the engine thread lazily
    registering counters (per-priority goodput), and iterating the live dict
    would raise mid-scrape."""

    def __init__(self, namespace: str = "",
                 clock: Callable[[], float] = time.perf_counter):
        self.namespace = namespace
        self._clock = clock
        self._metrics: "OrderedDict[str, object]" = OrderedDict()
        self._rate_windows: "OrderedDict[str, RateWindow]" = OrderedDict()

    def now(self) -> float:
        """The registry clock — every lifecycle stamp the engine takes goes
        through here, so tests inject a fake and get exact latencies."""
        return self._clock()

    def _register(self, name: str, cls, factory):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m
        m = factory()
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(name, Counter, lambda: Counter(name, help))

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              help: str = "", agg: str = "sum") -> Gauge:
        return self._register(name, Gauge,
                              lambda: Gauge(name, fn, help, agg))

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:
        return self._register(name, Histogram,
                              lambda: Histogram(name, buckets, help))

    def rate_window(self, name: str, fn: Callable[[], float],
                    windows: Sequence[Tuple[str, float]] = RATE_WINDOWS,
                    help: str = "", min_interval_s: float = 0.25,
                    agg: str = "sum", expose: bool = True) -> RateWindow:
        """A `RateWindow` over `fn` (a live counter read) on the registry
        clock, idempotent per name.  With `expose=True` each window also
        registers a pull gauge ``<name>_<label>`` (e.g. ``tokens_per_sec_10s``)
        so the rates ride every existing surface — snapshot, exposition,
        fleet merge — for free; `agg` is those gauges' fleet fold (rates are
        levels: fleet tokens/s SUM across replicas).  `sample_rates()`
        records one sample on every window; `reset()` clears the rings."""
        rw = self._rate_windows.get(name)
        if rw is not None:
            return rw
        rw = RateWindow(name, fn, self.now, windows, min_interval_s)
        self._rate_windows[name] = rw
        if expose:
            for lbl, w in rw.windows:
                self.gauge(f"{name}_{lbl}", (lambda w=w: rw.rate(w)),
                           help=f"{help or name} over the trailing {lbl}",
                           agg=agg)
        return rw

    def sample_rates(self, force: bool = False) -> None:
        """Record one ``(now, value)`` sample on every rate window — the
        engine's once-per-step hook (each window throttles itself unless
        `force`, which eventful steps use to anchor their events exactly)."""
        for rw in self._rate_windows.values():
            rw.sample(force)

    def get(self, name: str):
        return self._metrics.get(name)

    def reset(self) -> None:
        """Zero counters and histograms (set-gauges too; callback gauges read
        live state and have nothing to reset) and clear every rate window's
        sample ring (the counters underneath restart at zero, so a surviving
        ring would read negative deltas) — the engine's `reset_counters()`
        warmup-exclusion hook."""
        for m in list(self._metrics.values()):
            m.reset()
        for rw in self._rate_windows.values():
            rw.reset()

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain-JSON view: counters/gauges as scalars, histograms as
        summary dicts.  Callback gauges are evaluated here, once."""
        out: Dict[str, Dict[str, object]] = {"counters": {}, "gauges": {},
                                             "histograms": {}}
        for name, m in list(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        return out

    def _families(self, labels: Optional[Dict[str, str]] = None,
                  exemplars: bool = True, openmetrics: bool = False):
        """Yield one exposition family per metric: `(family_name, type,
        help, [sample lines])`, with `labels` attached to every sample —
        the shared core of `to_prometheus()` and `FleetMetrics`, which must
        interleave several registries' samples per family to keep the
        exposition grouped.  Counter samples always carry the `_total`
        suffix; the FAMILY name (what HELP/TYPE lines cite) depends on the
        dialect — OpenMetrics reserves the suffix for the sample and
        forbids it on the MetricFamily (`# TYPE foo counter` + sample
        `foo_total`; a strict parser rejects a `_total` family outright),
        while legacy 0.0.4 text names the family as exposed."""
        ns = _sanitize(self.namespace + "_") if self.namespace else ""
        lbl = _render_labels(labels)
        eng = (labels or {}).get("engine")
        for name, m in list(self._metrics.items()):
            full = ns + _sanitize(name)
            if isinstance(m, Counter):
                tname = full if full.endswith("_total") else full + "_total"
                fam = tname[:-len("_total")] if openmetrics else tname
                yield fam, "counter", m.help, [f"{tname}{lbl} {m.value}"]
            elif isinstance(m, Gauge):
                yield full, "gauge", m.help, [f"{full}{lbl} {_fmt(m.value)}"]
            else:
                lines: List[str] = []
                cum = 0
                for i, (edge, c) in enumerate(zip(m.edges, m.counts)):
                    cum += c
                    ex = (_render_exemplar(m.exemplars[i], eng)
                          if exemplars else "")
                    lines.append(
                        f'{full}_bucket'
                        f'{_render_labels(labels, le=_fmt(edge))} {cum}{ex}')
                ex = (_render_exemplar(m.exemplars[-1], eng)
                      if exemplars else "")
                lines.append(f'{full}_bucket'
                             f'{_render_labels(labels, le="+Inf")} '
                             f'{m.count}{ex}')
                lines.append(f"{full}_sum{lbl} {_fmt(m.sum)}")
                lines.append(f"{full}_count{lbl} {m.count}")
                yield full, "histogram", m.help, lines

    def to_prometheus(self, labels: Optional[Dict[str, str]] = None,
                      exemplars: Optional[bool] = None,
                      openmetrics: bool = False) -> str:
        """Text exposition format, one block per metric: HELP/TYPE comments,
        `_total` suffix on counters, cumulative `_bucket` rows ending at
        `+Inf` plus `_sum`/`_count` on histograms.  Histogram buckets carry
        their latest exemplar in OpenMetrics ``# {labels} value`` syntax;
        `labels` attaches a constant label set to every sample (how
        `FleetMetrics` scopes a member engine).  `openmetrics=True` names
        counter FAMILIES without the reserved `_total` suffix (samples keep
        it) as the OpenMetrics spec requires — a strict parser rejects a
        `_total` MetricFamily outright.

        `exemplars` defaults to FOLLOW the dialect: the ``# {...}`` suffix is
        OpenMetrics-only syntax that a stock 0.0.4 text parser rejects, so a
        bare `to_prometheus()` stays pure legacy text a naive scraper can
        consume, and `openmetrics=True` carries the exemplars.  Pass it
        explicitly to override either way (the tests round-trip exemplars
        through the legacy-named dialect that way)."""
        if exemplars is None:
            exemplars = openmetrics
        lines: List[str] = []
        for full, mtype, help_, samples in self._families(labels, exemplars,
                                                          openmetrics):
            if help_:
                lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} {mtype}")
            lines.extend(samples)
        return "\n".join(lines) + "\n"

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold `other`'s CURRENT values into this registry, in place, with
        per-type semantics (the fleet-aggregation primitive — build a fresh
        aggregate registry and merge each member into it):

        - **counter**: sum;
        - **gauge**: folded by the gauge's declared `agg` over the values
          read NOW — ``"sum"`` for fleet queue depths and page levels,
          ``"max"`` for ratio gauges like pool pressure, where a sum of
          per-replica fractions reads >100% on a healthy fleet and the
          meaningful aggregate is the worst member (`other`'s callback
          gauges are evaluated here and land as plain set-gauges in the
          aggregate; a callback gauge on the AGGREGATE side cannot absorb
          a merge and raises);
        - **histogram**: bucket-wise count add (edges must match exactly),
          overflow/count/sum added, min/max folded, and per bucket the
          last-merged exemplar wins (matching `observe`'s latest-wins rule).

        Metrics absent on one side pass through (a disjoint merge is a
        union); a name registered as different types on the two sides
        raises TypeError.  Returns self so merges chain."""
        for name, m in list(other._metrics.items()):
            if isinstance(m, Counter):
                self.counter(name, m.help).inc(m.value)
            elif isinstance(m, Gauge):
                g = self.gauge(name, help=m.help, agg=m.agg)
                if g.agg != m.agg:      # like mismatched histogram edges:
                    raise ValueError(   # refuse loudly, don't fold garbage
                        f"gauge {name!r} agg differs: aggregate folds by "
                        f"{g.agg!r}, member declares {m.agg!r}")
                g.set(max(g.value, m.value) if g.agg == "max"
                      else g.value + m.value)
            else:
                h = self.histogram(name, m.edges, m.help)
                if h.edges != m.edges:
                    raise ValueError(
                        f"histogram {name!r} bucket edges differ: "
                        f"{h.edges} vs {m.edges}")
                for i, c in enumerate(m.counts):
                    h.counts[i] += c
                h.overflow += m.overflow
                h.count += m.count
                h.sum += m.sum
                h._min = min(h._min, m._min)
                h._max = max(h._max, m._max)
                for i, ex in enumerate(m.exemplars):
                    if ex is not None:
                        h.exemplars[i] = ex
        return self


class FleetMetrics:
    """Aggregates N engines' registries — the dp-group router's input.

    Members register under a label (`add("e0", engine_or_registry)`); the two
    views are:

    - `merged()` — a fresh `MetricsRegistry` (namespace ``llm_fleet``) built
      by `MetricsRegistry.merge()` over every member: counters summed,
      gauges folded by their declared `agg` (sum / max),
      histograms bucket-wise added.  `snapshot()` returns
      ``{"fleet": <merged snapshot>, "engines": {label: snapshot}}``.
    - `to_prometheus()` — every member's samples re-exposed under an
      ``{engine="<label>"}`` label, interleaved per metric family (all
      samples of one name stay grouped under one TYPE comment, as the
      exposition format requires), exemplars intact.  The merged totals ride
      along as ``llm_fleet_*`` families — a different namespace, so the
      per-engine series are never double-counted by an aggregating scraper.

    Registration accepts an engine (anything with a `.metrics` registry —
    `stats()`/`debug_bundle()` owners are kept for the obs server's fleet
    endpoints) or a bare `MetricsRegistry`."""

    def __init__(self):
        self.registries: "OrderedDict[str, MetricsRegistry]" = OrderedDict()
        self.engines: "OrderedDict[str, object]" = OrderedDict()

    def add(self, label: str, member) -> "FleetMetrics":
        reg = getattr(member, "metrics", member)
        if not isinstance(reg, MetricsRegistry):
            raise TypeError(f"member {label!r} is neither a MetricsRegistry "
                            f"nor an engine exposing one, got {type(member)}")
        self.registries[str(label)] = reg
        self.engines[str(label)] = member if reg is not member else None
        return self

    def merged(self) -> MetricsRegistry:
        agg = MetricsRegistry(namespace="llm_fleet")
        for reg in self.registries.values():
            agg.merge(reg)
        return agg

    def snapshot(self) -> Dict[str, object]:
        return {
            "fleet": self.merged().snapshot(),
            "engines": {label: reg.snapshot()
                        for label, reg in self.registries.items()},
        }

    def to_prometheus(self, exemplars: Optional[bool] = None,
                      openmetrics: bool = False) -> str:
        if exemplars is None:       # follow the dialect, as the registry does
            exemplars = openmetrics
        lines: List[str] = []
        # per-engine series, grouped per metric family across members
        families: "OrderedDict[str, tuple]" = OrderedDict()
        samples: Dict[str, List[str]] = {}
        for label, reg in self.registries.items():
            for full, mtype, help_, fam_lines in reg._families(
                    {"engine": label}, exemplars, openmetrics):
                if full not in families:
                    families[full] = (mtype, help_)
                    samples[full] = []
                elif families[full][0] != mtype:
                    raise TypeError(
                        f"metric {full!r} exposed as {families[full][0]} by "
                        f"one engine and {mtype} by another")
                samples[full].extend(fam_lines)
        for full, (mtype, help_) in families.items():
            if help_:
                lines.append(f"# HELP {full} {help_}")
            lines.append(f"# TYPE {full} {mtype}")
            lines.extend(samples[full])
        # fleet totals under their own namespace (no double counting)
        merged = self.to_prometheus_merged(exemplars, openmetrics)
        return "\n".join(lines) + ("\n" + merged if merged else "\n")

    def to_prometheus_merged(self, exemplars: Optional[bool] = None,
                             openmetrics: bool = False) -> str:
        return self.merged().to_prometheus(exemplars=exemplars,
                                           openmetrics=openmetrics)
