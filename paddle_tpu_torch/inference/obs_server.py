"""HTTP observability plane for the serving engine — port of
`paddle_tpu/inference/obs_server.py`, stdlib only, the reference's routes
and payloads.

Over one `inference.engine.LLMEngine`, or over a group of them through an
`inference.metrics.FleetMetrics`:

- ``GET /metrics``: the text exposition (`MetricsRegistry.to_prometheus()`),
  content-negotiated: ``Accept: application/openmetrics-text`` gets
  OpenMetrics with ``# {...}`` bucket exemplars whose ``trace`` label is a
  path served below (and ``# EOF``); anything else gets plain 0.0.4 text
  with the exemplar suffixes stripped.  Fleet mode re-exposes every member
  under an ``{engine="<label>"}`` label beside ``llm_fleet_*`` totals.
- ``GET /stats``: the engine's `stats()` as JSON (fleet: ``{label:
  stats}``), read under the engine's serve lock, between two of its steps.
- ``GET /requests/<rid>``: the request's chrome-trace span tree
  (`LLMEngine.export_request_trace`); 404 for unknown ids.  Request ids are
  per engine, so in fleet mode ``?engine=<label>`` scopes the lookup, and a
  bare rid that several members know answers 300 with the candidate
  handles.
- ``GET /debug``: the postmortem bundle (`LLMEngine.debug_bundle()`), under
  the serve lock as well (fleet: ``{label: bundle}``).
- ``GET /healthz``: the engine's health evaluation (`LLMEngine.health()`
  against `analysis.registry.SERVE_SLO`).  ``ok`` and ``degraded`` answer
  200 with the state and reasons; ``overloaded``, or an evaluation that
  raises, 503.  Fleet mode: each member's report and the worst-of state.

The server runs on a daemon thread (`ThreadingHTTPServer`), on an ephemeral
loopback port by default (`port=0`; read `.port` after `start()`).  A
handler's exception answers 500 with its text.

Usage::

    srv = ObservabilityServer(engine).start()
    print(srv.url)                      # http://127.0.0.1:<port>
    srv.close()

    fleet = FleetMetrics().add("e0", eng0).add("e1", eng1)
    srv = ObservabilityServer(fleet=fleet).start()
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from .health import HEALTH_CODES
from .metrics import FleetMetrics

# exemplars are OpenMetrics-only syntax: a stock Prometheus text-format
# (0.0.4) parser rejects the `# {...} v` bucket suffix outright, so the
# server content-negotiates — plain scrapers get exemplar-free 0.0.4 text,
# and a client sending `Accept: application/openmetrics-text` (Prometheus
# does once exemplar storage is on) gets the full OpenMetrics exposition,
# `# EOF` terminator included
_METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
_OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"

# the one route table: dispatch documentation AND the 404 body read it, so
# the advertised set cannot drift from what is actually served
ROUTES = ("/metrics", "/stats", "/requests/<rid>", "/debug", "/healthz")

# worst-of ordering for the fleet /healthz rollup, derived from the ONE
# declared state ordering (health.HEALTH_CODES) so a new health state cannot
# desynchronize the rollup; "error" (an evaluation that raised — the engine
# is wedged mid-crash) outranks every real state, and anything unrecognized
# ranks worst too — and therefore serves 503, never a blind 200
_ERROR_CODE = max(HEALTH_CODES.values()) + 1
_HEALTH_SEVERITY = {**HEALTH_CODES, "error": _ERROR_CODE}


def _between_steps(engine, read):
    """`read()` under the engine's serve lock: a snapshot between two of
    its loop's steps."""
    with engine._serve_lock:
        return read()


def _health_status(state: str) -> int:
    """HTTP status for a health state: 200 up to degraded, 503 from
    overloaded up (error and unknown states included)."""
    return 503 if _HEALTH_SEVERITY.get(state, _ERROR_CODE) >= \
        HEALTH_CODES["overloaded"] else 200


class ObservabilityServer:
    """Daemon-thread HTTP server over one engine or a `FleetMetrics` group.

    Exactly one of `engine` / `fleet` must be given.  `port=0` (default)
    binds an ephemeral port; `host` defaults to loopback — this is an
    operator plane, not a public API, so exposing it wider is an explicit
    choice.  `start()` binds and returns self; `close()` shuts the listener
    down (also a context manager)."""

    def __init__(self, engine=None, *, fleet: Optional[FleetMetrics] = None,
                 host: str = "127.0.0.1", port: int = 0):
        if (engine is None) == (fleet is None):
            raise ValueError("pass exactly one of engine= or fleet=")
        self.engine = engine
        self.fleet = fleet
        self._host = host
        self._port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "ObservabilityServer":
        if self._httpd is not None:
            return self
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((self._host, self._port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-server", daemon=True)
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        if self._httpd is None:
            raise RuntimeError("server not started")
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=5.0)
                self._thread = None

    def __enter__(self) -> "ObservabilityServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ---- endpoint payloads (shared by the handler; best-effort snapshots) -
    def _engines(self):
        """(label, engine) pairs — fleet members with a stats() owner, or
        the single wrapped engine under the label "engine"."""
        if self.engine is not None:
            return [("engine", self.engine)]
        return [(label, e) for label, e in self.fleet.engines.items()
                if e is not None]

    def render_metrics(self, openmetrics: bool = True) -> str:
        """The scrape text: OpenMetrics (exemplars + `# EOF`) or plain
        0.0.4 text with the exemplar suffixes stripped."""
        if self.fleet is not None:
            text = self.fleet.to_prometheus(exemplars=openmetrics,
                                            openmetrics=openmetrics)
        else:
            text = self.engine.metrics.to_prometheus(exemplars=openmetrics,
                                                     openmetrics=openmetrics)
        return text + "# EOF\n" if openmetrics else text

    def render_stats(self):
        if self.fleet is not None:
            return {label: _between_steps(e, e.stats)
                    for label, e in self._engines()}
        return _between_steps(self.engine, self.engine.stats)

    def render_debug(self):
        if self.fleet is not None:
            return {label: _between_steps(e, e.debug_bundle)
                    for label, e in self._engines()}
        return _between_steps(self.engine, self.engine.debug_bundle)

    def render_health(self):
        """``(status_code, payload)`` for ``/healthz``: the engine's health
        evaluation, no longer a hardcoded ``{"ok": true}``.  ok/degraded are
        200 (degraded still serves; the state and reasons ride the body),
        overloaded is 503; an evaluation that RAISES — the exact
        wedged-mid-crash case the old stub answered 200 to — reports
        ``state="error"`` with the exception text, also 503.  Fleet mode:
        per-engine reports plus the worst-of rollup."""
        def one(e):
            try:
                h = e.health()
                return {"state": h["state"], "code": h["code"],
                        "reasons": h["reasons"], "signals": h["signals"],
                        "role": h.get("role")}
            except Exception as err:
                # same shape as a real report (probes read code/signals)
                return {"state": "error", "code": _ERROR_CODE,
                        "reasons": [f"health evaluation failed: "
                                    f"{type(err).__name__}: {err}"],
                        "signals": {}, "role": getattr(e, "role", None)}

        if self.fleet is not None:
            reports = {label: one(e) for label, e in self._engines()}
            worst = max((r["state"] for r in reports.values()),
                        key=lambda s: _HEALTH_SEVERITY.get(s, _ERROR_CODE),
                        default="ok")
            return _health_status(worst), {"state": worst, "engines": reports}
        rep = one(self.engine)
        return _health_status(rep["state"]), rep

    def dispatch(self, path: str, query: str = "", accept: str = "",
                 extra_routes: tuple = ()):
        """The ONE routing table, as data: ``(status, content_type,
        body_bytes)`` for any GET path.  Both HTTP doors serve exactly this
        — the stdlib handler below and the serving front door
        (`inference.frontend`, which mounts the obs routes next to
        ``/v1/*``) — so the two servers cannot drift.  Unknown paths 404
        with the advertised route list (plus the caller's `extra_routes`,
        e.g. the front door's inference endpoints)."""
        def json_reply(obj, code=200):
            return code, "application/json; charset=utf-8", \
                json.dumps(obj).encode("utf-8")

        path = path.rstrip("/") or "/"
        if path == "/metrics":
            om = "application/openmetrics-text" in (accept or "")
            return (200,
                    _OPENMETRICS_CONTENT_TYPE if om
                    else _METRICS_CONTENT_TYPE,
                    self.render_metrics(openmetrics=om).encode("utf-8"))
        if path == "/stats":
            return json_reply(self.render_stats())
        if path == "/debug":
            return json_reply(self.render_debug())
        if path == "/healthz":
            # routed through the real health evaluation (render_health
            # never raises: an evaluation failure IS a 503 payload, not a
            # generic 500 — and never a blind 200)
            code, payload = self.render_health()
            return json_reply(payload, code)
        if path.startswith("/requests/"):
            tail = path[len("/requests/"):]
            try:
                rid = int(tail)
            except ValueError:
                return json_reply({"error": f"bad request id {tail!r}"}, 400)
            engine = (parse_qs(query).get("engine") or [None])[0]
            status, payload = self.render_request(rid, engine)
            if status == "not_found":
                return json_reply(
                    {"error": f"unknown request {rid} (tracing off, "
                              f"never submitted, or not retained)"}, 404)
            if status == "ambiguous":
                return json_reply(
                    {"error": f"request id {rid} exists on "
                              f"{len(payload)} engines — request ids "
                              f"are per-engine; scope the lookup",
                     "engines": payload,
                     "handles": [f"/requests/{rid}?engine={lb}"
                                 for lb in payload]}, 300)
            return json_reply(payload)
        return json_reply({"error": f"no route {path!r}",
                           "routes": list(ROUTES) + list(extra_routes)}, 404)

    def render_request(self, rid: int, engine: Optional[str] = None):
        """``(status, payload)`` for ``/requests/<rid>``: ``("ok", tree)``,
        ``("not_found", None)``, or — fleet mode only — ``("ambiguous",
        [labels])``.  Request ids are per-engine counters, so in a fleet
        every member has a request 0: a bare rid that resolves in more than
        one member is reported as ambiguous (listing the members) instead of
        silently returning an arbitrary engine's timeline, and
        ``?engine=<label>`` (what fleet-exposed exemplar handles carry)
        scopes the lookup to exactly that member."""
        pairs = self._engines()
        if engine is not None:
            pairs = [(lb, e) for lb, e in pairs if lb == engine]
        hits = [(lb, e.export_request_trace(rid)) for lb, e in pairs]
        hits = [(lb, t) for lb, t in hits if t is not None]
        if not hits:
            return "not_found", None
        if len(hits) > 1:
            return "ambiguous", [lb for lb, _ in hits]
        return "ok", hits[0][1]


def _make_handler(srv: ObservabilityServer):
    class _Handler(BaseHTTPRequestHandler):
        # operator plane: no access-log spam on the engine's stderr
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode("utf-8"),
                       "application/json; charset=utf-8")

        def do_GET(self):  # noqa: N802 (http.server API)
            path, _, query = self.path.partition("?")
            try:
                # the shared routing table (srv.dispatch) is the whole
                # handler — the serving front door mounts the same calls
                code, ctype, body = srv.dispatch(
                    path, query, self.headers.get("Accept", ""))
                self._send(code, body, ctype)
            except (BrokenPipeError, ConnectionResetError):
                # client hung up mid-write (scrape timeout, curl Ctrl-C):
                # nothing to send a response TO — just drop the connection
                # quietly (a second write would raise again and socketserver
                # would traceback-spam the engine's stderr)
                return
            except Exception as e:  # snapshot raced the scheduler: report,
                try:                # don't kill the server thread
                    self._send_json({"error": f"{type(e).__name__}: {e}"},
                                    500)
                except OSError:
                    # the failure above may have left a half-written
                    # response or a dead socket; the 500 is best-effort
                    pass

    return _Handler
