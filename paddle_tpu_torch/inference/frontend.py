"""Serving front door: an asyncio HTTP server over an `EngineFleet` — port
of `paddle_tpu/inference/frontend.py`, stdlib only (asyncio and json), the
reference's routes, payloads and status codes.

- ``POST /v1/completions`` and ``POST /v1/chat/completions``: OpenAI-style
  requests over **token ids** (``prompt`` is a list of ints; chat
  ``messages`` carry ``content`` token-id lists, concatenated in order).
  Responses keep the OpenAI envelope (``choices``, ``usage``; the id is the
  fleet handle, ``cmpl-<engine>/<rid>``, so ``/requests/<rid>?engine=...``
  resolves it).  ``"stream": true`` serves Server-Sent Events: one
  ``data:`` frame per batch of new tokens, a final frame with
  ``finish_reason`` and ``usage``, then ``data: [DONE]``.
- **Validation**: malformed JSON, prompts that are not token ids, bad
  budgets answer 400 with the error text; an engine's intake rejection
  (a footprint that can never fit) is ``finish_reason: "rejected"``.
- **Per-tenant token buckets**: the tenant is the ``X-Tenant`` header or the
  body's ``user``; `rate_limit_rps`/`rate_limit_burst` per tenant; an empty
  bucket answers 429 with ``Retry-After`` and never reaches the fleet.
- **Priority classes**: ``priority_class`` maps onto the engine's
  `priority=`/`deadline_s=` (``realtime`` > ``interactive`` > ``batch``;
  explicit ``priority``/``deadline_s`` keys override).  Low classes route
  victim-aware (`inference.router`).
- **Disconnects**: a client that drops mid-request (stream or not) aborts
  its fleet request (`EngineFleet.abort` -> `LLMEngine.cancel`), so its KV
  pages free at once.
- **Load shedding**: `FleetOverloaded` answers 503 with ``Retry-After``.
- **One door**: ``/metrics``, ``/stats``, ``/healthz``, ``/debug`` and
  ``/requests/<rid>`` come from the same socket through
  `ObservabilityServer.dispatch` over the fleet's `FleetMetrics`.

Usage::

    fleet = EngineFleet(params, cfg, replicas=2).start()
    door = ServingFrontend(fleet).start()
    print(door.url)     # http://127.0.0.1:<port>
    door.close(); fleet.stop()
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Dict, Optional

from .obs_server import ObservabilityServer, ROUTES as OBS_ROUTES
from .router import EngineFleet, FleetHandle, FleetOverloaded

V1_ROUTES = ("POST /v1/completions", "POST /v1/chat/completions")

# priority classes -> the engine's scheduling lanes.  `deadline_s`
# None = no deadline; explicit body keys override the class.
PRIORITY_CLASSES: Dict[str, Dict[str, object]] = {
    "realtime": {"priority": 1, "deadline_s": 30.0},
    "interactive": {"priority": 0, "deadline_s": None},
    "batch": {"priority": -1, "deadline_s": None},
}

_JSON = "application/json; charset=utf-8"


class _TokenBucket:
    """Classic token bucket: `rate` tokens/s up to `burst`.  `take()`
    returns 0.0 on admit, else the seconds until a token exists."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t = time.monotonic()

    def take(self) -> float:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


class _BadRequest(ValueError):
    pass


def _token_ids(value, what: str):
    if not isinstance(value, list) or not value or \
            not all(isinstance(t, int) and not isinstance(t, bool)
                    for t in value):
        raise _BadRequest(
            f"{what} must be a non-empty list of token ids (ints) — this "
            f"server serves models, not tokenizers")
    return value


def _chat_prompt(messages):
    if not isinstance(messages, list) or not messages:
        raise _BadRequest("messages must be a non-empty list")
    prompt = []
    for i, m in enumerate(messages):
        if not isinstance(m, dict) or "content" not in m:
            raise _BadRequest(f"messages[{i}] must be an object with "
                              f"role/content")
        prompt.extend(_token_ids(m["content"], f"messages[{i}].content"))
    return prompt


class ServingFrontend:
    """The fleet's HTTP door.  Runs its own asyncio loop on a daemon thread
    (same embedding contract as `ObservabilityServer`): `start()` binds —
    `port=0` picks an ephemeral port, read `.port`/`.url` after — and
    `close()` tears down; also a context manager.  Wraps a bare `LLMEngine`
    into a 1-replica fleet so every caller gets the same surface."""

    def __init__(self, fleet, *, host: str = "127.0.0.1", port: int = 0,
                 rate_limit_rps: Optional[float] = None,
                 rate_limit_burst: Optional[float] = None,
                 priority_classes: Optional[Dict[str, Dict]] = None,
                 default_max_new_tokens: int = 16,
                 max_new_tokens_cap: Optional[int] = None,
                 stream_poll_s: float = 0.005,
                 model_name: str = "paddle-tpu"):
        if not isinstance(fleet, EngineFleet):
            fleet = EngineFleet(engines=[fleet])
        self.fleet = fleet
        # the shared obs routing table over the SAME fleet members — the
        # one-door contract (never a second, drifting implementation)
        self.obs = ObservabilityServer(fleet=fleet.fleet_metrics)
        self._host = host
        self._port = int(port)
        self.rate_limit_rps = rate_limit_rps
        self.rate_limit_burst = rate_limit_burst if rate_limit_burst \
            is not None else (rate_limit_rps or 0) * 2
        self.priority_classes = dict(priority_classes if priority_classes
                                     is not None else PRIORITY_CLASSES)
        self.default_max_new_tokens = int(default_max_new_tokens)
        self.max_new_tokens_cap = max_new_tokens_cap
        self.stream_poll_s = float(stream_poll_s)
        self.model_name = model_name
        self._buckets: Dict[str, _TokenBucket] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._bound_port: Optional[int] = None
        self._started = threading.Event()
        self._start_error: Optional[BaseException] = None

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> "ServingFrontend":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, name="front-door",
                                        daemon=True)
        self._thread.start()
        self._started.wait(10.0)
        if self._start_error is not None:
            raise RuntimeError("front door failed to bind") \
                from self._start_error
        return self

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        async def boot():
            self._server = await asyncio.start_server(
                self._handle, self._host, self._port)
            self._bound_port = self._server.sockets[0].getsockname()[1]

        try:
            loop.run_until_complete(boot())
        except BaseException as exc:    # bind failure -> surface in start()
            self._start_error = exc
            self._started.set()
            return
        self._started.set()
        try:
            loop.run_forever()
        finally:
            self._server.close()
            loop.run_until_complete(self._server.wait_closed())
            loop.close()

    @property
    def port(self) -> int:
        if self._bound_port is None:
            raise RuntimeError("front door not started")
        return self._bound_port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def close(self) -> None:
        loop, self._loop = self._loop, None
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- HTTP plumbing ----------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                head = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), timeout=30.0)
            except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                    asyncio.LimitOverrunError):
                return
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, target, _ = lines[0].split(" ", 2)
            except ValueError:
                await self._reply(writer, 400, {"error": "bad request line"})
                return
            headers = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, _, v = ln.partition(":")
                    headers[k.strip().lower()] = v.strip()
            body = b""
            n = int(headers.get("content-length") or 0)
            if n:
                body = await reader.readexactly(n)
            path, _, query = target.partition("?")
            if method == "GET":
                code, ctype, payload = self.obs.dispatch(
                    path, query, headers.get("accept", ""),
                    extra_routes=V1_ROUTES)
                await self._raw_reply(writer, code, payload, ctype)
            elif method == "POST" and path.rstrip("/") in \
                    ("/v1/completions", "/v1/chat/completions"):
                await self._completion(
                    reader, writer, headers, body,
                    chat=path.rstrip("/").endswith("chat/completions"))
            else:
                await self._reply(writer, 405 if method not in ("GET", "POST")
                                  else 404,
                                  {"error": f"no route {method} {path}",
                                   "routes": list(V1_ROUTES) +
                                   [f"GET {r}" for r in OBS_ROUTES]})
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _raw_reply(self, writer, code: int, body: bytes, ctype: str,
                         extra_headers: Dict[str, str] = ()) -> None:
        reason = {200: "OK", 300: "Multiple Choices", 400: "Bad Request",
                  404: "Not Found", 405: "Method Not Allowed",
                  429: "Too Many Requests",
                  503: "Service Unavailable"}.get(code, "OK")
        head = [f"HTTP/1.1 {code} {reason}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}",
                "Connection: close"]
        for k, v in dict(extra_headers or {}).items():
            head.append(f"{k}: {v}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        writer.write(body)
        await writer.drain()

    async def _reply(self, writer, code: int, obj,
                     extra_headers: Dict[str, str] = ()) -> None:
        await self._raw_reply(writer, code,
                              json.dumps(obj).encode("utf-8"), _JSON,
                              extra_headers)

    # ---- the inference endpoints ------------------------------------------
    def _parse(self, headers: Dict[str, str], body: bytes, chat: bool):
        """Validate one completion request -> submit kwargs + envelope
        info.  Raises `_BadRequest` with a client-facing message."""
        try:
            req = json.loads(body.decode("utf-8") or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise _BadRequest(f"body is not JSON: {e}") from None
        if not isinstance(req, dict):
            raise _BadRequest("body must be a JSON object")
        if chat:
            prompt = _chat_prompt(req.get("messages"))
        else:
            prompt = _token_ids(req.get("prompt"), "prompt")
        max_new = req.get("max_tokens", self.default_max_new_tokens)
        if not isinstance(max_new, int) or max_new < 1:
            raise _BadRequest("max_tokens must be a positive int")
        if self.max_new_tokens_cap is not None:
            max_new = min(max_new, self.max_new_tokens_cap)
        cls_name = req.get("priority_class", "interactive")
        try:
            lane = dict(self.priority_classes[cls_name])
        except KeyError:
            raise _BadRequest(
                f"unknown priority_class {cls_name!r}; expected one of "
                f"{sorted(self.priority_classes)}") from None
        if "priority" in req:
            lane["priority"] = req["priority"]
        if "deadline_s" in req:
            lane["deadline_s"] = req["deadline_s"]
        tenant = headers.get("x-tenant") or req.get("user") or "default"
        temperature = req.get("temperature")
        if temperature is not None:
            temperature = float(temperature)
        return {
            "prompt": prompt,
            "kwargs": {"max_new_tokens": max_new, "temperature": temperature,
                       "priority": int(lane.get("priority") or 0),
                       "deadline_s": lane.get("deadline_s"),
                       "session": req.get("session")},
            "tenant": str(tenant),
            "stream": bool(req.get("stream", False)),
            "echo": bool(req.get("echo", False)),
        }

    def _throttle(self, tenant: str) -> float:
        """0.0 = admitted; else seconds the tenant must back off."""
        if not self.rate_limit_rps:
            return 0.0
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = self._buckets[tenant] = _TokenBucket(
                self.rate_limit_rps, self.rate_limit_burst)
        return bucket.take()

    @staticmethod
    def _finish_payload(handle: FleetHandle, out, prompt, chat: bool,
                        model: str):
        ids = list(out.token_ids)
        choice = {"index": 0, "finish_reason": out.finish_reason}
        if chat:
            choice["message"] = {"role": "assistant", "token_ids": ids}
        else:
            choice["token_ids"] = ids
            choice["text"] = " ".join(map(str, ids))
        return {
            "id": f"cmpl-{handle}",
            "object": "chat.completion" if chat else "text_completion",
            "model": model,
            "engine": handle.label,
            "choices": [choice],
            "usage": {"prompt_tokens": len(prompt),
                      "completion_tokens": len(ids),
                      "total_tokens": len(prompt) + len(ids),
                      "cached_tokens": int(out.cached_tokens)},
        }

    async def _completion(self, reader, writer, headers, body,
                          chat: bool) -> None:
        try:
            req = self._parse(headers, body, chat)
        except _BadRequest as e:
            await self._reply(writer, 400, {"error": str(e)})
            return
        wait = self._throttle(req["tenant"])
        if wait > 0.0:
            await self._reply(
                writer, 429,
                {"error": f"tenant {req['tenant']!r} rate-limited; retry in "
                          f"{wait:.2f}s"},
                {"Retry-After": f"{max(1, int(wait + 0.999))}"})
            return
        kw = req["kwargs"]
        try:
            # fleet.submit probes/locks engines — off the event loop thread
            handle = await asyncio.get_running_loop().run_in_executor(
                None, lambda: self.fleet.submit(
                    req["prompt"], session=kw["session"],
                    max_new_tokens=kw["max_new_tokens"],
                    temperature=kw["temperature"],
                    priority=kw["priority"], deadline_s=kw["deadline_s"]))
        except FleetOverloaded as e:
            await self._reply(
                writer, 503,
                {"error": f"fleet overloaded: {e}"},
                {"Retry-After": f"{max(1, int(e.retry_after_s + 0.999))}"})
            return
        except ValueError as e:         # add_request validation
            await self._reply(writer, 400, {"error": str(e)})
            return
        # from here on the request owns KV pages somewhere — any client
        # disconnect must abort it (reader.read() returning b"" = peer gone;
        # pipelined bytes would also resolve this task, but the connection
        # is Connection: close, so nothing legitimate arrives)
        hangup = asyncio.ensure_future(reader.read(1))
        try:
            if req["stream"]:
                await self._stream(writer, hangup, handle, req, chat)
            else:
                await self._unary(writer, hangup, handle, req, chat)
        except (ConnectionResetError, BrokenPipeError):
            self.fleet.abort(handle)
        finally:
            hangup.cancel()

    async def _unary(self, writer, hangup, handle, req, chat: bool) -> None:
        while True:
            prog = self.fleet.progress(handle)
            if prog["finished"]:
                break
            if hangup.done():
                self.fleet.abort(handle)
                return
            await asyncio.sleep(self.stream_poll_s)
        await self._reply(writer, 200, self._finish_payload(
            handle, prog["output"], req["prompt"], chat, self.model_name))

    async def _stream(self, writer, hangup, handle, req, chat: bool) -> None:
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()

        def frame(obj) -> bytes:
            return b"data: " + json.dumps(obj).encode("utf-8") + b"\n\n"

        sent = 0
        rid = f"cmpl-{handle}"
        while True:
            prog = self.fleet.progress(handle)
            ids = prog["token_ids"]
            if len(ids) > sent:
                delta = ids[sent:]
                sent = len(ids)
                if chat:
                    choice = {"index": 0,
                              "delta": {"role": "assistant",
                                        "token_ids": delta}}
                else:
                    choice = {"index": 0, "token_ids": delta,
                              "text": " ".join(map(str, delta))}
                writer.write(frame({"id": rid, "object": "chunk",
                                    "engine": handle.label,
                                    "choices": [choice]}))
                await writer.drain()
            if prog["finished"]:
                break
            if hangup.done():
                self.fleet.abort(handle)
                return
            await asyncio.sleep(self.stream_poll_s)
        writer.write(frame(self._finish_payload(
            handle, prog["output"], req["prompt"], chat, self.model_name)))
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()
