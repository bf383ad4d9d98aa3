"""The port's engine fleet, front door and capture gate vs the JAX
reference, on the CPU.

Twins of `tests/test_fleet.py`'s 17 tests, each run on the reference's
classes and the port's over the same `gpt_tiny(64)` weights (fp32,
bridged through numpy), the reference's engines never warmed:

- `rank_replicas` fed the same `ReplicaView`s in both packages, equal picks
  (and the same errors), and the `FleetHandle` round trip;
- fleets of 1 and 2 replicas, affinity and round robin, on a 3-session x
  2-turn stream: the port's streams equal the reference's token for
  token, affinity's returning turns hit the cache for the whole turn-1 KV
  (14 tokens) and round robin's for none, exactly as the reference's;
  the port's replicas run on the leader's parameter tensors;
- finish-time registration, shedding, abort with invariants, and
  `create_predictor` (engine and fleet);
- the HTTP door on loopback sockets: the reference's door and the port's
  over fleets of the same weights answer the same requests with the same
  bodies (apart from the completion id), SSE streams, 400s, 429s, the
  observability routes through the one door, and a dropped client's
  request aborted with its pages freed.

Beside them, the port's capture gate (`graphs.GATE`): a `StepProgram`
build waits for a step another thread holds and no step starts inside it,
a build reached inside a step (a lazy capture) gives up and takes back its
own thread's shared hold, sixteen threads under a short switch interval
never see a shared or second exclusive hold beside an exclusive one, and
two engines' loops, one capturing a new prefill bucket while the other
decodes, never overlap a step with a build, with streams equal to solo
runs.
"""
import http.client
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.inference as ref_inf
from paddle_tpu.inference import router as ref_router
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.inference.frontend import ServingFrontend as RefFrontend
from paddle_tpu.models import gpt as G
import paddle_tpu_torch.inference as port_inf
from paddle_tpu_torch.inference import router as port_router
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.frontend import ServingFrontend
from paddle_tpu_torch.inference.graphs import GATE, StepProgram
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

EKW = dict(num_slots=2, page_size=8, max_model_len=64, prefill_chunk=16,
           seed=0)
ROUTERS = {"reference": ref_router, "port": port_router}
WAIT_S = 120.0          # a wedged loop must fail a test, not hang it


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, jax params, port cfg, port params)."""
    cfg = G.gpt_tiny(64)
    params = G.init_params(cfg, jax.random.key(0))
    tcfg = TG.gpt_tiny(64)
    tparams = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
    return cfg, params, tcfg, tparams


def engine(tiny, which, **kw):
    cfg, params, tcfg, tparams = tiny
    kw = dict(EKW, **kw)
    if which == "reference":
        return JaxEngine(params, cfg, **kw)
    return LLMEngine(tparams, tcfg, device="cpu", **kw)


def fleet(tiny, which, **kw):
    """A fleet of `which` package ("reference" or "port") over the shared
    weights; `engine_kwargs` are EKW (and the port's CPU device)."""
    cfg, params, tcfg, tparams = tiny
    ekw = dict(EKW, **kw.pop("engine_kwargs", {}))
    if which == "reference":
        return ref_router.EngineFleet(params, cfg, engine_kwargs=ekw, **kw)
    return port_router.EngineFleet(tparams, tcfg,
                                   engine_kwargs=dict(ekw, device="cpu"),
                                   **kw)


# ---------------------------------------------------------------------------
# rank_replicas units: the same views to both packages
# ---------------------------------------------------------------------------

def pick(views, **kw):
    """The label both packages' `rank_replicas` pick from `views` (a list of
    ReplicaView keyword dicts); they must agree."""
    got = {}
    for name, R in ROUTERS.items():
        chosen = R.rank_replicas([R.ReplicaView(**v) for v in views], **kw)
        got[name] = None if chosen is None else chosen.label
    assert got["port"] == got["reference"]
    return got["port"]


def test_affinity_prefers_longest_cached_prefix():
    assert pick([dict(label="engine0", matched_tokens=8),
                 dict(label="engine1", matched_tokens=24),
                 dict(label="engine2", matched_tokens=0)]) == "engine1"


def test_sticky_wins_ties_but_strictly_more_cache_overrides():
    assert pick([dict(label="engine0", matched_tokens=16),
                 dict(label="engine1", matched_tokens=16, sticky=True)]) \
        == "engine1"
    assert pick([dict(label="engine0", matched_tokens=40),
                 dict(label="engine1", matched_tokens=16, sticky=True)]) \
        == "engine0"


def test_affinity_load_tiebreak_depth_then_throughput():
    assert pick([dict(label="engine0", depth=3, tokens_per_sec=50.0),
                 dict(label="engine1", depth=1, tokens_per_sec=10.0)]) \
        == "engine1"
    assert pick([dict(label="engine0", depth=2, tokens_per_sec=50.0),
                 dict(label="engine1", depth=2, tokens_per_sec=10.0)]) \
        == "engine0"


def test_overloaded_and_error_replicas_excluded():
    assert pick([dict(label="engine0", state="overloaded", matched_tokens=99),
                 dict(label="engine1", state="error", matched_tokens=99),
                 dict(label="engine2", matched_tokens=0)]) == "engine2"
    assert pick([dict(label="engine0", state="overloaded"),
                 dict(label="engine1", state="error")]) is None


def test_victim_aware_prefilter_for_low_priority():
    hot = dict(label="engine0", matched_tokens=30, pool_pressure=0.95)
    churny = dict(label="engine1", matched_tokens=30,
                  preemptions_per_sec=2.0)
    calm = dict(label="engine2", matched_tokens=0, pool_pressure=0.1)
    assert pick([hot, churny, calm], priority=0) == "engine0"
    assert pick([hot, churny, calm], priority=-1) == "engine2"
    assert pick([hot, churny], priority=-1) == "engine0"


def test_least_loaded_and_policy_errors():
    views = [dict(label="engine0", depth=2), dict(label="engine1", depth=0)]
    assert pick(views, policy="least_loaded") == "engine1"
    for R in ROUTERS.values():
        rv = [R.ReplicaView(**v) for v in views]
        with pytest.raises(ValueError):
            R.rank_replicas(rv, policy="round_robin")
        with pytest.raises(ValueError):
            R.rank_replicas(rv, policy="nope")


def test_fleet_handle_roundtrip():
    for R in ROUTERS.values():
        h = R.FleetHandle(label="engine1", rid=7, session="s0")
        assert str(h) == "engine1/7"
        assert R.FleetHandle.parse("engine1/7") == R.FleetHandle("engine1", 7)
    assert port_router._parse_roles("2P:3D") == \
        ref_router._parse_roles("2P:3D") == (2, 3)
    for bad in ("P", "0P:D"):
        with pytest.raises(ValueError):
            port_router._parse_roles(bad)


# ---------------------------------------------------------------------------
# fleets of real engines, both packages
# ---------------------------------------------------------------------------

def _sessions(vocab, n=3, seed=7):
    rng = np.random.RandomState(seed)
    first = {f"s{i}": rng.randint(0, vocab, (10,)).astype(np.int32)
             for i in range(n)}
    chunk = {k: rng.randint(0, vocab, (4,)).astype(np.int32) for k in first}
    return first, chunk


def _run_two_turns(fl, first, chunk):
    outs = {}
    for k, p in first.items():
        outs[(k, 1)] = fl.result(
            fl.submit(p, session=k, max_new_tokens=5), timeout=WAIT_S)
    for k, p in first.items():
        conv = np.concatenate([p, np.asarray(outs[(k, 1)].token_ids,
                                             np.int32), chunk[k]])
        outs[(k, 2)] = fl.result(
            fl.submit(conv, session=k, max_new_tokens=5), timeout=WAIT_S)
    assert all(o is not None for o in outs.values())
    return outs


def test_fleet_parity_and_affinity_vs_round_robin(tiny):
    """Both packages' fleets (1 replica, 2 affinity, 2 round robin) on the
    same session stream: the port's streams and cached tokens equal the
    reference's; affinity's returning turns reuse the whole turn-1 KV
    (10 prompt + 5 generated - 1 = 14), round robin's shifted assignment
    (3 sessions over 2 replicas) reuses none; the port's replicas run on
    the leader's weights."""
    first, chunk = _sessions(256)
    got = {}
    for which in ("reference", "port"):
        for replicas, router in ((1, "affinity"), (2, "affinity"),
                                 (2, "round_robin")):
            fl = fleet(tiny, which, replicas=replicas, router=router)
            assert fl.shared_executables()
            with fl:
                outs = _run_two_turns(fl, first, chunk)
                fl.check_invariants()
            got[(which, replicas, router)] = (
                {k: list(map(int, o.token_ids)) for k, o in outs.items()},
                {k: int(o.cached_tokens) for k, o in outs.items()},
                fl.stats()["sessions"])
            if which == "port" and replicas == 2:
                e0, e1 = fl.engines.values()
                assert e1.params is e0.params
    for key in got:
        if key[0] == "port":
            assert got[key] == got[("reference",) + key[1:]], key
    digests = [got[k][0] for k in got]
    assert all(d == digests[0] for d in digests)
    c2, c3 = got[("port", 2, "affinity")][1], got[("port", 2,
                                                   "round_robin")][1]
    assert all(c2[(k, 2)] == 14 for k in first), c2
    assert all(c3[(k, 2)] == 0 for k in first), c3


def test_adopt_executables_refuses_other_weights(tiny):
    """A replica on another copy of the weights is not adopted: the fleet
    holds one copy on the device."""
    cfg, params, tcfg, tparams = tiny
    a = engine(tiny, "port")
    other = {k: (dict(v) if isinstance(v, dict) else v.clone())
             for k, v in tparams.items()}
    b = LLMEngine(other, tcfg, device="cpu", **EKW)
    with pytest.raises(ValueError, match="one copy of the weights"):
        port_router._adopt_executables(b, a)
    port_router._adopt_executables(engine(tiny, "port"), a)
    fl = port_router.EngineFleet(engines=[a, b])
    assert not fl.shared_executables()


def test_int8_followers_take_the_leaders_quantized_params(tiny):
    """With int8 weights the followers take the leader's quantized
    dictionary (one quantization, one copy) and stream as one engine."""
    fl = fleet(tiny, "port", replicas=2,
               engine_kwargs=dict(weight_dtype="int8"))
    e0, e1 = fl.engines.values()
    assert "wte_q" in e0.params and e1.params is e0.params
    assert fl.shared_executables()
    solo = engine(tiny, "port", weight_dtype="int8")
    prompt = np.arange(6, dtype=np.int32)
    want = list(solo.result(solo.add_request(prompt, max_new_tokens=3))
                .token_ids)
    with fl:
        h = fl.submit(prompt, max_new_tokens=3, policy="round_robin")
        h = fl.submit(prompt, max_new_tokens=3, policy="round_robin")
        assert h.label == "engine1"
        assert list(fl.result(h, timeout=WAIT_S).token_ids) == want


def test_finish_time_registration_stops_reprefill(tiny):
    """A returning session's last reply is cached too (finish-time
    registration): the probe and turn 2's cached tokens reach the whole
    turn-1 KV on both packages."""
    got = {}
    for which in ("reference", "port"):
        eng = engine(tiny, which)
        rng = np.random.RandomState(3)
        prompt = rng.randint(0, 256, (10,)).astype(np.int32)
        out = eng.result(eng.add_request(prompt, max_new_tokens=5))
        kvlen = prompt.size + len(out.token_ids) - 1
        reply = np.asarray(out.token_ids, np.int32)
        probe = eng.probe_affinity(np.concatenate([prompt, reply]))
        assert probe["cached_tokens"] == kvlen, probe
        conv = np.concatenate([prompt, reply, rng.randint(0, 256, (4,))
                               .astype(np.int32)])
        out2 = eng.result(eng.add_request(conv, max_new_tokens=4))
        assert out2.cached_tokens == kvlen
        eng.cache.check_invariants()
        got[which] = (list(out.token_ids), list(out2.token_ids), probe,
                      out2.cached_tokens)
    assert got["port"] == got["reference"]


def test_shed_when_all_replicas_overloaded(tiny):
    bad = {"state": "overloaded", "code": 2, "reasons": [], "signals": {},
           "burn_rates": {}}
    got = {}
    for which in ("reference", "port"):
        fl = fleet(tiny, which, replicas=2, shed_retry_after_s=2.5)
        fl.engines["engine0"].health = lambda: bad
        first = fl.select(np.arange(4, dtype=np.int32))
        fl.engines["engine1"].health = lambda: bad
        with pytest.raises(Exception) as ei:
            fl.submit(np.arange(4, dtype=np.int32), max_new_tokens=2)
        assert type(ei.value).__name__ == "FleetOverloaded"
        h = fl.health()
        got[which] = (first, ei.value.retry_after_s, fl.stats()["shed"],
                      h["state"], h["code"],
                      {l: v["state"] for l, v in h["per_engine"].items()})
    assert got["port"] == got["reference"]
    assert got["port"][:3] == ("engine1", 2.5, 1)


def test_abort_frees_pages_and_invariants(tiny):
    """Abort mid-generation (the engine stepped until the request has
    tokens, then the loops started), on both packages: the same partial
    stream, finish reason "abort", every page released, invariants."""
    got = {}
    for which in ("reference", "port"):
        fl = fleet(tiny, which, replicas=2)
        h = fl.submit(np.arange(20, dtype=np.int32), max_new_tokens=40)
        eng = fl.engines[h.label]
        steps = 0
        while not fl.progress(h)["token_ids"]:
            eng.step()
            steps += 1
            assert steps < 20
        assert fl.abort(h)
        with fl:
            out = fl.result(h, timeout=WAIT_S)
            assert out is not None and out.finish_reason == "abort"
            assert fl.drain(timeout=WAIT_S)
            fl.check_invariants()
        st = {l: e.stats() for l, e in fl.engines.items()}
        for s in st.values():
            assert s["running"] == s["prefilling"] == s["queued"] == 0
        assert st[h.label]["aborted_requests"] == 1
        got[which] = (h.label, steps, list(out.token_ids),
                      {l: e.cache.pages_in_use()
                       for l, e in fl.engines.items()})
    assert got["port"] == got["reference"]
    assert all(n == 0 for n in got["port"][3].values())


def test_create_predictor_routes_to_engine_and_fleet(tiny):
    cfg, params, tcfg, tparams = tiny
    prompt = np.arange(6, dtype=np.int32)
    ref = ref_inf.create_predictor(cfg, params=params, **EKW)
    want = list(ref.result(ref.add_request(prompt, max_new_tokens=3))
                .token_ids)
    eng = port_inf.create_predictor(tcfg, params=tparams, device="cpu",
                                    **EKW)
    assert isinstance(eng, LLMEngine)
    assert list(eng.result(eng.add_request(prompt, max_new_tokens=3))
                .token_ids) == want
    config = port_inf.Config().enable_llm_engine(tcfg, tparams, replicas=2,
                                                 device="cpu", **EKW)
    fl = port_inf.create_predictor(config)
    assert isinstance(fl, port_inf.EngineFleet)
    assert fl.shared_executables()
    with fl:
        out = fl.result(fl.submit(prompt, max_new_tokens=3),
                        timeout=WAIT_S)
    assert list(out.token_ids) == want
    with pytest.raises(TypeError):
        port_inf.create_predictor(object())
    with pytest.raises(ValueError):
        port_inf.create_predictor(tcfg)             # no params
    # a saved program needs jit/ and static/; mixed precision stays out
    with pytest.raises(NotImplementedError, match="Paddle API breadth"):
        port_inf.create_predictor(port_inf.Config("model.pdmodel"))
    with pytest.raises(NotImplementedError):
        port_inf.convert_to_mixed_precision()
    assert port_inf.PrecisionType.Bfloat16 == ref_inf.PrecisionType.Bfloat16
    assert port_inf.PlaceType.GPU == ref_inf.PlaceType.GPU
    assert isinstance(port_inf.get_version(), str)
    assert set(ref_inf._SERVING) == set(port_inf._SERVING)
    for name in port_inf._SERVING:
        getattr(port_inf, name)


# ---------------------------------------------------------------------------
# the HTTP door, both packages on loopback sockets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def doors(tiny):
    """{package: door} over a started 2-replica fleet each."""
    out = {}
    for which, cls in (("reference", RefFrontend), ("port", ServingFrontend)):
        fl = fleet(tiny, which, replicas=2).start()
        out[which] = cls(fl, rate_limit_rps=200.0,
                         rate_limit_burst=50).start()
    yield out
    for door in out.values():
        door.close()
        door.fleet.stop()


def _post(door, path, payload, headers=(), read=True):
    conn = http.client.HTTPConnection("127.0.0.1", door.port, timeout=60)
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json", **dict(headers)})
    resp = conn.getresponse()
    if not read:
        return conn, resp
    body = resp.read()
    conn.close()
    return resp, body


def _get(door, path):
    conn = http.client.HTTPConnection("127.0.0.1", door.port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, body


def _both(doors, fn):
    """`fn(door)` on the reference's door, then the port's."""
    return {which: fn(door) for which, door in doors.items()}


def _sans_id(body):
    body = dict(body)
    del body["id"]
    return body


def test_http_completion_roundtrip(doors, tiny):
    prompt = [int(x) for x in np.arange(8)]

    def call(door):
        resp, body = _post(door, "/v1/completions",
                           {"prompt": prompt, "max_tokens": 4,
                            "session": "h0"})
        assert resp.status == 200, body
        return json.loads(body)
    got = _both(doors, call)
    out = got["port"]
    assert _sans_id(out) == _sans_id(got["reference"])
    assert out["id"].startswith("cmpl-engine")
    assert out["object"] == "text_completion"
    toks = out["choices"][0]["token_ids"]
    assert len(toks) == 4 and out["usage"]["completion_tokens"] == 4
    eng = engine(tiny, "port")
    ref = eng.result(eng.add_request(np.asarray(prompt, np.int32),
                                     max_new_tokens=4))
    assert toks == [int(x) for x in ref.token_ids]


def test_http_chat_stream_sse(doors):
    def call(door):
        conn, resp = _post(door, "/v1/chat/completions",
                           {"messages": [{"role": "user",
                                          "content": [1, 2, 3, 4, 5]}],
                            "max_tokens": 4, "stream": True}, read=False)
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/event-stream")
        raw = resp.read().decode("utf-8")
        conn.close()
        assert raw.strip().endswith("data: [DONE]")
        frames = [json.loads(x[len("data: "):])
                  for x in raw.strip().split("\n\n")
                  if x.startswith("data: ") and x != "data: [DONE]"]
        streamed = []
        for f in frames[:-1]:
            assert f["object"] == "chunk"
            streamed += f["choices"][0]["delta"]["token_ids"]
        final = frames[-1]
        assert final["choices"][0]["message"]["token_ids"] == streamed
        return streamed, _sans_id(final)
    got = _both(doors, call)
    assert got["port"] == got["reference"]
    streamed, final = got["port"]
    assert len(streamed) == 4
    assert final["choices"][0]["finish_reason"] in ("stop", "length")


def test_http_validation_and_rate_limit(doors):
    def call(door):
        seen = []
        for payload in ({"prompt": "not tokens"}, {},
                        {"prompt": [1, 2], "priority_class": "warp-speed"},
                        {"prompt": [1, 2], "max_tokens": 0}):
            resp, body = _post(door, "/v1/completions", payload)
            seen.append((resp.status, json.loads(body)))
        resp, body = _post(door, "/v1/chat/completions",
                           {"messages": [{"role": "user"}]})
        seen.append((resp.status, json.loads(body)))
        # a second door on the same fleet: burst 1, a near-zero refill
        cls = type(door)
        fe2 = cls(door.fleet, rate_limit_rps=0.001,
                  rate_limit_burst=1.0).start()
        try:
            resp, _ = _post(fe2, "/v1/completions",
                            {"prompt": [1, 2, 3], "max_tokens": 2})
            seen.append(resp.status)
            resp, body = _post(fe2, "/v1/completions",
                               {"prompt": [1, 2, 3], "max_tokens": 2})
            assert "rate-limited" in json.loads(body)["error"]
            seen.append((resp.status, int(resp.getheader("Retry-After")) >= 1))
            resp, _ = _post(fe2, "/v1/completions",
                            {"prompt": [1, 2, 3], "max_tokens": 2},
                            headers={"X-Tenant": "other"})
            seen.append(resp.status)
        finally:
            fe2.close()
        return seen
    got = _both(doors, call)
    assert got["port"] == got["reference"]
    assert [s if isinstance(s, int) else s[0] for s in got["port"]] == \
        [400, 400, 400, 400, 400, 200, 429, 200]
    assert "token ids" in got["port"][0][1]["error"]


def test_http_obs_routes_one_door(doors):
    def call(door):
        codes = {p: _get(door, p)[0] for p in ("/healthz", "/stats",
                                               "/metrics", "/debug")}
        text = _get(door, "/metrics")[1].decode("utf-8")
        assert 'engine="engine0"' in text and 'engine="engine1"' in text
        assert "llm_fleet_" in text
        status, body = _get(door, "/nope")
        stats = json.loads(_get(door, "/stats")[1])
        return codes, status, json.loads(body), sorted(stats), \
            json.loads(_get(door, "/healthz")[1])["state"]
    got = _both(doors, call)
    assert got["port"] == got["reference"]
    codes, status, body, members, state = got["port"]
    assert set(codes.values()) == {200} and status == 404
    assert "/metrics" in body["routes"]
    assert "POST /v1/completions" in body["routes"]
    assert members == ["engine0", "engine1"] and state == "ok"


def test_http_disconnect_aborts_and_frees_pages(doors):
    """A client that drops mid-stream aborts its request on both doors, and
    the pages go back to what the replicas held before it.  The loops are
    stopped meanwhile and this thread steps the replicas until the first
    token frame has reached the client, so the drop lands mid-stream
    whatever the engines' speed."""
    def call(door):
        fl = door.fleet
        assert fl.drain(timeout=WAIT_S)
        fl.stop()
        before = {l: (e.stats()["aborted_requests"], e.cache.pages_in_use())
                  for l, e in fl.engines.items()}
        payload = json.dumps({"prompt": [9, 8, 7, 6, 5, 4, 3, 2],
                              "max_tokens": 48,
                              "stream": True}).encode("utf-8")
        sock = socket.create_connection(("127.0.0.1", door.port), timeout=60)
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\n"
                     b"Host: door\r\nContent-Type: application/json\r\n"
                     b"Content-Length: " + str(len(payload)).encode() +
                     b"\r\n\r\n" + payload)
        got = sock.recv(4096)
        assert got.startswith(b"HTTP/1.1 200"), got
        sock.settimeout(0.01)
        steps = 0
        while b"data: " not in got:
            for e in fl.engines.values():
                if e.has_work:
                    e.step()
            steps += 1
            assert steps < 40
            try:
                got += sock.recv(4096)
            except socket.timeout:
                pass
        sock.shutdown(socket.SHUT_RDWR)
        sock.close()
        deadline = time.monotonic() + 60.0
        while not any(e.stats()["aborted_requests"] > before[l][0]
                      for l, e in fl.engines.items()):
            assert time.monotonic() < deadline, \
                "disconnect never aborted the in-flight request"
            time.sleep(0.01)
        fl.start()
        assert fl.drain(timeout=WAIT_S)
        fl.check_invariants()
        for l, e in fl.engines.items():
            st = e.stats()
            assert st["running"] == 0 and st["prefilling"] == 0
            assert e.cache.pages_in_use() == before[l][1]
        return True
    assert _both(doors, call) == {"reference": True, "port": True}


# ---------------------------------------------------------------------------
# the capture gate
# ---------------------------------------------------------------------------

def _join(t):
    t.join(WAIT_S)
    assert not t.is_alive()


def test_gate_build_waits_for_a_held_step_and_excludes_new_ones():
    """A build waits for the step another thread holds; a step that starts
    during the build waits until the build ends."""
    log, lock = [], threading.Lock()
    in_body, let_body = threading.Event(), threading.Event()

    def note(what):
        with lock:
            log.append(what)

    def body(x):
        note("build")
        in_body.set()
        assert let_body.wait(WAIT_S)
        return x + 1
    prog = StepProgram("gated", body, {"x": ((2,), torch.int32, 0)},
                       torch.device("cpu"))
    stepping, let_step = threading.Event(), threading.Event()

    def step_a():
        with GATE.shared():
            note("step a")
            stepping.set()
            assert let_step.wait(WAIT_S)
            note("step a ends")

    def step_b():
        with GATE.shared():
            note("step b")

    a = threading.Thread(target=step_a)
    a.start()
    assert stepping.wait(WAIT_S)
    builder = threading.Thread(target=prog.build)
    builder.start()
    time.sleep(0.2)
    assert log == ["step a"]            # the build waits for the step
    let_step.set()
    assert in_body.wait(WAIT_S)
    b = threading.Thread(target=step_b)
    b.start()
    time.sleep(0.2)
    assert log == ["step a", "step a ends", "build"]    # b waits
    let_body.set()
    for t in (a, builder, b):
        _join(t)
    assert log == ["step a", "step a ends", "build", "step b"]
    assert prog.built and GATE.holds() == (0, False)


def test_gate_build_inside_a_step_gives_its_hold_up_and_back():
    """A build reached inside a step (nested shared holds) takes the gate
    exclusively while another thread's step waits, and the thread's holds
    are back after it; no deadlock."""
    seen = {}
    other_in, other_go = threading.Event(), threading.Event()

    def body(x):
        seen.setdefault("inside", GATE.holds())     # the build's call
        return x * 2
    prog = StepProgram("lazy", body, {"x": ((2,), torch.int32, 1)},
                       torch.device("cpu"))

    def other():
        with GATE.shared():
            other_in.set()
            assert other_go.wait(WAIT_S)

    def stepper():
        with GATE.shared(), GATE.shared():
            seen["before"] = GATE.holds()
            prog.stage(x=np.array([1, 2], np.int32))    # builds lazily
            seen["after"] = GATE.holds()
            seen["out"] = prog.run().tolist()

    o = threading.Thread(target=other)
    o.start()
    assert other_in.wait(WAIT_S)
    s = threading.Thread(target=stepper)
    s.start()
    time.sleep(0.2)
    assert "inside" not in seen         # waits for the other step
    other_go.set()
    for t in (o, s):
        _join(t)
    assert seen["before"] == seen["after"] == (2, False)
    assert seen["inside"] == (0, True)
    assert seen["out"] == [2, 4]


def test_gate_stress_exclusive_holds_stand_alone():
    """Sixteen threads (more than the cores), the switch interval
    shortened: twelve take the gate shared (some nested, some taking it
    exclusively inside, as a lazy capture does), four take it
    exclusively.  Inside an exclusive hold no other thread is ever inside
    a shared or an exclusive one."""
    import sys
    inside = {"shared": 0, "excl": 0}
    lock = threading.Lock()
    bad = []

    def move(kind, by):
        with lock:
            inside[kind] += by
            if inside["excl"] > 1 or (inside["excl"] and inside["shared"]):
                bad.append(dict(inside))
        time.sleep(0)                   # let another thread in here

    def stepper(i):
        for _ in range(150):
            with GATE.shared():
                move("shared", 1)
                if i % 3 == 0:
                    with GATE.shared():
                        pass
                move("shared", -1)
                if i % 4 == 0:
                    with GATE.exclusive():
                        move("excl", 1)
                        move("excl", -1)
                move("shared", 1)       # the shared hold is back
                move("shared", -1)

    def capturer():
        for _ in range(100):
            with GATE.exclusive():
                move("excl", 1)
                move("excl", -1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=stepper, args=(i,))
                   for i in range(12)]
        threads += [threading.Thread(target=capturer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            _join(t)
    finally:
        sys.setswitchinterval(old)
    assert not bad, bad[:3]
    assert inside == {"shared": 0, "excl": 0}
    assert GATE.holds() == (0, False)


def test_two_loops_lazy_capture_never_overlaps_a_step(tiny, monkeypatch):
    """Two port engines (bucketed: a program per prefill bucket, built at
    its first use) with loops running: replica 1 gets a prompt of a bucket
    it never built while replica 0 decodes a long request.  No other
    thread's step overlaps a build, and both streams equal solo runs."""
    intervals, lock = [], threading.Lock()
    build, step = StepProgram._build, LLMEngine._step

    def timed(fn, kind):
        def run(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return fn(self, *a, **k)
            finally:
                with lock:
                    intervals.append((kind, threading.get_ident(), t0,
                                      time.perf_counter()))
        return run
    monkeypatch.setattr(StepProgram, "_build", timed(build, "build"))
    monkeypatch.setattr(LLMEngine, "_step", timed(step, "step"))
    kw = dict(prefill_chunk=None, page_size=8, max_model_len=64)
    rng = np.random.RandomState(11)
    long_p = rng.randint(0, 256, (6,)).astype(np.int32)
    new_p = rng.randint(0, 256, (30,)).astype(np.int32)    # bucket 32
    solo = {}
    for name, p, n in (("long", long_p, 50), ("new", new_p, 8)):
        e = engine(tiny, "port", **kw)
        solo[name] = list(e.result(e.add_request(p, max_new_tokens=n))
                          .token_ids)
    fl = fleet(tiny, "port", replicas=2, engine_kwargs=kw)
    e0, e1 = fl.engines.values()
    warm = e1.add_request(np.arange(5, dtype=np.int32), max_new_tokens=2)
    e1.result(warm)                     # bucket 8 and the fused step built
    intervals.clear()
    with fl:
        h0 = e0.submit(long_p, max_new_tokens=50)
        while len(e0.progress(h0)["token_ids"]) < 5:
            time.sleep(0.001)
        h1 = e1.submit(new_p, max_new_tokens=8)
        out1 = e1.result(h1, timeout=WAIT_S)
        out0 = e0.result(h0, timeout=WAIT_S)
    assert list(out0.token_ids) == solo["long"]
    assert list(out1.token_ids) == solo["new"]
    assert "prefill:32" in e1._programs and "prefill:32" not in e0._programs
    builds = [iv for iv in intervals if iv[0] == "build"]
    steps = [iv for iv in intervals if iv[0] == "step"]
    assert builds and len({iv[1] for iv in steps}) == 2
    for _, tb, b0, b1 in builds:
        for _, ts, s0, s1 in steps:
            if ts != tb:
                assert s1 <= b0 or s0 >= b1, "a step overlapped a build"
    assert GATE.holds() == (0, False)
