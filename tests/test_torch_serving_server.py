"""The port's ``ModelServer`` against the JAX package's, on one archive.

Both packages' servers serve the same JAX archive; the same requests must
get the same status codes, the same response headers (request id echo,
worker id, model version, ``Retry-After``/``-Ms`` on an overloaded or paging
model, an honoured ``X-Deadline-Ms``), the same JSON keys on every GET
endpoint and the same ``/metrics`` families, with outputs within 1e-6.
Then the rest of the HTTP surface on the port: residency, replicas and
capacity (``tests/test_paging.py:377``, ``:429``, ``:879``), sessions over
HTTP with the Server-Sent-Events stream against a serial ``rnn_time_step``
loop (and the JAX server's answers), feedback (``tests/test_delivery.py:376``),
the journal, stacks and bundle endpoints (``tests/test_journal.py:624``),
and the scheduler hook: without a scheduler ``/v1/scheduler`` answers 404 as
a JAX worker's does, with one attached it answers 200 and ``/metrics``
gains the ``scheduler_*`` families (the rest in
``test_torch_serving_scheduler.py``).
"""

import io
import json
import tarfile
import threading
import time

import numpy as np
import pytest

from _torch_serving_host import (_PORT_EXTRA, BATCHER_KW, BUCKET, RTOL, F, T, X, _families,
                                 _keys, _norm, align_compile_caches, jax_archive, lstm,
                                 port_on_cpu, port_restore, post, request,  # noqa: F401
                                 set_port_cpu, wait_until)
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
from deeplearning4j_tpu.serving import ModelServer as JServer
from deeplearning4j_tpu.serving import blackbox as jblackbox
from deeplearning4j_tpu.serving import wire as jwire
from deeplearning4j_tpu_torch.runtime import chaos, journal, trace
from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer, blackbox, wire
from deeplearning4j_tpu_torch.serving.admission import Overloaded, PagingInProgress
from deeplearning4j_tpu_torch.serving.resilience import CircuitOpen

WORKER = "w-srv"
#: headers that differ by time or body length, not by contract
_VOLATILE = {"date", "server", "content-length"}
#: headers whose values are the contract
_CONTRACT = ("Content-Type", "X-Worker-Id", "X-Model-Version", "X-Request-Id", "Retry-After",
             "Retry-After-Ms", "X-Session-Step")
def _headers(h):
    return {k.lower() for k in h} - _VOLATILE


def _contract(h):
    low = {k.lower(): v for k, v in h.items()}
    return {k: low.get(k.lower()) for k in _CONTRACT}


def _outputs(headers, data):
    ctype = next((v for k, v in headers.items() if k.lower() == "content-type"), "")
    if ctype.startswith(wire.CONTENT_TYPE):
        _, _, out, fr = wire.decode_predict_response(data)
        try:
            return np.array(out)
        finally:
            out = None
            fr.close()
    return np.asarray(json.loads(data)["outputs"], np.float32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX and a port ModelServer over the same JAX archive, same worker id."""
    set_port_cpu()
    archive = jax_archive(tmp_path_factory.mktemp("server") / "m.zip")
    jreg, reg = JRegistry(), ModelRegistry()
    jsrv, srv = JServer(jreg, worker_id=WORKER), ModelServer(reg, worker_id=WORKER)
    try:
        for r in (jreg, reg):
            r.load("m", archive, warmup_example=X[:1], save_manifest=False, **BATCHER_KW)
        ports = {"jax": jsrv.start(0), "port": srv.start(0)}
        yield ports, {"jax": jsrv, "port": srv}, archive
    finally:
        jsrv.stop(shutdown_registry=True)
        srv.stop(shutdown_registry=True)


def _frame(x, **kw):
    return wire.encode_predict_request(x, **kw)


PREDICTS = {
    "json_f32": dict(body={"inputs": X[:3].tolist(), "dtype": "float32"},
                     headers={"X-Request-Id": "req-1"}),
    "json_f64_parse": dict(body={"inputs": X[:4].tolist()}),
    "json_one_row": dict(body={"inputs": X[5:6].tolist(), "timeout_ms": 10000}),
    "binary": dict(body=_frame(X[:4], timeout_ms=10000),
                   headers={"Content-Type": wire.CONTENT_TYPE, "X-Request-Id": "req-bin"}),
    "binary_fields": dict(body=_frame(X[:2], headers={"X-Request-Id": "in-frame"}),
                          headers={"Content-Type": wire.CONTENT_TYPE}),
    "malformed_json": dict(body=b"{not json"),
    "missing_inputs": dict(body={"rows": [[1.0]]}),
    "ragged_rows": dict(body={"inputs": [[1.0, 2.0], [3.0]]}),
    "object_dtype": dict(body={"inputs": X[:1].tolist(), "dtype": "str"}),
    "unknown_model": dict(body={"inputs": X[:1].tolist()}, model="nope"),
    "expired_deadline_header": dict(body={"inputs": X[:1].tolist()},
                                    headers={"X-Deadline-Ms": "0.001"}),
    "header_caps_body_timeout": dict(body={"inputs": X[:1].tolist(), "timeout_ms": 60000},
                                     headers={"X-Deadline-Ms": "0.001"}),
    "corrupt_frame": dict(body=bytes(b ^ 0xFF if i == 30 else b
                                     for i, b in enumerate(_frame(X[:4]))),
                          headers={"Content-Type": wire.CONTENT_TYPE}),
    "frame_of_a_response": dict(body=wire.encode_predict_response("m", 1, X[:1]),
                                headers={"Content-Type": wire.CONTENT_TYPE}),
}


@pytest.mark.parametrize("case", sorted(PREDICTS))
def test_predict_same_status_headers_keys_and_outputs(pair, case):
    ports, _, _ = pair
    c = PREDICTS[case]
    path = f"/v1/models/{c.get('model', 'm')}/predict"
    got = {side: request(ports[side], "POST", path, c["body"], headers=c.get("headers"))
           for side in ("jax", "port")}
    (js, jh, jd), (ps, ph, pd) = got["jax"], got["port"]
    assert ps == js, (case, js, ps, pd[:200])
    assert _headers(ph) == _headers(jh)
    assert _contract(ph) == _contract(jh)
    if _contract(jh)["Content-Type"] == "application/json":
        jobj, pobj = json.loads(jd), json.loads(pd)
        assert set(pobj) == set(jobj)
        if ps != 200:
            assert pobj.get("reason") == jobj.get("reason")
    if js == 200:
        np.testing.assert_allclose(_outputs(ph, pd), _outputs(jh, jd), rtol=RTOL, atol=1e-7)


def test_wire_disabled_worker_answers_415_in_both(pair):
    ports, servers, _ = pair
    frame = _frame(X[:2])
    try:
        for s in servers.values():
            s.wire_enabled = False
        got = [request(ports[side], "POST", "/v1/models/m/predict", frame,
                       headers={"Content-Type": wire.CONTENT_TYPE}) for side in ("jax", "port")]
        assert [g[0] for g in got] == [415, 415]
        assert json.loads(got[1][2]) == json.loads(got[0][2])
        assert [json.loads(request(ports[s], "GET", "/healthz")[2])["wire"]
                for s in ("jax", "port")] == [False, False]
    finally:
        for s in servers.values():
            s.wire_enabled = True


def test_binary_answers_are_the_registry_answers_bit_for_bit(pair):
    """The wire frame carries the in-process answer unchanged, and the
    port's and the JAX package's frames frame the same way."""
    ports, servers, _ = pair
    reg = servers["port"].registry
    pool = wire.ConnectionPool()
    try:
        for n in (1, 3, 4):
            status, h, data = pool.request(f"127.0.0.1:{ports['port']}", "POST",
                                           "/v1/models/m/predict", body=_frame(X[:n]),
                                           headers={"Content-Type": wire.CONTENT_TYPE},
                                           timeout=30)
            assert status == 200
            ref = np.asarray(reg.predict("m", X[:n]))
            assert _outputs(h, data).tobytes() == ref.tobytes()
            _, _, out, fr = jwire.decode_predict_response(data)  # a JAX client reads it
            assert np.array(out).tobytes() == ref.tobytes()
            out = None
            fr.close()
            assert json.loads(request(ports["port"], "POST", "/v1/models/m/predict",
                                      {"inputs": X[:n].tolist(), "dtype": "float32"})[2])[
                "outputs"] == ref.tolist()
    finally:
        pool.close()


GETS = ["/v1/models", "/v1/models/m", "/v1/models/nope", "/healthz", "/readyz",
        "/v1/metricsz", "/v1/slo", "/v1/capacity", "/v1/traces", "/v1/traces?limit=2",
        "/v1/traces?limit=nope", "/v1/journal", "/v1/journal?limit=nope", "/v1/debug/stacks",
        "/v1/scheduler", "/v1/nothing"]


@pytest.mark.parametrize("path", GETS)
def test_get_endpoints_same_status_and_json_keys(pair, path):
    from deeplearning4j_tpu.runtime import journal as jjournal
    ports, _, _ = pair
    post(ports["jax"])
    post(ports["port"])
    try:
        for j in (journal, jjournal):  # the same one event in both rings
            j.enable(capacity=64)
            j.emit("chaos.action", point="fixture", index=1, policy="P", action="a")
        (js, _, jd), (ps, _, pd) = (request(ports[s], "GET", path) for s in ("jax", "port"))
    finally:
        journal.enable(capacity=1024)
        jjournal.enable(capacity=1024)
    assert ps == js
    jk, pk = _norm(_keys(json.loads(jd))), _norm(_keys(json.loads(pd)))
    assert pk - jk <= _PORT_EXTRA and jk <= pk, (sorted(pk - jk), sorted(jk - pk))


def test_metrics_families_equal_the_jax_set(pair, monkeypatch, tmp_path):
    ports, _, _ = pair
    align_compile_caches(monkeypatch, tmp_path)
    post(ports["jax"])
    post(ports["port"])
    texts = {s: request(ports[s], "GET", "/metrics")[2].decode() for s in ports}
    assert _families(texts["port"]) == _families(texts["jax"])
    assert [ln for ln in texts["port"].splitlines() if ln.startswith("# TYPE")] == \
        [ln for ln in texts["jax"].splitlines() if ln.startswith("# TYPE")]
    assert 'serving_responses_total{model="m"}' in texts["port"]


class _FakeRegistry:
    """A registry whose one model raises ``exc`` from ``predict``."""

    def __init__(self, exc):
        self.exc = exc
        outer = self

        class Served:
            version = 1

            def predict(self, x, timeout_ms=None):
                raise outer.exc

        self.served = Served()

    def get(self, name):
        if name != "m":
            raise KeyError(name)
        return self.served

    def names(self):
        return ["m"]


def _jax_exc(exc):
    from deeplearning4j_tpu.serving import admission as ja
    from deeplearning4j_tpu.serving import resilience as jr
    kind = type(exc).__name__
    if kind == "Overloaded":
        return ja.Overloaded("queue full", retry_after_ms=exc.retry_after_ms)
    if kind == "CircuitOpen":
        return jr.CircuitOpen("breaker open")
    return RuntimeError("model fault")


@pytest.mark.parametrize("exc", [Overloaded("queue full", retry_after_ms=750.0),
                                 Overloaded("queue full", retry_after_ms=1250.4),
                                 CircuitOpen("breaker open"), RuntimeError("model fault")],
                         ids=["overloaded_750", "overloaded_1250", "circuit_open", "fault"])
def test_shed_and_fault_answers_match_over_http(exc):
    """``Retry-After`` (whole seconds, rounded up) and ``Retry-After-Ms`` on
    a 503 ``Overloaded``, 503 ``circuit_open``, 500 for a model fault: the
    same status, headers and body keys from both servers."""
    servers = [JServer(_FakeRegistry(_jax_exc(exc)), worker_id=WORKER),
               ModelServer(_FakeRegistry(exc), worker_id=WORKER)]
    try:
        ports = [s.start(0) for s in servers]
        got = [request(p, "POST", "/v1/models/m/predict", {"inputs": [[1.0]]},
                       headers={"X-Request-Id": "shed-1"}) for p in ports]
        (js, jh, jd), (ps, ph, pd) = got
        assert ps == js and _contract(ph) == _contract(jh) and _headers(ph) == _headers(jh)
        assert set(json.loads(pd)) == set(json.loads(jd))
        if isinstance(exc, Overloaded):
            assert ps == 503
            assert ph["Retry-After"] == str(int(np.ceil(exc.retry_after_ms / 1000)))
            assert ph["Retry-After-Ms"] == f"{exc.retry_after_ms:.0f}"
    finally:
        for s in servers:
            s.stop()


def test_scheduler_is_refused_by_name(pair, tmp_path):
    """The scheduler hook (the name kept from when attaching raised): none
    attached answers 404 as the JAX worker; an attached scheduler answers
    200 and renders its families; detaching goes back to 404."""
    from deeplearning4j_tpu_torch.serving.control_plane import FleetConfig
    from deeplearning4j_tpu_torch.serving.scheduler import JobStore, Scheduler
    ports, servers, _ = pair
    srv = servers["port"]
    assert srv.scheduler is None
    assert request(ports["port"], "GET", "/v1/scheduler")[:1] == \
        request(ports["jax"], "GET", "/v1/scheduler")[:1] == (404,)
    assert "scheduler_" not in request(ports["port"], "GET", "/metrics")[2].decode()
    srv.scheduler = Scheduler(JobStore(FleetConfig(str(tmp_path / "fleet.json"))),
                              signals=lambda: {}, worker_id=srv.worker_id)
    try:
        status, _, body = request(ports["port"], "GET", "/v1/scheduler")
        assert status == 200 and sorted(json.loads(body)) == ["jobs", "scheduler", "worker"]
        assert "scheduler_harvested_busy_s 0" in \
            request(ports["port"], "GET", "/metrics")[2].decode()
    finally:
        srv.scheduler = None
    assert request(ports["port"], "GET", "/v1/scheduler")[:1] == (404,)


# ========================================================= paging surfaces
def _residency_sequence(server_cls, registry_cls, archive):
    """The same operator sequence against one server: evict, re-evict,
    capacity, page in, pinned evict, resize up and down, bad bodies, a
    cold model's detail and resize. Returns (status, keys, picks) per step."""
    reg = registry_cls()
    srv = server_cls(reg, worker_id="w-res")
    steps = []
    try:
        reg.load("m", archive, warmup_example=X[:1], save_manifest=False, **BATCHER_KW)
        port = srv.start(0)

        def call(method, path, body=None, pick=()):
            status, _, data = request(port, method, path, body)
            obj = json.loads(data)
            steps.append((path, status, sorted(obj), {k: obj.get(k) for k in pick}))
            return obj

        call("POST", "/v1/models/m/residency", {"state": "cold"}, ("state",))
        call("POST", "/v1/models/m/residency", {"state": "cold"}, ("state", "already"))
        cap = call("GET", "/v1/capacity")
        steps.append(("cold capacity", cap["residency"]["models"]["m"]["state"],
                      cap["residency"]["resident_bytes"], {}))
        call("GET", "/v1/models/m", pick=("residency",))
        call("POST", "/v1/models/m/replicas", {"replicas": 2})
        obj = call("POST", "/v1/models/m/residency", {"state": "resident"}, ("state",))
        steps.append(("device bytes > 0", obj["device_bytes"] > 0, None, {}))
        served = reg.acquire("m")
        try:
            call("POST", "/v1/models/m/residency", {"state": "cold"})
        finally:
            served.unpin()
        call("POST", "/v1/models/m/residency", {"state": "warm"})
        call("POST", "/v1/models/nope/residency", {"state": "resident"})
        call("POST", "/v1/models/m/replicas", {"replicas": 2}, ("replicas", "replicas_before"))
        call("POST", "/v1/models/m/replicas", {"delta": -5}, ("replicas", "replicas_before"))
        call("POST", "/v1/models/m/replicas", {"replicas": 2, "delta": 1})
        call("POST", "/v1/models/m/replicas", {"delta": 1, "floor": 0})
        call("POST", "/v1/models/nope/replicas", {"replicas": 2})
        status, _, data = request(port, "POST", "/v1/models/m/predict",
                                  {"inputs": X[:4].tolist(), "dtype": "float32"})
        steps.append(("predict after resize", status, None, {}))
        return steps, np.asarray(json.loads(data)["outputs"], np.float32)
    finally:
        srv.stop()
        reg.shutdown()


def test_residency_replicas_and_capacity_sequence_matches_jax(pair):
    _, _, archive = pair
    jsteps, jout = _residency_sequence(JServer, JRegistry, archive)
    psteps, pout = _residency_sequence(ModelServer, ModelRegistry, archive)
    assert psteps == jsteps
    np.testing.assert_allclose(pout, jout, rtol=RTOL, atol=1e-7)


def test_server_pages_in_and_surfaces_paging_headers(pair):
    """A request for a cold model pages it in; one landing inside a slow
    page-in with a deadline that cannot cover it gets 503 ``paging_in``
    with an honest ``Retry-After``."""
    _, _, archive = pair
    reg = ModelRegistry()
    srv = ModelServer(reg, worker_id="w-paging")
    t = None
    try:
        reg.load("m", archive, warmup_example=X[:1], save_manifest=False, **BATCHER_KW)
        port = srv.start(0)
        ref = np.asarray(reg.predict("m", X))
        assert reg.evict("m") is True
        status, _, data = request(port, "POST", "/v1/models/m/predict",
                                  {"inputs": X.tolist(), "dtype": "float32"})
        assert status == 200
        assert np.asarray(json.loads(data)["outputs"], np.float32).tobytes() == ref.tobytes()
        assert reg.evict("m") is True

        def leader():
            with chaos.ChaosController(seed=2) as c:
                c.on("serving.registry.page_in", chaos.AddLatency(0.6))
                reg.page_in("m")

        t = threading.Thread(target=leader)
        t.start()
        assert wait_until(lambda: "m" in reg._flights, timeout_s=5.0, interval=0.005)
        status, headers, data = request(port, "POST", "/v1/models/m/predict",
                                        {"inputs": X.tolist(), "timeout_ms": 30})
        t.join(timeout=30)
        payload = json.loads(data)
        assert status == 503 and payload["reason"] == "paging_in"
        assert payload["retry_after_ms"] >= 25.0
        assert float(headers["Retry-After-Ms"]) == pytest.approx(payload["retry_after_ms"],
                                                                 abs=1.0)
        assert int(headers["Retry-After"]) >= 1
    finally:
        if t is not None:
            t.join(timeout=30)
        srv.stop()
        reg.shutdown()


def test_paging_in_progress_maps_like_jax():
    """``PagingInProgress`` out of ``acquire``: the same 503 and headers
    from both servers (a registry whose acquire refuses, no clock)."""
    from deeplearning4j_tpu.serving.admission import PagingInProgress as JPaging

    class Refusing:
        def __init__(self, exc):
            self.exc = exc

        def acquire(self, name, timeout_ms=None):
            raise self.exc

        def names(self):
            return ["m"]

    servers = [JServer(Refusing(JPaging("paging", retry_after_ms=1500.0)), worker_id=WORKER),
               ModelServer(Refusing(PagingInProgress("paging", retry_after_ms=1500.0)),
                           worker_id=WORKER)]
    try:
        got = [request(s.start(0), "POST", "/v1/models/m/predict", {"inputs": [[0.0]]})
               for s in servers]
        assert got[1][0] == got[0][0] == 503
        assert _contract(got[1][1]) == _contract(got[0][1])
        assert json.loads(got[1][2]) == json.loads(got[0][2])
    finally:
        for s in servers:
            s.stop()


# ============================================================ session tier
def _serial_oracle(net, chunks):
    outs = []
    net.rnn_clear_previous_state()
    for c in chunks:
        xb = np.zeros((BUCKET, T, F), np.float32)
        xb[0] = c[0]
        outs.append(np.asarray(net.rnn_time_step(xb))[:1])
    net.rnn_clear_previous_state()
    return outs


@pytest.fixture(scope="module")
def session_pair(tmp_path_factory):
    """JAX and port session-enabled servers over one JAX LSTM archive."""
    set_port_cpu()
    d = tmp_path_factory.mktemp("sessions")
    archive = jax_archive(d / "lstm.zip", lstm(True))
    jreg, reg = JRegistry(), ModelRegistry()
    servers = {}
    try:
        for side, r, cls in (("jax", jreg, JServer), ("port", reg, ModelServer)):
            r.load("lstm", archive, save_manifest=False, max_batch_size=8, replicas=1,
                   pipeline_depth=0)
            r.get("lstm").batcher.enable_sessions(np.zeros((1, T, F), np.float32),
                                                  session_bucket=BUCKET)
            servers[side] = cls(r, worker_id="w-http", session_dir=str(d / f"spill-{side}"),
                                session_kw={"start_evictor": False})
        ports = {s: srv.start(0) for s, srv in servers.items()}
        yield ports, servers, port_restore(archive)
    finally:
        for srv in servers.values():
            srv.stop(shutdown_registry=True)


def _chunks(key, n):
    rng = np.random.default_rng(key)
    return [rng.standard_normal((1, T, F)).astype(np.float32) for _ in range(n)]


def _session_script(port, sid, chunks):
    """Open, step, replay, conflict, unknown, capacity, drain, close, close
    again: ``[(status, keys, picks)]`` and the step outputs."""
    out, outs = [], []

    def call(method, path, body=None, pick=()):
        status, h, data = request(port, method, path, body)
        obj = json.loads(data)
        out.append((path.replace(sid, "<sid>"), status, sorted(obj),
                    {k: obj.get(k) for k in pick}, h.get("X-Session-Step")))
        return obj

    call("POST", "/v1/models/lstm/sessions", {"session_id": sid}, ("step", "session", "worker"))
    for i, c in enumerate(chunks):
        obj = call("POST", f"/v1/models/lstm/sessions/{sid}/step",
                   {"inputs": c.tolist(), "step": i}, ("step", "replayed"))
        outs.append(np.asarray(obj["outputs"], np.float32))
    obj = call("POST", f"/v1/models/lstm/sessions/{sid}/step",
               {"inputs": chunks[-1].tolist(), "step": len(chunks) - 1}, ("step", "replayed"))
    outs.append(np.asarray(obj["outputs"], np.float32))
    call("POST", f"/v1/models/lstm/sessions/{sid}/step",
         {"inputs": chunks[-1].tolist(), "step": 9}, ("reason",))
    call("POST", "/v1/models/lstm/sessions/nope/step", {"inputs": chunks[0].tolist()})
    call("POST", f"/v1/models/lstm/sessions/{sid}/step", {"inputs": "x"})
    call("POST", f"/v1/models/lstm/sessions/{sid}", {"session_id": sid})
    call("POST", "/v1/models/missing/sessions", {})
    cap = call("GET", "/v1/capacity")
    out.append(("session counters", cap["sessions"]["tracked"],
                cap["sessions"]["counters"]["steps_total"],
                cap["sessions"]["counters"]["replays_total"], None))
    call("POST", "/v1/sessions/drain", {}, ("spilled",))
    call("DELETE", f"/v1/models/lstm/sessions/{sid}", pick=("closed",))
    call("DELETE", f"/v1/models/lstm/sessions/{sid}")
    return out, outs


def test_session_endpoints_match_jax_and_the_serial_loop(session_pair):
    ports, servers, net = session_pair
    chunks = _chunks(37, 3)
    jscript, jouts = _session_script(ports["jax"], "s-unary", chunks)
    pscript, pouts = _session_script(ports["port"], "s-unary", chunks)
    assert pscript == jscript
    oracle = _serial_oracle(net, chunks)
    for i, (p, j) in enumerate(zip(pouts, jouts)):
        want = oracle[min(i, len(chunks) - 1)]
        assert p.tobytes() == want.astype(np.float32).tobytes(), i  # replay included
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=1e-7)
    text = request(ports["port"], "GET", "/metrics")[2].decode()
    for metric in ("serving_sessions_tracked", "serving_sessions_resident",
                   "serving_session_steps_total", "serving_session_replays_total",
                   "serving_session_rehydrate_seconds"):
        assert metric in text, metric


def _sse(port, sid, chunks, step0=0):
    status, h, data = request(port, "POST", f"/v1/models/lstm/sessions/{sid}/stream",
                              {"inputs": [c.tolist() for c in chunks], "step": step0},
                              timeout=60)
    frames = [f for f in data.decode().split("\n\n") if f.strip()]
    return status, h, frames


def test_sse_stream_matches_jax_serial_loop_and_joins_writer(session_pair):
    ports, _, net = session_pair
    chunks = _chunks(41, 4)
    oracle = _serial_oracle(net, chunks)
    got = {}
    for side in ("jax", "port"):
        assert request(ports[side], "POST", "/v1/models/lstm/sessions",
                       {"session_id": "s-sse"})[0] == 200
        status, h, frames = _sse(ports[side], "s-sse", chunks)
        assert status == 200 and h["Content-Type"].startswith("text/event-stream")
        got[side] = frames
        request(ports[side], "DELETE", "/v1/models/lstm/sessions/s-sse")
    data = {s: [json.loads(f[len("data:"):]) for f in fr if f.startswith("data:")]
            for s, fr in got.items()}
    assert len(data["port"]) == len(data["jax"]) == len(chunks)
    for i, (p, j) in enumerate(zip(data["port"], data["jax"])):
        assert sorted(p) == sorted(j) and p["step"] == j["step"] == i + 1
        out = np.asarray(p["outputs"], np.float32)
        assert out.tobytes() == oracle[i].astype(np.float32).tobytes(), i
        np.testing.assert_allclose(out, np.asarray(j["outputs"], np.float32), rtol=RTOL,
                                   atol=1e-7)
    ends = {s: [f for f in fr if f.startswith("event: end")] for s, fr in got.items()}
    assert ends["port"] == ends["jax"] and len(ends["port"]) == 1
    # an error mid-stream is an ``event: error`` with the unary body, in both
    errs = {}
    for side in ("jax", "port"):
        request(ports[side], "POST", "/v1/models/lstm/sessions", {"session_id": "s-err"})
        _, _, frames = _sse(ports[side], "s-err", chunks[:2], step0=5)
        errs[side] = [json.loads(f.splitlines()[-1][len("data:"):]) for f in frames
                      if f.startswith("event: error")]
        request(ports[side], "DELETE", "/v1/models/lstm/sessions/s-err")
    assert [(e["status"], e["reason"]) for e in errs["port"]] == \
        [(e["status"], e["reason"]) for e in errs["jax"]] == [(409, "step_conflict")]
    assert [request(ports[s], "POST", "/v1/models/lstm/sessions/x/stream", {"inputs": []})[0]
            for s in ("jax", "port")] == [400, 400]
    time.sleep(0.1)
    assert not [t for t in threading.enumerate() if t.name.startswith("stream-writer")]


def test_sessions_disabled_is_503_in_both(pair):
    ports, _, _ = pair
    got = [request(ports[s], "POST", "/v1/models/m/sessions", {}) for s in ("jax", "port")]
    assert got[1][0] == got[0][0] == 503
    assert json.loads(got[1][2]) == json.loads(got[0][2])


# ====================================================== feedback + black box
def test_feedback_route_joins_a_served_request(pair, tmp_path, monkeypatch):
    _, _, archive = pair
    access, out = str(tmp_path / "access.log"), str(tmp_path / "labeled.jsonl")
    monkeypatch.setenv("DL4J_TPU_ACCESS_LOG", access)
    monkeypatch.setenv("DL4J_TPU_FEEDBACK_FILE", out)
    trace.enable(rate=1.0, capacity=64, seed=1)
    reg = ModelRegistry()
    srv = ModelServer(reg, worker_id="w-fb")
    try:
        reg.load("m", archive, warmup_example=X[:1], save_manifest=False, **BATCHER_KW)
        port = srv.start(0)
        status, headers, _ = post(port, n=1)
        tid = headers.get("X-Trace-Id")
        assert status == 200 and tid
        assert wait_until(lambda: __import__("os").path.exists(access), timeout_s=5)
        status, _, data = request(port, "POST", "/v1/feedback", {"trace_id": tid, "label": 2})
        obj = json.loads(data)
        assert status == 200 and obj["joined"] is True
        assert (obj["example"]["model"], obj["example"]["worker"], obj["example"]["label"]) == \
            ("m", "w-fb", 2)
        with open(out) as f:
            assert any(json.loads(ln)["trace_id"] == tid for ln in f.read().splitlines())
        assert request(port, "POST", "/v1/feedback", {"trace_id": "t-none", "label": 1})[0] == 202
        assert request(port, "POST", "/v1/feedback", b"not json")[0] == 400
        text = request(port, "GET", "/metrics")[2].decode()
        assert "serving_feedback_joined_total" in text
        assert "serving_feedback_orphaned_total" in text
    finally:
        srv.stop(shutdown_registry=True)
        trace.disable()


def test_worker_journal_stacks_and_bundle_endpoints():
    journal.enable(capacity=512)
    srv = ModelServer(ModelRegistry(), worker_id="w-bb")
    jsrv = JServer(JRegistry(), worker_id="w-bb")
    try:
        journal.emit("chaos.action", point="fixture", index=1, policy="P", action="a")
        code, obj = srv._handle_get("/v1/journal?limit=5")
        assert code == 200 and obj["worker"] == "w-bb"
        assert [e["type"] for e in obj["events"]] == ["chaos.action"]
        assert srv._handle_get("/v1/journal?type=registry.page_in")[1]["events"] == []
        assert srv._handle_get("/v1/journal?limit=nope")[0] == 400
        code, obj = srv._handle_get("/v1/debug/stacks")
        assert code == 200 and any("MainThread" in k for k in obj["stacks"])
        port = srv.start(0)
        status, h, data = request(port, "GET", "/v1/debug/bundle")
        assert status == 200 and h["Content-Type"] == "application/gzip"
        with tarfile.open(fileobj=io.BytesIO(data)) as tf:
            names = tf.getnames()
            manifest = json.load(tf.extractfile("manifest.json"))
            jpayload = json.load(tf.extractfile("journal.json"))
        with tarfile.open(fileobj=io.BytesIO(jblackbox.local_bundle(jsrv))) as tf:
            jnames = tf.getnames()
            jmanifest = json.load(tf.extractfile("manifest.json"))
        strip = lambda ns: sorted(n for n in ns if not n.startswith("stacks/"))  # noqa: E731
        assert strip(names) == strip(jnames)
        assert sorted(manifest) == sorted(jmanifest)
        assert manifest["kind"] == "worker" and manifest["contents"] == sorted(manifest["contents"])
        assert any(n.startswith("stacks/") for n in names)
        assert [e["type"] for e in jpayload["events"]] == ["chaos.action"]
        assert "journal_events_total" in srv._render_metrics()
        assert blackbox.local_bundle(srv)[:2] == b"\x1f\x8b"
    finally:
        srv.stop()
        journal.enable(capacity=1024)
