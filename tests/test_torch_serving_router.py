"""The port's ``FleetRouter`` against the JAX package's.

- **Stub workers** (``tests/test_router.py:183-331``): hedging returns
  exactly one response and counts the discarded duplicate, the hedge
  carries the remaining deadline, failover on a worker dying mid-request,
  breaker isolation of a byzantine worker, ``Retry-After`` windows, an
  explicit 503 when every worker sheds or none is healthy; journaled shed
  windows and rolling-deploy stages (``tests/test_journal.py:246``,
  ``:289``).
- **Ranking**: the rendezvous order equals the JAX router's for the same
  worker ids and model names.
- **Trio** (``tests/test_router.py:390-480``): three port workers; routed
  answers bit for bit the port model's ``output`` at the serving bucket,
  a chaos forward fault absorbed by failover, the deadline header honoured,
  ``/metrics`` and the profiler hook. Both routers in front of the trio
  answer every GET endpoint with the same status and keys and render the
  same ``/metrics`` families.
- **Across packages**: the port's router in front of a JAX worker, and the
  JAX router in front of a port worker, over JSON and the binary wire,
  answer bit for bit as the same-package pairs do.
- **Sessions**: affinity, no hedging of steps, failover as migration over a
  shared spill directory, the pin published through an attached config
  (the JAX package's ``FleetConfig``: ``attach_config`` takes any object).
"""

import json
import socket
import time

import numpy as np
import pytest

from _torch_serving_host import (_PORT_EXTRA, BATCHER_KW, BUCKET, OK_BODY, F, StubWorker, T, X,
                                 _families, _keys, _norm, align_compile_caches, jax_archive,
                                 lstm, mlp,
                                 oracle_outs, port_on_cpu, post, request,  # noqa: F401
                                 set_port_cpu, wait_ready, wait_until)
from deeplearning4j_tpu.runtime import journal as jjournal
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
from deeplearning4j_tpu.serving import ModelServer as JServer
from deeplearning4j_tpu.serving.router import FleetRouter as JRouter
from deeplearning4j_tpu.serving.router import StaticFleet as JStaticFleet
from deeplearning4j_tpu_torch.runtime import journal
from deeplearning4j_tpu_torch.runtime.chaos import ChaosController, FailNth
from deeplearning4j_tpu_torch.serving import (FleetRouter, ModelRegistry, ModelServer,
                                              StaticFleet, wire)


@pytest.fixture
def stub_pair():
    a, b = StubWorker(OK_BODY), StubWorker(OK_BODY)
    router = FleetRouter(StaticFleet({"wa": a.address, "wb": b.address}),
                         probe_interval_s=0.05, hedge_initial_ms=50.0)
    try:
        port = router.start(0)
        ranked = [v.worker_id for v in router.ranked_workers("m")]
        yield router, port, {"wa": a, "wb": b}, ranked
    finally:
        router.stop()
        a.stop()
        b.stop()


# =================================================== stub-worker semantics
def test_hedge_returns_exactly_one_response_and_counts_duplicate(stub_pair):
    router, port, stubs, ranked = stub_pair
    stubs[ranked[0]].delay_s = 0.5
    status, _, out = post(port, timeout_ms=5000)
    assert status == 200 and out == json.loads(OK_BODY)
    snap = router.metrics.snapshot()
    assert snap["hedges_total"] == 1 and snap["hedge_wins_total"] == 1
    assert stubs[ranked[1]].hits == 1
    assert wait_until(lambda: router.metrics.snapshot()["hedges_discarded_total"] == 1)
    assert router.metrics.snapshot()["responses_total"] == 1


def test_hedge_carries_remaining_deadline_not_a_fresh_one(stub_pair):
    router, port, stubs, ranked = stub_pair
    primary, secondary = stubs[ranked[0]], stubs[ranked[1]]
    primary.delay_s = 0.5
    assert post(port, timeout_ms=2000)[0] == 200
    first = float(primary.headers_seen[0]["X-Deadline-Ms"])
    hedged = float(secondary.headers_seen[0]["X-Deadline-Ms"])
    assert first <= 2000.0 and 500.0 < hedged < first - 25.0, (first, hedged)
    assert primary.headers_seen[0]["X-Request-Id"] == secondary.headers_seen[0]["X-Request-Id"]


def test_failover_when_worker_dies_mid_request(stub_pair):
    router, port, stubs, ranked = stub_pair
    stubs[ranked[0]].mode = "die"
    status, _, out = post(port, timeout_ms=5000)
    assert status == 200 and out == json.loads(OK_BODY)
    assert router.metrics.snapshot()["failovers_total"] >= 1
    assert router.workers()[ranked[0]].failures_total >= 1


def test_byzantine_worker_isolated_by_breaker(stub_pair):
    router, port, stubs, ranked = stub_pair
    bad = stubs[ranked[0]]
    bad.mode = "error"
    for _ in range(8):
        status, _, out = post(port, timeout_ms=5000)
        assert status == 200 and out == json.loads(OK_BODY)
    assert bad.hits <= 4
    assert router.workers()[ranked[0]].breaker.snapshot()["state"] == "OPEN"
    hits_when_open = bad.hits
    for _ in range(4):
        assert post(port, timeout_ms=5000)[0] == 200
    assert bad.hits == hits_when_open


def test_retry_after_hint_prevents_hammering_a_shedding_worker(stub_pair):
    router, port, stubs, ranked = stub_pair
    shedding = stubs[ranked[0]]
    shedding.mode, shedding.retry_after_ms = "shed", 600.0
    for _ in range(6):
        assert post(port, timeout_ms=5000)[0] == 200
    assert shedding.hits == 1
    assert router.metrics.snapshot()["shed_skips_total"] >= 5
    view = router.workers()[ranked[0]]
    assert view.shedding()
    shedding.mode = "ok"
    view.shed_until = time.monotonic()
    for _ in range(3):
        assert post(port, timeout_ms=5000)[0] == 200
    assert shedding.hits >= 2


def test_all_workers_shedding_returns_503_with_retry_after(stub_pair):
    router, port, stubs, ranked = stub_pair
    for s in stubs.values():
        s.mode, s.retry_after_ms = "shed", 300.0
    status, headers, data = request(port, "POST", "/v1/models/m/predict",
                                    {"inputs": X[:2].tolist(), "timeout_ms": 5000})
    body = json.loads(data)
    assert status == 503 and body["reason"] == "overloaded"
    assert 0.0 < body["retry_after_ms"] <= 300.0
    assert float(headers["Retry-After-Ms"]) > 0


def test_no_healthy_workers_is_an_explicit_503():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    router = FleetRouter(StaticFleet({"w0": dead}), probe_interval_s=0.05)
    try:
        port = router.start(0)
        status, _, data = request(port, "POST", "/v1/models/m/predict",
                                  {"inputs": X[:2].tolist(), "timeout_ms": 1000})
        assert status == 503 and json.loads(data)["reason"] == "no_healthy_workers"
        assert request(port, "GET", "/healthz")[0] == 200
        assert request(port, "GET", "/readyz")[0] == 503
    finally:
        router.stop()


def test_shed_window_and_rolling_deploy_stages_are_journaled(tmp_path):
    j = journal.enable(capacity=512)
    shed = StubWorker(OK_BODY)
    shed.mode, shed.retry_after_ms = "shed", 700.0
    router = FleetRouter(StaticFleet({"w0": shed.address}), hedge_enabled=False,
                         probe_interval_s=0.05)
    try:
        port = router.start(0)
        assert request(port, "POST", "/v1/models/m/predict",
                       {"inputs": [[0.0]], "timeout_ms": 500})[0] == 503
        evs = j.events(types={"router.shed_window"})
        assert evs and evs[0]["attrs"]["worker"] == "w0"
        assert evs[0]["attrs"]["window_ms"] == pytest.approx(700.0, abs=1.0)
        assert any(e["attrs"]["worker"] == "w0" for e in j.events(types={"router.worker_ready"}))
    finally:
        router.stop()
        shed.stop()

    ok = StubWorker(OK_BODY)

    class RestartFleet:
        restarted = []

        def endpoints(self):
            return {"w0": ok.address}

        def worker_ids(self):
            return ["w0"]

        def restart_worker(self, wid, archive=None, version=None):
            self.restarted.append((wid, archive, version))

    fleet = RestartFleet()
    router = FleetRouter(fleet, probe_interval_s=0.05)
    try:
        router.start(0)
        archive = str(tmp_path / "model-v9.zip")
        open(archive, "wb").write(b"zip")
        report = router.rolling_deploy(archive, version=9, ready_timeout_s=10)
        assert fleet.restarted == [("w0", archive, 9)] and "w0" in report["workers"]
        assert [e["attrs"]["stage"] for e in j.events(types={"control.deploy_stage"})] == \
            ["drained", "readmitted", "completed"]
        with pytest.raises(TypeError, match="restart_worker"):
            FleetRouter(StaticFleet({"w0": ok.address})).rolling_deploy(archive)
    finally:
        router.stop()
        ok.stop()
        journal.enable(capacity=1024)


# ================================================================ ranking
@pytest.mark.parametrize("n_workers", [1, 2, 5, 9])
def test_rendezvous_ranking_equals_the_jax_router(n_workers):
    eps = {f"w{i}": f"127.0.0.1:{9000 + i}" for i in range(n_workers)}
    ours, theirs = FleetRouter(StaticFleet(eps)), JRouter(JStaticFleet(eps))
    for model in ("m", "model-a", "bert", "char-rnn", "__listing__", "lstm/s-1"):
        order = [v.worker_id for v in ours.ranked_workers(model)]
        assert order == [v.worker_id for v in theirs.ranked_workers(model)], model
        assert sorted(order) == sorted(eps)
    orders = {tuple(v.worker_id for v in ours.ranked_workers(f"model-{k}")) for k in "abcdefgh"}
    assert n_workers == 1 or len(orders) > 1  # spreads across models


# ================================================================== trio
@pytest.fixture(scope="module")
def trio():
    """Three port workers over identically seeded port nets, and the oracle."""
    set_port_cpu()
    oracle = mlp(False)
    servers, endpoints = [], {}
    try:
        for i in range(3):
            reg = ModelRegistry()
            srv = ModelServer(reg, worker_id=f"w{i}")
            servers.append(srv)
            reg.register("m", mlp(False), warmup_example=X[:1], **BATCHER_KW)
            endpoints[f"w{i}"] = f"127.0.0.1:{srv.start(0)}"
        yield endpoints, oracle
    finally:
        for srv in servers:
            srv.stop(shutdown_registry=True)


def _port_out(oracle):
    return lambda x: oracle.output(x).numpy()


def test_routes_consistently_and_bit_identical_to_oracle(trio):
    endpoints, oracle = trio
    router = FleetRouter(StaticFleet(endpoints), probe_interval_s=0.05, hedge_initial_ms=2000.0)
    try:
        port = router.start(0)
        for k in range(12):
            n, ofs = 1 + k % 4, (3 * k) % 8
            status, headers, out = post(port, n=n, ofs=ofs)
            assert status == 200
            got = np.asarray(out["outputs"], np.float32)
            assert any(np.array_equal(got, ref) for ref in oracle_outs(_port_out(oracle), n, ofs))
        served_by = router.metrics.snapshot()["worker_requests"]
        assert served_by == {router.ranked_workers("m")[0].worker_id: 12}
    finally:
        router.stop()


def test_chaos_forward_fault_is_absorbed_by_failover(trio):
    endpoints, oracle = trio
    router = FleetRouter(StaticFleet(endpoints), probe_interval_s=0.05, hedge_initial_ms=2000.0)
    try:
        port = router.start(0)
        with ChaosController(seed=3) as c:
            c.on("serving.router.forward", FailNth(1))
            status, _, out = post(port, n=2)
        assert status == 200
        assert any(np.array_equal(np.asarray(out["outputs"], np.float32), ref)
                   for ref in oracle_outs(_port_out(oracle), 2))
        assert router.metrics.snapshot()["failovers_total"] >= 1
        assert any(ev[0] == "serving.router.forward" for ev in c.events)
    finally:
        router.stop()


def test_worker_honors_deadline_header_over_http(trio):
    endpoints, _ = trio
    port = int(sorted(endpoints.values())[0].rsplit(":", 1)[1])
    for body in ({"inputs": X[:1].tolist()}, {"inputs": X[:1].tolist(), "timeout_ms": 60000}):
        assert request(port, "POST", "/v1/models/m/predict", body,
                       headers={"X-Deadline-Ms": "0.001"})[0] == 504


def test_router_metrics_prometheus_rendering(trio):
    from deeplearning4j_tpu_torch.runtime import profiler
    endpoints, _ = trio
    router = FleetRouter(StaticFleet(endpoints), probe_interval_s=0.05, hedge_initial_ms=2000.0)
    try:
        port = router.start(0)
        assert post(port, n=1)[0] == 200
        text = request(port, "GET", "/metrics")[2].decode()
        for metric in ("router_requests_total 1", "router_responses_total 1",
                       "router_hedges_total", "router_failovers_total",
                       "router_worker_healthy", "router_latency_seconds"):
            assert metric in text, metric
        stats = profiler.router_stats()
        assert stats["requests_total"] == 1 and stats["responses_total"] == 1
    finally:
        router.stop()


ROUTER_GETS = ["/healthz", "/readyz", "/fleet", "/v1/models", "/v1/models/m", "/v1/slo",
               "/v1/capacity", "/v1/traces", "/v1/traces?limit=x", "/v1/journal?limit=3",
               "/v1/debug/stacks", "/v1/peers", "/v1/delivery", "/v1/autoscaler", "/nope"]


def test_both_routers_answer_every_get_alike(trio, monkeypatch, tmp_path):
    """The JAX router and the port's in front of the same three port
    workers: every GET endpoint's status and keys, ``/metrics`` families,
    and the fleet bundle's entry names."""
    import io
    import tarfile
    endpoints, _ = trio
    align_compile_caches(monkeypatch, tmp_path)
    routers = {"jax": JRouter(JStaticFleet(endpoints), probe_interval_s=0.05,
                              hedge_initial_ms=2000.0),
               "port": FleetRouter(StaticFleet(endpoints), probe_interval_s=0.05,
                                   hedge_initial_ms=2000.0)}
    try:
        ports = {s: r.start(0) for s, r in routers.items()}
        for p in ports.values():
            assert post(p, n=2)[0] == 200
        for j in (journal, jjournal):  # the same one event in both rings
            j.enable(capacity=64)
            j.emit("chaos.action", point="fixture", index=1, policy="P", action="a")
        for path in ROUTER_GETS:
            (js, _, jd), (ps, _, pd) = (request(ports[s], "GET", path) for s in ("jax", "port"))
            assert ps == js, path
            jk, pk = _norm(_keys(json.loads(jd))), _norm(_keys(json.loads(pd)))
            extra = {"/workers/*" + k for k in _PORT_EXTRA} | _PORT_EXTRA
            assert pk - jk <= extra and jk <= pk, (path, sorted(pk - jk), sorted(jk - pk))
        texts = {s: request(ports[s], "GET", "/metrics")[2].decode() for s in ports}
        assert _families(texts["port"]) == _families(texts["jax"])
        names = {}
        for s in ports:
            status, _, data = request(ports[s], "GET", "/v1/debug/bundle", timeout=60)
            assert status == 200
            with tarfile.open(fileobj=io.BytesIO(data)) as tf:
                names[s] = sorted(n for n in tf.getnames() if not n.startswith("stacks/"))
        assert names["port"] == names["jax"]

        class Autoscaler:
            def report(self):
                return {"decisions": []}

        routers["port"].attach_autoscaler(Autoscaler())
        assert json.loads(request(ports["port"], "GET", "/v1/autoscaler")[2]) == \
            {"decisions": []}
    finally:
        for r in routers.values():
            r.stop()
        journal.enable(capacity=1024)
        jjournal.enable(capacity=1024)


# ========================================================= across packages
@pytest.fixture(scope="module")
def xpkg(tmp_path_factory):
    """One JAX and one port worker over the same JAX archive."""
    set_port_cpu()
    archive = jax_archive(tmp_path_factory.mktemp("xpkg") / "m.zip")
    jreg, reg = JRegistry(), ModelRegistry()
    servers = {"jax": JServer(jreg, worker_id="wj"), "port": ModelServer(reg, worker_id="wp")}
    try:
        for r in (jreg, reg):
            r.load("m", archive, warmup_example=X[:1], save_manifest=False, **BATCHER_KW)
        eps = {s: f"127.0.0.1:{srv.start(0)}" for s, srv in servers.items()}
        yield eps, {"jax": jreg, "port": reg}
    finally:
        for srv in servers.values():
            srv.stop(shutdown_registry=True)


def _ask(port, n, binary):
    if binary:
        status, h, data = request(port, "POST", "/v1/models/m/predict",
                                  wire.encode_predict_request(X[:n], timeout_ms=10000),
                                  headers={"Content-Type": wire.CONTENT_TYPE,
                                           "X-Request-Id": f"x-{n}"})
        assert status == 200 and h["Content-Type"] == wire.CONTENT_TYPE
        _, version, out, fr = wire.decode_predict_response(data)
        arr = np.array(out)
        out = None
        fr.close()
    else:
        status, h, data = request(port, "POST", "/v1/models/m/predict",
                                  {"inputs": X[:n].tolist(), "dtype": "float32",
                                   "timeout_ms": 10000}, headers={"X-Request-Id": f"x-{n}"})
        assert status == 200
        arr = np.asarray(json.loads(data)["outputs"], np.float32)
    return arr, (h.get("X-Worker-Id"), h.get("X-Model-Version"), h.get("X-Request-Id"))


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
@pytest.mark.parametrize("worker", ["jax", "port"])
def test_cross_package_router_and_worker_answer_as_same_package_pairs(xpkg, worker, binary):
    eps, regs = xpkg
    routers = {"jax": JRouter(JStaticFleet({"w": eps[worker]}), probe_interval_s=0.05,
                              hedge_initial_ms=5000.0),
               "port": FleetRouter(StaticFleet({"w": eps[worker]}), probe_interval_s=0.05,
                                   hedge_initial_ms=5000.0)}
    try:
        ports = {s: r.start(0) for s, r in routers.items()}
        wait_ready(routers["port"], 1)
        wait_ready(routers["jax"], 1)
        for n in (1, 3, 4):
            got = {s: _ask(ports[s], n, binary) for s in ports}
            assert got["port"][0].tobytes() == got["jax"][0].tobytes(), (worker, n)
            assert got["port"][1] == got["jax"][1]
            want = np.asarray(regs[worker].predict("m", X[:n]))
            assert got["port"][0].tobytes() == want.tobytes()
        snaps = {s: r.metrics.snapshot() for s, r in routers.items()}
        assert snaps["port"]["wire_requests_total"] == snaps["jax"]["wire_requests_total"]
        assert snaps["port"]["wire_downgrades_total"] == snaps["jax"]["wire_downgrades_total"] == 0
    finally:
        for r in routers.values():
            r.stop()


# ================================================================ sessions
def test_router_session_affinity_failover_and_fleet_aggregation(tmp_path):
    from deeplearning4j_tpu.serving.control_plane import FleetConfig
    j = journal.enable(capacity=2048)
    spill = tmp_path / "spill"
    spill.mkdir()
    servers, endpoints = {}, {}
    oracle_net = lstm(False)
    router = None
    try:
        for wid in ("wa", "wb"):
            reg = ModelRegistry()
            servers[wid] = ModelServer(reg, worker_id=wid, session_dir=str(spill),
                                       session_kw={"start_evictor": False})
            reg.register("lstm", lstm(False), max_batch_size=8, replicas=1, pipeline_depth=0)
            reg.get("lstm").batcher.enable_sessions(np.zeros((1, T, F), np.float32),
                                                    session_bucket=BUCKET)
            endpoints[wid] = f"127.0.0.1:{servers[wid].start(0)}"
        cfg = FleetConfig(str(tmp_path / "fleet.json"))
        router = FleetRouter(StaticFleet(endpoints), probe_interval_s=0.05,
                             hedge_initial_ms=1.0)  # would hedge at once...
        router.attach_config(cfg)
        rport = router.start(0)
        wait_ready(router, 2)
        rng = np.random.default_rng(43)
        chunks = [rng.standard_normal((1, T, F)).astype(np.float32) for _ in range(6)]
        oracle = []
        for c in chunks:
            xb = np.zeros((BUCKET, T, F), np.float32)
            xb[0] = c[0]
            oracle.append(oracle_net.rnn_time_step(xb).numpy()[:1])
        status, _, data = request(rport, "POST", "/v1/models/lstm/sessions", {})
        obj = json.loads(data)
        assert status == 200
        sid, pinned = obj["session"], obj["worker"]
        assert (cfg.snapshot().get("sessions") or {}).get(f"lstm/{sid}") == pinned

        def step(i, timeout=30):
            status, h, data = request(rport, "POST", f"/v1/models/lstm/sessions/{sid}/step",
                                      {"inputs": chunks[i].tolist(), "step": i},
                                      timeout=timeout)
            assert status == 200, data
            out = np.asarray(json.loads(data)["outputs"], np.float32)
            assert out.tobytes() == oracle[i].tobytes(), i
            return h

        for i in range(3):
            assert step(i)["X-Worker-Id"] == pinned
        snap = router.metrics.snapshot()
        assert snap["hedges_total"] == 0  # ...but steps are never hedged
        assert snap["session_requests_total"] == 4
        servers[pinned].stop()
        other = "wb" if pinned == "wa" else "wa"
        assert step(3, timeout=60)["X-Worker-Id"] == other
        assert router.metrics.snapshot()["session_migrations_total"] >= 1
        assert (cfg.snapshot().get("sessions") or {}).get(f"lstm/{sid}") == other
        assert any(e["type"] == "session.migrate" for e in j.events())
        for i in (4, 5):
            step(i)
        assert router.fleet_capacity()["sessions"]["tracked"] >= 1
        assert "fleet_capacity_sessions_tracked" in router.render_fleet_capacity()
        assert request(rport, "DELETE", f"/v1/models/lstm/sessions/{sid}")[0] == 200
        assert f"lstm/{sid}" not in (cfg.snapshot().get("sessions") or {})
    finally:
        if router is not None:
            router.stop()
        for srv in servers.values():
            srv.stop(shutdown_registry=True)
        journal.enable(capacity=1024)


def test_drain_readmit_and_await_ready(trio):
    endpoints, _ = trio
    router = FleetRouter(StaticFleet(endpoints), probe_interval_s=0.05, hedge_initial_ms=2000.0)
    try:
        port = router.start(0)
        first = router.ranked_workers("m")[0].worker_id
        router.drain(first, timeout_s=5.0)
        for _ in range(3):
            status, headers, _ = post(port, n=1)
            assert status == 200 and headers["X-Worker-Id"] != first
        router.readmit(first)
        assert router.await_ready(first, timeout_s=10.0) >= 0.0
        assert post(port, n=1)[1]["X-Worker-Id"] == first
    finally:
        router.stop()
