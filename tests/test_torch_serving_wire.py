"""The port's binary wire transport against the JAX package.

- **Codec across packages**: the same arrays and fields encode to the same
  bytes in both packages (float32, float64, int8, int64, multi-input dicts,
  empty arrays and fields, single and multi-output responses), each package
  decodes the other's frames, and the JSON transcodes agree byte for byte.
- **Damage**: corrupt, truncated and bit-flipped frames (by hand and
  through the ``serving.wire.frame`` chaos byte point) raise
  ``WireProtocolError`` and count in ``serving_wire_*``, never decode to a
  tensor; shared-memory frames round-trip (across packages too) behind the
  size gate.
- **Pools** (``tests/test_wire.py:207-306``) and the **duo** cases
  (``:307-503``) over two port ``ModelServer`` workers serving one JAX
  archive, one wire-enabled and one JSON-only, behind the port's router.
"""

import json
import time

import numpy as np
import pytest

from _torch_serving_host import (BATCHER_KW, X, jax_archive, port_on_cpu,  # noqa: F401
                                 set_port_cpu, wait_ready)
from deeplearning4j_tpu.serving import wire as jwire
from deeplearning4j_tpu_torch.runtime import chaos, journal
from deeplearning4j_tpu_torch.serving import FleetRouter, ModelRegistry, ModelServer, StaticFleet
from deeplearning4j_tpu_torch.serving import wire
from deeplearning4j_tpu_torch.serving.resilience import CircuitState
from deeplearning4j_tpu_torch.serving.router import _Attempt

_I8 = (X[:3] * 20).astype(np.int8)
REQUESTS = {
    "float32": dict(inputs=X[:3], timeout_ms=1234, headers={"X-Request-Id": "r-1",
                                                            "X-Deadline-Ms": "250"}),
    "float64": dict(inputs=X[:2].astype(np.float64)),
    "int8": dict(inputs=_I8, headers={"X-Trace-Id": "t", "X-Session-Step": "3"}),
    "int64": dict(inputs=np.arange(24, dtype=np.int64).reshape(2, 12) - 7),
    "multi": dict(inputs={"a": X[:2], "b": _I8[:2, :4]}, timeout_ms=5),
    "empty_array": dict(inputs=np.zeros((0, 8), np.float32)),
    "empty_fields": dict(inputs=X[:1], fields={}),
    "list_with_dtype": dict(inputs=X[:2].tolist(), dtype="float32"),
}
RESPONSES = {
    "single": ("m", 3, X[:2], {"worker_id": "w9", "model_version": "3"}),
    "multi": ("g", 1, [X[:2], np.arange(4, dtype=np.int64)], {}),
    "bf16_widened": ("m", None, X[:1].astype(np.float64), None),
    "no_outputs": ("m", 2, [], {}),
}


def _tensor_bytes(x):
    if isinstance(x, dict):
        return {k: (np.asarray(v).dtype.str, np.asarray(v).shape, np.asarray(v).tobytes())
                for k, v in x.items()}
    if isinstance(x, list):
        return [_tensor_bytes(v) for v in x]
    a = np.asarray(x)
    return a.dtype.str, a.shape, a.tobytes()


# ==================================================================== codec
@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_request_frames_byte_for_byte_across_packages(case):
    kw = REQUESTS[case]
    ours, theirs = wire.encode_predict_request(**kw), jwire.encode_predict_request(**kw)
    assert ours == theirs
    # each package decodes the other's frame to the same tensors and fields
    for raw, dec in ((theirs, wire.decode_predict_request), (ours, jwire.decode_predict_request)):
        x, timeout_ms, fields, fr = dec(raw)
        try:
            want = kw["inputs"]
            if isinstance(want, list):
                want = np.asarray(want, np.float32)
            assert _tensor_bytes(x) == _tensor_bytes(want)
            assert timeout_ms == (None if kw.get("timeout_ms") is None
                                  else float(kw["timeout_ms"]))
            assert fields == wire.headers_to_fields(kw.get("headers"))
            if not isinstance(x, dict):
                assert not x.flags.writeable  # a view over the frame
        finally:
            x = None
            fr.close()
    # the downgrade transcode to JSON is the same body
    assert wire.frame_to_json_body(theirs) == jwire.frame_to_json_body(ours)


@pytest.mark.parametrize("case", sorted(RESPONSES))
def test_response_frames_byte_for_byte_across_packages(case):
    model, version, outputs, fields = RESPONSES[case]
    ours = wire.encode_predict_response(model, version, outputs, fields=fields)
    theirs = jwire.encode_predict_response(model, version, outputs, fields=fields)
    assert ours == theirs
    for raw, dec in ((theirs, wire.decode_predict_response),
                     (ours, jwire.decode_predict_response)):
        name, ver, out, fr = dec(raw)
        try:
            assert (name, ver) == (model, version)
            assert _tensor_bytes(out) == _tensor_bytes(outputs)
            assert fr.meta["fields"] == dict(fields or {})
        finally:
            out = None
            fr.close()
    assert wire.response_to_jsonable(theirs) == jwire.response_to_jsonable(ours)


def test_header_field_mapping_matches_the_jax_registry():
    assert wire.HEADER_FIELDS == jwire.HEADER_FIELDS
    assert wire.CONTENT_TYPE == jwire.CONTENT_TYPE
    headers = {k: f"v{i}" for i, k in enumerate(wire.HEADER_FIELDS)}
    fields = wire.headers_to_fields(headers)
    assert set(fields) == set(wire.HEADER_FIELDS.values())
    assert wire.fields_to_headers(fields) == headers
    assert wire.headers_to_fields({"x-request-id": "a", "X-Mystery": "b", "Content-Type": "c"}) \
        == {"request_id": "a"}
    assert wire.fields_to_headers({"request_id": "a", "mystery": "b"}) == {"X-Request-Id": "a"}


def _damaged():
    raw = wire.encode_predict_request(X[:2], timeout_ms=500)
    flipped = bytearray(raw)
    flipped[len(raw) // 2] ^= 0x01
    bad_meta = bytearray(raw)
    bad_meta[24] ^= 0xFF
    return {"bit_flip": bytes(flipped), "truncated": raw[:len(raw) - 3],
            "bad_magic": b"NOPE" + raw[4:], "bad_version": raw[:4] + b"\xff" + raw[5:],
            "bad_meta": bytes(bad_meta), "header_only": raw[:10],
            "wrong_kind": wire.encode_predict_response("m", 1, X[:1])}


@pytest.mark.parametrize("case", sorted(_damaged()))
def test_damaged_frames_raise_and_count_in_both_packages(case):
    bad = _damaged()[case]
    wire.reset_counters()
    jwire.reset_counters()
    with pytest.raises(wire.WireProtocolError):
        wire.decode_predict_request(bad)
    with pytest.raises(jwire.WireProtocolError):
        jwire.decode_predict_request(bad)
    assert wire.counters()["protocol_errors_total"] >= 1
    assert wire.counters()["frames_decoded_total"] == \
        jwire.counters()["frames_decoded_total"]
    text = "\n".join(wire.render_prometheus())
    assert f"serving_wire_protocol_errors_total {wire.counters()['protocol_errors_total']}" \
        in text
    assert [ln.split()[0] for ln in wire.render_prometheus()] == \
        [ln.split()[0] for ln in jwire.render_prometheus()]


def test_bad_tensor_meta_and_bounds_are_protocol_errors():
    """A frame with a valid CRC but nonsense tensor tags (an object dtype,
    bounds past the payload, a shape that does not fit) never decodes."""
    for tensors in ([{"name": None, "dtype": "|O", "shape": [1], "offset": 0, "nbytes": 8}],
                    [{"name": None, "dtype": "<f4", "shape": [4], "offset": 0, "nbytes": 64}],
                    [{"name": None, "dtype": "<f4", "shape": [3], "offset": 0, "nbytes": 16}],
                    []):
        raw = wire.encode_frame(wire.KIND_REQUEST, {"tensors": tensors, "fields": {}},
                                [np.zeros(4, np.float32).tobytes()])
        assert raw == jwire.encode_frame(jwire.KIND_REQUEST, {"tensors": tensors, "fields": {}},
                                         [np.zeros(4, np.float32).tobytes()])
        with pytest.raises(wire.WireProtocolError):
            wire.decode_predict_request(raw)
        with pytest.raises(jwire.WireProtocolError):
            jwire.decode_predict_request(raw)
    with pytest.raises(wire.WireProtocolError):
        wire.encode_predict_request(np.array(["a", "b"]))


def test_chaos_byte_point_drills_flip_and_truncate():
    wire.reset_counters()
    for policy in (chaos.CorruptBytes(n_bytes=4, mode="flip"), chaos.CorruptBytes(mode="truncate")):
        with chaos.ChaosController(seed=3) as c:
            c.on("serving.wire.frame", policy)
            raw = wire.encode_predict_request(X[:4])
            with pytest.raises(wire.WireProtocolError):
                _, _, _, fr = wire.decode_predict_request(raw)
                fr.close()  # pragma: no cover (must raise)
    assert wire.counters()["protocol_errors_total"] == 2
    raw = wire.encode_predict_request(X[:4])
    got, _, _, fr = wire.decode_predict_request(raw)
    assert got.tobytes() == X[:4].tobytes()
    got = None
    fr.close()
    assert wire.counters()["protocol_errors_total"] == 2


def test_shm_frames_cross_packages_behind_the_size_gate():
    raw = wire.encode_predict_request(X)  # 512 payload bytes
    small, seg = wire.frame_to_shm(raw, min_bytes=100000)
    assert small is raw and seg is None
    for to_shm, dec in ((wire.frame_to_shm, jwire.decode_predict_request),
                        (jwire.frame_to_shm, wire.decode_predict_request)):
        shm_raw, seg = to_shm(raw, min_bytes=128)
        assert seg is not None and len(shm_raw) < len(raw)
        try:
            got, _, _, fr = dec(shm_raw)
            assert got.tobytes() == X.tobytes()
            got = None
            fr.close()
        finally:
            wire.release_shm(seg)
    # a released segment cannot be attached: an explicit protocol error
    shm_raw, seg = wire.frame_to_shm(raw, min_bytes=128)
    wire.release_shm(seg)
    with pytest.raises(wire.WireProtocolError):
        wire.decode_predict_request(shm_raw)


# ================================================================ the duo
@pytest.fixture(scope="module")
def duo(tmp_path_factory):
    """A wire-enabled and a JSON-only port worker over one JAX archive, and
    the in-process answer for X[:4] (bucket 4, exact)."""
    set_port_cpu()
    archive = jax_archive(tmp_path_factory.mktemp("wire") / "m.zip")
    servers, registries, endpoints = [], [], {}
    try:
        for i, wire_enabled in enumerate((True, False)):
            reg = ModelRegistry()
            registries.append(reg)
            reg.load("m", archive, warmup_example=X[:1], save_manifest=False, **BATCHER_KW)
            srv = ModelServer(reg, worker_id=f"w{i}", wire_enabled=wire_enabled)
            servers.append(srv)
            endpoints[f"w{i}"] = f"127.0.0.1:{srv.start(0)}"
        ref = np.asarray(registries[0].predict("m", X[:4]))
        yield endpoints, registries, servers, ref
    finally:
        for srv in servers:
            srv.stop(shutdown_registry=True)
        for reg in registries:
            reg.shutdown()


def _predict_wire(pool, port, frame, timeout=60):
    return pool.request(f"127.0.0.1:{port}", "POST", "/v1/models/m/predict", body=frame,
                        headers={"Content-Type": wire.CONTENT_TYPE}, timeout=timeout)


def _decode_any(headers, data):
    ctype = next((v for k, v in headers.items() if k.lower() == "content-type"), "")
    if ctype.split(";")[0].strip() == wire.CONTENT_TYPE:
        _, _, out, fr = wire.decode_predict_response(data)
        try:
            return np.array(out)
        finally:
            out = None
            fr.close()
    return np.asarray(json.loads(data)["outputs"], dtype=np.float32)


def test_pool_reuses_connections_and_bounds_idle(duo):
    address = duo[0]["w0"]
    pool = wire.ConnectionPool(max_idle_per_endpoint=2)
    try:
        for _ in range(5):
            assert pool.request(address, "GET", "/healthz", body=None, headers={},
                                timeout=30)[0] == 200
        snap = pool.snapshot()
        assert snap["created_total"] == 1 and snap["reused_total"] == 4
        assert pool.idle_count(address) == 1
        pool.invalidate(address)
        assert pool.idle_count(address) == 0
        assert pool.snapshot()["invalidated_total"] == 1
    finally:
        pool.close()


def test_pool_retry_once_on_stale_reused_connection(duo):
    address = duo[0]["w0"]
    pool = wire.ConnectionPool()
    try:
        assert pool.request(address, "GET", "/healthz", body=None, headers={},
                            timeout=30)[0] == 200
        assert pool.idle_count(address) == 1
        parked, _t = pool._idle[address][-1]
        parked.sock.close()
        assert pool.request(address, "GET", "/healthz", body=None, headers={},
                            timeout=30)[0] == 200
        snap = pool.snapshot()
        assert (snap["discarded_total"], snap["created_total"], snap["reused_total"]) == (1, 2, 1)
    finally:
        pool.close()


def test_breaker_open_and_restart_drop_pooled_connections(duo):
    endpoints = duo[0]

    class MutableFleet:
        def __init__(self, eps):
            self.eps = dict(eps)

        def endpoints(self):
            return dict(self.eps)

    fleet = MutableFleet({"w0": endpoints["w0"]})
    router = FleetRouter(fleet, probe_interval_s=3600.0)
    try:
        router._sync_views()
        view = router.workers()["w0"]
        assert router.pool.request(view.address, "GET", "/healthz", body=None, headers={},
                                   timeout=30)[0] == 200
        assert router.pool.idle_count(view.address) == 1
        while view.breaker.state is not CircuitState.OPEN:
            view.breaker.record_failure()
        attempt = _Attempt(view, hedged=False)
        attempt.status = 500
        router._classify(attempt)
        assert router.pool.idle_count(view.address) == 0
        router.pool.request(view.address, "GET", "/healthz", body=None, headers={}, timeout=30)
        assert router.pool.idle_count(view.address) == 1
        old_address = view.address
        fleet.eps["w0"] = endpoints["w1"]
        router._sync_views()
        assert router.pool.idle_count(old_address) == 0
        assert router.pool.snapshot()["invalidated_total"] >= 2
    finally:
        router.stop()


def test_pool_no_fd_leak(duo, fd_guard):
    pool = wire.ConnectionPool()
    try:
        for _ in range(6):
            pool.request(duo[0]["w0"], "GET", "/healthz", body=None, headers={}, timeout=30)
    finally:
        pool.close()


def _router(endpoints, **kw):
    kw.setdefault("probe_interval_s", 0.05)
    kw.setdefault("hedge_initial_ms", 2000.0)
    return FleetRouter(StaticFleet(endpoints), **kw)


def test_binary_end_to_end_bit_identical_and_zero_copy(duo):
    endpoints, registries, _, ref = duo
    router = _router({"w0": endpoints["w0"]})
    port = router.start(0)
    pool = wire.ConnectionPool()
    wire.reset_counters()
    zero_before = registries[0].get("m").metrics.snapshot()["zero_copy_rows_total"]
    try:
        wait_ready(router, 1)
        frame = wire.encode_predict_request(X[:4], timeout_ms=10000)
        for _ in range(3):
            status, headers, data = _predict_wire(pool, port, frame)
            assert status == 200
            assert _decode_any(headers, data).tobytes() == ref.tobytes()
        snap = router.metrics.snapshot()
        assert snap["wire_requests_total"] == 3 and snap["wire_downgrades_total"] == 0
        assert router.workers()["w0"].wire_ok is True
        assert wire.counters()["protocol_errors_total"] == 0
        zero_after = registries[0].get("m").metrics.snapshot()["zero_copy_rows_total"]
        assert zero_after - zero_before == 3 * 4
    finally:
        pool.close()
        router.stop()


def test_binary_client_json_only_worker_downgrades_bit_identical(duo):
    endpoints, _, _, ref = duo
    router = _router({"w1": endpoints["w1"]})
    port = router.start(0)
    pool = wire.ConnectionPool()
    journal.enable(capacity=2048)
    try:
        wait_ready(router, 1)
        frame = wire.encode_predict_request(X[:4], timeout_ms=10000)
        for _ in range(2):
            status, headers, data = _predict_wire(pool, port, frame)
            assert status == 200
            assert _decode_any(headers, data).tobytes() == ref.tobytes()
        assert router.metrics.snapshot()["wire_downgrades_total"] == 1
        assert router.workers()["w1"].wire_ok is False
        downs = journal.events(types=["router.wire_downgrade"])
        assert len(downs) == 1 and downs[0]["attrs"]["worker"] == "w1"
    finally:
        journal.enable(capacity=1024)
        pool.close()
        router.stop()


def test_json_client_through_wire_enabled_fleet_unchanged(duo):
    from _torch_serving_host import request
    endpoints, _, _, ref = duo
    router = _router({"w0": endpoints["w0"]})
    port = router.start(0)
    try:
        wait_ready(router, 1)
        status, _, data = request(port, "POST", "/v1/models/m/predict",
                                  {"inputs": X[:4].tolist(), "dtype": "float32",
                                   "timeout_ms": 10000},
                                  headers={"Content-Type": "application/json"})
        assert status == 200
        assert np.asarray(json.loads(data)["outputs"], np.float32).tobytes() == ref.tobytes()
        assert router.metrics.snapshot()["wire_requests_total"] == 0
    finally:
        router.stop()


def test_mid_stream_downgrade_when_worker_stops_speaking_binary(duo):
    endpoints, _, servers, ref = duo
    router = _router({"w0": endpoints["w0"]})
    port = router.start(0)
    pool = wire.ConnectionPool()
    try:
        wait_ready(router, 1)
        frame = wire.encode_predict_request(X[:4], timeout_ms=10000)
        assert _predict_wire(pool, port, frame)[0] == 200
        assert router.workers()["w0"].wire_ok is True
        servers[0].wire_enabled = False
        status, headers, data = _predict_wire(pool, port, frame)
        assert status == 200
        assert _decode_any(headers, data).tobytes() == ref.tobytes()
        assert router.workers()["w0"].wire_ok is False
        assert router.metrics.snapshot()["wire_downgrades_total"] == 1
    finally:
        servers[0].wire_enabled = True
        pool.close()
        router.stop()


def test_hedged_request_mixed_protocols_winner_bit_identical(duo):
    endpoints, _, servers, ref = duo
    router = _router(endpoints, hedge_initial_ms=50.0)
    port = router.start(0)
    pool = wire.ConnectionPool()
    slowed = orig = None
    try:
        wait_ready(router, 2)
        primary = router.ranked_workers("m")[0].worker_id
        slowed = servers[0] if primary == "w0" else servers[1]
        orig = slowed._handle_predict

        def slow_predict(*args, **kw):
            time.sleep(0.4)
            return orig(*args, **kw)

        slowed._handle_predict = slow_predict
        frame = wire.encode_predict_request(X[:4], timeout_ms=10000)
        status, headers, data = _predict_wire(pool, port, frame)
        assert status == 200
        assert _decode_any(headers, data).tobytes() == ref.tobytes()
        snap = router.metrics.snapshot()
        assert snap["hedges_total"] >= 1 and snap["responses_total"] == 1
    finally:
        if slowed is not None:
            slowed._handle_predict = orig
            time.sleep(0.45)  # let the straggler finish before the next test
        pool.close()
        router.stop()


def test_corrupt_frame_is_503_protocol_error_at_router_and_worker(duo):
    endpoints = duo[0]
    router = _router({"w0": endpoints["w0"]})
    port = router.start(0)
    pool = wire.ConnectionPool()
    try:
        wait_ready(router, 1)
        frame = bytearray(wire.encode_predict_request(X[:4]))
        frame[30] ^= 0xFF
        for target in (port, int(endpoints["w0"].rsplit(":", 1)[1])):
            status, _, data = _predict_wire(pool, target, bytes(frame))
            assert status == 503 and json.loads(data)["reason"] == "wire_protocol_error"
    finally:
        pool.close()
        router.stop()


def test_chaos_corrupted_shm_frame_retries_inline_correct_answer(duo):
    endpoints, _, _, ref = duo
    router = _router({"w0": endpoints["w0"]}, shm_min_bytes=64)
    port = router.start(0)
    pool = wire.ConnectionPool()
    try:
        wait_ready(router, 1)
        frame = wire.encode_predict_request(X[:4], timeout_ms=10000)
        wire.reset_counters()
        with chaos.ChaosController(seed=11) as c:
            # the router's shm re-encode is the first encode the controller
            # sees; its transform is call 2 (each encode fires, then transforms)
            c.on("serving.wire.frame", chaos.CorruptBytes(n_bytes=4, mode="flip", nth=2))
            status, headers, data = _predict_wire(pool, port, frame)
        assert status == 200
        assert _decode_any(headers, data).tobytes() == ref.tobytes()
        assert router.metrics.snapshot()["shm_fallbacks_total"] == 1
        assert wire.counters()["protocol_errors_total"] >= 1
        status, headers, data = _predict_wire(pool, port, frame)
        assert status == 200 and _decode_any(headers, data).tobytes() == ref.tobytes()
        assert router.metrics.snapshot()["shm_hops_total"] >= 1
    finally:
        pool.close()
        router.stop()
