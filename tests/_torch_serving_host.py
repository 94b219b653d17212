"""Shared pieces of the port's host-side serving tests
(``test_torch_serving_{wire,server,router,delivery}.py``).

The model is the JAX serving tests' MLP (Dense(16, tanh) + softmax(4) over
8 features, seed 7) built with either package's classes; archives are
written by the JAX package and served by both. The HTTP helpers carry a
timeout on every call, and the stub worker is ``tests/test_router.py``'s
scripted fake.
"""

import json
import re
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

RNG = np.random.default_rng(0)
X = RNG.normal(size=(16, 8)).astype(np.float32)
BATCHER_KW = dict(max_batch_size=4, buckets=[1, 4], batch_timeout_ms=1.0, pipeline_depth=0)
#: outputs of the two packages on the same archive (``test_torch_serving_registry.py``)
RTOL = 1e-6

# LSTM session model: one timestep of 3 features a chunk, one fixed step bucket
T, F = 1, 3
BUCKET = 4


@pytest.fixture(autouse=True)
def port_on_cpu():
    """The port on the CPU in float32, as every ``test_torch_*`` file."""
    from deeplearning4j_tpu_torch.runtime.environment import get_environment
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    env.set_aot_dispatch(True)
    yield
    env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch = saved


def set_port_cpu():
    """The same settings for module-scoped fixtures (built before the
    autouse fixture runs)."""
    from deeplearning4j_tpu_torch.runtime.environment import get_environment
    get_environment().set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")


def _pkg(jax_side):
    if jax_side:
        from deeplearning4j_tpu import models, nn
        from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    else:
        from deeplearning4j_tpu_torch import models, nn
        from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration
    return models, nn, NeuralNetConfiguration


def mlp_conf(jax_side, seed=7):
    _, nn, conf = _pkg(jax_side)
    return (conf.builder().seed(seed).updater(None).list()
            .layer(nn.DenseLayer(n_out=16, activation="tanh"))
            .layer(nn.OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(nn.InputType.feed_forward(8)).build())


def mlp(jax_side, seed=7):
    models, _, _ = _pkg(jax_side)
    return models.MultiLayerNetwork(mlp_conf(jax_side, seed)).init()


def lstm(jax_side, seed=7):
    """LSTM(5) + RnnOutputLayer(2): ``tests/test_sessions.py``'s model."""
    models, nn, conf = _pkg(jax_side)
    c = (conf.builder().seed(seed).list().layer(nn.LSTM(n_out=5))
         .layer(nn.RnnOutputLayer(n_out=2, activation="softmax"))
         .set_input_type(nn.InputType.recurrent(F, T)).build())
    return models.MultiLayerNetwork(c).init()


def jax_archive(path, net=None):
    """``net`` (default: the JAX MLP) written by the JAX serializer."""
    from deeplearning4j_tpu.models.serializer import ModelSerializer
    ModelSerializer.write_model(net if net is not None else mlp(True), str(path))
    return str(path)


def port_restore(path):
    from deeplearning4j_tpu_torch.models import ModelSerializer
    return ModelSerializer.restore_model(str(path), device="cpu")


def rolled_jax_net(net):
    """The class-permuted twin of the JAX ``net``: every output-layer leaf
    rolled by one class, so its top-1 disagrees with ``net`` everywhere."""
    import jax
    bad = mlp(True)
    bad.set_params(jax.tree.map(
        lambda a: np.roll(np.asarray(a), 1, -1) if a.shape[-1] == 4 else a, net.params()))
    return bad


def oracle_outs(output_fn, n, ofs=0, x=X):
    """The reference output at every bucket that could have served ``n``
    rows (a served answer depends on the bucket that padded it)."""
    outs = []
    for bucket in (b for b in BATCHER_KW["buckets"] if b >= n):
        padded = np.concatenate([x[ofs:ofs + n], np.zeros((bucket - n, x.shape[1]), x.dtype)])
        outs.append(np.asarray(output_fn(padded))[:n])
    return outs


def post(port, name="m", n=2, timeout_ms=5000, headers=None, ofs=0, dtype=None):
    body = {"inputs": X[ofs:ofs + n].tolist(), "timeout_ms": timeout_ms}
    if dtype is not None:
        body["dtype"] = dtype
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/models/{name}/predict",
                                 data=json.dumps(body).encode(), headers=headers or {})
    resp = urllib.request.urlopen(req, timeout=30)
    return resp.status, dict(resp.getheaders()), json.loads(resp.read())


def request(port, method, path, body=None, timeout=30, headers=None):
    """``(status, headers, raw body)`` of one call; HTTP errors are returned,
    not raised."""
    raw = None if body is None else (body if isinstance(body, bytes)
                                     else json.dumps(body).encode())
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=raw, method=method,
                                 headers=headers or {})
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def wait_until(pred, timeout_s=10.0, interval=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def wait_ready(router, n, timeout_s=10.0):
    assert wait_until(lambda: len(router.workers()) >= n
                      and all(v.ready for v in router.workers().values()), timeout_s), \
        "workers never became ready"


class StubWorker:
    """A fake worker: /readyz always 200; predict scripted by ``mode``
    ("ok" | "error" | "shed" | "die") plus ``delay_s``."""

    def __init__(self, body: bytes):
        self.mode = "ok"
        self.delay_s = 0.0
        self.body = body
        self.retry_after_ms = 400.0
        self.hits = 0
        self.headers_seen = []
        self.lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, payload, extra=None):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                if self.path == "/readyz":
                    self._send(200, b'{"ready": true}')
                else:
                    self._send(404, b'{}')

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                with stub.lock:
                    stub.hits += 1
                    stub.headers_seen.append(dict(self.headers.items()))
                    mode, delay = stub.mode, stub.delay_s
                if delay:
                    time.sleep(delay)
                if mode == "die":
                    # a reset with no response: what a killed worker looks like
                    try:
                        self.connection.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                                   struct.pack("ii", 1, 0))
                        self.connection.close()
                    except OSError:
                        pass
                    return
                if mode == "error":
                    self._send(500, b'{"error": "byzantine"}')
                    return
                if mode == "shed":
                    ms = stub.retry_after_ms
                    payload = json.dumps({"error": "overloaded", "reason": "overloaded",
                                          "retry_after_ms": ms}).encode()
                    self._send(503, payload, extra={"Retry-After-Ms": f"{ms:.0f}"})
                    return
                self._send(200, stub.body)

            def log_message(self, *a):
                pass

        class Server(ThreadingHTTPServer):
            daemon_threads = True

            def handle_error(self, request, client_address):
                pass  # "die" closes mid-handler on purpose

        self.httpd = Server(("127.0.0.1", 0), Handler)
        self.address = f"127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                       name="stub-worker")
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


OK_BODY = json.dumps({"model": "m", "version": 1,
                      "outputs": [[0.25, 0.25, 0.25, 0.25]]}).encode()


# ======================================= comparing two servers' JSON payloads
#: dict children keyed by data (device positions, thread names, event
#: attributes), not by schema
_DATA_KEYED = ("per_device_bytes", "device_map", "stacks", "per_physical_device_bytes", "attrs")
#: the port's one addition to the capacity payload: its positions share a
#: card, so the residency ledger also sums bytes per physical device
_PORT_EXTRA = {"/residency/per_physical_device_bytes", "/residency/per_physical_device_bytes/*"}


#: lists whose records are data: the kept traces depend on what else ran in
#: the process (each package's collector is process-wide)
_DATA_LISTS = ("/traces",)


def _keys(obj, path=""):
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{path}/{k}"
            out.add(p)
            if not any(path.endswith("/" + d) or path == "/" + d for d in _DATA_KEYED):
                out |= _keys(v, p)
    elif (isinstance(obj, list) and obj and isinstance(obj[0], dict)
          and not path.endswith(_DATA_LISTS)):
        out |= _keys(obj[0], path + "[]")
    return out


def _norm(path_keys):
    """Device positions and thread names replaced by a placeholder."""
    out = set()
    for k in path_keys:
        for d in _DATA_KEYED:
            k = re.sub(rf"(/{d})/[^/]+", r"\1/*", k)
        out.add(k)
    return out


def _families(text):
    return {re.split(r"[{ ]", ln)[0] for ln in text.splitlines() if ln and not ln.startswith("#")}


def align_compile_caches(monkeypatch, directory):
    """Both packages' compile caches reported at ``directory``: whether the
    ``capacity_compile_cache_bytes`` family renders depends on that process
    state, which other tests in the same process may have set in one package."""
    from deeplearning4j_tpu.runtime import compile_cache as jcc
    from deeplearning4j_tpu_torch.runtime import compile_cache as cc
    monkeypatch.setattr(jcc, "cache_dir", lambda: str(directory))
    monkeypatch.setattr(cc, "cache_dir", lambda: str(directory))
