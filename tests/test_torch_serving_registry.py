"""The port's model registry, breakers, retries and warm-up manifests
against the JAX package.

Mirrors ``tests/test_serving.py``'s registry cases and its sustained-load
case on ``deeplearning4j_tpu_torch.serving`` (the sustained-load case keeps
its bounded-capture and no-hang asserts; its "faster than serial" timing is
the card's to show), then the registry's lifecycle (hot-swap rollback and
manifest inheritance, breaker and retry, health, undeploy), and against live
JAX runs: a warm-up manifest saved by either package's registry replays in
the other with the same buckets, replicas and pairs, and the two packages'
circuit breakers go through the same states under one injected clock.
Paging and quantized deploys have their own files
(``test_torch_serving_paging.py``, ``test_torch_serving_quantize.py``).
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.models import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
from deeplearning4j_tpu.serving.manifest import WarmupManifest as JManifest
from deeplearning4j_tpu.serving.resilience import CircuitBreaker as JBreaker
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime.chaos import ChaosController, ChaosError, FailNth
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import (CircuitBreaker, CircuitOpen, CircuitState,
                                              DeadlineExceeded, HealthState, ModelRegistry,
                                              Overloaded, RetryPolicy, ServingShutdown,
                                              WarmupManifest, manifest_path)
from deeplearning4j_tpu_torch.train import Sgd

WIDTH, FEATURES = 256, 8
CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    env.set_aot_dispatch(True)
    yield
    env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch = saved


def _mln_conf(seed=7, builder=NeuralNetConfiguration, dense=DenseLayer, out=OutputLayer,
              input_type=InputType, sgd=Sgd):
    """3 x Dense(256) + softmax(4) over 8 features (either package's classes)."""
    b = builder.builder().seed(seed).updater(sgd(0.1)).list()
    for _ in range(3):
        b.layer(dense(n_out=WIDTH, activation="relu"))
    return (b.layer(out(n_out=4, activation="softmax"))
            .set_input_type(input_type.feed_forward(FEATURES)).build())


def _net(seed=7):
    return MultiLayerNetwork(_mln_conf(seed)).init()


def _data(n=64, seed=0, dim=FEATURES):
    return np.random.default_rng(seed).normal(0, 1, (n, dim)).astype(np.float32)


def _pad_rows(x, bucket):
    return np.concatenate([x, np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)])


def _ref_at_bucket(ref, x, bucket):
    return np.asarray(ref.output(_pad_rows(x, bucket)))[:x.shape[0]]


def _jax_archive(path, seed=7):
    net = JMultiLayerNetwork(_mln_conf(seed, JConf, JDense, JOutput, JInputType, JSgd)).init()
    JSerializer.write_model(net, str(path))
    return str(path)


# --------------------------------------------------------------- registry
def test_registry_predict_and_describe():
    reg = ModelRegistry()
    net = _net()
    x = _data(32)
    reg.register("mlp", net, warmup_example=x[:1], max_batch_size=8)
    try:
        got = np.asarray(reg.predict("mlp", x[:3]))
        assert (got == _ref_at_bucket(net, x[:3], 4)).all()
        desc = reg.describe()
        assert desc[0]["name"] == "mlp" and desc[0]["version"] == 1
        assert desc[0]["buckets"] == [1, 2, 4, 8]
        assert desc[0]["metrics"]["responses_total"] >= 1
        assert desc[0]["health"] == "ready" and desc[0]["residency"] == "resident"
        assert desc[0]["metrics"]["warmup_seconds"] > 0
        with pytest.raises(KeyError):
            reg.predict("nope", x[:1])
    finally:
        reg.shutdown()


def test_registry_hot_swap_and_undeploy():
    reg = ModelRegistry()
    x = _data(16)
    net1, net2 = _net(seed=1), _net(seed=2)
    try:
        reg.register("m", net1, warmup_example=x[:1], max_batch_size=8)
        y1 = np.asarray(reg.predict("m", x[:2]))
        old_batcher = reg.get("m").batcher
        served2 = reg.register("m", net2, warmup_example=x[:1], max_batch_size=8)
        assert served2.version == 2
        y2 = np.asarray(reg.predict("m", x[:2]))
        assert (y1 == np.asarray(net1.output(x[:2]))).all()
        assert (y2 == np.asarray(net2.output(x[:2]))).all()
        assert not (y1 == y2).all(), "different seeds must differ"
        with pytest.raises(ServingShutdown):
            old_batcher.submit(x[:1])
        reg.undeploy("m")
        assert reg.names() == []
        with pytest.raises(KeyError):
            reg.undeploy("m")
    finally:
        reg.shutdown()


def test_registry_loads_serializer_archive(tmp_path):
    net = _net()
    path = str(tmp_path / "model.zip")
    ModelSerializer.write_model(net, path)
    reg = ModelRegistry()
    x = _data(8)
    try:
        served = reg.load("restored", path, warmup_example=x[:1], max_batch_size=8)
        assert served.describe()["model_type"] == "MultiLayerNetwork"
        got = np.asarray(reg.predict("restored", x[:4]))
        np.testing.assert_allclose(got, np.asarray(net.output(x[:4])), rtol=1e-6)
        assert served.archive_path == path
    finally:
        reg.shutdown()
    # load() wrote the manifest; the graceful shutdown refreshed it
    m = WarmupManifest.load(manifest_path(path))
    assert m.buckets == [1, 2, 4, 8] and m.replicas == 1 and len(m.pairs) == 4


def test_registry_zoo_entry():
    reg = ModelRegistry()
    try:
        served = reg.register_zoo("lenet", "LeNet", max_batch_size=2, batch_timeout_ms=1.0)
        out = np.asarray(reg.predict("lenet", np.zeros((1, 28, 28, 1), np.float32)))
        assert out.shape == (1, 10)
        assert served.describe()["model_type"] in ("MultiLayerNetwork", "ComputationGraph")
    finally:
        reg.shutdown()


def test_sustained_load_bounded_compiles_no_hangs():
    """8 concurrent clients against a registry-served model: captures stay
    at the warmed bucket count, and every response is bit for bit right or
    an explicit rejection — no hangs, no silent drops. (Speed against the
    serial loop is measured on the card, not asserted on a shared CPU.)"""
    reg = ModelRegistry()
    net, ref = _net(), _net()
    x = _data(256)
    served = reg.register("mlp", net, warmup_example=x[:1], max_batch_size=16,
                          batch_timeout_ms=2.0, queue_limit=512)
    n_threads, per_thread = 8, 25
    work = [[(i * per_thread + j) % 200 for j in range(per_thread)] for i in range(n_threads)]
    sizes = [1 + (k % 4) for k in range(n_threads * per_thread)]
    buckets = list(served.batcher.buckets)
    expected, k = {}, 0
    for i in range(n_threads):
        for ofs in work[i]:
            n = sizes[k]
            expected[(i, ofs)] = [_ref_at_bucket(ref, x[ofs:ofs + n], bk)
                                  for bk in buckets if bk >= n]
            k += 1
    compiles_before = served.batcher.compile_count()
    outcomes = []
    lock = threading.Lock()

    def client(i):
        k0 = i * per_thread
        for j, ofs in enumerate(work[i]):
            n = sizes[k0 + j]
            try:
                got = np.asarray(reg.predict("mlp", x[ofs:ofs + n], timeout_ms=10_000))
                ok = any((got == c).all() for c in expected[(i, ofs)])
                with lock:
                    outcomes.append("ok" if ok else "WRONG")
            except (Overloaded, DeadlineExceeded) as e:
                with lock:
                    outcomes.append(type(e).__name__)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    try:
        assert not any(t.is_alive() for t in threads), "client thread hung"
        assert len(outcomes) == n_threads * per_thread
        assert "WRONG" not in outcomes
        assert outcomes.count("ok") > 0
        assert served.batcher.compile_count() <= len(served.batcher.buckets)
        assert served.batcher.compile_count() == compiles_before
        s = served.metrics.snapshot()
        assert s["batches_total"] < n_threads * per_thread, "no coalescing happened"
        assert s["responses_total"] == outcomes.count("ok")
    finally:
        reg.shutdown()


# ---------------------------------------------------------------- lifecycle
def test_hot_swap_inherits_manifest_and_rolls_back_a_failed_build():
    """A replacement with no example of its own warms every bucket the live
    entry serves (a traffic-minted one too) before it takes traffic; a
    replacement whose warm-up fails leaves the old version serving."""
    reg = ModelRegistry()
    x = _data(64)
    try:
        reg.register("m", _net(seed=1), warmup_example=x[:1], max_batch_size=8, replicas=2,
                     devices=CPU2)
        reg.predict("m", x[:12])  # mints bucket 16
        v1 = reg.get("m")
        assert v1.batcher.buckets == [1, 2, 4, 8, 16]
        v2 = reg.register("m", _net(seed=2), devices=CPU2)
        assert v2.version == 2 and v2.batcher.buckets == [1, 2, 4, 8, 16]
        assert v2.batcher.replica_count == 2 and v2.batcher.compile_count() == 10
        assert not v1.batcher._worker.is_alive() and v1.health is HealthState.DRAINING
        with ChaosController() as c:
            c.on("serving.batcher.warmup", FailNth(1))
            with pytest.raises(ChaosError):
                reg.register("m", _net(seed=3), devices=CPU2)
        assert reg.get("m") is v2 and v2.batcher._worker.is_alive()
        assert (reg.predict("m", x[:3]) == _ref_at_bucket(_net(seed=2), x[:3], 4)).all()
    finally:
        reg.shutdown()


def test_breaker_opens_sheds_probes_and_closes_through_predict():
    """Model faults count once per batch and open the breaker; while open
    ``predict`` sheds with ``CircuitOpen``; the probe after the reset
    timeout closes it. Admission rejections never trip it. A retry absorbs
    a transient fault."""
    clock = [0.0]
    reg = ModelRegistry()
    x = _data(8)
    try:
        served = reg.register("m", _net(), warmup_example=x[:1], max_batch_size=4,
                              breaker=CircuitBreaker(failure_threshold=2, reset_timeout_s=5.0,
                                                     clock=lambda: clock[0]),
                              retry=RetryPolicy(max_attempts=1))
        assert reg.health() == {"m": "ready"} and reg.ready()
        with ChaosController() as c:
            c.on("serving.batcher.forward", FailNth(1, every=True))
            for _ in range(2):
                with pytest.raises(ChaosError):
                    reg.predict("m", x[:1])
        assert served.breaker.state is CircuitState.OPEN
        assert reg.health() == {"m": "degraded"} and not reg.ready()
        with pytest.raises(CircuitOpen):
            reg.predict("m", x[:1])
        clock[0] = 6.0
        assert served.breaker.state is CircuitState.HALF_OPEN
        reg.predict("m", x[:1])
        assert served.breaker.state is CircuitState.CLOSED and reg.ready()
        assert served.metrics.snapshot()["rejected_circuit"] == 1
        retrying = reg.register("r", _net(), warmup_example=x[:1], max_batch_size=4,
                                retry=RetryPolicy(max_attempts=3, base_delay_s=0.0))
        with ChaosController() as c:
            c.on("serving.batcher.forward", FailNth(1))
            assert reg.predict("r", x[:2]).shape == (2, 4)
        assert retrying.metrics.snapshot()["retries_total"] == 1
    finally:
        reg.shutdown()


def test_second_half_names_raise_by_name(tmp_path):
    """The paging and quantized-deploy names answer on a plain registry:
    no budget on the CPU, unknown names raise ``KeyError`` naming them, a
    cold entry whose archive is missing fails its page-in by name and stays
    cold, and ``deploy_quantized`` refuses a plain archive by name."""
    reg = ModelRegistry()
    try:
        assert reg.hbm_budget_bytes is None
        for call in (lambda: reg.acquire("a"), lambda: reg.page_in("a"),
                     lambda: reg.predict("a", _data(1))):
            with pytest.raises(KeyError, match="'a'"):
                call()
        assert reg.evict("a") is False
        missing = str(tmp_path / "x.zip")
        assert reg.load("a", missing, resident=False) is None
        assert reg.names() == ["a"] and reg.resident_names() == []
        with pytest.raises(OSError, match="x.zip"):
            reg.page_in("a")  # the leader raises its load's own error
        snap = reg.residency_snapshot()
        assert snap["models"]["a"]["state"] == "cold" and snap["resident_bytes"] == 0
        assert snap["paging"]["page_in_failures_total"] >= 1
        plain = str(tmp_path / "plain.zip")
        ModelSerializer.write_model(_net(), plain)
        reg.load("b", plain, warmup_example=_data(1), max_batch_size=4)
        with pytest.raises(ValueError, match="not a quantized archive"):
            reg.deploy_quantized("b", plain, _data(8))
        assert ModelRegistry(hbm_budget_bytes=1).hbm_budget_bytes == 1
    finally:
        reg.shutdown()


# ------------------------------------------------- against live JAX runs
def test_manifest_saved_by_either_registry_replays_in_the_other(tmp_path):
    """JAX registry: load (2 replicas, warm-up), traffic minting bucket 16,
    save_manifest. The port's registry replays it: the same buckets,
    replicas and pairs, nothing captured on traffic at those buckets. Then
    the port mints bucket 32 and saves; the JAX registry replays that."""
    path = _jax_archive(tmp_path / "mlp.zip")
    x = _data(64, seed=3)
    jreg = JRegistry()
    try:
        jreg.load("m", path, warmup_example=x[:1], replicas=2, max_batch_size=8)
        jreg.predict("m", x[:12])
        assert jreg.save_manifest("m") == manifest_path(path)
    finally:
        jreg.shutdown(drain=False)
    jm = JManifest.load(manifest_path(path))
    reg = ModelRegistry()
    try:
        served = reg.load("m", path, device="cpu", devices=CPU2)
        b = served.batcher
        assert b.buckets == jm.buckets == [1, 2, 4, 8, 16]
        assert b.replica_count == jm.replicas == 2 and b.max_batch_size == jm.max_batch_size
        assert b.compile_count() == len(jm.pairs) == 10
        assert sorted(b.warmup_manifest().pairs) == sorted(tuple(p) for p in jm.pairs)
        for n in (1, 3, 12):
            reg.predict("m", x[:n])
        assert b.compile_count() == 10
        reg.predict("m", x[:20])  # mints bucket 32 on both replicas
        port_path = reg.save_manifest("m")
    finally:
        reg.shutdown(drain=False)
    pm = WarmupManifest.load(port_path)
    assert pm.to_dict()["format"] == "dl4j-tpu-warmup-v1"
    jreg = JRegistry()
    try:
        jserved = jreg.load("m", path)
        jb = jserved.batcher
        assert jb.buckets == pm.buckets == [1, 2, 4, 8, 16, 32]
        assert jb.replica_count == pm.replicas == 2
        assert jb.compile_count() == len(pm.pairs) == 12
        assert sorted(jb.warmup_manifest().pairs) == sorted(tuple(p) for p in pm.pairs)
    finally:
        jreg.shutdown(drain=False)


def test_breaker_state_sequence_matches_jax_under_one_clock():
    clock = [0.0]
    kw = dict(failure_threshold=3, window_s=10.0, reset_timeout_s=5.0, half_open_probes=1,
              clock=lambda: clock[0])
    script = [("fail", 0.0), ("fail", 1.0), ("success", 2.0), ("fail", 3.0), ("fail", 4.0),
              ("fail", 20.0), ("fail", 21.0), ("fail", 22.0), ("allow", 23.0),
              ("allow", 27.5), ("allow", 27.6), ("discard", 27.7), ("allow", 27.8),
              ("fail", 28.0), ("allow", 29.0), ("allow", 33.5), ("success", 33.6),
              ("fail", 34.0, "k"), ("fail", 34.1, "k"), ("warm_open", 35.0), ("allow", 36.0),
              ("allow", 41.0), ("success", 41.1)]

    def run(breaker):
        clock[0] = 0.0
        seen = []
        for step in script:
            op, t = step[0], step[1]
            clock[0] = t
            if op == "fail":
                breaker.record_failure(key=step[2] if len(step) > 2 else None)
                r = None
            elif op == "success":
                r = breaker.record_success()
            elif op == "discard":
                r = breaker.record_discard()
            elif op == "warm_open":
                r = breaker.warm_open()
            else:
                r = breaker.allow()
            seen.append((op, t, r, breaker.state.name, breaker.snapshot()))
        return seen

    got, want = run(CircuitBreaker(**kw)), run(JBreaker(**kw))
    assert got == want
    assert [s[3] for s in got].count("OPEN") >= 3 and got[-1][3] == "CLOSED"
