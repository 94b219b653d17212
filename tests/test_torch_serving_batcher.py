"""The port's batcher, replica pool and admission against the JAX package.

Mirrors ``tests/test_serving.py``'s batcher, admission and metrics cases on
``deeplearning4j_tpu_torch.serving`` (the HTTP server cases come with the
server), then holds the port against live JAX runs of the same calls: one
archive the JAX ``ModelSerializer`` wrote, served by both packages' batchers
at the same buckets (outputs within 1e-5 relative in float32), the same
capture/compile counts after the same warm-up and traffic, and the same
outcomes and ``retry_after_ms`` for a scripted admission and deadline
scenario.

The port runs on the CPU (each test's fixture); two replicas on the CPU are
``devices=["cpu", "cpu"]`` (the JAX package has 8 virtual CPU devices here).
On the CPU a request served at bucket ``b`` equals ``model.output(pad_to_b(x))``
bit for bit, the exactness contract.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu.models import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.serving import ContinuousBatcher as JBatcher
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu_torch.models import ComputationGraph, ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.parallel import ParallelPlan
from deeplearning4j_tpu_torch.runtime.chaos import (AddLatency, ChaosController, ChaosError,
                                                    FailNth)
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import (AdmissionController, ContinuousBatcher,
                                              DeadlineExceeded, LatencyHistogram, Overloaded,
                                              ReplicaPool, ServingShutdown, default_buckets)
from deeplearning4j_tpu_torch.serving.batcher import _Request
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.train import Adam, Sgd

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


def _jax_conf(seed=7):
    return _mln_conf(seed, JConf, JDense, JOutput, JInputType, JSgd)


def _net(seed=7):
    return MultiLayerNetwork(_mln_conf(seed)).init()


def _graph_conf(seed=5):
    return (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
            .graph_builder()
            .add_inputs("in_a", "in_b")
            .add_layer("ha", DenseLayer(n_out=16, activation="relu"), "in_a")
            .add_layer("hb", DenseLayer(n_out=16, activation="relu"), "in_b")
            .add_vertex("merged", MergeVertex(), "ha", "hb")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"),
                       "merged")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(8), InputType.feed_forward(6))
            .build())


def _data(n=64, seed=0, dim=FEATURES):
    return np.random.default_rng(seed).normal(0, 1, (n, dim)).astype(np.float32)


def _pad_rows(x, bucket):
    return np.concatenate([x, np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)])


def _ref_at_bucket(ref, x, bucket):
    """The exactness contract: ``model.output(pad_to_b(x))[:n]``."""
    return np.asarray(ref.output(_pad_rows(x, bucket)))[:x.shape[0]]


# ---------------------------------------------------------------- batcher
def test_default_buckets_power_of_two():
    assert default_buckets(32) == [1, 2, 4, 8, 16, 32]
    assert default_buckets(24) == [1, 2, 4, 8, 16, 24]
    assert default_buckets(1) == [1]


def test_rows_independent_of_batch_context():
    net = _net()
    rng = np.random.default_rng(3)
    x = _data(16)
    base = np.asarray(net.output(_pad_rows(x[:3], 16)))[:3]
    for ofs in (1, 5, 13):
        batch = rng.normal(0, 1, (16, FEATURES)).astype(np.float32)
        batch[ofs:ofs + 3] = x[:3]
        got = np.asarray(net.output(batch))[ofs:ofs + 3]
        assert (got == base).all(), f"row result depends on context @ {ofs}"


def test_batcher_results_bit_identical_and_compiles_bounded():
    net, ref = _net(), _net()
    x = _data(64)
    b = ContinuousBatcher(net, max_batch_size=16, batch_timeout_ms=1.0, warmup_example=x[:1])
    assert b.compile_count() == len(b.buckets)
    try:
        for n in (1, 2, 3, 5, 7, 11, 13, 16):
            got = np.asarray(b.submit(x[:n]))
            bucket = min(bk for bk in b.buckets if bk >= n)
            assert (got == _ref_at_bucket(ref, x[:n], bucket)).all(), f"rows={n}"
            np.testing.assert_allclose(got, np.asarray(ref.output(x[:n])), rtol=1e-5)
        assert b.compile_count() == len(b.buckets)
    finally:
        b.shutdown()


def test_batcher_coalesce_window_is_one_deadline():
    b = ContinuousBatcher(_net(), max_batch_size=64, batch_timeout_ms=40.0)
    b.shutdown(drain=False)  # drive _collect directly, no worker racing us
    recorded = []
    real_queue = b._queue

    class SpyQueue:
        def get(self, timeout=None):
            recorded.append(timeout)
            time.sleep(0.005)
            return real_queue.get(timeout=timeout)

        def __getattr__(self, name):
            return getattr(real_queue, name)

    for _ in range(20):
        real_queue.put(_Request(_data(1), 1, None))
    b._queue = SpyQueue()
    first = _Request(_data(2), 2, None)
    t0 = time.monotonic()
    batch = b._collect(first)
    elapsed = time.monotonic() - t0
    assert elapsed < 0.5, f"window stayed open {elapsed:.3f}s"
    assert 1 <= len(batch) < 21
    assert all(t <= 0.040 + 1e-6 for t in recorded)
    assert recorded == sorted(recorded, reverse=True)


def test_batcher_shutdown_fails_queued_requests():
    b = ContinuousBatcher(_net(), max_batch_size=8, batch_timeout_ms=1.0)
    gate = threading.Event()
    orig_forward = b._forward
    b._forward = lambda x: (gate.wait(5), orig_forward(x))[1]
    x = _data(8)
    results = []

    def client():
        try:
            results.append(("ok", b.submit(x[:2])))
        except BaseException as e:
            results.append(("err", e))

    threads = [threading.Thread(target=client) for _ in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    sd = threading.Thread(target=lambda: b.shutdown(drain=False, timeout_s=10))
    sd.start()
    time.sleep(0.05)
    gate.set()
    sd.join(timeout=10)
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads), "caller hung"
    assert len(results) == 6
    kinds = [k for k, _ in results]
    assert kinds.count("ok") >= 1, "the in-flight batch must still complete"
    shut = [v for k, v in results if k == "err"]
    assert len(shut) >= 2, "queued-but-unbatched requests must be failed"
    assert all(isinstance(e, ServingShutdown) for e in shut)
    with pytest.raises(ServingShutdown):
        b.submit(x[:1])


def test_idle_worker_blocks_without_polling():
    x = _data(8)
    b = ContinuousBatcher(_net(), max_batch_size=8, batch_timeout_ms=2.0, warmup_example=x[:1])
    recorded = []
    real_queue = b._queue

    class SpyQueue:
        def get(self, timeout=None):
            recorded.append(timeout)
            return real_queue.get(timeout=timeout)

        def __getattr__(self, name):
            return getattr(real_queue, name)

    b._queue = SpyQueue()
    try:
        b.submit(x[:2])
        time.sleep(0.6)
        assert recorded.count(None) >= 1, "worker must park in a blocking get when idle"
        assert len(recorded) <= 5, f"idle worker woke {len(recorded)} times"
        timed = [t for t in recorded if t is not None]
        assert all(t <= b.batch_timeout_s + 1e-6 for t in timed)
    finally:
        b.shutdown()


def test_pipelined_bit_exact_under_concurrent_load():
    net, ref = _net(), _net()
    x = _data(64)
    b = ContinuousBatcher(net, max_batch_size=16, batch_timeout_ms=2.0, queue_limit=512,
                          replicas=2, devices=CPU2, pipeline_depth=4, warmup_example=x[:1])
    assert b.replica_count == 2
    assert b.compile_count() == len(b.buckets) * 2
    try:
        results = {}
        lock = threading.Lock()

        def client(i):
            for j in range(15):
                ofs = (i * 15 + j) % 48
                n = 1 + (i + j) % 4
                got = np.asarray(b.submit(x[ofs:ofs + n], timeout_ms=10_000))
                with lock:
                    results[(i, j, ofs, n)] = got

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads), "client hung"
        assert len(results) == 8 * 15
        for (i, j, ofs, n), got in results.items():
            candidates = [_ref_at_bucket(ref, x[ofs:ofs + n], bk) for bk in b.buckets if bk >= n]
            assert any((got == c).all() for c in candidates), f"request {(i, j)}"
        assert b.compile_count() == len(b.buckets) * 2
        assert b.metrics.snapshot()["dispatch_p99_s"] > 0
    finally:
        b.shutdown()


def test_replicas_identical_and_balanced():
    net, ref = _net(), _net()
    x = _data(16)
    b = ContinuousBatcher(net, max_batch_size=16, batch_timeout_ms=1.0, replicas=2,
                          devices=CPU2, warmup_example=x[:1])
    try:
        expected = _ref_at_bucket(ref, x[:3], 4)
        for _ in range(8):
            assert (np.asarray(b.submit(x[:3])) == expected).all()
        counts = b.metrics.snapshot()["replica_batches"]
        assert sorted(counts) == [0, 1], f"replica counts: {counts}"
        assert all(v >= 3 for v in counts.values()), f"routing did not balance: {counts}"
    finally:
        b.shutdown()


def test_replicas_clamp_to_devices_and_hold_their_own_copies():
    """``replicas`` beyond the devices clamps with a warning (one CPU
    device); an explicit ``devices=[d, d]`` gives two parameter copies on
    one device, cast as ``_forward`` casts them (the same bits)."""
    net = _net()
    assert ReplicaPool(net, n_replicas=3).__len__() == 1
    pool = ReplicaPool(net, n_replicas=2, devices=CPU2)
    a, b = pool.replicas
    for k, layer in net.params().items():
        for name, t in layer.items():
            assert a.params[k][name].data_ptr() != b.params[k][name].data_ptr()
            assert a.params[k][name].data_ptr() != t.data_ptr()
            assert (a.params[k][name] == t).all() and a.params[k][name].dtype == t.dtype
    with pytest.raises(ValueError, match="4 devices per replica"):
        ReplicaPool(net, plan=ParallelPlan.compose(pipe=4, devices_=["cpu"] * 4),
                    devices=CPU2)


def test_each_replica_captures_into_its_own_cache():
    """One ``AotCache`` per replica: ``compile_count`` sums them; a retired
    replica's cache leaves the count but stays with the replica for the
    batches still in flight on it; indices are never reused."""
    x = _data(8)
    b = ContinuousBatcher(_net(), max_batch_size=4, batch_timeout_ms=1.0, replicas=2,
                          devices=CPU2, warmup_example=x[:1])
    try:
        nb = len(b.buckets)
        r0, r1 = b._pool.replicas
        assert r0.aot is not r1.aot and len(r0.aot) == len(r1.aot) == nb
        assert b.add_replica() == 3 and b.compile_count() == 3 * nb
        new = b._pool.replicas[-1]
        assert b.remove_replica() == 2 and b.compile_count() == 2 * nb
        assert len(new.aot) == nb
        assert b.add_replica() == 3 and b._pool.replicas[-1].index == new.index + 1
        assert b.compile_count() == 3 * nb
    finally:
        b.shutdown()


def test_a_warm_up_failure_raises_and_nothing_serves_eagerly():
    """A forward that fails at warm-up raises out of the batcher (which
    starts no thread); the pool has no eager rule to fall back on."""
    class Refusing(MultiLayerNetwork):
        def _forward(self, *a, **k):
            raise RuntimeError("refused at warm-up")

    net = Refusing(_mln_conf()).init()
    before = {t.name for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="refused at warm-up"):
        ContinuousBatcher(net, max_batch_size=4, replicas=2, devices=CPU2,
                          warmup_example=_data(1))
    assert not {t.name for t in threading.enumerate()} - before


def test_replica_copies_hold_the_bits_of_the_bf16_cast():
    """Under bf16 compute a replica holds its weights already cast: the
    same bits ``cast_floating`` gives inside ``_forward``, so a served
    request equals ``model.output`` at the bucket bit for bit."""
    import torch

    from deeplearning4j_tpu_torch.nn.base import cast_floating
    get_environment().set_compute_dtype("bfloat16")
    net = _net()
    x = _data(8)
    pool = ReplicaPool(net, n_replicas=1)
    cast = cast_floating(net.params(), torch.bfloat16)
    for k, layer in cast.items():
        for name, t in layer.items():
            assert torch.equal(pool.replicas[0].params[k][name], t)
    b = ContinuousBatcher(net, max_batch_size=8, batch_timeout_ms=1.0, warmup_example=x[:1])
    try:
        got = b.submit(x[:3])
        assert got.dtype == np.float32  # bf16 widened exactly
        want = net.output(_pad_rows(x[:3], 4)).float().numpy()[:3]
        assert (got == want).all()
    finally:
        b.shutdown()


def test_deadline_rejected_at_coalesce_and_dispatch_stages():
    net = _net()
    x = _data(8)
    b = ContinuousBatcher(net, max_batch_size=4, batch_timeout_ms=1.0, warmup_example=x[:1])
    gate = threading.Event()
    orig_forward = b._forward
    b._forward = lambda v: (gate.wait(5), orig_forward(v))[1]
    parked = threading.Thread(target=lambda: b.submit(x[:1]))
    parked.start()
    time.sleep(0.05)
    threading.Timer(0.3, gate.set).start()
    with pytest.raises(DeadlineExceeded) as ei:
        b.submit(x[:1], timeout_ms=10.0)
    assert "coalesce" in str(ei.value)
    parked.join(timeout=5)
    b.shutdown()

    b2 = ContinuousBatcher(net, max_batch_size=4, batch_timeout_ms=1.0, pipeline_depth=1,
                           warmup_example=x[:1])
    try:
        with ChaosController() as c:
            c.on("serving.batcher.complete", AddLatency(0.5))
            slow = threading.Thread(target=lambda: b2.submit(x[:1]))
            slow.start()
            time.sleep(0.1)
            with pytest.raises(DeadlineExceeded) as ei:
                b2.submit(x[1:2], timeout_ms=100.0)
            assert "dispatch" in str(ei.value), str(ei.value)
            slow.join(timeout=10)
            assert not slow.is_alive()
    finally:
        b2.shutdown()


def test_midflight_fault_fails_only_that_batch():
    net, ref = _net(), _net()
    x = _data(32)
    b = ContinuousBatcher(net, max_batch_size=8, batch_timeout_ms=1.0, replicas=2,
                          devices=CPU2, pipeline_depth=4, warmup_example=x[:1])
    try:
        with ChaosController() as c:
            c.on("serving.batcher.forward", FailNth(2))
            r1 = np.asarray(b.submit(x[:2]))
            with pytest.raises(ChaosError):
                b.submit(x[2:4])
            r3 = np.asarray(b.submit(x[4:6]))
        assert (r1 == _ref_at_bucket(ref, x[:2], 2)).all()
        assert (r3 == _ref_at_bucket(ref, x[4:6], 2)).all()
        with ChaosController() as c:
            c.on("serving.batcher.complete", FailNth(1))
            with pytest.raises(ChaosError):
                b.submit(x[:2])
            r5 = np.asarray(b.submit(x[6:8]))
        assert (r5 == _ref_at_bucket(ref, x[6:8], 2)).all()
        outcomes = []
        lock = threading.Lock()

        def client(i):
            try:
                got = np.asarray(b.submit(x[i:i + 1], timeout_ms=10_000))
                ok = any((got == _ref_at_bucket(ref, x[i:i + 1], bk)).all() for bk in b.buckets)
                with lock:
                    outcomes.append("ok" if ok else "WRONG")
            except BaseException as e:
                with lock:
                    outcomes.append(type(e).__name__)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert not any(t.is_alive() for t in threads), "pipeline wedged"
        assert outcomes.count("ok") == 8, f"outcomes: {outcomes}"
    finally:
        b.shutdown()


def test_bad_request_mix_fails_batch_not_worker():
    x = _data(8)
    b = ContinuousBatcher(_net(), max_batch_size=8, batch_timeout_ms=20.0, warmup_example=x[:1])
    try:
        results = []
        lock = threading.Lock()

        def client(arr):
            try:
                r = np.asarray(b.submit(arr))
                with lock:
                    results.append(("ok", r))
            except BaseException as e:
                with lock:
                    results.append(("err", e))

        threads = [threading.Thread(target=client, args=(x[:1],)),
                   threading.Thread(target=client, args=(np.zeros((1, 5), np.float32),))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads), "caller hung"
        assert len(results) == 2
        assert any(k == "err" for k, _ in results)
        assert b._worker.is_alive(), "coalescer thread died"
        assert np.asarray(b.submit(x[:2])).shape == (2, 4)
    finally:
        b.shutdown()


def test_oversized_request_warms_new_bucket_on_every_replica():
    net, ref = _net(), _net()
    x = _data(64)
    b = ContinuousBatcher(net, max_batch_size=8, batch_timeout_ms=1.0, replicas=2,
                          devices=CPU2, warmup_example=x[:1])
    try:
        assert b.buckets == [1, 2, 4, 8]
        assert b.compile_count() == 4 * 2
        got = np.asarray(b.submit(x[:20]))
        assert 32 in b.buckets
        assert (got == _ref_at_bucket(ref, x[:20], 32)).all()
        assert b.compile_count() == len(b.buckets) * 2
        c0 = b.compile_count()
        np.asarray(b.submit(x[:17]))
        np.asarray(b.submit(x[:20]))
        assert b.compile_count() == c0, "surprise capture after bucket mint"
    finally:
        b.shutdown()


def test_admission_overload_rejects_explicitly():
    b = ContinuousBatcher(_net(), max_batch_size=4, batch_timeout_ms=1.0, queue_limit=2)
    gate = threading.Event()
    orig_forward = b._forward
    b._forward = lambda x: (gate.wait(5), orig_forward(x))[1]
    x = _data(16)
    outcomes, hints = [], []

    def client(i):
        try:
            b.submit(x[i:i + 1])
            outcomes.append("ok")
        except Overloaded as e:
            outcomes.append("overloaded")
            hints.append(e.retry_after_ms)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    gate.set()
    for t in threads:
        t.join(timeout=5)
    b.shutdown()
    assert len(outcomes) == 12, "no request may hang or vanish"
    assert "overloaded" in outcomes and "ok" in outcomes
    assert b.metrics.snapshot()["rejected_overload"] == outcomes.count("overloaded")
    assert all(h is not None and h >= 25.0 for h in hints)  # the floor, nothing measured


def test_deadline_exceeded():
    b = ContinuousBatcher(_net(), max_batch_size=4, batch_timeout_ms=1.0)
    gate = threading.Event()
    orig_forward = b._forward
    b._forward = lambda x: (gate.wait(5), orig_forward(x))[1]
    x = _data(4)
    parked = threading.Thread(target=lambda: b.submit(x[:1]))
    parked.start()
    time.sleep(0.05)
    threading.Timer(0.3, gate.set).start()
    with pytest.raises(DeadlineExceeded):
        b.submit(x[:1], timeout_ms=10.0)
    parked.join(timeout=5)
    b.shutdown()


def test_admission_controller_defaults():
    ac = AdmissionController(queue_limit=3, default_timeout_ms=5.0)
    ac.admit(2)
    with pytest.raises(Overloaded):
        ac.admit(3)
    d = ac.deadline_for(None)
    assert d is not None and d - time.monotonic() < 0.006
    assert ac.deadline_for(1000.0) - time.monotonic() > 0.9
    assert AdmissionController().deadline_for(None) is None


def test_batcher_computation_graph_multi_input():
    g = ComputationGraph(_graph_conf()).init()
    ref = ComputationGraph(_graph_conf()).init()
    xa, xb = _data(32, seed=1, dim=8), _data(32, seed=2, dim=6)
    b = ContinuousBatcher(g, max_batch_size=8, batch_timeout_ms=5.0,
                          warmup_example={"in_a": xa[:1], "in_b": xb[:1]})
    try:
        results = {}

        def client(i, n):
            results[i] = np.asarray(b.submit({"in_a": xa[i:i + n], "in_b": xb[i:i + n]}))

        threads = [threading.Thread(target=client, args=(i, 1 + i % 3)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        for i in range(8):
            n = 1 + i % 3
            candidates = [np.asarray(ref.output(_pad_rows(xa[i:i + n], bk),
                                                _pad_rows(xb[i:i + n], bk)))[:n]
                          for bk in b.buckets if bk >= n]
            assert any((results[i] == c).all() for c in candidates), f"request {i}"
        assert b.compile_count() <= len(b.buckets)
    finally:
        b.shutdown()


def test_unsupported_options_raise_by_name():
    """What plan-sliced serving refuses, by name: a feature mask through a
    pipe slice's forward, a session step on a plan slice, and a plan wider
    than the devices."""
    import torch

    from deeplearning4j_tpu_torch.parallel import PipePlanExecutor
    net = _net()
    plan = ParallelPlan.compose(pipe=2, devices_=CPU2)
    ex = PipePlanExecutor(net, plan)
    x = torch.zeros((1, FEATURES))
    with pytest.raises(NotImplementedError, match="feature masks"):
        ex.make_forward()(ex.pack_params(net.params()), {}, x, torch.ones((1, FEATURES)))
    b = ContinuousBatcher(net, plan=plan, devices=CPU2, max_batch_size=2)
    try:
        with pytest.raises(ValueError, match="plan slices"):
            b._pool.step(b._pool.replicas[0], {}, np.zeros((1, FEATURES), np.float32))
    finally:
        b.shutdown()
    with pytest.raises(ValueError, match="2 devices per replica"):
        ContinuousBatcher(_net(), plan=plan, devices=["cpu"])


def test_duck_typed_model_is_one_honest_pseudo_replica():
    class Doubler:
        def output(self, x):
            import torch
            return torch.from_numpy(np.asarray(x) * 2.0)

    b = ContinuousBatcher(Doubler(), max_batch_size=4, batch_timeout_ms=1.0, replicas=3)
    try:
        x = _data(3)
        assert (b.submit(x) == x * 2.0).all()
        assert b.replica_count == 1 and b.compile_count() == 0
        with pytest.raises(ValueError, match="fallback"):
            b.add_replica()
    finally:
        b.shutdown()


# ---------------------------------------------------------------- metrics
def test_latency_histogram_percentiles():
    h = LatencyHistogram()
    assert h.percentile(99) == 0.0
    for ms in range(1, 101):
        h.observe(ms / 1000.0)
    assert h.count == 100
    assert 0.05 <= h.percentile(50) <= 0.11
    assert h.percentile(99) >= 0.09
    assert h.max == pytest.approx(0.1)
    assert h.mean == pytest.approx(0.0505, rel=1e-6)


def test_serving_metrics_snapshot_and_prometheus():
    m = ServingMetrics(queue_depth_fn=lambda: 3, compile_count_fn=lambda: 6,
                       inflight_fn=lambda: 2)
    m.record_admitted()
    m.record_response(0.004)
    m.record_batch(real_rows=6, padded_rows=8, latency_s=0.003, replica=1)
    m.record_dispatch(0.002)
    m.record_rejection("overload")
    m.record_rejection("deadline")
    s = m.snapshot()
    assert s["requests_total"] == 1 and s["responses_total"] == 1
    assert s["rejected_overload"] == 1 and s["rejected_deadline"] == 1
    assert s["batch_occupancy"] == 0.75
    assert s["queue_depth"] == 3 and s["compile_count"] == 6
    assert s["latency_p50_s"] > 0
    assert s["inflight_depth"] == 2
    assert s["replica_batches"] == {1: 1}
    assert s["dispatch_p99_s"] > 0
    text = m.render_prometheus("m")
    assert 'serving_requests_total{model="m"} 1' in text
    assert 'serving_inflight_depth{model="m"} 2' in text
    assert 'serving_replica_batches_total{model="m",replica="1"} 1' in text


def test_profiler_reuses_latency_histogram():
    from deeplearning4j_tpu_torch.runtime.profiler import OpProfiler
    prof = OpProfiler()
    for _ in range(20):
        with prof.section("step"):
            time.sleep(0.001)
    t = prof.timings()["step"]
    assert t["count"] == 20
    assert 0 < t["p50_s"] <= t["p99_s"]
    prof.reset()
    assert prof.timings() == {}


# ------------------------------------------------- against live JAX runs
@pytest.fixture(scope="module")
def jax_archive(tmp_path_factory):
    net = JMultiLayerNetwork(_jax_conf()).init()
    path = str(tmp_path_factory.mktemp("serving") / "mlp.zip")
    JSerializer.write_model(net, path)
    return path


def test_served_outputs_and_compile_counts_match_jax(jax_archive):
    """One JAX archive, both packages' batchers (2 replicas, depth 2, warmed
    from the same example): each sequential request alone at its bucket
    within 1e-5 relative; the same number of programs after warm-up, after
    the traffic, and after an oversized request mints a bucket."""
    x = _data(64, seed=9)
    port = ContinuousBatcher(ModelSerializer.restore_model(jax_archive, device="cpu"),
                             max_batch_size=16, batch_timeout_ms=1.0, replicas=2,
                             devices=CPU2, warmup_example=x[:1])
    jax = JBatcher(JSerializer.restore_model(jax_archive), max_batch_size=16,
                   batch_timeout_ms=1.0, replicas=2, warmup_example=x[:1])
    try:
        assert port.compile_count() == jax.compile_count() == 5 * 2
        for n in (1, 2, 3, 5, 8, 13, 16, 4):
            np.testing.assert_allclose(port.submit(x[:n]), np.asarray(jax.submit(x[:n])),
                                       rtol=1e-5, atol=1e-7, err_msg=f"rows={n}")
        assert port.compile_count() == jax.compile_count() == 10
        np.testing.assert_allclose(port.submit(x[:20]), np.asarray(jax.submit(x[:20])),
                                   rtol=1e-5, atol=1e-7)
        assert port.buckets == jax.buckets == [1, 2, 4, 8, 16, 32]
        assert port.compile_count() == jax.compile_count() == 12
        assert port.warmup_manifest().pairs == jax.warmup_manifest().pairs
    finally:
        port.shutdown()
        jax.shutdown()


def test_admission_and_deadline_scenario_matches_jax():
    """A scripted scenario on both packages' stopped batchers: the same
    batch latencies recorded, then admission at queue depths 0-4 under
    ``queue_limit=3`` (outcome and ``retry_after_ms`` each), then
    deadlines at the coalesce stage (expired, live, no deadline)."""
    from deeplearning4j_tpu.serving import Overloaded as JOverloaded
    from deeplearning4j_tpu.serving.batcher import _Request as JRequest

    port = ContinuousBatcher(_net(), max_batch_size=8, queue_limit=3)
    jax = JBatcher(JMultiLayerNetwork(_jax_conf()).init(), max_batch_size=8, queue_limit=3)
    for b in (port, jax):
        b.shutdown(drain=False)

    def script(b, overloaded, request):
        out = []
        for lat in (0.4, 0.65, 1.2):
            b.metrics.record_batch(real_rows=5, padded_rows=8, latency_s=lat, replica=0)
        for depth in range(5):
            try:
                b.admission.admit(depth, b._drain_ms_per_request())
                out.append(("admitted", depth))
            except overloaded as e:
                out.append(("Overloaded", round(e.retry_after_ms, 9)))
        now = time.monotonic()
        reqs = [request(_data(1), 1, now - 0.5), request(_data(1), 1, now + 60.0),
                request(_data(1), 1, None)]
        live = b._expire(reqs, "coalesce")
        out += [(type(r.error).__name__ if r.error is not None else "live",
                 "coalesce" in str(r.error)) for r in reqs]
        out.append(("live", len(live)))
        out.append(("rejected_deadline", b.metrics.snapshot()["rejected_deadline"]))
        return out

    got = script(port, Overloaded, _Request)
    want = script(jax, JOverloaded, JRequest)
    assert got == want
    # the drain rate: mean batch latency 750 ms over a full bucket of 8, x depth
    assert got[3] == ("Overloaded", 3 * 750.0 / 8) and got[4] == ("Overloaded", 4 * 750.0 / 8)
