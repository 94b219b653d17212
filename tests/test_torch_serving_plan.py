"""Plan-sliced serving replicas and ``ParallelInference`` on the port,
against the JAX package.

Mirrors the four serving cases of ``tests/test_parallel_plan.py`` (a replica
is one plan slice; the mesh's 8 positions are ``devices=["cpu"] * 8``) and
the ``ParallelInference`` cases of ``tests/test_parallel.py`` on
``deeplearning4j_tpu_torch``. The port's answers are held bit for bit
against ``net.output`` at the bucket shape each request was served at (the
exactness contract of the batcher), with zero captures on traffic.

Against live JAX runs: a plan-sliced warm-up manifest recorded by either
package replays in the other (the same buckets, replicas, pairs and plan),
and the two packages answer alike within 1e-5 relative. ``ParallelInference``
answers bit for bit what the batcher answers.
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
from deeplearning4j_tpu.parallel import ParallelPlan as JPlan
from deeplearning4j_tpu.serving import ContinuousBatcher as JBatcher
from deeplearning4j_tpu.serving.manifest import WarmupManifest as JManifest
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu_torch.models import ComputationGraph, ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.parallel import ParallelInference, ParallelPlan
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import (ContinuousBatcher, HBMBudgetExceeded,
                                              ModelRegistry, ServingShutdown, WarmupManifest)
from deeplearning4j_tpu_torch.serving import capacity
from deeplearning4j_tpu_torch.train import Adam, Sgd

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    env.set_aot_dispatch(True)
    yield
    env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch = saved


def _serve_conf(seed=42, builder=NeuralNetConfiguration, dense=DenseLayer, out=OutputLayer,
                input_type=InputType, sgd=Sgd):
    """5 x Dense(16, relu) + softmax(4) over 8 features (either package)."""
    b = builder.builder().seed(seed).updater(sgd(0.1)).list()
    for _ in range(5):
        b.layer(dense(n_out=16, activation="relu"))
    return (b.layer(out(n_out=4, activation="softmax"))
            .set_input_type(input_type.feed_forward(8)).build())


def _serve_net(seed=42):
    return MultiLayerNetwork(_serve_conf(seed), device="cpu").init()


def _plan(microbatches=2, **axes):
    axes = axes or {"data": 2, "pipe": 4}
    return ParallelPlan.compose(**axes, microbatches=microbatches, devices_=CPU8)


def _pad_rows(x, bucket):
    return np.concatenate([x, np.zeros((bucket - x.shape[0],) + x.shape[1:], x.dtype)])


def _at_bucket(net, x, buckets):
    n = x.shape[0]
    bucket = next(b for b in buckets if b >= n)
    return net.output(_pad_rows(x, bucket)).numpy()[:n]


# ===================================================================
# serving: replica = one plan slice, the manifest records the plan
def test_plan_sliced_batcher_bitwise_zero_traffic_compiles():
    net = _serve_net()
    x = np.random.RandomState(0).randn(16, 8).astype(np.float32)
    plan = _plan()
    cb = ContinuousBatcher(net, max_batch_size=8, batch_timeout_ms=2, replicas=2, plan=plan,
                           devices=CPU8, warmup_example=x[:1])
    try:
        warm = cb.compile_count()
        assert warm == len(cb.buckets) * 2 and cb.replica_count == 2
        for n in (1, 3, 8):
            for i in range(0, 16, n):
                got = cb.submit(x[i:i + n])
                assert np.array_equal(got, _at_bucket(net, x[i:i + n], cb.buckets)), (n, i)
        assert cb.compile_count() == warm
        assert set(cb.metrics.snapshot()["replica_batches"]) == {0, 1}
        m = cb.warmup_manifest()
        assert m.plan == plan.describe()
        assert WarmupManifest.from_dict(m.to_dict()).plan == plan.describe()
        groups = [sorted({k for k, _ in r.placed}) for r in cb._pool.replicas]
        assert groups == [[f"cpu#{i}" for i in range(4)], [f"cpu#{i}" for i in range(4, 8)]]
    finally:
        cb.shutdown()


def test_plan_sliced_pool_spreads_bytes_per_device():
    """Each position is charged only what it holds: the 8 positions of one
    card keep 8 keys, and no position holds a whole replica."""
    from types import SimpleNamespace
    net = _serve_net()
    cb = ContinuousBatcher(net, max_batch_size=8, batch_timeout_ms=2, replicas=2,
                           plan=_plan(microbatches=1), devices=CPU8,
                           warmup_example=np.zeros((1, 8), np.float32))
    try:
        served = SimpleNamespace(batcher=cb, model=net)
        per_dev = capacity.served_per_device_bytes(served)
        total = capacity.served_device_bytes(served)
        assert sorted(per_dev) == [f"cpu#{i}" for i in range(8)]
        assert sum(per_dev.values()) == total
        assert max(per_dev.values()) < total / 2
        assert capacity.served_physical_device_bytes(served) == {"cpu": total}
        params = sum(t.numel() * t.element_size()
                     for layer in net.params().values() for t in layer.values())
        assert total == 2 * params
    finally:
        cb.shutdown()


def test_manifest_replay_of_plan_sliced_warmup_zero_traffic_compiles():
    net = _serve_net()
    x = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    plan = _plan()
    cb1 = ContinuousBatcher(net, max_batch_size=8, batch_timeout_ms=2, replicas=2, plan=plan,
                            devices=CPU8, warmup_example=x[:1])
    m = cb1.warmup_manifest()
    cb1.shutdown()
    assert m.plan == plan.describe()
    cb2 = ContinuousBatcher(net, max_batch_size=m.max_batch_size or 8, batch_timeout_ms=2,
                            replicas=m.replicas, buckets=list(m.buckets), plan=plan,
                            devices=CPU8, warmup_example=m.example())
    try:
        warm = cb2.compile_count()
        assert warm == len(m.pairs)
        outs = np.stack([cb2.submit(x[i:i + 1])[0] for i in range(8)])
        assert np.array_equal(outs, np.stack([_at_bucket(net, x[i:i + 1], cb2.buckets)[0]
                                              for i in range(8)]))
        assert cb2.compile_count() == warm
        assert sorted(cb2._warmed_pairs) == sorted(tuple(p) for p in m.pairs)
    finally:
        cb2.shutdown()


def test_registry_admits_oversized_model_only_when_plan_sliced():
    net = _serve_net()
    host = sum(t.numel() * t.element_size()
               for layer in net.params().values() for t in layer.values())
    budget = int(host * 0.6)
    x = np.zeros((1, 8), np.float32)
    reg = ModelRegistry(hbm_budget_bytes=budget)
    try:
        with pytest.raises(HBMBudgetExceeded):
            reg.register("m-flat", net, warmup_example=x, max_batch_size=8,
                         batch_timeout_ms=2, devices=CPU8)
        served = reg.register("m", net, warmup_example=x, plan=_plan(microbatches=1),
                              replicas=2, max_batch_size=8, batch_timeout_ms=2, devices=CPU8)
        q = np.random.RandomState(2).randn(4, 8).astype(np.float32)
        assert np.array_equal(served.batcher.submit(q), net.output(q).numpy())
        snap = reg.residency_snapshot()
        per_dev = snap["per_device_bytes"]
        assert len(per_dev) == 8 and max(per_dev.values()) <= budget
        assert snap["per_physical_device_bytes"] == {"cpu": sum(per_dev.values())}
    finally:
        reg.shutdown()


def test_tensor_and_fsdp_slices_answer_as_the_network(tmp_path):
    """A tensor slice computes with its pieces where they lie and an FSDP
    slice gathers its pieces at use; both answer as ``net.output`` (float32
    reassociation of the split products), each position charged its
    pieces."""
    from deeplearning4j_tpu_torch.zoo import Bert
    env = get_environment()
    net = Bert.small(vocab_size=50, dropout_rate=0.0).init(device="cpu")
    ids = np.random.default_rng(3).integers(0, 50, (4, 16))
    ref = net.output(ids).numpy()
    for axes in ({"data": 2, "tensor": 2}, {"data": 2, "fsdp": 2}):
        plan = ParallelPlan.compose(**axes, min_size=64, devices_=["cpu"] * 4)
        cb = ContinuousBatcher(net, max_batch_size=4, buckets=[4], replicas=2, plan=plan,
                               devices=["cpu"] * 4, warmup_example=ids[:1])
        try:
            warm = cb.compile_count()
            got = cb.submit(ids)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=str(axes))
            assert cb.compile_count() == warm
            keys = {k for r in cb._pool.replicas for k, _ in r.placed}
            assert len(keys) == 4, (axes, keys)
        finally:
            cb.shutdown()
    assert env.compute_dtype.is_floating_point


# ===================================================================
# manifests across packages
@pytest.fixture(scope="module")
def jax_serve_archive(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("plan") / "serve.zip")
    JSerializer.write_model(JMultiLayerNetwork(_serve_conf(
        42, JConf, JDense, JOutput, JInputType, JSgd)).init(), path)
    return path


def test_plan_sliced_manifest_replays_across_packages(jax_serve_archive):
    """The JAX batcher's plan-sliced manifest replays in the port (the same
    buckets, replicas, pairs and plan), and the port's in the JAX package;
    the two answer alike within 1e-5 relative."""
    jnet = JSerializer.restore_model(jax_serve_archive)
    net = ModelSerializer.restore_model(jax_serve_archive, device="cpu")
    x = np.random.RandomState(4).randn(2, 8).astype(np.float32)
    jplan = JPlan.compose(data=2, pipe=4, microbatches=2)
    plan = _plan()
    assert jplan.describe() == plan.describe()
    jb = JBatcher(jnet, max_batch_size=2, batch_timeout_ms=2, replicas=2, plan=jplan,
                  warmup_example=x[:1])
    try:
        jm = jb.warmup_manifest()
        want = np.asarray(jb.submit(x))
    finally:
        jb.shutdown()
    pm = WarmupManifest.from_dict(jm.to_dict())
    b = ContinuousBatcher(net, max_batch_size=pm.max_batch_size, batch_timeout_ms=2,
                          replicas=pm.replicas, buckets=list(pm.buckets), plan=plan,
                          devices=CPU8, warmup_example=pm.example())
    try:
        warm = b.compile_count()
        assert warm == len(pm.pairs)
        np.testing.assert_allclose(b.submit(x), want, rtol=1e-5, atol=0)
        assert b.compile_count() == warm
        mine = b.warmup_manifest()
        assert mine.plan == jm.plan == plan.describe()
        assert sorted(map(tuple, mine.pairs)) == sorted(map(tuple, jm.pairs))
        assert (mine.buckets, mine.replicas) == (list(jm.buckets), jm.replicas)
    finally:
        b.shutdown()
    back = JManifest.from_dict(mine.to_dict())
    assert back.plan == jplan.describe()
    assert sorted(map(tuple, back.pairs)) == sorted(map(tuple, jm.pairs))


# ===================================================================
# ParallelInference
def _conf(seed=7):
    return (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())


def _data(n=64, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (n, 8)).astype(np.float32)


def test_parallel_inference_batches():
    net = MultiLayerNetwork(_conf(), device="cpu").init()
    pi = ParallelInference(net, max_batch_size=16)
    try:
        x = _data(24)
        np.testing.assert_allclose(net.output(x[:8]).numpy(), pi.output(x[:8]), rtol=1e-5)
        assert np.array_equal(pi.output(x[:8]), _at_bucket(net, x[:8], pi._batcher.buckets))
    finally:
        pi.shutdown()


def test_parallel_inference_computation_graph_multi_input():
    conf = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2))
            .graph_builder()
            .add_inputs("in_a", "in_b")
            .add_layer("ha", DenseLayer(n_out=16, activation="relu"), "in_a")
            .add_layer("hb", DenseLayer(n_out=16, activation="relu"), "in_b")
            .add_vertex("m", MergeVertex(), "ha", "hb")
            .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "m")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(12), InputType.feed_forward(6))
            .build())
    net = ComputationGraph(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    xa = rng.normal(size=(32, 12)).astype(np.float32)
    xb = rng.normal(size=(32, 6)).astype(np.float32)
    pi = ParallelInference(net, max_batch_size=8, batch_timeout_ms=5.0)
    try:
        results = {}

        def client(i, n):
            results[i] = pi.output({"in_a": xa[i:i + n], "in_b": xb[i:i + n]})

        threads = [threading.Thread(target=client, args=(i, 1 + i % 3)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert len(results) == 8
        for i in range(8):
            n = 1 + i % 3
            np.testing.assert_allclose(results[i], net.output(xa[i:i + n], xb[i:i + n]).numpy(),
                                       rtol=1e-6)
    finally:
        pi.shutdown()


def test_parallel_inference_workers_are_device_replicas():
    """``workers(n)`` means n replicas, clamped to the visible devices with a
    warning (one on the CPU, as the JAX package clamps to its local
    devices); every answer bit for bit the same, and the batcher's."""
    net = MultiLayerNetwork(_conf(), device="cpu").init()
    pi = (ParallelInference.builder(net).workers(2).max_batch_size(16)
          .batch_timeout_ms(1.0).build())
    b = ContinuousBatcher(net, max_batch_size=16, batch_timeout_ms=1.0)
    try:
        assert pi.workers == 1
        x = _data(24)
        outs = [pi.output(x[:4]) for _ in range(6)]
        assert all(np.array_equal(o, outs[0]) for o in outs[1:])
        assert np.array_equal(outs[0], b.submit(x[:4]))
        assert pi._batcher.metrics.snapshot()["replica_batches"] == {0: 6}
        np.testing.assert_allclose(outs[0], net.output(x[:4]).numpy(), rtol=1e-5)
        big = ParallelInference.builder(net).workers(64).build()
        assert big.workers == 1
        big.shutdown()
        seq = ParallelInference.builder(net).inference_mode("SEQUENTIAL").max_batch_size(8)
        seq = seq.build()
        assert seq._batcher.max_batch_size == 1
        seq.shutdown()
        with pytest.raises(ValueError, match="inference mode"):
            ParallelInference.builder(net).inference_mode("eager")
    finally:
        pi.shutdown()
        b.shutdown()


def test_parallel_inference_shutdown_does_not_hang_queued_callers():
    net = MultiLayerNetwork(_conf(), device="cpu").init()
    pi = ParallelInference(net, max_batch_size=4, batch_timeout_ms=1.0)
    x = _data(16)
    gate = threading.Event()
    orig = pi._batcher._forward
    pi._batcher._forward = lambda v: (gate.wait(5), orig(v))[1]
    done = []

    def client(i):
        try:
            pi.output(x[i:i + 1])
            done.append("ok")
        except ServingShutdown:
            done.append("shutdown")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    sd = threading.Thread(target=lambda: pi._batcher.shutdown(drain=False, timeout_s=10))
    sd.start()
    time.sleep(0.05)
    gate.set()
    sd.join(timeout=10)
    for t in threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in threads), "output() caller hung"
    assert len(done) == 8 and "shutdown" in done
