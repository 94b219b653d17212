"""The port's capacity ledger against the JAX package.

Mirrors the capacity-accounting and replica-resize cases of
``tests/test_capacity_autoscale.py`` on ``deeplearning4j_tpu_torch`` (the
HTTP, router and autoscaler cases come with serving's host side). Against
live JAX runs: one archive served by both packages' registries gives the
same per-model accounting in float32 (parameter, state and device bytes per
dtype, replicas, queue, graphs), and ``render_prometheus`` renders the same
text for the same payload, a pager's residency section included. The port's
own rules: the ledger keys charges by mesh position, counts the replicas'
copies at the compute dtype, and leaves a model's host copy out.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.models import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
from deeplearning4j_tpu.serving import capacity as jcap
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime import profiler
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import ModelRegistry
from deeplearning4j_tpu_torch.serving import capacity as cap


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    env.set_aot_dispatch(True)
    yield
    env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch = saved


def _conf(seed=7):
    return (NeuralNetConfiguration.builder().seed(seed).updater(None).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())


def _jax_conf(seed=7):
    return (JConf.builder().seed(seed).updater(None).list()
            .layer(JDense(n_out=16, activation="tanh"))
            .layer(JOutput(n_out=4, activation="softmax"))
            .set_input_type(JInputType.feed_forward(8)).build())


RNG = np.random.default_rng(0)
X = RNG.normal(size=(16, 8)).astype(np.float32)
BATCHER_KW = dict(max_batch_size=4, buckets=[1, 4], batch_timeout_ms=1.0, pipeline_depth=0)


def _registry():
    reg = ModelRegistry()
    reg.register("m", MultiLayerNetwork(_conf(), device="cpu").init(),
                 warmup_example=X[:1], **BATCHER_KW)
    return reg


def _tree_bytes(tree):
    from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.fixture(scope="module")
def jax_archive(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("capacity") / "m.zip")
    JSerializer.write_model(JMultiLayerNetwork(_jax_conf()).init(), path)
    return path


# ==========================================================================
# capacity accounting
def test_capacity_accounting_matches_registry_exactly():
    reg = _registry()
    try:
        served = reg.get("m")
        payload = cap.registry_capacity(reg)
        c = payload["models"]["m"]
        net = served.model
        assert c["param_bytes"] == _tree_bytes(net.params())
        assert c["model_state_bytes"] == _tree_bytes(net._model_state)
        assert c["device_bytes_total"] == c["param_bytes"] + c["model_state_bytes"]
        assert c["param_dtype_bytes"] == {"float32": c["param_bytes"]}
        assert c["per_device_bytes"] == {"cpu#0": c["device_bytes_total"]}
        assert c["replicas"] == 1
        assert c["queue"]["limit"] == 256
        assert c["queue"]["headroom_requests"] == 256
        assert c["aot_executables"] == len(c["buckets"])
        assert payload["totals"]["param_bytes"] == c["param_bytes"]
        u = c["utilization"]
        assert u["window_s"] > 0 and u["busy_s"] >= 0.0
        assert u["busy_fraction"] == pytest.approx(u["busy_s"] / u["window_s"], rel=1e-3)
        assert payload["process"]["device_budget_bytes"] is None  # the CPU reports none
        assert profiler.device_memory_stats() == {}
        profiler.attach_capacity(lambda: cap.registry_capacity(reg))
        try:
            assert profiler.capacity_stats()["models"]["m"]["param_bytes"] == c["param_bytes"]
        finally:
            profiler.detach_capacity()
    finally:
        reg.shutdown()


def test_capacity_payload_matches_jax_for_one_archive(jax_archive):
    """Both packages' registries load one archive with 2 replicas: the same
    per-model accounting in float32 (the ledger: one copy per replica)."""
    reg, jreg = ModelRegistry(), JRegistry()
    try:
        reg.load("m", jax_archive, warmup_example=X[:1], replicas=2, devices=["cpu", "cpu"],
                 save_manifest=False, device="cpu", **BATCHER_KW)
        jreg.load("m", jax_archive, warmup_example=X[:1], replicas=2, save_manifest=False,
                  **BATCHER_KW)
        got, want = cap.registry_capacity(reg), jcap.registry_capacity(jreg)
        g, w = got["models"]["m"], want["models"]["m"]
        for k in ("param_bytes", "param_dtype_bytes", "model_state_bytes", "replicas",
                  "device_bytes_total", "aot_executables", "warmed_pairs", "buckets",
                  "max_batch_size", "dtype_policy", "version", "health", "queue"):
            assert g[k] == w[k], k
        assert [r["bytes"] for r in g["per_replica"]] == [r["bytes"] for r in w["per_replica"]]
        assert sorted(g["per_device_bytes"].values()) == sorted(w["per_device_bytes"].values())
        assert got["totals"] == want["totals"]
        assert reg.get("m").device_bytes == jreg.get("m").device_bytes
    finally:
        reg.shutdown()
        jreg.shutdown()


def test_ledger_counts_replicas_at_the_compute_dtype_by_position():
    """In bfloat16 the replicas hold bf16 copies and the ledger says so;
    two replicas over ``["cpu", "cpu"]`` are two positions of one card."""
    env = get_environment()
    net = MultiLayerNetwork(_conf(), device="cpu").init()
    env.set_compute_dtype("bfloat16")
    reg = ModelRegistry()
    try:
        served = reg.register("m", net, warmup_example=X[:1], replicas=2,
                              devices=["cpu", "cpu"], **BATCHER_KW)
        params = _tree_bytes(net.params())
        assert served.device_bytes == 2 * params // 2
        assert cap.served_device_dtype_bytes(served) == {"bfloat16": params}
        assert cap.served_per_device_bytes(served) == {"cpu#0": params // 2,
                                                       "cpu#1": params // 2}
        assert cap.served_physical_device_bytes(served) == {"cpu": params}
        assert reg.residency_snapshot()["per_physical_device_bytes"] == {"cpu": params}
    finally:
        reg.shutdown()


def test_evicted_entry_leaves_the_ledger_and_frees_its_replicas(tmp_path):
    """An eviction closes the pool: the replicas' tensors and graphs go, and
    the ledger of what is left reads nothing for the entry."""
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(MultiLayerNetwork(_conf(), device="cpu").init(), path)
    reg = ModelRegistry()
    try:
        served = reg.load("m", path, warmup_example=X[:1], **BATCHER_KW)
        pool = served.batcher._pool
        assert served.device_bytes > 0 and pool.aot_count() == 2
        assert reg.evict("m") is True
        assert pool.live_replicas() == [] and pool.aot_count() == 0
        assert all(r.params is None and r.aot._entries == {} for r in pool.replicas)
        assert cap.served_device_bytes(served) == 0
        assert reg.resident_bytes() == 0
    finally:
        reg.shutdown()


def test_render_prometheus_matches_jax_for_the_same_payload(jax_archive):
    reg = ModelRegistry(hbm_budget_bytes=10_000)
    jreg = JRegistry(hbm_budget_bytes=10_000)
    try:
        reg.load("m", jax_archive, warmup_example=X[:1], save_manifest=False, device="cpu",
                 **BATCHER_KW)
        jreg.load("m", jax_archive, warmup_example=X[:1], save_manifest=False, **BATCHER_KW)
        reg.predict("m", X[:2])
        jreg.predict("m", X[:2])
        for payload in (cap.registry_capacity(reg), jcap.registry_capacity(jreg)):
            text = cap.render_prometheus(payload)
            assert text == jcap.render_prometheus(payload)
            assert text == jcap.render_prometheus(payload, prefix="capacity")
            assert cap.render_prometheus(payload, "fleet_capacity") == \
                jcap.render_prometheus(payload, "fleet_capacity")
            for line in ('capacity_param_bytes{model="m"}', 'capacity_replicas{model="m"} 1',
                         "capacity_queue_headroom_requests", "capacity_hbm_budget_bytes 10000",
                         'capacity_model_resident{model="m"} 1',
                         'capacity_param_dtype_bytes{model="m",dtype="float32"}'):
                assert line in text, line
    finally:
        reg.shutdown()
        jreg.shutdown()


def test_device_utilization_and_harvest_match_jax():
    models = {"a": {"utilization": {"busy_s": 1.5, "window_s": 10.0}, "replicas": 2},
              "b": {"utilization": {"busy_s": 0.25, "window_s": 4.0}, "replicas": 1}}
    for h in (0.0, 3.0):
        assert cap.device_utilization(models, h) == jcap.device_utilization(models, h)
    cap.attach_harvest(lambda: {"harvested_busy_s": 2.0})
    reg = _registry()
    try:
        out = cap.registry_capacity(reg)
        assert out["scheduler"] == {"harvested_busy_s": 2.0}
        assert out["utilization"]["harvested_busy_s"] == 2.0
    finally:
        cap.detach_harvest()
        reg.shutdown()


# ==========================================================================
# runtime replica resize
def test_replica_resize_bit_identical_and_never_reuses_indices():
    reg = _registry()
    try:
        served = reg.get("m")
        b = served.batcher
        oracle = served.model.output(np.concatenate([X[:2], np.zeros((2, 8), X.dtype)]))
        oracle = oracle.numpy()[:2]
        base = b.compile_count()
        assert b.replica_count == 1
        assert b.add_replica() == 2
        after_add = b.compile_count()
        assert after_add == base + len(b.buckets)
        for _ in range(8):
            assert np.array_equal(reg.predict("m", X[:2]), oracle)
        assert b.compile_count() == after_add
        assert set(served.metrics.snapshot()["replica_batches"]) == {0, 1}
        assert reg.refresh_device_bytes("m") == 2 * cap.model_capacity(served)["param_bytes"]
        assert b.remove_replica() == 1
        assert b.compile_count() == base
        assert np.array_equal(reg.predict("m", X[:2]), oracle)
        b.add_replica()
        assert [r.index for r in b._pool.replicas] == [0, 2]
        assert b.remove_replica() == 1
        with pytest.raises(ValueError):
            b.remove_replica()
    finally:
        reg.shutdown()
