"""The port's HBM-budgeted registry pager against the JAX package.

Mirrors ``tests/test_paging.py`` case by case on ``deeplearning4j_tpu_torch``
(the HTTP, fleet-router and autoscaler cases come with serving's host side;
the replica-resize case drives ``add_replica`` and ``refresh_device_bytes``,
what the scale endpoint calls): the policy units, budget enforcement with
cost-weighted eviction, the single-flight page-in race, pins, cold
registration, compile-free page-ins, the honest ``Retry-After``, the
deadline spent once, the hot-swap ledger and the dtype-aware retention.

Against live JAX runs: both packages' registries go through one scripted
sequence of loads, requests, page-ins and evictions under one injected clock
and give the same residency snapshots after every step (the same victims,
states, bytes, traffic and retention weights); the ``Retry-After`` math is
the same function. A session step on a cold model pages it in, as the JAX
store's does.
"""

import os
import shutil
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
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
from deeplearning4j_tpu.serving import admission as jadmission
from deeplearning4j_tpu.serving import paging as jpaging
from deeplearning4j_tpu.serving import registry as jregistry
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime.chaos import AddLatency, ChaosController
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import (DeadlineExceeded, HBMBudgetExceeded,
                                              ModelRegistry, PagingInProgress, SessionStore,
                                              paging)
from deeplearning4j_tpu_torch.serving import registry as pregistry
from deeplearning4j_tpu_torch.serving.admission import page_in_retry_after_ms
from deeplearning4j_tpu_torch.serving.manifest import WarmupManifest, manifest_path


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
X = RNG.normal(size=(4, 8)).astype(np.float32)
KW = dict(max_batch_size=4, buckets=[1, 4], batch_timeout_ms=1.0, pipeline_depth=0,
          warmup_example=X[:1])


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """Six tiny archives (distinct seeds) and their oracle outputs at the
    request's bucket (4 rows)."""
    td = tmp_path_factory.mktemp("paging-archives")
    paths, oracles = [], []
    for i in range(6):
        net = MultiLayerNetwork(_conf(i), device="cpu").init()
        p = str(td / f"m{i}.zip")
        ModelSerializer.write_model(net, p)
        paths.append(p)
        oracles.append(net.output(X).numpy())
    return paths, oracles


def _per_model_bytes(archives):
    reg = ModelRegistry()
    try:
        return reg.load("probe", archives[0][0], save_manifest=False, **KW).device_bytes
    finally:
        reg.shutdown()


# ==========================================================================
# policy units
def test_env_budget_parsing():
    for env in ({}, {paging.ENV_BUDGET: ""}, {paging.ENV_BUDGET: "  123456 "},
                {paging.ENV_BUDGET: "nope"}, {paging.ENV_BUDGET: "-5"},
                {paging.ENV_BUDGET: "0"}):
        assert paging.env_hbm_budget(env) == jpaging.env_hbm_budget(env)
    assert paging.ENV_BUDGET == jpaging.ENV_BUDGET == "DL4J_TPU_HBM_BUDGET_BYTES"
    assert paging.env_hbm_budget({paging.ENV_BUDGET: "  123456 "}) == 123456
    assert paging.env_hbm_budget({paging.ENV_BUDGET: "nope"}) is None


def test_retention_weight_cost_weighted_lru():
    assert paging.retention_weight(10_000, 1.0, 1.0) < paging.retention_weight(1_000, 1.0, 1.0)
    assert paging.retention_weight(1_000, 0.1, 1.0) < paging.retention_weight(1_000, 10.0, 1.0)
    assert paging.retention_weight(1_000, 1.0, 0.25) < paging.retention_weight(1_000, 1.0, 1.0)
    assert paging.retention_weight(2_000, 0.0, 1.0) < paging.retention_weight(1_000, 0.0, 1.0)
    for args in ((10_000, 1.0, 1.0), (1_000, 0.1, 0.5), (0, 0.0, 0.25)):
        assert paging.retention_weight(*args) == jpaging.retention_weight(*args)


def test_traffic_ewma_decays_with_halflife():
    e, je = paging.TrafficEWMA(halflife_s=10.0), jpaging.TrafficEWMA(halflife_s=10.0)
    for _ in range(8):
        e.update(now=100.0)
        je.update(now=100.0)
    assert e.rate(now=100.0) == pytest.approx(8.0)
    assert e.rate(now=110.0) == pytest.approx(4.0)
    assert e.rate(now=130.0) == pytest.approx(1.0)
    e.update(now=130.0)
    assert e.rate(now=130.0) == pytest.approx(2.0)
    je.rate(now=110.0)
    je.update(now=130.0)
    assert e.rate(now=131.5) == je.rate(now=131.5)


def test_recompile_risk_tiers(tmp_path):
    assert paging.recompile_risk(None) == 1.0
    archive = str(tmp_path / "m.zip")
    assert paging.recompile_risk(archive) == 1.0
    WarmupManifest.from_example(X[:1], buckets=[1, 4], replicas=1,
                                pairs=[(1, 0, "float32")]).save(manifest_path(archive))
    assert paging.recompile_risk(archive) in (0.25, 0.5)


def test_page_in_retry_after_honest_math():
    assert page_in_retry_after_ms(900.0, 300.0) == 600.0
    assert page_in_retry_after_ms(900.0, 2000.0) == 25.0
    assert page_in_retry_after_ms(0.0, 0.0, floor_ms=40.0) == 40.0
    for args in ((900.0, 300.0), (900.0, 2000.0), (1234.5, 0.25), (0.0, 0.0)):
        assert page_in_retry_after_ms(*args) == jadmission.page_in_retry_after_ms(*args)


def test_manifest_roundtrips_paging_fields(tmp_path):
    m = WarmupManifest.from_example(X[:1], buckets=[1, 4], replicas=1,
                                    pairs=[(1, 0, "float32")])
    m.device_bytes = 4096
    m.page_in_s = 0.75
    p = str(tmp_path / "m.warmup.json")
    m.save(p)
    back = WarmupManifest.load(p)
    assert back.device_bytes == 4096 and back.page_in_s == 0.75
    assert WarmupManifest.from_dict(
        {k: v for k, v in m.to_dict().items()
         if k not in ("device_bytes", "page_in_s")}).device_bytes == 0


# ==========================================================================
# registry state machine
def test_budget_enforced_and_cost_weighted_eviction(archives):
    paths, oracles = archives
    per = _per_model_bytes(archives)
    budget = int(per * 2.5)
    reg = ModelRegistry(hbm_budget_bytes=budget)
    try:
        reg.load("a", paths[0], **KW)
        reg.load("b", paths[1], **KW)
        assert reg.resident_bytes() <= budget
        for _ in range(5):
            reg.predict("a", X)
        reg.load("c", paths[2], **KW)
        assert reg.resident_bytes() <= budget
        snap = reg.residency_snapshot()
        assert snap["models"]["a"]["state"] == "resident"
        assert snap["models"]["b"]["state"] == "cold"
        assert snap["models"]["c"]["state"] == "resident"
        assert snap["hbm_budget_bytes"] == budget
        assert snap["resident_bytes"] == reg.resident_bytes()
        assert snap["per_physical_device_bytes"] == {"cpu": snap["resident_bytes"]}
        assert np.array_equal(reg.predict("b", X), oracles[1])
        assert reg.resident_bytes() <= budget
        assert reg.paging.snapshot()["page_ins_total"] == 1
        assert reg.paging.snapshot()["evictions_total"] >= 2
    finally:
        reg.shutdown()


def test_single_flight_page_in_race(archives):
    paths, oracles = archives
    per = _per_model_bytes(archives)
    reg = ModelRegistry(hbm_budget_bytes=int(per * 1.5))
    try:
        reg.load("a", paths[0], **KW)
        reg.load("b", paths[1], **KW)
        assert reg.resident_names() == ["b"]
        before = reg.paging.snapshot()["page_ins_total"]
        results, errors = [], []

        def hit():
            try:
                results.append(reg.predict("a", X))
            except Exception as e:  # pragma: no cover - the assert reports
                errors.append(repr(e))

        # the flight takes long enough that every thread meets it
        with ChaosController(seed=2) as c:
            c.on("serving.registry.page_in", AddLatency(0.2))
            threads = [threading.Thread(target=hit) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        assert errors == [] and len(results) == 8
        assert all(np.array_equal(r, oracles[0]) for r in results)
        pg = reg.paging.snapshot()
        assert pg["page_ins_total"] - before == 1
        assert pg["page_in_queue_waits_total"] >= 1
    finally:
        reg.shutdown()


def test_pinned_model_never_evicted(archives):
    paths, _ = archives
    reg = ModelRegistry()
    try:
        reg.load("a", paths[0], **KW)
        served = reg.acquire("a")
        assert served.pins == 1
        assert reg.evict("a") is False
        assert reg.resident_names() == ["a"]
        served.unpin()
        assert reg.evict("a") is True
        assert reg.resident_names() == []
        assert reg.residency_snapshot()["models"]["a"]["state"] == "cold"
    finally:
        reg.shutdown()


def test_register_cold_spends_no_hbm_until_first_request(archives):
    paths, oracles = archives
    reg1 = ModelRegistry()
    try:
        measured = reg1.load("m", paths[3], **KW).device_bytes
        assert reg1.evict("m") is True
        assert WarmupManifest.load_for_archive(paths[3]).device_bytes == measured
    finally:
        reg1.shutdown()
    reg = ModelRegistry()
    try:
        assert reg.load("m", paths[3], resident=False, **KW) is None
        assert reg.resident_bytes() == 0
        assert "m" in reg.names() and reg.resident_names() == []
        snap = reg.residency_snapshot()["models"]["m"]
        assert snap["state"] == "cold" and snap["bytes"] == measured
        with pytest.raises(KeyError):
            reg.get("m")
        assert np.array_equal(reg.predict("m", X), oracles[3])
        assert reg.resident_names() == ["m"]
        assert reg.get("m").device_bytes == measured
        reg.load("never", paths[4], resident=False, **KW)
        reg.undeploy("never")
        assert "never" not in reg.names()
    finally:
        reg.shutdown()


def test_page_in_is_compile_free_after_manifest(archives):
    paths, _ = archives
    reg = ModelRegistry()
    try:
        reg.load("m", paths[0], **KW)
        assert reg.evict("m") is True
        served = reg.page_in("m")
        at_page_in = served.batcher.compile_count()
        assert at_page_in == len(served.batcher.buckets)
        for _ in range(5):
            reg.predict("m", X)
        assert served.batcher.compile_count() == at_page_in
    finally:
        reg.shutdown()


def test_deadline_too_short_gets_honest_paging_rejection(archives):
    paths, oracles = archives
    reg = ModelRegistry()
    try:
        reg.load("m", paths[0], **KW)
        assert reg.evict("m") is True
        leader_out = []

        def leader():
            with ChaosController(seed=1) as c:
                c.on("serving.registry.page_in", AddLatency(0.6))
                leader_out.append(reg.predict("m", X))

        t = threading.Thread(target=leader)
        t.start()
        deadline = time.monotonic() + 5.0
        while "m" not in reg._flights and time.monotonic() < deadline:
            time.sleep(0.005)
        assert "m" in reg._flights, "leader never opened a page-in flight"
        with pytest.raises(PagingInProgress) as ei:
            reg.predict("m", X, timeout_ms=30.0)
        t.join()
        assert ei.value.retry_after_ms >= 25.0
        assert np.array_equal(leader_out[0], oracles[0])
        assert reg.paging.snapshot()["page_in_rejections_total"] >= 1
    finally:
        reg.shutdown()


def test_budget_smaller_than_one_model_raises_explicitly(archives):
    paths, _ = archives
    per = _per_model_bytes(archives)
    reg = ModelRegistry(hbm_budget_bytes=max(1, per // 2))
    try:
        with pytest.raises(HBMBudgetExceeded):
            reg.load("m", paths[0], **KW)
        assert reg.resident_names() == [] and reg.resident_bytes() == 0
    finally:
        reg.shutdown()


def test_describe_and_names_include_cold(archives):
    paths, _ = archives
    reg = ModelRegistry()
    try:
        reg.load("hot", paths[0], **KW)
        reg.load("cold", paths[1], resident=False, **KW)
        assert reg.names() == ["cold", "hot"]
        desc = {d["name"]: d for d in reg.describe()}
        assert desc["hot"]["residency"] == "resident"
        assert desc["cold"]["residency"] == "cold"
        assert desc["cold"]["archive"] == paths[1]
        assert reg.ready() is True
    finally:
        reg.shutdown()


def test_deadline_spent_once_across_page_in(archives):
    paths, oracles = archives
    reg = ModelRegistry()
    try:
        reg.load("m", paths[0], **KW)
        assert reg.evict("m") is True
        with ChaosController(seed=3) as c:
            c.on("serving.registry.page_in", AddLatency(0.4))
            with pytest.raises(DeadlineExceeded):
                reg.predict("m", X, timeout_ms=50.0)
        assert reg.resident_names() == ["m"]
        assert np.array_equal(reg.predict("m", X), oracles[0])
    finally:
        reg.shutdown()


def test_cold_hit_counts_traffic_once(archives):
    paths, _ = archives
    per = _per_model_bytes(archives)
    reg = ModelRegistry(hbm_budget_bytes=int(per * 1.5))
    try:
        reg.load("a", paths[0], **KW)
        reg.load("b", paths[1], **KW)
        reg.predict("a", X)
        snap = reg.residency_snapshot()["models"]["a"]
        assert snap["traffic_ewma"] == pytest.approx(1.0, abs=0.05)
    finally:
        reg.shutdown()


def test_hot_swap_ledger_never_over_budget(archives):
    paths, _ = archives
    per = _per_model_bytes(archives)
    budget = int(per * 1.5)
    reg = ModelRegistry(hbm_budget_bytes=budget)
    try:
        reg.load("a", paths[0], **KW)
        samples, stop = [], threading.Event()

        def sampler():
            while not stop.is_set():
                samples.append(reg.resident_bytes())
                time.sleep(0.002)

        t = threading.Thread(target=sampler)
        t.start()
        try:
            with ChaosController(seed=4) as c:
                c.on("serving.batcher.warmup", AddLatency(0.2))
                reg.load("a", paths[1], **KW)
        finally:
            stop.set()
            t.join()
        assert samples and max(samples) <= budget
        assert reg.get("a").version == 2
    finally:
        reg.shutdown()


def test_all_cold_registry_stays_ready(archives):
    paths, _ = archives
    reg = ModelRegistry()
    try:
        reg.load("m", paths[0], **KW)
        assert reg.evict("m") is True
        assert reg.health() == {"m": "cold"} and reg.ready() is True
        reg.page_in("m")
        assert reg.ready() is True
        reg.get("m")._started = False
        assert reg.ready() is False
    finally:
        reg.shutdown()


def test_replica_resize_refreshes_hbm_ledger(archives):
    """A runtime resize mints copies the register-time measurement cannot
    know: ``refresh_device_bytes`` re-measures the ledger and pages others
    out when the new footprint overshoots (what the scale endpoint does)."""
    paths, _ = archives
    per = _per_model_bytes(archives)
    reg = ModelRegistry(hbm_budget_bytes=int(per * 3.5))
    try:
        a = reg.load("a", paths[0], devices=["cpu"] * 3, **KW)
        reg.load("b", paths[1], **KW)
        assert a.batcher.add_replica() == 2
        assert reg.refresh_device_bytes("a") == 2 * per
        snap = reg.residency_snapshot()
        assert snap["models"]["a"]["bytes"] == 2 * per
        assert snap["resident_bytes"] == 3 * per
        assert sorted(snap["per_device_bytes"].values()) == [per, 2 * per]
        assert a.batcher.add_replica() == 3
        reg.refresh_device_bytes("a")
        snap = reg.residency_snapshot()
        assert snap["models"]["a"]["bytes"] == 3 * per
        assert snap["models"]["b"]["state"] == "cold"
        assert snap["resident_bytes"] <= int(per * 3.5)
    finally:
        reg.shutdown()


# ==========================================================================
# int8 residency in eviction scoring
def test_dtype_density_follows_residency_policy():
    from deeplearning4j_tpu_torch.serving.quantize import DtypePolicy
    assert paging.dtype_density(None) == 1.0
    assert paging.dtype_density(DtypePolicy(weight_residency="dequantized")) == 1.0
    assert paging.dtype_density(DtypePolicy(weight_residency="int8", weight_dtype="int8")) == 0.25


def test_policy_adjusted_archive_bytes(tmp_path):
    from deeplearning4j_tpu_torch.serving.quantize import DtypePolicy, policy_path
    plain = str(tmp_path / "plain.zip")
    open(plain, "wb").write(b"x" * 1000)
    assert paging.policy_adjusted_archive_bytes(plain, 1000) == 1000
    deq = str(tmp_path / "deq.zip")
    open(deq, "wb").write(b"x" * 1000)
    DtypePolicy(weight_residency="dequantized", weight_dtype="int8").save(policy_path(deq))
    assert paging.policy_adjusted_archive_bytes(deq, 1000) == 4000
    res = str(tmp_path / "res.zip")
    open(res, "wb").write(b"x" * 1000)
    DtypePolicy(weight_residency="int8", weight_dtype="int8").save(policy_path(res))
    assert paging.policy_adjusted_archive_bytes(res, 1000) == 1000
    for p in (plain, deq, res):  # the JAX package reads the port's sidecars alike
        assert jpaging.policy_adjusted_archive_bytes(p, 1000) == \
            paging.policy_adjusted_archive_bytes(p, 1000)


def test_register_cold_estimate_is_policy_aware(tmp_path, archives):
    from deeplearning4j_tpu_torch.serving.quantize import DtypePolicy, policy_path
    paths, _ = archives
    deq = str(tmp_path / "deq.zip")
    shutil.copyfile(paths[0], deq)
    DtypePolicy(weight_residency="dequantized", weight_dtype="int8").save(policy_path(deq))
    res8 = str(tmp_path / "res8.zip")
    shutil.copyfile(paths[0], res8)
    DtypePolicy(weight_residency="int8", weight_dtype="int8").save(policy_path(res8))
    reg = ModelRegistry()
    try:
        r_deq = reg.register_cold("deq", deq)
        r_res = reg.register_cold("res8", res8)
        assert r_deq.bytes == 4 * os.path.getsize(deq)
        assert r_res.bytes == os.path.getsize(res8)
        assert r_deq.bytes_estimated and r_res.bytes_estimated
    finally:
        reg.shutdown()


def test_retention_runs_on_measured_dtype_bytes():
    now = 1000.0
    f32, q8 = paging.Residency("f32"), paging.Residency("q8")
    for r in (f32, q8):
        r.risk = 0.5
        r.ewma.update(now)
    f32.bytes, f32.dtype_bytes = 4000, {"float32": 4000}
    q8.bytes, q8.dtype_bytes = 1000, {"int8": 900, "float32": 100}
    assert q8.retention(now) == pytest.approx(4 * f32.retention(now))
    snap = q8.snapshot(now)
    assert snap["dtype_bytes"] == {"int8": 900, "float32": 100}
    assert snap["retention_weight"] == pytest.approx(q8.retention(now))
    cold = paging.Residency("cold")
    cold.bytes = 2000
    cold.ewma.update(now)
    cold.risk = 1.0
    assert cold.retention(now) == pytest.approx(
        paging.retention_weight(2000, cold.ewma.rate(now), 1.0))


def test_registry_records_dtype_bytes_and_evicts_f32_first(archives):
    paths, _ = archives
    per = _per_model_bytes(archives)
    reg = ModelRegistry(hbm_budget_bytes=3 * per)
    try:
        reg.load("a", paths[0], **KW)
        reg.load("b", paths[1], **KW)
        snap = reg.residency_snapshot()
        for name in ("a", "b"):
            d = snap["models"][name]["dtype_bytes"]
            assert sum(d.values()) == snap["models"][name]["bytes"]
            assert all(v > 0 for v in d.values())
        with reg._lock:
            resb = reg._residency["b"]
            resb.dtype_bytes = {"int8": max(1, resb.bytes // 4)}
        assert reg._pick_victim_locked() == "a"
    finally:
        reg.shutdown()


def test_session_step_pages_in_a_cold_model(tmp_path):
    """``SessionStore`` resolves its model through ``acquire``: a step on a
    stream whose model was evicted pages the model back in (a cold hit),
    and then meets the page-in's batcher, which serves no session bucket
    until ``enable_sessions`` is called on it, as in the JAX package."""
    from deeplearning4j_tpu_torch.nn import LSTM, RnnOutputLayer
    conf = (NeuralNetConfiguration.builder().seed(3).updater(None).list()
            .layer(LSTM(n_out=8, activation="tanh"))
            .layer(RnnOutputLayer(n_out=5, activation="softmax"))
            .set_input_type(InputType.recurrent(5)).build())
    path = str(tmp_path / "rnn.zip")
    ModelSerializer.write_model(MultiLayerNetwork(conf, device="cpu").init(), path)
    x = np.random.default_rng(1).normal(size=(1, 3, 5)).astype(np.float32)
    reg = ModelRegistry()
    store = SessionStore(reg, str(tmp_path / "spill"), start_evictor=False)
    try:
        reg.load("rnn", path, warmup_example=x, max_batch_size=4).batcher.enable_sessions(
            x, session_bucket=2)
        sess = store.create("rnn")
        _, step, _ = store.step("rnn", sess.session_id, x)
        assert step == 1
        assert reg.evict("rnn") is True and reg.resident_names() == []
        with pytest.raises(RuntimeError, match="sessions not enabled"):
            store.step("rnn", sess.session_id, x)
        assert reg.resident_names() == ["rnn"]
        assert reg.paging.snapshot()["cold_hits_total"] == 1
        reg.get("rnn").batcher.enable_sessions(x, session_bucket=2)
        _, step, _ = store.step("rnn", sess.session_id, x)
        assert step == 2
    finally:
        reg.shutdown()


# ==========================================================================
# against live JAX runs: one scripted sequence under one injected clock
class _Clock:
    """A ``time`` module whose monotonic clock the test moves."""

    def __init__(self):
        self.now = 1000.0
        self.time = time.time
        self.sleep = time.sleep
        self.perf_counter = time.perf_counter

    def monotonic(self):
        return self.now


def _jax_archives(tmp_path, n):
    out = []
    for i in range(n):
        p = str(tmp_path / f"jm{i}.zip")
        JSerializer.write_model(JMultiLayerNetwork(_jax_conf(i)).init(), p)
        out.append(p)
    return out


def _copies(paths, d):
    os.makedirs(d, exist_ok=True)
    out = []
    for p in paths:
        q = os.path.join(d, os.path.basename(p))
        shutil.copyfile(p, q)
        out.append(q)
    return out


def _comparable(snap):
    models = {n: {k: v for k, v in m.items() if k not in ("device_map", "page_in_s")}
              for n, m in snap["models"].items()}
    paging_counts = {k: v for k, v in snap["paging"].items() if not k.endswith("_s")}
    return {"budget": snap["hbm_budget_bytes"], "resident": snap["resident_bytes"],
            "per_device": sorted(snap["per_device_bytes"].values()),
            "models": models, "paging": paging_counts}


def test_eviction_order_and_snapshots_match_jax_under_one_clock(tmp_path, monkeypatch):
    src = _jax_archives(tmp_path, 4)
    pp, jp = _copies(src, str(tmp_path / "port")), _copies(src, str(tmp_path / "jax"))
    pclock, jclock = _Clock(), _Clock()
    for mod, clock in ((pregistry, pclock), (paging, pclock),
                       (jregistry, jclock), (jpaging, jclock)):
        monkeypatch.setattr(mod, "time", clock)
    probe = ModelRegistry()
    try:
        per = probe.load("probe", pp[0], save_manifest=False, **KW).device_bytes
    finally:
        probe.shutdown()
    budget = int(per * 2.5)
    port, jax = ModelRegistry(hbm_budget_bytes=budget), JRegistry(hbm_budget_bytes=budget)
    script = [("load", "a", 0), ("load", "b", 1), ("predict", "a"), ("predict", "a"),
              ("predict", "a"), ("predict", "b"), ("load", "c", 2), ("predict", "b"),
              ("predict", "c"), ("cold", "d", 3), ("predict", "d"), ("evict", "a"),
              ("predict", "a"), ("predict", "c"), ("page_in", "b")]
    snaps = []
    try:
        for step in script:
            for reg, paths, clock in ((port, pp, pclock), (jax, jp, jclock)):
                clock.now += 7.5
                kind, name = step[0], step[1]
                if kind == "load":
                    reg.load(name, paths[step[2]], **KW)
                elif kind == "cold":
                    reg.load(name, paths[step[2]], resident=False, **KW)
                elif kind == "predict":
                    reg.predict(name, X)
                elif kind == "evict":
                    assert reg.evict(name) is True
                else:
                    reg.page_in(name)
            snaps.append((step, _comparable(port.residency_snapshot()),
                          _comparable(jax.residency_snapshot())))
        for step, got, want in snaps:
            assert got == want, step
        assert snaps[-1][1]["paging"]["evictions_total"] >= 4
    finally:
        port.shutdown()
        jax.shutdown()
