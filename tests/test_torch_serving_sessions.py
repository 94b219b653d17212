"""The port's session tier against the JAX package.

Mirrors ``tests/test_sessions.py``'s model-state and ``SessionStore`` cases
on ``deeplearning4j_tpu_torch`` (the HTTP, router and fleet cases come with
the server): the carry-state API round trips, the store's lifecycle with
write-through CRC-framed spills, idle-TTL and byte-budget eviction,
rehydrate on touch, exactly-once replay, migration over a shared spill
directory, damaged spills as ``SessionLost``, the step chaos point, and
concurrent streams bit for bit against a serial ``rnn_time_step`` loop
padded to the session bucket with nothing captured on traffic. Against live
JAX runs: the same streams from one JAX archive within 1e-5, spill frames
byte for byte the JAX format (a frame the JAX package wrote is read by the
port, and a session the JAX store spilled continues in the port's store).

The network: 2 x LSTM(32) + RnnOutputLayer(2), one timestep of 3 features
a chunk, on the CPU.
"""

import os
import threading

import numpy as np
import pytest

from deeplearning4j_tpu.models import MultiLayerNetwork as JMultiLayerNetwork
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import LSTM as JLSTM
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import RnnOutputLayer as JRnnOutput
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.serving import ModelRegistry as JRegistry
from deeplearning4j_tpu.serving import SessionStore as JStore
from deeplearning4j_tpu.serving import sessions as jsessions
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import LSTM, InputType, NeuralNetConfiguration, RnnOutputLayer
from deeplearning4j_tpu_torch.runtime import journal
from deeplearning4j_tpu_torch.runtime.chaos import (ChaosController, ChaosError, CorruptBytes,
                                                    FailNth)
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.serving import (DeadlineExceeded, ModelRegistry, SessionLost,
                                              SessionStepConflict, SessionStore)
from deeplearning4j_tpu_torch.serving import sessions as tsessions

T, F, H = 1, 3, 32   # one timestep of 3 features per chunk; 2 LSTM layers of 32
BUCKET = 4           # the one fixed padded step-batch size


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    env.set_aot_dispatch(True)
    yield
    env.device, env.default_dtype, env.compute_dtype, env.aot_dispatch = saved


def _conf(seed=7, builder=NeuralNetConfiguration, lstm=LSTM, out=RnnOutputLayer,
          input_type=InputType):
    return (builder.builder().seed(seed).list()
            .layer(lstm(n_out=H)).layer(lstm(n_out=H))
            .layer(out(n_out=2, activation="softmax"))
            .set_input_type(input_type.recurrent(F, T)).build())


def _net(seed=7):
    return MultiLayerNetwork(_conf(seed)).init()


def _chunks(key, n, rows=1):
    rng = np.random.default_rng(key)
    return [rng.standard_normal((rows, T, F)).astype(np.float32) for _ in range(n)]


_ORACLE = None


def _shared_net():
    global _ORACLE
    if _ORACLE is None:
        _ORACLE = _net()
    _ORACLE.rnn_clear_previous_state()
    return _ORACLE


def _serial_oracle(chunks, bucket=BUCKET):
    """A serial ``rnn_time_step`` loop over zero-padded batches of the
    session bucket, the stream in row 0."""
    net = _shared_net()
    outs = []
    for c in chunks:
        xb = np.zeros((bucket, T, F), np.float32)
        xb[0] = c[0]
        outs.append(net.rnn_time_step(xb).numpy()[:1])
    net.rnn_clear_previous_state()
    return outs


@pytest.fixture()
def fresh_journal():
    j = journal.enable(capacity=2048)
    yield j
    journal.enable(capacity=1024)


@pytest.fixture(scope="module")
def lstm_registry():
    env = get_environment()
    saved = (env.device, env.compute_dtype)
    env.set_device("cpu").set_compute_dtype("float32")
    reg = ModelRegistry()
    reg.register("lstm", _net(), max_batch_size=8, replicas=1, pipeline_depth=0)
    reg.get("lstm").batcher.enable_sessions(np.zeros((1, T, F), np.float32),
                                            session_bucket=BUCKET)
    yield reg
    reg.shutdown()
    env.device, env.compute_dtype = saved


def _store(reg, tmp_path, **kw):
    kw.setdefault("start_evictor", False)
    return SessionStore(reg, str(tmp_path), worker_id=kw.pop("worker_id", "w-test"), **kw)


# ==================================================== the model's state API
def test_rnn_state_round_trip_is_bit_exact():
    net = _shared_net()
    c1, c2 = _chunks(1, 2)
    net.rnn_time_step(c1)
    st = net.rnn_get_state()
    assert st is not None
    out_a = net.rnn_time_step(c2).numpy()
    net.rnn_set_state(st)
    out_b = net.rnn_time_step(c2).numpy()
    assert np.array_equal(out_a, out_b)
    net.rnn_set_state(st)
    for a, b in zip(tree_leaves(st), tree_leaves(net.rnn_get_state())):
        assert a.dtype == b.dtype and np.array_equal(a.numpy(), b.numpy())
    net.rnn_clear_previous_state()
    assert net.rnn_get_state() is None
    net.rnn_time_step(c1)
    net.rnn_set_state(None)
    assert net.rnn_get_state() is None


def test_one_call_time_step_matches_full_sequence_output():
    net = _shared_net()
    xs = np.random.default_rng(3).standard_normal((2, T, F)).astype(np.float32)
    full = net.output(xs).numpy()
    net.rnn_clear_previous_state()
    assert np.array_equal(full, net.rnn_time_step(xs).numpy())


def test_external_step_bit_identical_to_stored_state_step():
    net = _shared_net()
    chunks = _chunks(5, 4)
    net.rnn_clear_previous_state()
    stored = [net.rnn_time_step(c).numpy() for c in chunks]
    state = None
    for i, c in enumerate(chunks):
        out, state = net.rnn_time_step_external(c, state)
        assert np.array_equal(out.numpy(), stored[i]), i
    for leaf in tree_leaves(net.rnn_zero_state(1, like=chunks[0])):
        assert not leaf.numpy().any()


def test_computation_graph_rnn_state_round_trip():
    conf = (NeuralNetConfiguration.builder().seed(7).graph_builder()
            .add_inputs("in")
            .add_layer("lstm", LSTM(n_out=H), "in")
            .add_layer("out", RnnOutputLayer(n_out=2, activation="softmax"), "lstm")
            .set_outputs("out")
            .set_input_types(InputType.recurrent(F, T))
            .build())
    g = ComputationGraph(conf).init()
    c1, c2 = _chunks(7, 2)
    g.rnn_time_step(c1)
    st = g.rnn_get_state()
    out_a = g.rnn_time_step(c2).numpy()
    g.rnn_set_state(st)
    assert np.array_equal(out_a, g.rnn_time_step(c2).numpy())
    g.rnn_clear_previous_state()
    assert g.rnn_get_state() is None


# ================================================================ the store
def test_store_lifecycle_bit_identical_and_exactly_once(lstm_registry, tmp_path,
                                                        fresh_journal):
    store = _store(lstm_registry, tmp_path)
    chunks = _chunks(11, 5)
    oracle = _serial_oracle(chunks)
    store.create("lstm", session_id="s-life")
    assert os.path.exists(store._spill_path("lstm", "s-life"))
    for i, c in enumerate(chunks):
        out, step, replayed = store.step("lstm", "s-life", c, client_step=i)
        assert step == i + 1 and replayed is False
        assert np.array_equal(out, oracle[i]), i
    out_r, step_r, replayed = store.step("lstm", "s-life", chunks[-1], client_step=4)
    assert replayed is True and step_r == 5 and np.array_equal(out_r, oracle[-1])
    with pytest.raises(SessionStepConflict):
        store.step("lstm", "s-life", chunks[-1], client_step=7)
    snap = store.snapshot()
    assert snap["counters"]["steps_total"] == 5 and snap["counters"]["replays_total"] == 1
    assert "session.create" in {e["type"] for e in fresh_journal.events()}
    store.close("lstm", "s-life")
    assert not os.path.exists(store._spill_path("lstm", "s-life"))
    assert any(e["type"] == "session.close" for e in fresh_journal.events())
    with pytest.raises(KeyError):
        store.step("lstm", "s-life", chunks[0])
    store.shutdown()


def test_idle_ttl_eviction_spills_and_rehydrates_bit_exact(lstm_registry, tmp_path,
                                                           fresh_journal):
    clock = [0.0]
    store = _store(lstm_registry, tmp_path, idle_ttl_s=10.0, clock=lambda: clock[0])
    chunks = _chunks(13, 4)
    oracle = _serial_oracle(chunks)
    store.create("lstm", session_id="s-ttl")
    for i in (0, 1):
        out, _, _ = store.step("lstm", "s-ttl", chunks[i], client_step=i)
        assert np.array_equal(out, oracle[i])
    clock[0] = 11.0
    store._evict_pass()
    snap = store.snapshot()
    assert snap["resident"] == 0 and snap["tracked"] == 1
    evs = fresh_journal.events()
    assert any(e["type"] == "session.spill" for e in evs)
    assert any(e["type"] == "session.evict" and e["attrs"]["reason"] == "idle_ttl" for e in evs)
    out, step, _ = store.step("lstm", "s-ttl", chunks[2], client_step=2)
    assert step == 3 and np.array_equal(out, oracle[2])
    evs = fresh_journal.events()
    assert any(e["type"] == "session.step_miss" for e in evs)
    assert any(e["type"] == "session.rehydrate" for e in evs)
    assert store.snapshot()["counters"]["rehydrates_total"] == 1
    assert store.snapshot()["rehydrate"]["count"] == 1
    store.shutdown()


def test_byte_budget_evicts_least_recently_touched(lstm_registry, tmp_path):
    clock = [0.0]
    store = _store(lstm_registry, tmp_path, clock=lambda: clock[0])
    a = store.create("lstm", session_id="s-old")
    clock[0] = 1.0
    store.create("lstm", session_id="s-new")
    store.byte_budget_bytes = a.state_bytes + 1
    store._evict_pass()
    assert store.snapshot()["resident"] == 1
    with store._lock:
        resident = [s.session_id for s in store._sessions.values() if s.state is not None]
    assert resident == ["s-new"]
    store.shutdown()


def test_migration_between_stores_over_shared_spill_dir(lstm_registry, tmp_path,
                                                        fresh_journal):
    chunks = _chunks(17, 4)
    oracle = _serial_oracle(chunks)
    a = _store(lstm_registry, tmp_path, worker_id="w-a")
    b = _store(lstm_registry, tmp_path, worker_id="w-b")
    a.create("lstm", session_id="s-mig")
    for i in (0, 1):
        a.step("lstm", "s-mig", chunks[i], client_step=i)
    assert a.spill_all(reason="drain") == 1
    out, step, _ = b.step("lstm", "s-mig", chunks[2], client_step=2)
    assert step == 3 and np.array_equal(out, oracle[2])
    assert b.snapshot()["counters"]["migrations_total"] == 1
    mig = [e for e in fresh_journal.events() if e["type"] == "session.migrate"]
    assert mig and mig[-1]["attrs"]["to_worker"] == "w-b"
    out, _, _ = b.step("lstm", "s-mig", chunks[3], client_step=3)
    assert np.array_equal(out, oracle[3])
    a.shutdown(spill=False)
    b.shutdown()


@pytest.mark.parametrize("mode", ["flip", "truncate"])
def test_damaged_spill_is_explicit_session_lost(lstm_registry, tmp_path, fresh_journal, mode):
    store = _store(lstm_registry, tmp_path)
    chunks = _chunks(19, 2)
    store.create("lstm", session_id="s-rot")
    store.step("lstm", "s-rot", chunks[0], client_step=0)
    store.spill_all(reason="drain")
    with ChaosController(seed=3) as c:
        c.on("serving.session.rehydrate", CorruptBytes(mode=mode))
        with pytest.raises(SessionLost):
            store.step("lstm", "s-rot", chunks[1], client_step=1)
    assert store.snapshot()["counters"]["lost_total"] == 1
    assert os.path.exists(store._spill_path("lstm", "s-rot"))
    store.shutdown(spill=False)


def test_step_chaos_point_failure_does_not_advance_the_carry(lstm_registry, tmp_path):
    store = _store(lstm_registry, tmp_path)
    chunks = _chunks(29, 3)
    oracle = _serial_oracle(chunks)
    store.create("lstm", session_id="s-chaos")
    store.step("lstm", "s-chaos", chunks[0], client_step=0)
    with ChaosController(seed=7) as c:
        c.on("serving.session.step", FailNth(1))
        with pytest.raises(ChaosError):
            store.step("lstm", "s-chaos", chunks[1], client_step=1)
    out, step, replayed = store.step("lstm", "s-chaos", chunks[1], client_step=1)
    assert step == 2 and replayed is False and np.array_equal(out, oracle[1])
    store.shutdown()


def _run_streams(store, all_chunks):
    results = {sid: [] for sid in all_chunks}
    errors = []

    def run(sid):
        try:
            for i, c in enumerate(all_chunks[sid]):
                out, _, _ = store.step("lstm", sid, c, client_step=i)
                results[sid].append(out)
        except Exception as e:  # surfaced below
            errors.append((sid, repr(e)))

    threads = [threading.Thread(target=run, args=(sid,)) for sid in all_chunks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    return results


def test_concurrent_sessions_bit_identical_to_serial_oracle(lstm_registry, tmp_path):
    store = _store(lstm_registry, tmp_path)
    batcher = lstm_registry.get("lstm").batcher
    all_chunks = {f"s{i}": _chunks(100 + i, 6) for i in range(5)}
    oracles = {sid: _serial_oracle(cs) for sid, cs in all_chunks.items()}
    for sid in all_chunks:
        store.create("lstm", session_id=sid)
    compiles_before = batcher.compile_count()
    results = _run_streams(store, all_chunks)
    for sid, outs in results.items():
        for i, out in enumerate(outs):
            assert np.array_equal(out, oracles[sid][i]), (sid, i)
    assert batcher.compile_count() == compiles_before, "session traffic captured after warmup"
    store.shutdown()


def test_sessions_on_two_replicas_in_flight_bit_identical(tmp_path):
    """Two replicas on the CPU with two batches in flight: one session graph
    per replica at enable time, nothing more after the streams, every
    stream its serial loop bit for bit, both replicas used."""
    reg = ModelRegistry()
    try:
        served = reg.register("lstm", _net(), max_batch_size=8, replicas=2,
                              devices=["cpu", "cpu"], pipeline_depth=2)
        b = served.batcher
        b.enable_sessions(np.zeros((1, T, F), np.float32), session_bucket=BUCKET)
        assert b.compile_count() == 2 and b.session_bucket == BUCKET
        store = _store(reg, tmp_path)
        all_chunks = {f"r{i}": _chunks(200 + i, 5) for i in range(6)}
        for sid in all_chunks:
            store.create("lstm", session_id=sid)
        results = _run_streams(store, all_chunks)
        for sid, outs in results.items():
            for out, want in zip(outs, _serial_oracle(all_chunks[sid])):
                assert np.array_equal(out, want), sid
        assert b.compile_count() == 2
        assert sorted(b.metrics.snapshot()["replica_batches"]) == [0, 1]
        store.shutdown()
    finally:
        reg.shutdown()


def test_step_deadline_is_honoured(lstm_registry, tmp_path):
    store = _store(lstm_registry, tmp_path)
    store.create("lstm", session_id="s-dl")
    with pytest.raises(DeadlineExceeded):
        store.step("lstm", "s-dl", _chunks(31, 1)[0], timeout_ms=0.0001)
    store.shutdown()


def test_sessions_need_a_recurrent_model():
    from deeplearning4j_tpu_torch.nn import DenseLayer, OutputLayer
    conf = (NeuralNetConfiguration.builder().seed(1).list()
            .layer(DenseLayer(n_out=4)).layer(OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(3)).build())
    reg = ModelRegistry()
    try:
        b = reg.register("ff", MultiLayerNetwork(conf).init()).batcher
        with pytest.raises(ValueError, match="recurrent"):
            b.enable_sessions(np.zeros((1, 3), np.float32))
        with pytest.raises(RuntimeError, match="sessions not enabled"):
            b.submit_step(np.zeros((1, 3), np.float32), None)
    finally:
        reg.shutdown()


# ================================================= against live JAX runs
def _jax_conf(seed=7):
    return _conf(seed, JConf, JLSTM, JRnnOutput, JInputType)


def test_spill_frames_are_the_jax_format():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((1, H)).astype(np.float32) for _ in range(4)] + \
        [rng.standard_normal((1, T, 2)).astype(np.float32), np.arange(5, dtype=np.int64)]
    header = {"v": 1, "model": "lstm", "session": "s", "step": 3, "worker": "w",
              "incarnation": "i", "out": None}
    raw = jsessions._pack_frame(header, leaves)
    assert tsessions._pack_frame(header, leaves) == raw
    got_header, got = tsessions._unpack_frame(raw)
    assert got_header == jsessions._unpack_frame(raw)[0]
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, leaves))
    with pytest.raises(SessionLost):
        tsessions._unpack_frame(raw[:-3])


def test_streams_and_a_jax_spilled_session_continue_in_the_port(tmp_path):
    """One JAX archive; both packages' registries and stores drive the same
    streams (within 1e-5); then a session the JAX store created, stepped
    and spilled is adopted by the port's store over the same spill
    directory and continues where the JAX store would (within 1e-5)."""
    path = str(tmp_path / "lstm.zip")
    JSerializer.write_model(JMultiLayerNetwork(_jax_conf()).init(), path)
    jreg, reg = JRegistry(), ModelRegistry()
    spill = tmp_path / "spill"
    try:
        jreg.load("lstm", path, max_batch_size=8, replicas=1, pipeline_depth=0,
                  save_manifest=False)
        jreg.get("lstm").batcher.enable_sessions(np.zeros((1, T, F), np.float32),
                                                 session_bucket=BUCKET)
        reg.load("lstm", path, device="cpu", max_batch_size=8, pipeline_depth=0,
                 save_manifest=False)
        reg.get("lstm").batcher.enable_sessions(np.zeros((1, T, F), np.float32),
                                                session_bucket=BUCKET)
        jstore = JStore(jreg, str(spill), worker_id="w-jax", start_evictor=False)
        store = SessionStore(reg, str(tmp_path / "port-spill"), worker_id="w-port",
                             start_evictor=False)
        chunks = _chunks(41, 6)
        jstore.create("lstm", session_id="s")
        store.create("lstm", session_id="s")
        for i, c in enumerate(chunks):
            want, _, _ = jstore.step("lstm", "s", c, client_step=i)
            got, _, _ = store.step("lstm", "s", c, client_step=i)
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
        # the JAX store spills a second stream; the port adopts it
        jstore.create("lstm", session_id="m")
        for i in (0, 1, 2):
            jstore.step("lstm", "m", chunks[i], client_step=i)
        jstore.spill_all(reason="drain")
        adopter = SessionStore(reg, str(spill), worker_id="w-port", start_evictor=False)
        got, step, _ = adopter.step("lstm", "m", chunks[3], client_step=3)
        want, jstep, _ = jstore.step("lstm", "m", chunks[3], client_step=3)
        assert step == jstep == 4
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
        assert adopter.snapshot()["counters"]["migrations_total"] == 1
        for s in (jstore, store, adopter):
            s.shutdown(spill=False)
    finally:
        jreg.shutdown()
        reg.shutdown()
