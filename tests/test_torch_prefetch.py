"""The port's overlapped feed path on the CPU, the MultiLayerNetwork and
ComputationGraph cases of the JAX package's ``tests/test_train_pipeline.py``:
prefetched fits bit for bit against the synchronous loop (and within
``_TOL`` of live JAX fits from the same archive), the listeners' callbacks
in the same order with the same arguments under async delivery, a
listener's error failing the fit, the stateful-listener gate, and the
``train.prefetch.fetch`` chaos point failing the fit with no thread left.

Float32; ``_TOL``: the two packages sum in other orders (a few 1e-7 a step
at Sgd(0.1)).
"""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import NumpyDataSetIterator as JNumpyIt
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.train import CollectScoresListener as JCollect
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu_torch.data import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models import ComputationGraph, ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime.chaos import ChaosController, ChaosError, FailNth
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.train import (Adam, AsyncLossDelivery, CollectScoresListener,
                                            DevicePrefetcher, Sgd, TrainingListener,
                                            TrainingProfiler, coerce_training_batch)
from deeplearning4j_tpu_torch.train.prefetch import batch_source, stateless_listeners

_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.dispatch_unroll)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype, env.dispatch_unroll = saved


def _conf(seed=7):
    return (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


class _OrderListener(TrainingListener):
    """Records every callback with its arguments; slow in iteration_done so
    an ordering bug in the completion path would show."""

    needs_model_state = False

    def __init__(self):
        self.events = []

    def iteration_done(self, model, iteration, epoch, score):
        time.sleep(0.002)
        self.events.append(("iter", iteration, epoch, float(score)))

    def on_epoch_start(self, model, epoch):
        self.events.append(("start", epoch))

    def on_epoch_end(self, model, epoch):
        self.events.append(("end", epoch))


def _no_stray_threads():
    deadline = time.monotonic() + 5.0
    stray = []
    while time.monotonic() < deadline:
        stray = [t for t in threading.enumerate()
                 if t.name.startswith(("train-prefetch", "train-listener-delivery"))]
        if not stray:
            return
        time.sleep(0.05)
    raise AssertionError(f"hung pipeline threads: {[t.name for t in stray]}")


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    conf = (JConf.builder().seed(7).updater(JSgd(0.1)).list()
            .layer(JDense(n_out=16, activation="tanh"))
            .layer(JOutput(n_out=4, activation="softmax"))
            .set_input_type(JInputType.feed_forward(8)).build())
    path = str(tmp_path_factory.mktemp("prefetch") / "mln.zip")
    JSerializer.write_model(JNet(conf).init(), path)
    return path


@pytest.mark.parametrize("unroll", [1, 3])
def test_mln_prefetched_fit_bit_identical_and_against_jax(archive, unroll):
    x, y = _data()
    cs, cp = CollectScoresListener(), CollectScoresListener()
    ns = ModelSerializer.restore_model(archive, device="cpu")
    ns.set_listeners(cs)
    ns.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=3)
    get_environment().set_dispatch_unroll(unroll)
    prof = TrainingProfiler()
    npf = ModelSerializer.restore_model(archive, device="cpu")
    npf.set_listeners(cp)
    npf.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=3, prefetch_buffer=3,
            profiler=prof)
    assert cs.scores == cp.scores  # float-exact trajectory
    assert torch.equal(ns.params()["layer_0"]["W"], npf.params()["layer_0"]["W"])
    r = prof.report()
    assert r["iterations"] == 12 and r["step_measured"]
    assert 0.0 <= r["data_wait_fraction"] <= 1.0
    jnet = JSerializer.restore_multi_layer_network(archive)
    jc = JCollect()
    jnet.set_listeners(jc)
    jnet.fit(JNumpyIt(x, y, batch_size=16), epochs=3, prefetch_buffer=3)
    np.testing.assert_allclose([s for _, s in cp.scores], [s for _, s in jc.scores], **_TOL)
    np.testing.assert_allclose(npf.params()["layer_0"]["W"].numpy(),
                               np.asarray(jnet.params()["layer_0"]["W"]), **_TOL)


def test_computation_graph_prefetched_fit_bit_identical():
    def conf():
        return (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2))
                .graph_builder().add_inputs("in")
                .add_layer("h", DenseLayer(n_out=32, activation="relu"), "in")
                .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
                .set_outputs("out").set_input_types(InputType.feed_forward(12)).build())

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 12)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    cs, cp = CollectScoresListener(), CollectScoresListener()
    g1 = ComputationGraph(conf()).init()
    g1.set_listeners(cs)
    g1.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=3)
    g2 = ComputationGraph(conf()).init()
    g2.set_listeners(cp)
    prof = TrainingProfiler()
    g2.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=3, prefetch_buffer=2,
           profiler=prof)
    assert cs.scores == cp.scores
    assert torch.equal(g1.params()["h"]["W"], g2.params()["h"]["W"])
    assert prof.report()["iterations"] == 12


def test_listener_ordering_identical_under_async_readback():
    x, y = _data()
    ls, la = _OrderListener(), _OrderListener()
    ns = MultiLayerNetwork(_conf()).init()
    ns.set_listeners(ls)
    ns.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=2)
    na = MultiLayerNetwork(_conf()).init()
    na.set_listeners(la)
    na.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=2, prefetch_buffer=2)
    assert ls.events == la.events
    assert ls.events[0] == ("start", 0)
    assert [e[0] for e in ls.events].count("iter") == 8


def test_listener_exception_propagates_from_async_delivery():
    class Boom(TrainingListener):
        needs_model_state = False

        def iteration_done(self, model, iteration, epoch, score):
            if iteration == 3:
                raise ValueError("listener boom")

    x, y = _data()
    net = MultiLayerNetwork(_conf()).init()
    net.set_listeners(Boom())
    with pytest.raises(ValueError, match="listener boom"):
        net.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=5, prefetch_buffer=2)
    _no_stray_threads()


def test_stateful_listener_forces_synchronous_delivery():
    class StateReader(TrainingListener):
        needs_model_state = True

        def __init__(self):
            self.w = []

        def iteration_done(self, model, iteration, epoch, score):
            self.w.append(model.params()["layer_0"]["W"].clone())

    x, y = _data()
    net = MultiLayerNetwork(_conf()).init()
    sr = StateReader()
    net.set_listeners(sr)
    assert not stateless_listeners(net)
    net.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=2, prefetch_buffer=2)
    assert len(sr.w) == 8
    # each call saw its own step's weights: all different, the last = final
    assert all(not torch.equal(a, b) for a, b in zip(sr.w, sr.w[1:]))
    assert torch.equal(sr.w[-1], net.params()["layer_0"]["W"])


@pytest.mark.parametrize("prefetch", [0, 2])
def test_chaos_prefetch_fetch_fails_fit_cleanly(prefetch):
    x, y = _data()
    net = MultiLayerNetwork(_conf()).init()
    with ChaosController(seed=3) as c:
        c.on("train.prefetch.fetch", FailNth(3))
        with pytest.raises(ChaosError, match="train.prefetch.fetch"):
            net.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=2,
                    prefetch_buffer=prefetch)
        assert c.count("train.prefetch.fetch") == 3
    # synchronously the two fetched batches trained; the prefetcher raises
    # at the consumer's next pull once its worker has failed, batches
    # staged before the fault or not (the JAX package's rule)
    assert net.iteration == 2 if prefetch == 0 else net.iteration <= 2
    _no_stray_threads()


def test_samediff_prefetched_fit_bit_identical():
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    x, y = _data()
    runs = []
    for prefetch in (0, 2):
        rng = np.random.default_rng(5)
        sd = SameDiff(device="cpu")
        xi = sd.placeholder("x", shape=(None, 8))
        yi = sd.placeholder("y", shape=(None, 4))
        w = sd.var("w", array=rng.normal(size=(8, 4)).astype(np.float32) * 0.3)
        sd.set_loss_variables(sd.loss.softmax_cross_entropy("loss", yi, xi.mmul(w)))
        sd.set_training_config(TrainingConfig(updater=Adam(1e-2), data_set_feature_mapping=["x"],
                                              data_set_label_mapping=["y"]))
        prof = TrainingProfiler()
        hist = sd.fit(ListDataSetIterator([DataSet(x[i:i + 16], y[i:i + 16])
                                           for i in range(0, 64, 16)]), epochs=2,
                      prefetch_buffer=prefetch, profiler=prof)
        runs.append((list(hist), sd.arrays["w"].clone()))
        assert prof.report()["iterations"] == 8
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    _no_stray_threads()


def test_prefetcher_and_delivery_units():
    x, y = _data(32)
    net = MultiLayerNetwork(_conf()).init()
    it = NumpyDataSetIterator(x, y, batch_size=8)
    pf = DevicePrefetcher(it, lambda ds: coerce_training_batch(net, ds), buffer=2)
    got = [b[0] for b in pf]
    pf.close()
    pf.close()  # idempotent
    assert len(got) == 4 and torch.equal(got[0], torch.as_tensor(x[:8]))
    src = batch_source(it, lambda ds: coerce_training_batch(net, ds), 0)
    assert [b[0].shape[0] for b in src] == [8, 8, 8, 8]
    seen = []
    adel = AsyncLossDelivery(lambda a, loss: seen.append((a, loss)), max_pending=2)
    for i in range(5):
        adel.submit(i, torch.tensor(float(i)))
    adel.flush()
    adel.shutdown()
    adel.shutdown()
    assert [a for a, _ in seen] == [0, 1, 2, 3, 4]
    _no_stray_threads()
