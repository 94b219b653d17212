"""The LeNet slice (BASELINE config #1) from the port against the JAX
package, on the CPU.

A JAX ``zoo.LeNet()`` at full width (28x28x1, conv 20 and 50 5x5 ``same``,
dense 500, softmax 10) is written to an archive with a normalizer and
loaded by the port: its output, every layer's activation (``feed_forward``),
``evaluate`` (the same confusion matrix and ``stats()`` text),
``num_params``, ``summary()``, ``clone``, ``set_params``, the archive's
normalizer and ``save(save_updater=False)``. Then the loss-curve golden's
configuration (``tests/test_goldens.py``) is started from one archive and
fit for 2 epochs on ``MnistDataSetIterator(32, num_examples=160,
shuffle=False)`` by both packages: the 10 losses of the live JAX run and of
the port agree within that file's ``_TOL``. Then the listeners' callbacks,
``evaluate_regression``/``evaluate_roc``, and ``ModelRegistry`` serving
rows of 784 floats.

Tolerances, float32: outputs and activations ``atol=1e-5`` (the two sum
the convolutions' and products' terms in other orders); losses ``rtol=2e-3,
atol=2e-3`` (``_TOL``).
"""

import threading
import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import MnistDataSetIterator as JMnist
from deeplearning4j_tpu.data.normalizers import NormalizerStandardize as JStandardize
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import (ConvolutionLayer, DenseLayer, InputType,
                                   NeuralNetConfiguration, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu.train import Adam, CollectScoresListener as JCollect
from deeplearning4j_tpu.zoo import LeNet as JLeNet
from deeplearning4j_tpu_torch.data import MnistDataSetIterator, NumpyDataSetIterator
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serializer import tree_leaves
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import ModelRegistry
from deeplearning4j_tpu_torch.train import listeners as tlst
from deeplearning4j_tpu_torch.zoo import LeNet

_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_goldens.py


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


@pytest.fixture(scope="module")
def jax_lenet(tmp_path_factory):
    """The JAX zoo LeNet after 3 Adam steps (so its outputs are not all
    near-uniform), and its archive with a normalizer fitted on the
    training images: ``(jnet, path, normalizer)``."""
    jnet = JLeNet().init()
    it = JMnist(64, train=True, num_examples=192, seed=3)
    jnet.fit(it)
    norm = JStandardize().fit(JMnist(64, train=True, num_examples=256, seed=3))
    path = str(tmp_path_factory.mktemp("lenet") / "lenet.zip")
    JSerializer.write_model(jnet, path, normalizer=norm)
    return jnet, path, norm


def _images(n, seed=9):
    return MnistDataSetIterator(n, train=False, num_examples=n, seed=seed).features


def test_configuration_and_summary_match_jax(jax_lenet):
    jnet, path, _ = jax_lenet
    net = MultiLayerNetwork.load(path, device="cpu")
    assert net.conf.to_json() == LeNet().conf().to_json() == JLeNet().conf().to_json()
    assert net.num_params() == jnet.num_params() == 1256080
    assert net.summary() == jnet.summary()
    assert [type(p).__name__ for p in net.conf.preprocessors.values()] == \
        ["FeedForwardToCnnPreProcessor", "CnnToFeedForwardPreProcessor"]
    assert net.get_layer(4) is net.get_layer("layer_4") is net.layers[4]
    assert (net.iteration, net.epoch) == (jnet._iteration, jnet._epoch) == (3, 1)


def test_jax_archive_output_and_activations_match(jax_lenet):
    jnet, path, _ = jax_lenet
    net = MultiLayerNetwork.load(path, device="cpu")
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = _images(16)
    out = net.output(x)
    assert out.shape == (16, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)), rtol=0, atol=1e-5)
    acts, jacts = net.feed_forward(x), jnet.feed_forward(x)
    assert [tuple(a.shape) for a in acts] == [tuple(np.shape(b)) for b in jacts] == \
        [(16, 784), (16, 28, 28, 20), (16, 14, 14, 20), (16, 14, 14, 50), (16, 7, 7, 50),
         (16, 500), (16, 10)]
    for i, (a, b) in enumerate(zip(acts, jacts)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=f"activation {i}")
    part = net.feed_forward_to_layer(2, x)
    assert len(part) == 4
    torch.testing.assert_close(part[-1], acts[3], rtol=0, atol=0)


def test_evaluate_matches_jax(jax_lenet):
    jnet, path, _ = jax_lenet
    net = MultiLayerNetwork.load(path, device="cpu")
    ev = net.evaluate(MnistDataSetIterator(32, train=False, num_examples=96))
    jev = jnet.evaluate(JMnist(32, train=False, num_examples=96))
    np.testing.assert_array_equal(ev.confusion_matrix(), jev.confusion_matrix())
    assert ev.total == 96 and ev.stats() == jev.stats()
    assert ev.accuracy() == jev.accuracy()


def test_normalizer_clone_set_params_and_save_without_updater(jax_lenet, tmp_path):
    jnet, path, norm = jax_lenet
    net = MultiLayerNetwork.load(path, device="cpu")
    got = ModelSerializer.restore_normalizer(path)
    np.testing.assert_array_equal(got.mean, norm.mean)
    np.testing.assert_array_equal(got.std, norm.std)
    x = _images(8)
    twin = net.clone()
    torch.testing.assert_close(twin.output(x), net.output(x), rtol=0, atol=0)
    twin.params()["layer_5"]["b"][0] += 1.0  # the clone owns its parameters
    assert not torch.equal(twin.output(x), net.output(x))
    fresh = MultiLayerNetwork(LeNet().conf(), device="cpu")
    fresh.set_params({k: {n: np.asarray(a) for n, a in v.items()}
                      for k, v in jnet.train_state.params.items()})
    np.testing.assert_allclose(fresh.output(x).numpy(), np.asarray(jnet.output(x)), atol=1e-5)
    net.set_params(twin.params())
    torch.testing.assert_close(net.output(x), twin.output(x), rtol=0, atol=0)
    assert net.params()["layer_5"]["b"].data_ptr() != twin.params()["layer_5"]["b"].data_ptr()
    for save_updater in (True, False):
        p = str(tmp_path / f"u{save_updater}.zip")
        net.save(p, save_updater=save_updater)
        jp = str(tmp_path / f"j{save_updater}.zip")
        jnet.save(jp, save_updater=save_updater)
        for q in (p, jp):
            with zipfile.ZipFile(q) as zf:
                assert ("updaterState.npz" in zf.namelist()) == save_updater, q
    again = MultiLayerNetwork.load(str(tmp_path / "uTrue.zip"), device="cpu",
                                   load_updater=False)
    assert again._restored_updater_leaves is None
    torch.testing.assert_close(again.output(x), net.output(x), rtol=0, atol=0)


def _golden_conf():
    """tests/test_goldens.py's LeNet configuration."""
    return (NeuralNetConfiguration.builder().seed(123).updater(Adam(1e-3)).list()
            .layer(ConvolutionLayer(n_out=4, kernel_size=(5, 5), activation="relu"))
            .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=10, activation="softmax"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1)).build())


def test_golden_lenet_loss_curve_matches_a_live_jax_run(tmp_path):
    jnet = JNet(_golden_conf()).init()
    path = str(tmp_path / "golden.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    jit = JMnist(batch_size=32, train=True, num_examples=160, shuffle=False)
    it = MnistDataSetIterator(batch_size=32, train=True, num_examples=160, shuffle=False)
    assert it.synthetic and jit.synthetic
    jc, tc = JCollect(), tlst.CollectScoresListener()
    jnet.set_listeners(jc)
    net.set_listeners(tc)
    jnet.fit(jit, epochs=2)
    net.fit(it, epochs=2)
    want, got = [s for _, s in jc.scores], [s for _, s in tc.scores]
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, **_TOL)
    assert got[-1] < got[0]
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)


class _Order(tlst.TrainingListener):
    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch, score):
        self.calls.append(("it", iteration, epoch))

    def on_epoch_start(self, model, epoch):
        self.calls.append(("start", epoch))

    def on_epoch_end(self, model, epoch):
        self.calls.append(("end", epoch))


def test_listener_callbacks(caplog):
    """Callbacks in order; PerformanceListener counts each batch's examples
    and reports every ``frequency`` iterations; EvaluativeListener
    evaluates the held-out iterator every ``frequency`` iterations, as
    ``evaluate`` does; ScoreIterationListener logs."""
    import logging
    net = LeNet(height=8, width=8).init(device="cpu")
    rng = np.random.default_rng(0)
    x = rng.random((50, 64)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 50)]
    held = NumpyDataSetIterator(x[:20], y[:20], 8)
    order, perf = _Order(), tlst.PerformanceListener(frequency=2)
    evl = tlst.EvaluativeListener(held, frequency=3)
    net.set_listeners(order, perf, evl)
    net.add_listeners(tlst.ScoreIterationListener(print_iterations=4))
    assert len(net.get_listeners()) == 4
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        net.fit(NumpyDataSetIterator(x, y, 16), epochs=2)  # 4 batches: 16, 16, 16, 2
    assert order.calls == [("start", 0)] + [("it", i, 0) for i in (1, 2, 3, 4)] + \
        [("end", 0), ("start", 1)] + [("it", i, 1) for i in (5, 6, 7, 8)] + [("end", 1)]
    assert [r[0] for r in perf.reports] == [3, 5, 7]
    assert all(r[1] > 0 and r[2] > 0 and np.isfinite(r[3]) for r in perf.reports)
    assert perf._samples == 2  # the last batch's, since the report at iteration 7
    want = net.evaluate(held)
    np.testing.assert_array_equal(evl.last_evaluation.confusion_matrix(),
                                  want.confusion_matrix())
    assert evl.last_evaluation.total == 20
    text = caplog.text
    assert "Score at iteration 4 (epoch 0)" in text and "Score at iteration 8" in text
    assert "Evaluation at iteration 6" in text and "samples/s" in text


def test_evaluate_regression_and_roc_match_jax(tmp_path):
    """A 2-class LeNet on small images: ``evaluate_roc`` on its softmax and
    ``evaluate_regression`` on its outputs, against the JAX network from the
    same archive."""
    jnet = JLeNet(num_classes=2, height=8, width=6).init()
    path = str(tmp_path / "two.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.random((40, 48)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 40)]
    from deeplearning4j_tpu.data.iterators import NumpyDataSetIterator as JNumpy
    roc, jroc = net.evaluate_roc(NumpyDataSetIterator(x, y, 16)), \
        jnet.evaluate_roc(JNumpy(x, y, 16))
    np.testing.assert_allclose(roc.calculate_auc(), jroc.calculate_auc(), atol=1e-6)
    reg = net.evaluate_regression(NumpyDataSetIterator(x, y, 16))
    jreg = jnet.evaluate_regression(JNumpy(x, y, 16))
    assert reg.n == jreg.n == 40
    for c in range(2):
        np.testing.assert_allclose(reg.mean_squared_error(c), jreg.mean_squared_error(c),
                                   rtol=1e-5)


def test_registry_serves_rows_of_784_floats(jax_lenet):
    """The archive through ``ModelRegistry.load``, requests of 1-16 rows
    from 4 threads: each answer is ``net.output`` of its rows (the batcher
    pads the 2-D rows to its bucket; the preprocessor runs inside the
    served forward)."""
    _, path, _ = jax_lenet
    net = MultiLayerNetwork.load(path, device="cpu")
    reg = ModelRegistry()
    reg.load("lenet", path, device="cpu", max_batch_size=16)
    rng = np.random.default_rng(4)
    reqs = [_images(int(n), seed=int(s)) for n, s in zip(rng.integers(1, 17, 8), range(8))]
    answers, errors = [None] * len(reqs), []

    def client(i):
        try:
            for k in range(i, len(reqs), 4):
                answers[k] = reg.predict("lenet", reqs[k])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    reg.shutdown()
    assert not errors and all(not t.is_alive() for t in threads)
    for r, a in zip(reqs, answers):
        assert a.shape == (len(r), 10)
        np.testing.assert_allclose(a, net.output(r).numpy(), rtol=0, atol=1e-5)
