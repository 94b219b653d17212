"""The port's training slice against the JAX package, end to end on the CPU.

``TextGenerationLSTM(vocab 12, hidden 128, 2 layers, tbptt_length 6)`` is
built in both packages from the same weights (JAX's, carried across with
``params_from_numpy``) and fit on the same one-hot batches (B=8, T=12, made
from a seed with numpy), so every batch is two truncated-BPTT chunks. The
JAX side runs its Pallas kernels in interpret mode; the port takes its plain
forward-with-residuals and plain backward. The loss of every chunk
(``CollectScoresListener``), the final parameters and the RmsProp moments
must agree; then archives with ``updaterState.npz`` must resume identically
across the packages.

Tolerances (float32): losses ``rtol=1e-5``; parameters ``atol=1e-6`` —
RmsProp moves a weight by about ``lr * sign(g)`` where ``|g| >> sqrt(eps)``
(insensitive to the last bits of g), and by ``lr * g / sqrt(eps)`` below
that, where a relative difference of g of 1e-5 (summation order) moves the
update by far less than 1e-6; moments ``rtol=1e-4, atol=1e-12``.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JCollect
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JText
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork, params_from_numpy
from deeplearning4j_tpu_torch.models.serializer import tree_leaves
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.train.listeners import (CollectScoresListener,
                                                      ScoreIterationListener,
                                                      TrainingListener)
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

VOCAB, HIDDEN, T, B, L = 12, 128, 12, 8, 6


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _batches(n, seed, masked=False):
    rng = np.random.default_rng(seed)
    eye = np.eye(VOCAB, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, (B, T + 1))
        mask = None
        if masked:
            mask = (np.arange(T)[None, :] < rng.integers(4, T + 1, B)[:, None])
            mask = mask.astype(np.float32)
            mask[2, 5:8] = 0.0  # a hole that spans the chunk boundary
        out.append((eye[ids[:, :T]], eye[ids[:, 1:]], mask))
    return out


def _pair(graves):
    """A JAX net and a port net holding the same weights."""
    jnet = JText(vocab_size=VOCAB, hidden=HIDDEN, tbptt_length=L, graves=graves).init()
    params = jax.tree.map(np.asarray, jnet.train_state.params)
    conf = TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN, tbptt_length=L,
                              graves=graves).conf()
    return jnet, MultiLayerNetwork(conf, device="cpu").init(params=params_from_numpy(params))


def _assert_same_state(net, jnet, what):
    jparams = jax.tree.map(np.asarray, jnet.train_state.params)
    for k, layer in jparams.items():
        for n, leaf in layer.items():
            np.testing.assert_allclose(net.params()[k][n].numpy(), leaf, rtol=0, atol=1e-6,
                                       err_msg=f"{what}: {k}/{n}")
    jleaves = jax.tree.leaves(jnet.train_state.opt_state)
    tleaves = tree_leaves(net.updater_state())
    assert len(jleaves) == len(tleaves)
    for i, (j, t) in enumerate(zip(jleaves, tleaves)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-12,
                                   err_msg=f"{what}: moment {i}")


def _assert_same_scores(port, jax_, what):
    assert [i for i, _ in port] == [i for i, _ in jax_], what
    np.testing.assert_allclose([s for _, s in port], [s for _, s in jax_], rtol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("case", ["graves", "plain", "plain_masked"])
def test_fit_with_tbptt_matches_jax(case):
    jnet, net = _pair(graves=case == "graves")
    jc, tc = JCollect(), CollectScoresListener()
    jnet.set_listeners(jc)
    net.set_listeners(tc)
    for x, y, m in _batches(2, seed=1, masked=case.endswith("masked")):
        jnet.fit(x, y, mask=m)
        net.fit(x, y, mask=m)
    assert len(tc.scores) == 4  # two batches of two chunks: one iteration each
    _assert_same_scores(tc.scores, jc.scores, case)
    _assert_same_state(net, jnet, case)
    assert net.score() == pytest.approx(tc.scores[-1][1])


def test_jax_archive_resumes_in_the_port_with_its_optimizer_state(tmp_path):
    (x1, y1, _), (x2, y2, _) = _batches(2, seed=2)
    jnet = JText(vocab_size=VOCAB, hidden=HIDDEN, tbptt_length=L, graves=True).init()
    jnet.fit(x1, y1)
    path = str(tmp_path / "jax.zip")
    JSerializer.write_model(jnet, path)
    net = MultiLayerNetwork.load(path, device="cpu")
    _assert_same_state(net, jnet, "restored")
    jresumed = JSerializer.restore_model(path)
    jc, tc = JCollect(), CollectScoresListener()
    jresumed.set_listeners(jc)
    net.set_listeners(tc)
    jresumed.fit(x2, y2)
    net.fit(x2, y2)
    _assert_same_scores(tc.scores, jc.scores, "resumed")
    _assert_same_state(net, jresumed, "resumed")


def test_port_archive_resumes_in_jax_with_its_optimizer_state(tmp_path):
    (x1, y1, _), (x2, y2, _) = _batches(2, seed=3)
    net = TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN, tbptt_length=L).init(
        device="cpu")
    net.fit(x1, y1)
    path = str(tmp_path / "port.zip")
    net.save(path)
    jnet = JSerializer.restore_model(path)
    _assert_same_state(net, jnet, "restored")
    again = MultiLayerNetwork.load(path, device="cpu")
    jc, tc = JCollect(), CollectScoresListener()
    jnet.set_listeners(jc)
    again.set_listeners(tc)
    jnet.fit(x2, y2)
    again.fit(x2, y2)
    _assert_same_scores(tc.scores, jc.scores, "resumed")
    _assert_same_state(again, jnet, "resumed")
    # an archive written without fitting carries no updater state, and a
    # restored one writes its moments back as it read them
    fresh = str(tmp_path / "fresh.zip")
    TextGenerationLSTM(vocab_size=VOCAB, hidden=8).init(device="cpu").save(fresh)
    import zipfile
    assert "updaterState.npz" not in zipfile.ZipFile(fresh).namelist()
    MultiLayerNetwork.load(path, device="cpu").save(str(tmp_path / "again.zip"))
    with zipfile.ZipFile(path) as a, zipfile.ZipFile(str(tmp_path / "again.zip")) as b:
        assert a.read("updaterState.npz") == b.read("updaterState.npz")


def test_score_matches_jax():
    jnet, net = _pair(graves=True)
    x, y, m = _batches(1, seed=4, masked=True)[0]
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    for mask in (None, m):
        want = jnet.score(JDataSet(x, y, features_mask=mask))
        got = net.score(DataSet(x, y, features_mask=mask))
        assert got == pytest.approx(want, rel=1e-5)


def test_fit_iterator_over_epochs_counts_iterations_and_epochs():
    jnet, net = _pair(graves=False)
    batches = [DataSet(x, y) for x, y, _ in _batches(3, seed=5)]
    events = []

    class Recorder(TrainingListener):
        def on_epoch_start(self, model, epoch):
            events.append(("start", epoch))

        def on_epoch_end(self, model, epoch):
            events.append(("end", epoch))

    tc = CollectScoresListener()
    net.set_listeners(Recorder(), tc, ScoreIterationListener(4))
    net.fit(ListDataSetIterator(batches), epochs=2)
    assert [i for i, _ in tc.scores] == list(range(1, 13))  # 3 batches x 2 chunks x 2
    assert events == [("start", 0), ("end", 0), ("start", 1), ("end", 1)]
    assert net._epoch == 2
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
    jc = JCollect()
    jnet.set_listeners(jc)
    jnet.fit(JList([JDataSet(b.features, b.labels) for b in batches]), epochs=2)
    _assert_same_scores(tc.scores, jc.scores, "two epochs")


def test_plain_step_without_tbptt_matches_jax():
    """A feed-forward net takes the plain step, with the default
    ``Sgd(0.1)``."""
    from deeplearning4j_tpu.nn import (DenseLayer as JDense, InputType as JIn,
                                       NeuralNetConfiguration as JConf, OutputLayer as JOut)
    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType, NeuralNetConfiguration,
                                             OutputLayer)

    def conf(C, D, O, I):
        return (C.builder().seed(3).list().layer(D(n_out=16, activation="tanh"))
                .layer(O(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(I.feed_forward(5)).build())

    jnet = JNet(conf(JConf, JDense, JOut, JIn)).init()
    net = MultiLayerNetwork(conf(NeuralNetConfiguration, DenseLayer, OutputLayer, InputType),
                            device="cpu").init(params=params_from_numpy(
                                jax.tree.map(np.asarray, jnet.train_state.params)))
    rng = np.random.default_rng(6)
    jc, tc = JCollect(), CollectScoresListener()
    jnet.set_listeners(jc)
    net.set_listeners(tc)
    for _ in range(3):
        x = rng.normal(0, 1, (10, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)]
        jnet.fit(x, y)
        net.fit(x, y)
    _assert_same_scores(tc.scores, jc.scores, "plain step")
    _assert_same_state(net, jnet, "plain step")
    assert net.updater_state() == {}


def test_output_in_training_mode_is_the_inference_pass():
    """As in the JAX package, ``output(training=True)`` runs no dropout."""
    _, net = _pair(graves=True)
    net.layers[0].dropout = 0.5
    x = _batches(1, seed=7)[0][0]
    torch.testing.assert_close(net.output(x, training=True), net.output(x), rtol=0, atol=0)


def test_layer_input_dropout_statistics_match_jax():
    """Dropout draws from each package's own stream, so the two are held to
    the same statistics: retain probability p, kept values scaled by 1/p;
    the layer's training forward runs on the dropped input."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn import base as jbase
    from deeplearning4j_tpu.nn import recurrent_layers as jrec
    from deeplearning4j_tpu_torch.nn import base as tbase
    from deeplearning4j_tpu_torch.nn import recurrent_layers as trec
    p = 0.8
    jl, tl = jrec.GravesLSTM(n_out=4, dropout=p), trec.GravesLSTM(n_out=4, dropout=p)
    jl._g, tl._g = jbase.GlobalConfig(), tbase.GlobalConfig()
    x = np.ones((64, 50, 6), np.float32)
    jd = np.asarray(jl._apply_input_dropout(jnp.asarray(x), jl._g, True,
                                            jax.random.PRNGKey(0)))
    td = tl._apply_input_dropout(torch.from_numpy(x), tl._g, True,
                                 torch.Generator().manual_seed(0)).numpy()
    for d in (jd, td):
        assert set(np.unique(d)) <= {0.0, np.float32(1 / p)}
        assert abs((d == 0).mean() - (1 - p)) < 0.01
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    params, _ = tl.init(torch.Generator().manual_seed(1), InputType.recurrent(6), tl._g)
    y, _ = tl.forward(params, {}, torch.from_numpy(x), training=True,
                      generator=torch.Generator().manual_seed(0))
    want, _ = tl.forward(params, {}, torch.from_numpy(td), training=False)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_sequence_helpers_match_jax():
    import jax.numpy as jnp

    from deeplearning4j_tpu.models import _tbptt as jt
    from deeplearning4j_tpu_torch.models import _tbptt as tt
    arrays = [np.zeros((2, 5, 3), np.float32), np.zeros((2, 5), np.int32),
              np.zeros((2, 5), np.float32), np.zeros((2,), np.int64),
              np.zeros((2, 5), np.bool_)]
    for a in arrays:
        assert tt.is_sequence_array(torch.from_numpy(a)) == jt.is_sequence_array(jnp.asarray(a))
        want = np.asarray(jt.slice_time(jnp.asarray(a), 1, 2))
        np.testing.assert_array_equal(tt.slice_time(torch.from_numpy(a), 1, 2).numpy(), want)


def test_dataset_and_list_iterator():
    x = np.arange(10, dtype=np.float32)[:, None]
    a, b = DataSet(x[:6], x[:6] * 2), DataSet(x[6:], x[6:] * 2, features_mask=None)
    it = ListDataSetIterator([a, b], batch_size=4)
    got = [ds.features[:, 0].tolist() for ds in it]
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert it.batch() == 4 and not it.has_next()
    assert [len(ds) for ds in it] == [4, 4, 2]  # iterating again resets
    with pytest.raises(ValueError, match="mixed mask"):
        DataSet.merge([DataSet(x, x, features_mask=np.ones((10, 1))), DataSet(x, x)])
