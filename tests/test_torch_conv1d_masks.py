"""Mask propagation in the port's ``MultiLayerNetwork`` against the JAX
package on the CPU: a ``Convolution1DLayer`` that changes the time axis
(strided, or causal and strided) realigns the features mask for the layers
after it, and the default labels mask of per-timestep labels is the mask at
the output. ``fit`` (3 Adam steps), ``score`` and ``evaluate`` on masked
sequences, from the same weights through the JAX archive.

Inputs are numpy from a seed. Float32; losses ``rtol=1e-5``; weights after
three steps ``rtol=1e-4, atol=1e-6``; evaluation counts exactly.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import DataSet as JDataSet
from deeplearning4j_tpu.data import ListDataSetIterator as JList
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import (LSTM, Convolution1DLayer, GlobalPoolingLayer, InputType,
                                   NeuralNetConfiguration, OutputLayer, RnnOutputLayer)
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JScores
from deeplearning4j_tpu.train.updaters import Adam
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import ModelSerializer
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.runtime.environment import get_environment

B, T, F, C = 6, 12, 4, 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _conf(mode, stride, head):
    b = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2)).list()
         .layer(Convolution1DLayer(n_out=6, kernel_size=3, stride=stride,
                                   convolution_mode=mode, activation="tanh"))
         .layer(LSTM(n_out=5)))
    if head == "rnn":
        b.layer(RnnOutputLayer(n_out=C, activation="softmax"))
    else:
        b.layer(GlobalPoolingLayer(pooling_type="avg"))
        b.layer(OutputLayer(n_out=C, activation="softmax"))
    return b.set_input_type(InputType.recurrent(F, T)).build()


def _data(seed, t_out, head):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T, F)).astype(np.float32)
    fm = np.ones((B, T), np.float32)
    for i, n in enumerate([T, 9, 7, 4, 2, 11]):
        fm[i, n:] = 0.0
    if head == "rnn":
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, t_out))]
    else:
        y = np.eye(C, dtype=np.float32)[rng.integers(0, C, B)]
    return x, y, fm


CASES = [("truncate", 2, "rnn"), ("causal", 2, "rnn"), ("same", 3, "rnn"),
         ("causal", 1, "pool")]


@pytest.mark.parametrize("mode,stride,head", CASES, ids=[f"{m}-s{s}-{h}" for m, s, h in CASES])
def test_masked_fit_score_evaluate_match_jax(tmp_path, mode, stride, head):
    jnet = JNet(_conf(mode, stride, head)).init()
    t_out = jnet.conf.layer_input_types[-1].timesteps if head == "rnn" else None
    path = str(tmp_path / "net.zip")
    jnet.save(path)
    net = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    x, y, fm = _data(1, t_out, head)
    # the labels mask the packages derive: the features mask at the output
    import jax.numpy as jnp
    want_lm = jnet._output_time_mask(jnp.asarray(fm))
    got_lm = net._output_time_mask(torch.from_numpy(fm))
    np.testing.assert_array_equal(got_lm.numpy(), np.asarray(want_lm))
    if head == "rnn":
        assert got_lm.shape == (B, t_out) and t_out < T or stride == 1

    jds, tds = JDataSet(x, y, features_mask=fm), DataSet(x, y, features_mask=fm)
    np.testing.assert_allclose(net.score(tds), jnet.score(jds), rtol=1e-5)
    jnet.set_listeners(js := JScores())
    net.set_listeners(ts := CollectScoresListener())
    jnet.fit(JList([jds]), epochs=3)
    net.fit(ListDataSetIterator([tds]), epochs=3)
    np.testing.assert_allclose([v for _, v in ts.scores], [float(v) for _, v in js.scores],
                               rtol=1e-5)
    import jax
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(net.score(tds), jnet.score(jds), rtol=1e-5)
    np.testing.assert_allclose(net.output(x, mask=fm).numpy(),
                               np.asarray(jnet.output(x, mask=fm)), rtol=1e-5, atol=1e-6)
    jev, tev = jnet.evaluate(JList([jds])), net.evaluate(ListDataSetIterator([tds]))
    np.testing.assert_array_equal(np.asarray(tev.confusion), np.asarray(jev.confusion))
    assert tev.accuracy() == pytest.approx(jev.accuracy())


def test_unmasked_and_mask_free_layers_are_unchanged():
    """No features mask, or no layer that moves the time axis: the labels
    mask is what it was before (none, or the features mask itself)."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _conf("truncate", 2, "rnn").to_json()), device="cpu").init()
    assert net._output_time_mask(None) is None
    fm = torch.ones(2, T)
    fm[1, 5:] = 0
    got = net._output_time_mask(fm)
    assert got.shape == (2, (T - 3) // 2 + 1)
    assert torch.equal(got[1], torch.tensor([1., 1., 1., 0., 0.]))


def test_masked_fit_under_remat_matches_plain(tmp_path):
    """With remat on, each hidden layer is recomputed in the backward pass
    with the mask it saw in the forward: the masked LSTM before the strided
    convolution gets the full-length mask again, not the convolution's. The
    same losses and weights as the plain fit."""
    conf = (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2)).list()
            .layer(LSTM(n_out=5))
            .layer(Convolution1DLayer(n_out=6, kernel_size=3, stride=2,
                                      convolution_mode="causal", activation="tanh"))
            .layer(LSTM(n_out=4))
            .layer(RnnOutputLayer(n_out=C, activation="softmax"))
            .set_input_type(InputType.recurrent(F, T)).build())
    jnet = JNet(conf).init()
    t_out = jnet.conf.layer_input_types[-1].timesteps
    path = str(tmp_path / "net.zip")
    jnet.save(path)
    x, y, fm = _data(3, t_out, "rnn")
    env = get_environment()
    runs = {}
    for remat in (False, True):
        env.remat_segments = remat
        try:
            net = ModelSerializer.restore_multi_layer_network(path, device="cpu")
            net.set_listeners(scores := CollectScoresListener())
            net.fit(ListDataSetIterator([DataSet(x, y, features_mask=fm)]), epochs=2)
        finally:
            env.remat_segments = False
        runs[remat] = ([v for _, v in scores.scores], tree_leaves(net.params()))
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)
