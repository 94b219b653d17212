"""The port's ComputationGraph recurrent, external-errors and remat paths
against the JAX package on the CPU: ``rnn_time_step`` in chunks against the
whole sequence and against JAX's, the stored-state methods, truncated BPTT
(per-chunk losses and weights, one-hot and token inputs), ``backprop_gradient``
and ``fit_external``, and a rematerialized training step against a plain one
(with a segment that holds dropout and a fused 1x1 convolution +
BatchNormalization pair), in the port and against JAX; the same for a
``MultiLayerNetwork`` whose hidden layers are checkpointed.

Inputs are numpy from a seed; weights cross through the JAX archive.
Float32: outputs ``rtol=1e-5, atol=1e-6``; chunked against whole
``atol=1e-5``; losses ``rtol=1e-5``; weights after the steps ``rtol=1e-4,
atol=1e-6``; remat against plain in the port bit for bit where no
BatchNormalization sum is reordered, else ``rtol=1e-6``.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import ComputationGraph as JGraph
from deeplearning4j_tpu.nn import (LSTM, ActivationLayer, BatchNormalization, ConvolutionLayer,
                                   DenseLayer, DropoutLayer, EmbeddingSequenceLayer,
                                   GlobalPoolingLayer, InputType, NeuralNetConfiguration,
                                   OutputLayer, PoolingType, RnnOutputLayer)
from deeplearning4j_tpu.nn.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu.runtime.environment import get_environment as jax_env
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JScores
from deeplearning4j_tpu.train.updaters import Adam, Nesterovs
from deeplearning4j_tpu_torch.models import ComputationGraph, ModelSerializer
from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.remat_segments)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    env.set_remat(False)
    yield
    env.device, env.default_dtype, env.compute_dtype, env.remat_segments = saved


def _close(got, want, what, rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _through_archive(jnet, tmp_path, name="g.zip"):
    path = str(tmp_path / name)
    jnet.save(path)
    return ModelSerializer.restore_computation_graph(path, device="cpu")


def _rnn_graph(F=4, H=8, C=3, tbptt=None, updater=None, tokens=False):
    g = (NeuralNetConfiguration.builder().seed(0).updater(updater or Adam(1e-2))
         .graph_builder().add_inputs("in"))
    src = "in"
    if tokens:
        g.add_layer("emb", EmbeddingSequenceLayer(n_in=F, n_out=6), "in")
        src = "emb"
    g.add_layer("lstm", LSTM(n_out=H), src)
    g.add_layer("lstm2", LSTM(n_out=H), "lstm")
    g.add_layer("out", RnnOutputLayer(n_out=C, activation="softmax"), "lstm2")
    g.set_outputs("out")
    if tbptt:
        g.tbptt_fwd_length(tbptt)
    g.set_input_types(InputType.recurrent(F, None))
    return g.build()


def test_rnn_time_step_chunked_matches_whole_and_jax(tmp_path):
    jnet = JGraph(_rnn_graph()).init()
    net = _through_archive(jnet, tmp_path)
    x = np.random.default_rng(0).normal(0, 1, (3, 12, 4)).astype(np.float32)
    whole = net.output(x)
    _close(whole, jnet.output(x), "whole sequence vs JAX")
    chunks, jchunks = [], []
    for t0 in range(0, 12, 4):
        chunks.append(net.rnn_time_step(x[:, t0:t0 + 4]))
        jchunks.append(jnet.rnn_time_step(x[:, t0:t0 + 4]))
    _close(torch.cat(chunks, 1), whole, "chunks vs whole", atol=1e-5)
    for t, j in zip(chunks, jchunks):
        _close(t, j, "chunk vs JAX chunk")
    # external form: the same chunks from an explicit state, stored state untouched
    stored = net.rnn_get_state()
    out, state = net.rnn_time_step_external(x[:, :4], state=None)
    _close(out, chunks[0], "external first chunk", atol=0)
    out2, _ = net.rnn_time_step_external(x[:, 4:8], state=state)
    _close(out2, chunks[1], "external second chunk", atol=0)
    for a, b in zip(tree_leaves(net.rnn_get_state()), tree_leaves(stored)):
        assert torch.equal(a, b)


def test_stored_state_methods(tmp_path):
    net = _through_archive(JGraph(_rnn_graph()).init(), tmp_path)
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 4)).astype(np.float32)
    assert net.rnn_get_state() is None
    first = net.rnn_time_step(x)
    state = net.rnn_get_state()
    assert set(state) == {"lstm", "lstm2"} and all(len(c) == 2 for c in state.values())
    assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in tree_leaves(state))
    second = net.rnn_time_step(x)
    net.rnn_set_state(state)
    _close(net.rnn_time_step(x), second, "after set_state", atol=0)
    net.rnn_set_state({k: tuple(t.numpy() for t in v) for k, v in state.items()})
    _close(net.rnn_time_step(x), second, "after set_state from numpy", atol=0)
    net.rnn_clear_previous_state()
    assert net.rnn_get_state() is None
    _close(net.rnn_time_step(x), first, "after clear", atol=0)
    zero = net.rnn_zero_state(2)
    assert set(zero) == {"lstm", "lstm2"}
    assert all(float(t.abs().sum()) == 0 and tuple(t.shape) == (2, 8) for t in tree_leaves(zero))
    net.rnn_set_state(zero)
    _close(net.rnn_time_step(x), first, "from rnn_zero_state", atol=0)
    assert net.rnn_zero_state(2, like=x.astype(np.float64))["lstm"][0].dtype == torch.float32
    net.rnn_set_state(None)
    assert net.rnn_get_state() is None
    net.rnn_time_step(x)
    net.init()
    assert net.rnn_get_state() is None  # a new init forgets the stream


@pytest.mark.parametrize("tokens", [False, True], ids=["one-hot", "token-ids"])
def test_tbptt_fit_matches_jax(tmp_path, tokens):
    B, T, V, L = 4, 22, 6, 8
    seq = np.tile(np.arange(V), (B, T // V + 2))[:, :T + 1]
    seq = (seq + np.arange(B)[:, None]) % V
    x = seq[:, :-1].astype(np.int32) if tokens else np.eye(V, dtype=np.float32)[seq[:, :-1]]
    y = np.eye(V, dtype=np.float32)[seq[:, 1:]]
    jnet = JGraph(_rnn_graph(F=V, H=12, C=V, tbptt=L, tokens=tokens)).init()
    net = _through_archive(jnet, tmp_path)
    assert net.conf.tbptt_fwd_length == L
    jnet.set_listeners(js := JScores())
    net.set_listeners(ts := CollectScoresListener())
    jnet.fit(x, y, epochs=3)
    net.fit(x, y, epochs=3)
    assert len(ts.scores) == 3 * 3 == len(js.scores)  # 3 windows a batch
    assert net._iteration == jnet._iteration == 9
    _close([v for _, v in ts.scores], [v for _, v in js.scores], "per-window losses",
           rtol=1e-5)
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params)):
        _close(a, b, "weights after tBPTT", rtol=1e-4)
    for a, b in zip(tree_leaves(net.updater_state()),
                    jax.tree.leaves(jnet.train_state.opt_state)):
        _close(a, b, "Adam state", rtol=1e-4)


def _dense_graph():
    g = (NeuralNetConfiguration.builder().seed(3).updater(Nesterovs(0.05, momentum=0.9))
         .graph_builder().add_inputs("a", "b"))
    g.add_layer("da", DenseLayer(n_out=6, activation="tanh"), "a")
    g.add_layer("bn", BatchNormalization(), "da")
    g.add_layer("db", DenseLayer(n_out=6, activation="relu"), "b")
    g.add_vertex("sum", ElementWiseVertex(op="add"), "bn", "db")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax"), "sum")
    g.add_layer("out2", DenseLayer(n_out=2, activation="identity"), "db")
    g.set_outputs("out", "out2")
    g.set_input_types(InputType.feed_forward(5), InputType.feed_forward(4))
    return g.build()


def test_backprop_gradient_and_fit_external_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    a = rng.normal(1, 2, (8, 5)).astype(np.float32)
    b = rng.normal(0, 1, (8, 4)).astype(np.float32)
    eps = [rng.normal(0, 1, (8, 3)).astype(np.float32),
           rng.normal(0, 1, (8, 2)).astype(np.float32)]
    jnet = JGraph(_dense_graph()).init()
    net = _through_archive(jnet, tmp_path)
    jgp, jgin = jnet.backprop_gradient({"a": a, "b": b}, eps)
    gp, gin = net.backprop_gradient({"a": a, "b": b}, eps)
    assert set(gin) == {"a", "b"}
    for k in ("a", "b"):
        _close(gin[k], jgin[k], f"dL/d{k}")
    for t, j in zip(tree_leaves(gp), jax.tree.leaves(jgp)):
        _close(t, j, "parameter gradient", rtol=1e-4)
    # list and single-array forms of the inputs
    _, gin2 = net.backprop_gradient([a, b], eps)
    _close(gin2["a"], gin["a"], "list form", atol=0)
    for _ in range(2):
        jg = jnet.fit_external({"a": a, "b": b}, eps)
        tg = net.fit_external([a, b], eps)
    for k in ("a", "b"):
        _close(tg[k], jg[k], f"fit_external dL/d{k}", rtol=1e-4)
    assert net._iteration == jnet._iteration == 2
    for t, j in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params)):
        _close(t, j, "weights after 2 fit_external steps", rtol=1e-4)
    for t, j in zip(tree_leaves(net._model_state),
                    jax.tree.leaves(jnet.train_state.model_state)):
        _close(t, j, "BatchNormalization state", rtol=1e-4)


def _remat_graph(pkg_dropout=True):
    """JAX ``tests/test_zoo.py:144``'s graph, with a residual branch that
    holds a dropout and a plain 1x1 convolution + BatchNormalization pair,
    so one checkpointed segment runs both."""
    g = (NeuralNetConfiguration.builder().seed(3).updater(Nesterovs(0.05, momentum=0.9))
         .graph_builder().add_inputs("in"))
    g.add_layer("c1", ConvolutionLayer(n_out=8, kernel_size=(3, 3), convolution_mode="same",
                                       activation="identity"), "in")
    g.add_layer("b1", BatchNormalization(activation="relu"), "c1")
    g.add_layer("c2", ConvolutionLayer(n_out=8, kernel_size=(3, 3), convolution_mode="same",
                                       activation="identity"), "b1")
    src = "c2"
    if pkg_dropout:
        g.add_layer("drop", DropoutLayer(dropout=0.7), "c2")
        src = "drop"
    g.add_layer("c3", ConvolutionLayer(n_out=8, kernel_size=(1, 1), activation="identity",
                                       has_bias=False), src)
    g.add_layer("b3", BatchNormalization(), "c3")
    g.add_vertex("add", ElementWiseVertex(op="add"), "b3", "b1")
    g.add_layer("relu", ActivationLayer(activation="relu"), "add")
    g.add_layer("pool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), "relu")
    g.add_layer("out", OutputLayer(n_out=3, activation="softmax"), "pool")
    return g.set_outputs("out").set_input_types(InputType.convolutional(8, 8, 4)).build()


def _step(net, x, y, seed=0):
    from deeplearning4j_tpu_torch.runtime.rng import RngManager
    gen = RngManager(seed).next_generator()
    loss = net._train_step({"in": torch.from_numpy(x)}, [torch.from_numpy(y)], None,
                           generator=gen)
    return float(loss), [t.clone() for t in tree_leaves(net.params())], \
        [t.clone() for t in tree_leaves(net._model_state)]


def test_remat_segments_are_the_jax_cuts(tmp_path):
    jnet = JGraph(_remat_graph()).init()
    net = _through_archive(jnet, tmp_path)
    assert net._remat_segments() == jnet._remat_segments()
    assert ["c2", "drop", "c3", "b3", "add"] in net._remat_segments()
    assert net.fused_pairs == {"c3": "b3"}


def test_remat_step_matches_plain_step_with_dropout(tmp_path, monkeypatch):
    """One training step with remat on equals the plain step: the
    recomputed segment replays its dropout mask, the BatchNormalization
    state comes from the first forward, and the fused pair's conv_stats
    runs again in the backward pass."""
    x = np.random.default_rng(0).normal(0, 1, (4, 8, 8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    calls = []
    real = cs._apply
    monkeypatch.setattr(cs, "_apply", lambda *a: calls.append(1) or real(*a))
    jnet = JGraph(_remat_graph()).init()
    results = {}
    for remat in (False, True):
        get_environment().set_remat(remat)
        net = _through_archive(jnet, tmp_path, f"r{remat}.zip")
        calls.clear()
        results[remat] = _step(net, x, y)
        results[remat] += (len(calls),)
    (l0, p0, s0, n0), (l1, p1, s1, n1) = results[False], results[True]
    assert (n0, n1) == (1, 2)  # recomputed once in the backward pass
    assert l0 == l1
    for a, b in zip(p0 + s0, p1 + s1):
        _close(b, a, "remat vs plain", rtol=1e-6, atol=1e-7)
    # a second seed draws another mask: the step differs
    get_environment().set_remat(True)
    net = _through_archive(jnet, tmp_path, "other.zip")
    assert _step(net, x, y, seed=1)[0] != l1


def test_remat_step_matches_jax_without_dropout(tmp_path):
    x = np.random.default_rng(2).normal(0, 1, (4, 8, 8, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[[2, 1, 0, 0]]
    jenv = jax_env()
    jenv.set_remat(True)
    try:
        jnet = JGraph(_remat_graph(pkg_dropout=False)).init()
        net = _through_archive(jnet, tmp_path)
        get_environment().set_remat(True)
        jnet.set_listeners(js := JScores())
        net.set_listeners(ts := CollectScoresListener())
        for _ in range(2):
            jnet.fit(x, y)
            net.fit(x, y)
    finally:
        jenv.set_remat(False)
    _close([v for _, v in ts.scores], [v for _, v in js.scores], "losses", rtol=1e-5)
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params)):
        _close(a, b, "weights after 2 remat steps", rtol=1e-4, atol=1e-5)


def test_remat_switch_reads_its_variable(monkeypatch):
    from deeplearning4j_tpu_torch.runtime import environment as envmod
    monkeypatch.setattr(envmod, "_instance", None)
    monkeypatch.setenv("DL4J_TPU_REMAT", "1")
    env = envmod.get_environment()
    assert env.remat_segments and env.to_dict()["remat_segments"] is True
    assert env.set_remat(False) is env and not env.remat_segments


def test_multilayer_remat_matches_jax_and_plain(tmp_path):
    """``MultiLayerNetwork`` under remat (every hidden layer checkpointed,
    JAX ``multi_layer_network.py:171-176``): 2 steps against JAX's remat
    fit, and a step with dropout equal to the plain step."""
    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.runtime.rng import RngManager
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]

    def conf(drop):
        b = (NeuralNetConfiguration.builder().seed(2).updater(Adam(1e-2)).list()
             .layer(DenseLayer(n_out=8, activation="tanh"))
             .layer(BatchNormalization())
             .layer(DenseLayer(n_out=6, activation="relu", dropout=0.6 if drop else None))
             .layer(OutputLayer(n_out=3, activation="softmax")))
        return b.set_input_type(InputType.feed_forward(5)).build()

    jenv = jax_env()
    jenv.set_remat(True)
    try:
        jnet = JNet(conf(False)).init()
        path = str(tmp_path / "mln.zip")
        jnet.save(path)
        net = ModelSerializer.restore_multi_layer_network(path, device="cpu")
        get_environment().set_remat(True)
        jnet.set_listeners(js := JScores())
        net.set_listeners(ts := CollectScoresListener())
        jnet.fit(x, y, epochs=2)
        net.fit(x, y, epochs=2)
    finally:
        jenv.set_remat(False)
    _close([v for _, v in ts.scores], [v for _, v in js.scores], "losses", rtol=1e-5)
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params)):
        _close(a, b, "weights after 2 remat steps", rtol=1e-4)
    jd = JNet(conf(True)).init()
    jd.save(path)
    out = {}
    for remat in (False, True):
        get_environment().set_remat(remat)
        n = ModelSerializer.restore_multi_layer_network(path, device="cpu")
        loss, _ = n._train_step(torch.from_numpy(x), torch.from_numpy(y), None, None,
                                generator=RngManager(4).next_generator())
        out[remat] = (float(loss), [t.clone() for t in tree_leaves(n.params())])
    assert out[False][0] == out[True][0]
    for a, b in zip(out[False][1], out[True][1]):
        _close(b, a, "remat vs plain with dropout", rtol=1e-6, atol=1e-7)
