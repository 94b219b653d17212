"""The port's transfer learning against the JAX package on the CPU: the
cases of ``tests/test_transfer_graph.py:28-112`` (swap a graph's head and
keep its features, a removed output that was never replaced, downstream
removal, BatchNormalization's running statistics carried over, a misspelled
feature-extractor name) and ``TransferLearning`` on a ``MultiLayerNetwork``,
each built from the same trained weights in both packages (through the JAX
archive) and fitted on the same batches.

Inputs are numpy from a seed. Float32: losses ``rtol=1e-5``; weights after
the steps ``rtol=1e-4, atol=1e-6``; frozen weights bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import ComputationGraph as JGraph
from deeplearning4j_tpu.models import FineTuneConfiguration as JFine
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models import TransferLearning as JTransfer
from deeplearning4j_tpu.nn import (BatchNormalization, DenseLayer, InputType,
                                   NeuralNetConfiguration, OutputLayer)
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JScores
from deeplearning4j_tpu.train.updaters import Adam
from deeplearning4j_tpu_torch import nn as tnn
from deeplearning4j_tpu_torch.models import (ComputationGraph, FineTuneConfiguration,
                                             ModelSerializer, MultiLayerNetwork,
                                             TransferLearning)
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train import updaters as tupd
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _close(got, want, what, rtol=1e-4, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (48, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 48)]
    return x, y


def _trained_graphs(tmp_path):
    """``test_transfer_graph._trained_graph`` in JAX, and the port's graph
    from its archive."""
    x, y = _data()
    g = (NeuralNetConfiguration.builder().seed(0).updater(Adam(2e-2)).graph_builder()
         .add_inputs("in")
         .add_layer("feat1", DenseLayer(n_out=16, activation="tanh"), "in")
         .add_layer("feat2", DenseLayer(n_out=8, activation="tanh"), "feat1")
         .add_layer("out", OutputLayer(n_out=3, activation="softmax"), "feat2")
         .set_outputs("out"))
    g.set_input_types(InputType.feed_forward(5))
    jnet = JGraph(g.build()).init()
    jnet.fit(x, y, epochs=5)
    path = str(tmp_path / "g.zip")
    jnet.save(path)
    return jnet, ModelSerializer.restore_computation_graph(path, device="cpu"), x


def test_graph_transfer_swap_head_keeps_features(tmp_path):
    jnet, net, x = _trained_graphs(tmp_path)
    w_feat1 = net.params()["feat1"]["W"].clone()

    def build(pkg_tl, pkg_ft, pkg_adam, out_layer, n):
        return (pkg_tl.graph_builder(n)
                .fine_tune_configuration(pkg_ft(updater=pkg_adam(1e-3)))
                .set_feature_extractor("feat2")
                .remove_vertex_and_connections("out")
                .add_layer("out2", out_layer(n_out=5, activation="softmax"), "feat2")
                .set_outputs("out2")
                .build())

    jnet2 = build(JTransfer, JFine, Adam, OutputLayer, jnet)
    net2 = build(TransferLearning, FineTuneConfiguration, tupd.Adam, tnn.OutputLayer, net)
    assert isinstance(net2, ComputationGraph) and net2.device == net.device
    assert torch.equal(net2.params()["feat1"]["W"], w_feat1)
    assert net2.params()["feat1"]["W"] is not net.params()["feat1"]["W"]  # a copy
    assert tuple(net2.params()["out2"]["W"].shape) == (8, 5)
    assert net2.conf.node("feat1").obj.frozen and net2.conf.node("feat2").obj.frozen
    assert not net2.conf.node("out2").obj.frozen
    assert net2.conf.to_dict()["nodes"] == jnet2.conf.to_dict()["nodes"]
    # the new head from the JAX build's weights, then 3 steps in both
    net2.set_params({k: {n: torch.from_numpy(np.asarray(v).copy()) for n, v in p.items()}
                     for k, p in jnet2.train_state.params.items()})
    assert tuple(net2.output(x).shape) == (48, 5)
    _close(net2.output(x), jnet2.output(x), "output", rtol=1e-5)
    y2 = np.eye(5, dtype=np.float32)[np.random.default_rng(1).integers(0, 5, 48)]
    jnet2.set_listeners(js := JScores())
    net2.set_listeners(ts := CollectScoresListener())
    jnet2.fit(x, y2, epochs=3)
    net2.fit(x, y2, epochs=3)
    _close([v for _, v in ts.scores], [v for _, v in js.scores], "losses", rtol=1e-5)
    assert torch.equal(net2.params()["feat1"]["W"], w_feat1)  # frozen: bit for bit
    assert torch.equal(net2.params()["feat2"]["W"], net.params()["feat2"]["W"])
    for a, b in zip(tree_leaves(net2.params()), jax.tree.leaves(jnet2.train_state.params)):
        _close(a, b, "weights after 3 steps")
    assert not torch.allclose(net2.params()["out2"]["W"], torch.zeros(8, 5))


def test_graph_transfer_removed_output_must_be_replaced(tmp_path):
    jnet, net, _ = _trained_graphs(tmp_path)
    for pkg, n in ((JTransfer, jnet), (TransferLearning, net)):
        with pytest.raises(ValueError, match="set_outputs"):
            pkg.graph_builder(n).remove_vertex_and_connections("out").build()


def test_graph_transfer_downstream_removal(tmp_path):
    jnet, net, _ = _trained_graphs(tmp_path)
    jb = JTransfer.graph_builder(jnet).remove_vertex_and_connections("feat2")
    b = TransferLearning.graph_builder(net).remove_vertex_and_connections("feat2")
    assert b._removed == jb._removed == {"feat2", "out"}


def test_transfer_keeps_batchnorm_running_stats(tmp_path):
    rng = np.random.default_rng(0)
    x = (rng.normal(3.0, 2.0, (64, 6))).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 64)]
    g = (NeuralNetConfiguration.builder().seed(0).updater(Adam(1e-2)).graph_builder()
         .add_inputs("in")
         .add_layer("bn", BatchNormalization(), "in")
         .add_layer("out", OutputLayer(n_out=2, activation="softmax"), "bn")
         .set_outputs("out"))
    g.set_input_types(InputType.feed_forward(6))
    jnet = JGraph(g.build()).init()
    path = str(tmp_path / "bn.zip")
    jnet.save(path)
    net = ModelSerializer.restore_computation_graph(path, device="cpu")
    jnet.fit(x, y, epochs=10)
    net.fit(x, y, epochs=10)
    trained_mean = net._model_state["bn"]["mean"].clone()
    _close(trained_mean, jnet.train_state.model_state["bn"]["mean"], "running mean")
    assert float(trained_mean.mean()) > 1.0
    net2 = (TransferLearning.graph_builder(net)
            .set_feature_extractor("bn")
            .remove_vertex_and_connections("out")
            .add_layer("out2", tnn.OutputLayer(n_out=4, activation="softmax"), "bn")
            .set_outputs("out2")
            .build())
    assert torch.equal(net2._model_state["bn"]["mean"], trained_mean)
    assert torch.equal(net2._model_state["bn"]["var"], net._model_state["bn"]["var"])


def test_feature_extractor_typo_raises(tmp_path):
    jnet, net, _ = _trained_graphs(tmp_path)
    for pkg, n in ((JTransfer, jnet), (TransferLearning, net)):
        with pytest.raises(ValueError, match="nope"):
            pkg.graph_builder(n).set_feature_extractor("nope").build()


def test_multilayer_transfer_matches_jax(tmp_path):
    x, y = _data()
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_out=12, activation="tanh"))
            .layer(BatchNormalization())
            .layer(DenseLayer(n_out=8, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(5)).build())
    jnet = JNet(conf).init()
    jnet.fit(x, y, epochs=3)
    path = str(tmp_path / "mln.zip")
    jnet.save(path)
    net = ModelSerializer.restore_multi_layer_network(path, device="cpu")

    def build(pkg_tl, pkg_ft, adam, out, n):
        return (pkg_tl.builder(n)
                .fine_tune_configuration(pkg_ft(updater=adam(5e-3), l2=1e-3))
                .set_feature_extractor(1)
                .remove_layers_from_output(2)
                .add_layer(pkg_tl_dense(pkg_tl)(n_out=6, activation="tanh"))
                .add_layer(out(n_out=4, activation="softmax"))
                .build())

    def pkg_tl_dense(pkg):
        return DenseLayer if pkg is JTransfer else tnn.DenseLayer

    jnet2 = build(JTransfer, JFine, Adam, OutputLayer, jnet)
    net2 = build(TransferLearning, FineTuneConfiguration, tupd.Adam, tnn.OutputLayer, net)
    assert isinstance(net2, MultiLayerNetwork)
    assert [l.frozen for l in net2.layers] == [True, True, False, False]
    assert net2.conf.to_dict() == MultiLayerNetwork(
        type(net2.conf).from_json(jnet2.conf.to_json())).conf.to_dict()
    for k in ("layer_0",):
        for n in ("W", "b"):
            assert torch.equal(net2.params()[k][n], net.params()[k][n])
    assert torch.equal(net2._model_state["layer_1"]["mean"], net._model_state["layer_1"]["mean"])
    net2.set_params({k: {n: torch.from_numpy(np.asarray(v).copy()) for n, v in p.items()}
                     for k, p in jnet2.train_state.params.items()})
    y2 = np.eye(4, dtype=np.float32)[np.random.default_rng(2).integers(0, 4, 48)]
    jnet2.set_listeners(js := JScores())
    net2.set_listeners(ts := CollectScoresListener())
    jnet2.fit(x, y2, epochs=3)
    net2.fit(x, y2, epochs=3)
    _close([v for _, v in ts.scores], [v for _, v in js.scores], "losses", rtol=1e-5)
    assert torch.equal(net2.params()["layer_0"]["W"], net.params()["layer_0"]["W"])
    for a, b in zip(tree_leaves(net2.params()), jax.tree.leaves(jnet2.train_state.params)):
        _close(a, b, "weights after 3 steps")
    for a, b in zip(tree_leaves(net2._model_state),
                    jax.tree.leaves(jnet2.train_state.model_state)):
        _close(a, b, "BatchNormalization state")
