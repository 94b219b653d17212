"""The port's ComputationGraph against the JAX package on the CPU: the
configuration's JSON both ways, every ported vertex, and a small residual
CNN graph's ``output`` and three ``fit`` steps under Nesterovs from the same
weights (losses, weights, BatchNormalization's running statistics and the
updater's trace), with its three plain 1x1 convolution +
BatchNormalization pairs running through ``conv_stats``'s plain version,
and once more with them unfused.

Inputs are made with numpy from a seed; weights cross through the JAX
package's archive. Float32; outputs ``rtol=1e-5, atol=1e-5``; losses
``rtol=1e-5``; weights, statistics and traces after three steps ``rtol=1e-4,
atol=1e-5`` (sums in another order, amplified by the normalizations).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.computation_graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn import (ActivationLayer, BatchNormalization, ConvolutionLayer,
                                   GlobalPoolingLayer, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu.nn import graph_vertices as jv
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import (ComputationGraph, ComputationGraphConfiguration,
                                             ModelSerializer)
from deeplearning4j_tpu_torch.models.serializer import tree_leaves
from deeplearning4j_tpu_torch.nn import graph_vertices as tv
from deeplearning4j_tpu_torch.nn.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
from deeplearning4j_tpu_torch.runtime.environment import get_environment

B, H, W, C = 8, 8, 8, 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _close(got, want, what, rtol=1e-5, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _jax_conf():
    """A residual block with a projecting shortcut: ``c1``/``b1``,
    ``c3``/``b3`` and ``sc``/``sb`` are plain 1x1 convolution +
    BatchNormalization pairs;
    ``cx`` is a plain 1x1 convolution with two consumers (not fused); a max
    pooled side branch merges with the block before the head."""
    one = dict(kernel_size=(1, 1), activation="identity", has_bias=False)
    g = (NeuralNetConfiguration.builder().seed(7).updater(Nesterovs(0.05, momentum=0.9))
         .weight_init("relu").graph_builder().add_inputs("in"))
    g.add_layer("c0", ConvolutionLayer(n_out=6, kernel_size=(3, 3),
                                       convolution_mode="same"), "in")
    g.add_layer("b0", BatchNormalization(activation="relu"), "c0")
    g.add_layer("c1", ConvolutionLayer(n_out=4, stride=(2, 2), **one), "b0")
    g.add_layer("b1", BatchNormalization(activation="relu"), "c1")
    g.add_layer("c3", ConvolutionLayer(n_out=8, **one), "b1")
    g.add_layer("b3", BatchNormalization(), "c3")
    g.add_layer("sc", ConvolutionLayer(n_out=8, stride=(2, 2), **one), "b0")
    g.add_layer("sb", BatchNormalization(decay=0.8), "sc")
    g.add_vertex("add", jv.ElementWiseVertex(op="add"), "b3", "sb")
    g.add_layer("relu", ActivationLayer(activation="relu"), "add")
    g.add_layer("cx", ConvolutionLayer(n_out=8, **one), "relu")
    g.add_layer("bx", BatchNormalization(), "cx")
    g.add_vertex("mix", jv.ElementWiseVertex(op="average"), "bx", "cx")
    g.add_layer("avg", GlobalPoolingLayer(pooling_type="avg"), "mix")
    g.add_layer("side", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                         convolution_mode="same"), "b0")
    g.add_layer("smax", GlobalPoolingLayer(pooling_type="max"), "side")
    g.add_vertex("merge", jv.MergeVertex(), "avg", "smax")
    g.add_layer("out", OutputLayer(n_out=5, activation="softmax", loss="mcxent"), "merge")
    g.set_outputs("out").set_input_types(JInputType.convolutional(H, W, C))
    return g.build()


@pytest.fixture(scope="module")
def jax_graph(tmp_path_factory):
    jnet = JGraph(_jax_conf()).init()
    path = str(tmp_path_factory.mktemp("graph") / "graph.zip")
    jnet.save(path)
    return jnet, path


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (B, H, W, C)) + 0.5).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, B)]
    return x, y


def test_configuration_json_both_ways():
    jconf = _jax_conf()
    tconf = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    back = type(jconf).from_json(tconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert tconf.topo_order == jconf.topo_order
    assert tconf.node_input_types == {k: None if v is None else TInputType(**v.to_dict())
                                      for k, v in jconf.node_input_types.items()}
    assert tconf.node_input_types["out"] == TInputType.feed_forward(14)
    assert tconf.output_types == [TInputType.feed_forward(5)]


def test_fused_pairs_follow_the_graph():
    net = ComputationGraph(ComputationGraphConfiguration.from_json(_jax_conf().to_json()),
                           device="cpu").init()
    assert net.fused_pairs == {"c1": "b1", "c3": "b3", "sc": "sb"}


VERTEX_CASES = [
    ("MergeVertex", {}, [(2, 3, 4), (2, 3, 5)]),
    ("ElementWiseVertex", {"op": "add"}, [(3, 4)] * 3),
    ("ElementWiseVertex", {"op": "product"}, [(3, 4)] * 3),
    ("ElementWiseVertex", {"op": "subtract"}, [(2, 2, 3, 4)] * 2),
    ("ElementWiseVertex", {"op": "average"}, [(3, 4)] * 3),
    ("ElementWiseVertex", {"op": "max"}, [(3, 4)] * 3),
    ("ElementWiseVertex", {"op": "min"}, [(3, 4)] * 2),
    ("ElementWiseVertex", {"op": "dot"}, [(3, 5, 4)] * 2),
    ("SubsetVertex", {"from_idx": 1, "to_idx": 3}, [(3, 6)]),
    ("StackVertex", {}, [(2, 4), (3, 4)]),
    ("UnstackVertex", {"from_idx": 1, "stack_size": 3}, [(6, 4)]),
    ("ScaleVertex", {"scale": 2.5}, [(3, 4)]),
    ("ShiftVertex", {"shift": -1.5}, [(3, 4)]),
    ("L2NormalizeVertex", {"eps": 1e-6}, [(3, 4)]),
    ("ReshapeVertex", {"shape": [2, 6]}, [(3, 12)]),
]


@pytest.mark.parametrize("name,kw,shapes", VERTEX_CASES,
                         ids=[f"{n}-{json.dumps(k)}" for n, k, _ in VERTEX_CASES])
def test_vertex_forward_and_json_match_jax(name, kw, shapes):
    rng = np.random.default_rng(len(name) + len(shapes))
    xs = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    jvert, tvert = getattr(jv, name)(**kw), getattr(tv, name)(**kw)
    want = jvert.forward(*[jnp.asarray(x) for x in xs])
    got = tvert.forward(*[torch.from_numpy(x) for x in xs])
    _close(got, want, name)
    assert json.loads(json.dumps(tvert.to_dict())) == json.loads(json.dumps(jvert.to_dict()))
    assert tv.GraphVertex.from_dict(jvert.to_dict()) == tvert


def test_vertex_output_types_match_jax():
    for its in ([(4, 4, 3), (4, 4, 5)],):
        j = jv.MergeVertex().output_type(*[JInputType.convolutional(*s) for s in its])
        t = tv.MergeVertex().output_type(*[TInputType.convolutional(*s) for s in its])
        assert t.to_dict() == j.to_dict()
    for kind in ("recurrent", "feedforward"):
        mk = (lambda m, n: m.recurrent(n, 7)) if kind == "recurrent" else \
            (lambda m, n: m.feed_forward(n))
        j = jv.MergeVertex().output_type(mk(JInputType, 3), mk(JInputType, 4))
        t = tv.MergeVertex().output_type(mk(TInputType, 3), mk(TInputType, 4))
        assert t.to_dict() == j.to_dict()
        j = jv.SubsetVertex(1, 2).output_type(mk(JInputType, 5))
        t = tv.SubsetVertex(1, 2).output_type(mk(TInputType, 5))
        assert t.to_dict() == j.to_dict()


def test_unported_parts_raise_by_name():
    # PreprocessorVertex, once refused here, now reads as the JAX package's
    d = {"@type": "PreprocessorVertex",
         "preprocessor": {"@type": "CnnToFeedForwardPreProcessor", "height": 2, "width": 3,
                          "channels": 4}}
    vert = tv.GraphVertex.from_dict(d)
    assert vert.to_dict() == jv.GraphVertex.from_dict(d).to_dict() == d
    assert tuple(vert.forward(torch.zeros(5, 2, 3, 4)).shape) == (5, 24)
    with pytest.raises(KeyError, match="FrozenVertex"):
        tv.GraphVertex.from_dict({"@type": "FrozenVertex"})
    net = ComputationGraph(ComputationGraphConfiguration.from_json(_jax_conf().to_json()),
                           device="cpu").init()
    x, _ = _batch(0)
    # the external-errors mode and the stateful API, once refused here, run
    # (held against the JAX package in test_torch_graph_rnn.py)
    eps = np.ones((B, 5), np.float32)
    gp, g_in = net.backprop_gradient(x, eps)
    assert set(gp) == set(net.params()) and tuple(g_in["in"].shape) == x.shape
    assert tuple(net.fit_external(x, eps)["in"].shape) == x.shape
    out, state = net.rnn_time_step_external(x, state=None)
    assert state == {} and tuple(out.shape) == (B, 5)
    # the line-search solvers, once refused here, run (held against the
    # JAX package in test_torch_solvers.py)
    net.conf.global_conf.optimization_algo = "LBFGS"
    net.fit(x, eps)
    assert len(net._solver_log) == 1 and net._solver_log[0]["algorithm"] == "LBFGS"


def test_output_matches_jax(jax_graph):
    jnet, path = jax_graph
    net = ModelSerializer.restore_model(path, device="cpu")
    assert isinstance(net, ComputationGraph) and net.num_params() == jnet.num_params()
    x, _ = _batch(1)
    out = net.output(x)
    _close(out, jnet.output(x), "output")
    assert out.shape == (B, 5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_three_fit_steps_match_jax(jax_graph, fused):
    """Nesterovs(0.05, 0.9), three batches: the same losses, weights,
    running statistics and traces; the fused pairs go through conv_stats
    (its plain version here: three per step), the unfused through the
    layers."""
    _, path = jax_graph
    jnet = JGraph.load(path)
    net = ModelSerializer.restore_model(path, device="cpu")
    if not fused:
        net._fused = {}
    calls = []
    real = cs.conv_stats_reference

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    cs.conv_stats_reference = counting
    try:
        for step in range(3):
            x, y = _batch(10 + step)
            jnet.fit(x, y)
            net.fit(x, y)
            _close(net.score(), float(jnet.score()), f"loss {step}")
    finally:
        cs.conv_stats_reference = real
    assert len(calls) == (9 if fused else 0)
    tol = dict(rtol=1e-4, atol=1e-5)
    ts = jnet.train_state
    for t, j in zip(tree_leaves(net.params()), jax.tree.leaves(ts.params), strict=True):
        _close(t, j, "weights", **tol)
    for t, j in zip(tree_leaves(net._model_state), jax.tree.leaves(ts.model_state),
                    strict=True):
        _close(t, j, "running statistics", **tol)
    for t, j in zip(tree_leaves(net.updater_state()), jax.tree.leaves(ts.opt_state),
                    strict=True):
        _close(t, j, "trace", **tol)
    assert float(net._model_state["sb"]["var"].sub(1.0).abs().max()) > 1e-3


def test_fit_on_an_iterator_and_score_match_jax(jax_graph):
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
    _, path = jax_graph
    jnet = JGraph.load(path)
    net = ModelSerializer.restore_model(path, device="cpu")
    batches = [_batch(20 + i) for i in range(2)]
    jnet.fit(JList([JDataSet(x, y) for x, y in batches], batch_size=B), epochs=2)
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches], batch_size=B), epochs=2)
    assert net._iteration == 4 and net._epoch == 2
    x, y = _batch(30)
    _close(net.score(DataSet(x, y)), jnet.score(_jds(x, y)), "score", rtol=1e-4)


def _jds(x, y):
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    return JDataSet(x, y)


def test_fit_takes_tensors_already_on_the_device():
    net = ComputationGraph(ComputationGraphConfiguration.from_json(_jax_conf().to_json()),
                           device="cpu").init()
    twin = ComputationGraph(ComputationGraphConfiguration.from_json(_jax_conf().to_json()),
                            device="cpu").init()
    x, y = _batch(3)
    net.fit(torch.from_numpy(x), torch.from_numpy(y))
    twin.fit(x, y)
    assert float(net.score()) == float(twin.score())
    other = ComputationGraph(ComputationGraphConfiguration.from_json(_jax_conf().to_json()),
                             device="cpu").init()
    other.set_params(net.params())
    other._model_state = net._model_state
    assert torch.equal(other.output(x), net.output(x))
    assert other.num_params() == net.num_params() == sum(
        t.numel() for t in tree_leaves(net.params()))
