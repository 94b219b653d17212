"""The network methods that were missing from the port, against the JAX
package on the CPU.

``MultiLayerNetwork``: ``backprop_gradient`` (parameter gradients and
dL/dInput for an external dL/dOutput), ``fit_external`` (two updater steps
on external errors) and ``rnn_activate_using_stored_state`` (a recurrent
net from its stored state, keeping the final state or not).
``ComputationGraph``: ``evaluate`` over DataSets and over two-input
MultiDataSets, ``clone``, the stateful-RNN methods raising by name, and the
eight training options of ``test_torch_updaters.py``'s network test, held
here on a graph: three steps from one JAX archive, losses, weights and
optimizer state.

Networks cross through the JAX package's archives; inputs are made with
numpy from a seed. Float32: 1e-5 relative, 1e-6 absolute.
"""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import ModelSerializer
from deeplearning4j_tpu_torch.models.serializer import tree_leaves
from deeplearning4j_tpu_torch.runtime.environment import get_environment


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _close(got, want, what="", rtol=1e-5, atol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _trees_close(got, want, rtol=1e-5, atol=1e-6):
    t, j = tree_leaves(got), jax.tree.leaves(want)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        _close(a, b, rtol=rtol, atol=atol)


def _both(jnet, tmp_path, name="net.zip"):
    path = str(tmp_path / name)
    jnet.save(path)
    return ModelSerializer.restore_model(path, device="cpu")


def _jax_mln(updater=None):
    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
    from deeplearning4j_tpu.train.updaters import Adam
    conf = (NeuralNetConfiguration.builder().seed(2).updater(updater or Adam(1e-2)).list()
            .layer(DenseLayer(n_out=7, activation="tanh"))
            .layer(DenseLayer(n_out=5, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(4)).build())
    return JNet(conf).init()


def _x_eps(seed, n=6, d_in=4, d_out=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, d_in)).astype(np.float32),
            rng.normal(0, 1, (n, d_out)).astype(np.float32))


def test_backprop_gradient_matches_jax(tmp_path):
    jnet = _jax_mln()
    net = _both(jnet, tmp_path)
    x, eps = _x_eps(0)
    jgp, jgx = jnet.backprop_gradient(x, eps)
    gp, gx = net.backprop_gradient(x, eps)
    _trees_close(gp, jgp)
    _close(gx, jgx, "dL/dInput")
    _trees_close(net.params(), jnet.train_state.params, rtol=0, atol=0)  # no update


def test_fit_external_matches_jax(tmp_path):
    jnet = _jax_mln()
    net = _both(jnet, tmp_path)
    for seed in (1, 2):
        x, eps = _x_eps(seed)
        _close(net.fit_external(x, eps), jnet.fit_external(x, eps), "dL/dInput")
    assert net.iteration == jnet._iteration == 2
    _trees_close(net.params(), jnet.train_state.params)
    _trees_close(net.updater_state(), jnet.train_state.opt_state)


def test_rnn_activate_using_stored_state_matches_jax(tmp_path):
    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn import LSTM, InputType, NeuralNetConfiguration, RnnOutputLayer
    conf = (NeuralNetConfiguration.builder().seed(4).list()
            .layer(LSTM(n_out=6, activation="tanh"))
            .layer(RnnOutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.recurrent(5)).build())
    jnet = JNet(conf).init()
    net = _both(jnet, tmp_path)
    rng = np.random.default_rng(5)
    chunks = [rng.normal(0, 1, (2, 4, 5)).astype(np.float32) for _ in range(3)]
    # from zeros, keeping the final state; again from it; then not keeping it
    for x, store, training in ((chunks[0], True, False), (chunks[1], True, True),
                               (chunks[2], False, False), (chunks[2], False, False)):
        want = jnet.rnn_activate_using_stored_state(x, training=training,
                                                    store_last_for_tbptt=store)
        got = net.rnn_activate_using_stored_state(x, training=training,
                                                  store_last_for_tbptt=store)
        _close(got, want)
        _trees_close(net.rnn_get_state(), jnet.rnn_get_state())
    net.rnn_clear_previous_state()
    jnet.rnn_clear_previous_state()
    _close(net.rnn_activate_using_stored_state(chunks[1]),
           jnet.rnn_activate_using_stored_state(chunks[1]))
    # the zero state it started from is stored, as in the JAX package
    _trees_close(net.rnn_get_state(), jnet.rnn_get_state(), rtol=0, atol=0)
    assert all(not t.any() for t in tree_leaves(net.rnn_get_state()))


# --------------------------------------------------------- ComputationGraph
def _jax_graph(updater=None, two_inputs=False, **kw):
    """The JAX package's graph: 3 -> Dense(4, tanh) -> softmax(2), or two
    inputs merged; ``kw`` are global options, ``layer_kw`` the dense
    layer's."""
    from deeplearning4j_tpu.models.computation_graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
    from deeplearning4j_tpu.nn import graph_vertices as jv
    from deeplearning4j_tpu.train.updaters import Adam
    layer_kw = kw.pop("layer_kw", {})
    b = NeuralNetConfiguration.builder().seed(1).updater(updater or Adam(1e-2))
    if "gradient_normalization" in kw:
        b.gradient_normalization(*kw.pop("gradient_normalization"))
    for k, v in kw.items():
        getattr(b, k)(v)
    g = b.graph_builder()
    if two_inputs:
        g.add_inputs("a", "b").add_vertex("merge", jv.MergeVertex(), "a", "b")
        g.add_layer("dense", DenseLayer(n_out=4, activation="tanh", **layer_kw), "merge")
        types = (InputType.feed_forward(3), InputType.feed_forward(2))
    else:
        g.add_inputs("in").add_layer("dense", DenseLayer(n_out=4, activation="tanh",
                                                         **layer_kw), "in")
        types = (InputType.feed_forward(3),)
    g.add_layer("out", OutputLayer(n_out=2, activation="softmax"), "dense").set_outputs("out")
    return JGraph(g.set_input_types(*types).build()).init()


def _dense_batches(n=3, seed=4, rows=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (rows, 3)).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, rows)]) for _ in range(n)]


def test_graph_evaluate_matches_jax(tmp_path):
    from deeplearning4j_tpu.data import ListDataSetIterator as JList
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    jnet = _jax_graph()
    net = _both(jnet, tmp_path)
    batches = _dense_batches(4, seed=8, rows=16)
    jev = jnet.evaluate(JList([JDataSet(x, y) for x, y in batches]))
    ev = net.evaluate(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
    assert ev.accuracy() == jev.accuracy() and ev.f1() == pytest.approx(jev.f1())
    np.testing.assert_array_equal(np.asarray(ev.confusion_matrix()),
                                  np.asarray(jev.confusion_matrix()))


def test_graph_evaluate_and_fit_over_multidatasets(tmp_path):
    """A two-input graph fed MultiDataSets (JAX ``_coerce_batch``): three
    fit steps and ``evaluate`` agree with the JAX package's."""
    from deeplearning4j_tpu.data import ExistingDataSetIterator as JExisting
    from deeplearning4j_tpu.data.dataset import MultiDataSet as JMulti
    from deeplearning4j_tpu_torch.data import ExistingDataSetIterator, MultiDataSet
    jnet = _jax_graph(two_inputs=True)
    net = _both(jnet, tmp_path)
    rng = np.random.default_rng(6)
    data = [([rng.normal(0, 1, (8, 3)).astype(np.float32),
              rng.normal(0, 1, (8, 2)).astype(np.float32)],
             [np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]]) for _ in range(3)]
    jnet.fit(JExisting([JMulti(f, l) for f, l in data]))
    net.fit(ExistingDataSetIterator([MultiDataSet(f, l) for f, l in data]))
    _trees_close(net.params(), jnet.train_state.params)
    jev = jnet.evaluate(JExisting([JMulti(f, l) for f, l in data]))
    ev = net.evaluate(ExistingDataSetIterator([MultiDataSet(f, l) for f, l in data]))
    np.testing.assert_array_equal(np.asarray(ev.confusion_matrix()),
                                  np.asarray(jev.confusion_matrix()))


def test_graph_clone(tmp_path):
    """JAX ``clone``: the same configuration, copies of the parameters and
    the layers' state, on the same device, a fresh optimizer."""
    jnet = _jax_graph()
    net = _both(jnet, tmp_path)
    (x, y), = _dense_batches(1)
    net.fit(x, y)
    jnet.fit(x, y)
    twin, jtwin = net.clone(), jnet.clone()
    assert twin.conf.to_dict() == net.conf.to_dict() and twin.device == net.device
    for a, b in zip(tree_leaves(twin.params()), tree_leaves(net.params())):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    _close(twin.output(x), jtwin.output(x))
    assert twin._optimizer is None
    twin.fit(x, y)  # the twin trains alone
    jtwin.fit(x, y)
    assert not torch.equal(twin.params()["dense"]["W"], net.params()["dense"]["W"])
    _trees_close(twin.params(), jtwin.train_state.params)


@pytest.mark.parametrize("method,args", [("rnn_clear_previous_state", ()),
                                         ("rnn_get_state", ()),
                                         ("rnn_set_state", (None,)),
                                         ("rnn_zero_state", (2,))])
def test_graph_rnn_state_methods_raise_by_name(method, args, tmp_path):
    # once refused by name, the stored-state methods now run (held against
    # JAX on an LSTM graph in test_torch_graph_rnn.py); this graph holds no
    # recurrent layer, so its state is empty
    net = _both(_jax_graph(), tmp_path)
    got = getattr(net, method)(*args)
    assert got == ({} if method == "rnn_zero_state" else None)
    assert net.rnn_get_state() is None


@pytest.mark.parametrize("what", ["Nadam", "AdaGrad", "schedule", "gradient_normalization",
                                  "l2", "l1", "weight_decay", "layer_l2"])
def test_graph_training_options_match_jax(what, tmp_path):
    from deeplearning4j_tpu.train import schedules as jsched
    from deeplearning4j_tpu.train import updaters as jupd
    kw = {"gradient_normalization": {"gradient_normalization": ("ClipL2PerLayer", 0.05)},
          "l2": {"l2": 1e-2}, "l1": {"l1": 1e-2}, "weight_decay": {"weight_decay": 1e-2},
          "layer_l2": {"layer_kw": {"l2": 2e-2}}}.get(what, {})
    upd = {"Nadam": jupd.Nadam(1e-2), "AdaGrad": jupd.AdaGrad(5e-2),
           "schedule": jupd.RmsProp(jsched.StepSchedule(initial_value=1e-2, decay_rate=0.5,
                                                        step_size=2))}.get(what, jupd.Adam(1e-2))
    jnet = _jax_graph(upd, **kw)
    net = _both(jnet, tmp_path)
    jl, tl = [], []
    for x, y in _dense_batches():
        jnet.fit(x, y)
        net.fit(x, y)
        jl.append(float(jnet.score()))
        tl.append(float(net.score()))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _trees_close(net.params(), jnet.train_state.params)
    jleaves, tleaves = jax.tree.leaves(jnet.train_state.opt_state), \
        tree_leaves(net.updater_state())
    assert [(tuple(np.shape(a)), np.asarray(a).dtype.name) for a in jleaves] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tleaves]
    for j, t in zip(jleaves, tleaves):
        _close(t, j)
