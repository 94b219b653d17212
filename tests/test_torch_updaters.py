"""The port's updater math against optax, as the JAX package builds it.

Five steps of random gradients (numpy, from a seed) go through
``Updater.make()`` of the JAX package, one transform per layer under
``optax.multi_transform`` as the JAX network builds it, and through the
port's ``NetworkOptimizer`` (for Adam over a parameter tree that nests as a
transformer block's does); parameters and optimizer state must agree
after every step. Float32: ``rtol=1e-6, atol=1e-9`` — the same float
operations in the same order on both sides, up to the last bit of
``rsqrt``, ``sqrt`` and ``pow``.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.serializer import tree_leaves
from deeplearning4j_tpu_torch.nn import base as tbase
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.train import updaters as tupd

SHAPES = {"layer_0": {"W": (6, 8), "W_rec": (2, 8), "b": (8,), "peephole": (6,)},
          "layer_1": {"W": (2, 3), "b": (3,)}}
# a layer whose parameters nest, as a transformer block's "attn" does
NESTED = {"layer_0": {**SHAPES["layer_0"], "attn": {"W_q": (8, 4), "b_q": (4,)}},
          "layer_1": SHAPES["layer_1"]}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _tree(rng, scale=1.0, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, scale, v) for k, v in shapes.items()}
    return rng.normal(0, scale, shapes).astype(np.float32)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


def _jax_multi_transform(make, shapes):
    """One optax transform per layer label, as the JAX network's
    ``_build_tx`` builds them."""
    import jax
    import optax
    labels = {k: jax.tree.map(lambda _, k=k: k, _tree(np.random.default_rng(0), shapes=v))
              for k, v in shapes.items()}
    return optax.multi_transform({k: make() for k in shapes}, labels)


@pytest.mark.parametrize("name,kw", [("RmsProp", {"learning_rate": 1e-2}),
                                     ("RmsProp", {"learning_rate": 1e-3, "rms_decay": 0.9,
                                                  "epsilon": 1e-6}),
                                     ("Sgd", {"learning_rate": 0.1}),
                                     ("NoOp", {}),
                                     ("Adam", {"learning_rate": 2e-5}),
                                     ("Adam", {"learning_rate": 1e-3, "beta1": 0.8,
                                               "beta2": 0.99, "epsilon": 1e-6}),
                                     ("Nesterovs", {"learning_rate": 0.1, "momentum": 0.9}),
                                     ("Nesterovs", {"learning_rate": 1e-2, "momentum": 0.5})],
                         ids=["rmsprop", "rmsprop_decay_eps", "sgd", "noop", "adam",
                              "adam_betas_eps", "nesterovs", "nesterovs_lr_momentum"])
def test_updater_matches_optax_over_five_steps(name, kw):
    import jax
    import jax.numpy as jnp
    import optax

    from deeplearning4j_tpu.train import updaters as jupd
    shapes = NESTED if name in ("Adam", "Nesterovs") else SHAPES
    rng = np.random.default_rng(0)
    params = _tree(rng, shapes=shapes)
    tx = _jax_multi_transform(lambda: getattr(jupd, name)(**kw).make(), shapes)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = _torch_tree(params)
    opt = tupd.NetworkOptimizer({k: getattr(tupd, name)(**kw) for k in shapes}, tparams)
    for step in range(5):
        # mixed magnitudes: some |g| << sqrt(eps), where the update is most sensitive
        grads = _tree(rng, scale=10.0 ** -(step % 3 * 2), shapes=shapes)
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, _torch_tree(grads))
        for i, (t, j) in enumerate(zip(tree_leaves(tparams), jax.tree.leaves(jparams),
                                       strict=True)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-9,
                                       err_msg=f"parameter leaf {i} step {step}")
        jleaves = jax.tree.leaves(jstate)
        tleaves = tree_leaves(opt.state)
        assert len(jleaves) == len(tleaves)
        for j, t in zip(jleaves, tleaves):
            assert t.dtype == {np.dtype(np.int32): torch.int32,
                               np.dtype(np.float32): torch.float32}[np.asarray(j).dtype]
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-12)


def _net_conf(global_updater=None, **layer_kw):
    from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType, NeuralNetConfiguration,
                                             OutputLayer)
    b = NeuralNetConfiguration.builder().seed(1)
    if global_updater is not None:
        b.updater(global_updater)
    return (b.list().layer(DenseLayer(n_out=4, activation="tanh", **layer_kw))
            .layer(OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(3)).build())


def test_network_optimizer_follows_layer_transform():
    """Global updater, per-layer override, ``Sgd(0.1)`` when none is set,
    and ``NoOp`` for a frozen layer (JAX ``_layer_transform``)."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    conf = _net_conf(tupd.RmsProp(0.01), updater=tupd.Sgd(0.5))
    conf.layers[1].frozen = True
    net = MultiLayerNetwork(conf, device="cpu").init()
    opt = net._ensure_optimizer()
    assert isinstance(opt.transforms["layer_0"], tupd.Sgd)
    assert opt.transforms["layer_0"].learning_rate == 0.5
    assert isinstance(opt.transforms["layer_1"], tupd.NoOp)
    assert opt.state == {}
    net = MultiLayerNetwork(_net_conf(), device="cpu").init()
    t = net._ensure_optimizer().transforms
    assert all(isinstance(u, tupd.Sgd) and u.learning_rate == 0.1 for u in t.values())


@pytest.mark.parametrize("what", ["Nadam", "AdaGrad", "schedule", "gradient_normalization",
                                  "l2", "l1", "weight_decay", "layer_l2"])
def test_unported_training_options_raise_by_name(what):
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    if what in ("Nadam", "AdaGrad"):
        conf = _net_conf(getattr(tupd, what)(1e-3))
    elif what == "schedule":
        conf = _net_conf(tupd.RmsProp({"@type": "StepSchedule", "initial_value": 0.1}))
    elif what == "layer_l2":
        conf = _net_conf(l2=1e-4)
    else:
        conf = _net_conf()
        if what == "gradient_normalization":
            conf.global_conf.gradient_normalization = "ClipL2PerLayer"
        else:
            setattr(conf.global_conf, what, 1e-4)
    net = MultiLayerNetwork(conf, device="cpu").init()
    x = np.zeros((2, 3), np.float32)
    y = np.eye(2, dtype=np.float32)
    name = {"schedule": "StepSchedule", "layer_l2": "l2"}.get(what, what)
    with pytest.raises(NotImplementedError, match=name):
        net.fit(x, y)


def test_rmsprop_state_leaf_order_matches_jax_opt_state():
    """``updaterState.npz`` order: the JAX net's ``jax.tree.leaves(opt_state)``
    for the 2-layer GravesLSTM char-RNN is each layer's ``nu`` in sorted key
    order (layer_0/{W, W_rec, b, peephole}, layer_1/{...}, layer_2/{W, b})."""
    import jax

    from deeplearning4j_tpu.zoo import TextGenerationLSTM as JText
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM
    jnet = JText(vocab_size=7, hidden=5, graves=True).init()
    net = TextGenerationLSTM(vocab_size=7, hidden=5, graves=True).init(device="cpu")
    jshapes = [tuple(a.shape) for a in jax.tree.leaves(jnet.train_state.opt_state)]
    tleaves = tree_leaves(net.updater_state())
    assert [tuple(t.shape) for t in tleaves] == jshapes
    assert [tuple(t.shape) for t in tree_leaves(net.params())] == jshapes
    assert list(net.updater_state()) == ["layer_0", "layer_1", "layer_2"]
    assert list(net.updater_state()["layer_0"]) == ["W", "W_rec", "b", "peephole"]


def test_global_config_defaults_round_trip_the_updater():
    g = tbase.GlobalConfig(updater=tupd.RmsProp(2e-3, rms_decay=0.9))
    assert tupd.Updater.from_dict(g.updater.to_dict()) == g.updater


def test_adam_state_leaf_order_matches_jax_opt_state_over_nested_params():
    """Adam's ``updaterState.npz`` order over a tree that nests twice
    (``Bert.small(stacked=True)``: ``layer_1/stack/attn/W_q`` ...): per layer
    label in sorted order, the 0-d int32 count, then the mu leaves, then the
    nu leaves, each in sorted nested order — the JAX net's
    ``jax.tree.leaves(opt_state)``."""
    import jax

    from deeplearning4j_tpu.zoo import Bert as JBert
    from deeplearning4j_tpu_torch.zoo import Bert
    for stacked in (False, True):
        jnet = JBert.small(vocab_size=50, stacked=stacked).init()
        net = Bert.small(vocab_size=50, stacked=stacked).init(device="cpu")
        jleaves = jax.tree.leaves(jnet.train_state.opt_state)
        tleaves = tree_leaves(net.updater_state())
        assert [(tuple(a.shape), np.asarray(a).dtype.name) for a in jleaves] == \
            [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tleaves]
        state = net.updater_state()
        assert sorted(state) == sorted(net.params())
        for k, layer in state.items():
            assert list(sorted(layer)) == ["count", "mu", "nu"]
            assert [tuple(t.shape) for t in tree_leaves(layer["mu"])] == \
                [tuple(t.shape) for t in tree_leaves(net.params()[k])]
        if stacked:
            assert tuple(state["layer_1"]["mu"]["stack"]["attn"]["W_q"].shape) == (2, 128, 128)


def test_adam_subclasses_raise_by_name():
    for name in ("AdaMax", "AMSGrad", "Nadam"):
        upd = getattr(tupd, name)(1e-3)
        with pytest.raises(NotImplementedError, match=name):
            upd.init_state({"W": torch.zeros(2)})
        with pytest.raises(NotImplementedError, match=name):
            upd.apply([torch.zeros(2)], [torch.zeros(2)], None)


def test_nesterovs_state_leaf_order_matches_jax_opt_state():
    """Nesterovs' ``updaterState.npz`` order on a graph: per node name in
    sorted order, that node's ``trace`` leaves in sorted parameter order —
    the JAX graph's ``jax.tree.leaves(opt_state)`` (optax ``TraceState``
    under ``multi_transform``); BatchNormalization's gamma/beta are traced,
    its running statistics are not."""
    import jax

    from deeplearning4j_tpu.models.computation_graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn import (BatchNormalization, ConvolutionLayer,
                                       GlobalPoolingLayer, InputType, OutputLayer)
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu.train.updaters import Nesterovs
    from deeplearning4j_tpu_torch.models import (ComputationGraph,
                                                 ComputationGraphConfiguration)
    conf = (NeuralNetConfiguration.builder().seed(3).updater(Nesterovs(0.1, momentum=0.9))
            .graph_builder().add_inputs("in")
            .add_layer("conv", ConvolutionLayer(n_out=4, kernel_size=(1, 1),
                                                activation="identity", has_bias=False), "in")
            .add_layer("bn", BatchNormalization(activation="relu"), "conv")
            .add_layer("pool", GlobalPoolingLayer(pooling_type="avg"), "bn")
            .add_layer("fc", OutputLayer(n_out=3, activation="softmax"), "pool")
            .set_outputs("fc").set_input_types(InputType.convolutional(5, 5, 2)).build())
    jnet = JGraph(conf).init()
    net = ComputationGraph(ComputationGraphConfiguration.from_json(conf.to_json()),
                           device="cpu").init()
    jleaves = jax.tree.leaves(jnet.train_state.opt_state)
    tleaves = tree_leaves(net.updater_state())
    assert [(tuple(a.shape), np.asarray(a).dtype.name) for a in jleaves] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tleaves]
    assert sorted(net.updater_state()) == ["bn", "conv", "fc"]
    assert sorted(net.updater_state()["bn"]) == ["beta", "gamma"]
    assert isinstance(net._ensure_optimizer().transforms["conv"], tupd.Nesterovs)
