"""The port's updater math against optax, as the JAX package builds it.

Five steps of random gradients (numpy, from a seed) go through
``Updater.make()`` of the JAX package and through the port's
``NetworkOptimizer``; parameters and moments must agree after every step.
Float32: ``rtol=1e-6, atol=1e-9`` — the same float operations in the same
order on both sides, up to the last bit of ``rsqrt``.
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


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _tree(rng, scale=1.0):
    return {k: {n: (rng.normal(0, scale, s)).astype(np.float32) for n, s in v.items()}
            for k, v in SHAPES.items()}


def _torch_tree(tree):
    return {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()} for k, v in tree.items()}


@pytest.mark.parametrize("name,kw", [("RmsProp", {"learning_rate": 1e-2}),
                                     ("RmsProp", {"learning_rate": 1e-3, "rms_decay": 0.9,
                                                  "epsilon": 1e-6}),
                                     ("Sgd", {"learning_rate": 0.1}),
                                     ("NoOp", {})],
                         ids=["rmsprop", "rmsprop_decay_eps", "sgd", "noop"])
def test_updater_matches_optax_over_five_steps(name, kw):
    import jax
    import jax.numpy as jnp
    import optax

    from deeplearning4j_tpu.train import updaters as jupd
    rng = np.random.default_rng(0)
    params = _tree(rng)
    tx = getattr(jupd, name)(**kw).make()
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = _torch_tree(params)
    opt = tupd.NetworkOptimizer({k: getattr(tupd, name)(**kw) for k in SHAPES}, tparams)
    for step in range(5):
        # mixed magnitudes: some |g| << sqrt(eps), where the update is most sensitive
        grads = _tree(rng, scale=10.0 ** -(step % 3 * 2))
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, _torch_tree(grads))
        for k in SHAPES:
            for n in SHAPES[k]:
                np.testing.assert_allclose(tparams[k][n].numpy(), np.asarray(jparams[k][n]),
                                           rtol=1e-6, atol=1e-9, err_msg=f"{k}/{n} step {step}")
        jleaves = jax.tree.leaves(jstate)
        tleaves = tree_leaves(opt.state)
        assert len(jleaves) == len(tleaves)
        for j, t in zip(jleaves, tleaves):
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


@pytest.mark.parametrize("what", ["Adam", "AdaGrad", "schedule", "gradient_normalization",
                                  "l2", "l1", "weight_decay", "layer_l2"])
def test_unported_training_options_raise_by_name(what):
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    if what in ("Adam", "AdaGrad"):
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
