"""The port's updater math against optax, as the JAX package builds it.

Five steps of random gradients (numpy, from a seed) go through
``Updater.make()`` of the JAX package, one transform per layer under
``optax.multi_transform`` as the JAX network builds it, and through the
port's ``NetworkOptimizer`` (for the Adam family, Nesterovs and AdaDelta
over a parameter tree that nests as a transformer block's does); parameters
and optimizer state must agree after every step. Float32: ``rtol=1e-6,
atol=1e-9`` — the same float operations in the same order on both sides, up
to the last bit of ``rsqrt``, ``sqrt``, ``pow`` and of the sums of the
gradient norms. The same holds for learning-rate schedules (values at steps
0-50, and scheduled updaters), the gradient normalizations and the
decoupled weight decay as ``_layer_transform`` chains them, and the l1/l2
penalty against ``_reg_score``.

At the network level, a small dense network under each training option is
built by the JAX package, carried to the port by its archive, and trained
three steps in both: the losses, the weights and the optimizer state agree
(``rtol=1e-5``: the networks' float32 products sum in another order), and
``updaterState.npz`` crosses between the packages both ways.
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

# The chain tests' parameters: an update of size lr (up to 0.1) carries the
# last-bit differences of rsqrt/sqrt/pow and of the norms' sums, a few 1e-9;
# where a parameter passes near 0, rtol alone cannot hold that.
_ULP_ATOL = 1e-7


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
                                     ("Nesterovs", {"learning_rate": 1e-2, "momentum": 0.5}),
                                     ("AdaMax", {"learning_rate": 2e-3}),
                                     ("AMSGrad", {"learning_rate": 1e-3, "beta2": 0.99}),
                                     ("Nadam", {"learning_rate": 1e-3}),
                                     ("AdaGrad", {"learning_rate": 0.05}),
                                     ("AdaDelta", {"rho": 0.9, "epsilon": 1e-6})],
                         ids=["rmsprop", "rmsprop_decay_eps", "sgd", "noop", "adam",
                              "adam_betas_eps", "nesterovs", "nesterovs_lr_momentum",
                              "adamax", "amsgrad", "nadam", "adagrad", "adadelta"])
def test_updater_matches_optax_over_five_steps(name, kw):
    import jax
    import jax.numpy as jnp
    import optax

    from deeplearning4j_tpu.train import updaters as jupd
    shapes = NESTED if name in ("Adam", "Nesterovs", "AMSGrad", "AdaDelta") else SHAPES
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


def _jax_dense_conf(updater, **kw):
    """The JAX package's 3 -> Dense(4, tanh) -> softmax(2) network under
    ``updater`` and the global options ``kw`` (``l1``, ``weight_decay``,
    ``gradient_normalization`` with its threshold, ...); ``layer_kw`` go to
    the dense layer."""
    from deeplearning4j_tpu.nn import (DenseLayer, InputType, NeuralNetConfiguration,
                                       OutputLayer)
    layer_kw = kw.pop("layer_kw", {})
    b = NeuralNetConfiguration.builder().seed(1).updater(updater)
    if "gradient_normalization" in kw:
        b.gradient_normalization(*kw.pop("gradient_normalization"))
    for k, v in kw.items():
        getattr(b, k)(v)
    return (b.list().layer(DenseLayer(n_out=4, activation="tanh", **layer_kw))
            .layer(OutputLayer(n_out=2, activation="softmax"))
            .set_input_type(InputType.feed_forward(3)).build())


def _dense_batches(n=3, seed=4):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (5, 3)).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)]) for _ in range(n)]


def _fit_both(jconf, tmp_path, steps=3):
    """The JAX network of ``jconf`` and the port's from its archive, each
    fit on the same batches one step at a time; returns both nets and both
    loss lists."""
    import jax

    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    jnet = JNet(jconf).init()
    path = str(tmp_path / "init.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    jl, tl = [], []
    for x, y in _dense_batches(steps):
        jnet.fit(x, y)
        jl.append(float(jnet.score()))
        net.fit(x, y)
        tl.append(float(net.score()))
    for t, j in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params),
                    strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    return jnet, net, jl, tl


def _assert_state_matches(net, jnet, rtol=1e-5, atol=1e-6):
    import jax
    jleaves = jax.tree.leaves(jnet.train_state.opt_state)
    tleaves = tree_leaves(net.updater_state())
    assert [(tuple(np.shape(a)), np.asarray(a).dtype.name) for a in jleaves] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tleaves]
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("what", ["Nadam", "AdaGrad", "schedule", "gradient_normalization",
                                  "l2", "l1", "weight_decay", "layer_l2"])
def test_unported_training_options_raise_by_name(what, tmp_path):
    """Each training option that used to raise by name, now held against
    the JAX package: three steps of the network from one archive, the
    losses, weights and optimizer state (a schedule's and a decay's count
    leaves among them)."""
    from deeplearning4j_tpu.train import schedules as jsched
    from deeplearning4j_tpu.train import updaters as jupd
    kw = {"Nadam": {}, "AdaGrad": {}, "schedule": {},
          "gradient_normalization": {"gradient_normalization": ("ClipL2PerLayer", 0.05)},
          "l2": {"l2": 1e-2}, "l1": {"l1": 1e-2}, "weight_decay": {"weight_decay": 1e-2},
          "layer_l2": {"layer_kw": {"l2": 2e-2}}}[what]
    upd = {"Nadam": jupd.Nadam(1e-2), "AdaGrad": jupd.AdaGrad(5e-2),
           "schedule": jupd.RmsProp(jsched.StepSchedule(initial_value=1e-2, decay_rate=0.5,
                                                        step_size=2))}.get(what, jupd.Adam(1e-2))
    jnet, net, jl, tl = _fit_both(_jax_dense_conf(upd, **kw), tmp_path)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_state_matches(net, jnet)
    if what in ("l1", "l2", "layer_l2"):  # the penalty the losses hold
        want = float(jnet._reg_score(jnet.train_state.params))
        got = tupd.reg_score([(f"layer_{i}", l) for i, l in enumerate(net.layers)],
                             net.params(), net.conf.global_conf)
        assert want > 0.0
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("name", ["AdaMax", "AMSGrad", "Nadam", "AdaGrad", "AdaDelta"])
def test_new_updater_state_crosses_archives_both_ways(name, tmp_path):
    """``updaterState.npz`` of each newly ported updater: a JAX net trained
    two steps resumes in the port, whose state leaves are the JAX
    ``opt_state`` leaves (order, shapes, dtypes, values); both take a third
    step alike; the port's archive restores into the JAX package with the
    port's state."""
    import jax

    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.train import updaters as jupd
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    jnet = JNet(_jax_dense_conf(getattr(jupd, name)(1e-2))).init()
    (x0, y0), (x1, y1), (x2, y2) = _dense_batches()
    jnet.fit(x0, y0)
    jnet.fit(x1, y1)
    path = str(tmp_path / "two.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    net._ensure_optimizer()
    _assert_state_matches(net, jnet, rtol=0, atol=0)
    jnet.fit(x2, y2)
    net.fit(x2, y2)
    np.testing.assert_allclose(float(net.score()), float(jnet.score()), rtol=1e-5)
    _assert_state_matches(net, jnet)
    back = str(tmp_path / "port.zip")
    net.save(back)
    jback = JNet.load(back)
    for j, t in zip(jax.tree.leaves(jback.train_state.opt_state),
                    tree_leaves(net.updater_state()), strict=True):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


_SCHEDULES = [("StepSchedule", {"initial_value": 0.1, "decay_rate": 0.5, "step_size": 7}),
              ("ExponentialSchedule", {"initial_value": 0.1, "gamma": 0.93}),
              ("InverseSchedule", {"initial_value": 0.1, "gamma": 0.07, "power": 1.5}),
              ("PolySchedule", {"initial_value": 0.1, "power": 2.0, "max_iter": 40}),
              ("SigmoidSchedule", {"initial_value": 0.1, "gamma": 0.3, "step_size": 20}),
              ("MapSchedule", {"initial_value": 0.1, "values": {5: 0.05, 17: 0.01, 30: 0.3}}),
              ("CycleSchedule", {"initial_value": 0.01, "max_value": 0.1, "cycle_length": 31,
                                 "annealing_length": 9, "annealing_decay": 0.2})]


@pytest.mark.parametrize("name,kw", _SCHEDULES, ids=[n for n, _ in _SCHEDULES])
def test_schedule_values_match_jax(name, kw):
    """``value_at`` at steps 0-50 (an int32 count, as optax passes it):
    float32 values within the last bits of ``pow``/``exp``; the JSON is the
    JAX package's and builds the same schedule in either package."""
    import json

    import jax.numpy as jnp

    from deeplearning4j_tpu.train import schedules as jsched
    from deeplearning4j_tpu_torch.train import schedules as tsched
    js, ts = getattr(jsched, name)(**kw), getattr(tsched, name)(**kw)
    for step in range(51):
        want = js.value_at(jnp.asarray(step, jnp.int32))
        got = ts.value_at(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   err_msg=f"step {step}")
        assert float(ts.value_at(step)) == float(got)
    d = json.loads(json.dumps(js.to_dict()))
    assert json.loads(json.dumps(ts.to_dict())) == d
    assert tsched.Schedule.from_dict(d) == ts
    assert jsched.Schedule.from_dict(json.loads(json.dumps(ts.to_dict()))) == js


@pytest.mark.parametrize("name,sched", [("Adam", ("StepSchedule", {"initial_value": 1e-2,
                                                                   "decay_rate": 0.5,
                                                                   "step_size": 2})),
                                        ("Sgd", ("ExponentialSchedule", {"initial_value": 0.1,
                                                                         "gamma": 0.8})),
                                        ("RmsProp", ("MapSchedule", {"initial_value": 1e-2,
                                                                     "values": {3: 1e-3}})),
                                        ("Nesterovs", ("CycleSchedule", {
                                            "initial_value": 1e-2, "max_value": 0.1,
                                            "cycle_length": 4, "annealing_length": 2}))],
                         ids=["adam_step", "sgd_exponential", "rmsprop_map",
                              "nesterovs_cycle"])
def test_scheduled_updater_matches_optax(name, sched):
    """Five steps under a schedule: optax's ``scale_by_schedule`` reads its
    own int32 count (a state leaf after the updater's) before stepping it;
    the parameters and every state leaf agree."""
    import jax
    import jax.numpy as jnp
    import optax

    from deeplearning4j_tpu.train import schedules as jsched
    from deeplearning4j_tpu.train import updaters as jupd
    from deeplearning4j_tpu_torch.train import schedules as tsched
    rng = np.random.default_rng(1)
    params = _tree(rng)
    tx = _jax_multi_transform(
        lambda: getattr(jupd, name)(getattr(jsched, sched[0])(**sched[1])).make(), SHAPES)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = _torch_tree(params)
    opt = tupd.NetworkOptimizer(
        {k: getattr(tupd, name)(getattr(tsched, sched[0])(**sched[1])) for k in SHAPES},
        tparams)
    for step in range(5):
        grads = _tree(rng, scale=10.0 ** -(step % 2))
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, _torch_tree(grads))
        for t, j in zip(tree_leaves(tparams), jax.tree.leaves(jparams), strict=True):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=_ULP_ATOL,
                                       err_msg=f"step {step}")
        jleaves, tleaves = jax.tree.leaves(jstate), tree_leaves(opt.state)
        assert [np.asarray(j).dtype.name for j in jleaves] == \
            [str(t.dtype).replace("torch.", "") for t in tleaves]
        for j, t in zip(jleaves, tleaves, strict=True):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-12)
    assert int(tleaves[-1]) == 5  # the schedule's count, last of the last layer's


def _chain_parity(make_jax_chain, make_port_opt, steps=4, scales=(1.0, 30.0, 1e-3, 3.0)):
    """Drive a JAX per-layer chain and the port's optimizer on the same
    gradients; parameters and state agree after every step."""
    import jax
    import jax.numpy as jnp
    import optax
    rng = np.random.default_rng(2)
    params = _tree(rng)
    jparams = jax.tree.map(jnp.asarray, params)
    labels = {k: jax.tree.map(lambda _, k=k: k, v) for k, v in params.items()}
    tx = optax.multi_transform({k: make_jax_chain(k) for k in SHAPES}, labels)
    jstate = tx.init(jparams)
    tparams = _torch_tree(params)
    opt = make_port_opt(tparams)
    for step in range(steps):
        grads = _tree(rng, scale=scales[step % len(scales)])
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, _torch_tree(grads))
        for i, (t, j) in enumerate(zip(tree_leaves(tparams), jax.tree.leaves(jparams),
                                       strict=True)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=_ULP_ATOL,
                                       err_msg=f"leaf {i} step {step}")
        jleaves, tleaves = jax.tree.leaves(jstate), tree_leaves(opt.state)
        assert len(jleaves) == len(tleaves)
        for j, t in zip(jleaves, tleaves):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-12)
    return opt


@pytest.mark.parametrize("kind,threshold", [("ClipElementWiseAbsoluteValue", 0.5),
                                            ("ClipL2PerLayer", 2.0),
                                            ("ClipL2PerParamType", 0.7),
                                            ("RenormalizeL2PerLayer", 1.0),
                                            ("RenormalizeL2PerParamType", 1.0),
                                            ("ClipGlobalNorm", 3.0)])
def test_gradient_normalization_matches_jax(kind, threshold):
    """Each gradient normalization before ``Sgd(0.1)``, as
    ``_layer_transform`` chains it: per-leaf norms for the per-layer and
    per-param-type kinds (a leaf is a parameter type), the layer's joint norm
    for ``ClipGlobalNorm``; gradients scaled so that some steps clip and
    some do not."""
    import optax

    from deeplearning4j_tpu.train import updaters as jupd
    _chain_parity(
        lambda k: optax.chain(jupd.gradient_normalization_transform(kind, threshold),
                              jupd.Sgd(0.1).make()),
        lambda tp: tupd.NetworkOptimizer({k: tupd.Sgd(0.1) for k in SHAPES}, tp,
                                         normalization={k: (kind, threshold) for k in SHAPES}))
    with pytest.raises(ValueError, match="Bogus"):
        tupd.normalize_gradients("Bogus", 1.0, [torch.ones(2)])


@pytest.mark.parametrize("updater", ["Adam", "Sgd_schedule", "NoOp"])
def test_decoupled_weight_decay_matches_jax(updater):
    """The decay after the updater (``-lr_t * wd * p``) on the regularizable
    leaves only (W and W_rec here; b and peephole keep their updater's
    step), with its own int32 count after the updater's state; a schedule's
    value at that count."""
    import optax

    from deeplearning4j_tpu.models.multi_layer_network import _mask_keys
    from deeplearning4j_tpu.nn.base import Layer as JLayer
    from deeplearning4j_tpu.train import schedules as jsched
    from deeplearning4j_tpu.train import updaters as jupd
    from deeplearning4j_tpu_torch.train import schedules as tsched
    wd, keys = 0.05, set(JLayer().regularizable_params())
    make = {"Adam": (lambda m: m.Adam(1e-2)),
            "Sgd_schedule": (lambda m: m.Sgd((jsched if m is jupd else tsched).StepSchedule(
                initial_value=0.1, decay_rate=0.5, step_size=2))),
            "NoOp": (lambda m: m.NoOp(1e-2))}[updater]

    def jax_chain(k):
        u = make(jupd)
        return optax.chain(u.make(), jupd.decoupled_weight_decay(
            wd, u._lr(), mask=lambda p: _mask_keys(p, keys)))

    def port_opt(tp):
        ups = {k: make(tupd) for k in SHAPES}
        return tupd.NetworkOptimizer(ups, tp, decay={
            k: tupd.WeightDecay(wd, u._lr(), tupd.regularizable_mask(tbase.Layer(), tp[k]))
            for k, u in ups.items()})

    opt = _chain_parity(jax_chain, port_opt)
    assert tupd.regularizable_mask(tbase.Layer(), _torch_tree(_tree(
        np.random.default_rng(0), shapes=SHAPES["layer_0"]))) == \
        [True, True, False, False]  # W, W_rec, b, peephole
    assert int(tree_leaves(opt.state)[-1]) == 4


def test_reg_score_matches_jax():
    """The l1/l2 penalty of a network whose layers set their own l1/l2 or
    inherit the global ones, over the regularizable leaves only, against
    the JAX network's ``_reg_score`` on the same parameters."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.train import updaters as jupd
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serializer import params_from_numpy
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    jconf = _jax_dense_conf(jupd.Sgd(0.1), l1=3e-3, l2=2e-2, layer_kw={"l2": 0.5, "l1": 0.0})
    jnet = JNet(jconf).init()
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                            device="cpu").init()
    params = {k: {n: np.asarray(a) for n, a in v.items()}
              for k, v in jnet.train_state.params.items()}
    tparams = params_from_numpy(params)
    got = tupd.reg_score([(f"layer_{i}", l) for i, l in enumerate(net.layers)], tparams,
                         net.conf.global_conf)
    want = jnet._reg_score({k: {n: jnp.asarray(a) for n, a in v.items()}
                            for k, v in params.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    w0, w1 = params["layer_0"]["W"], params["layer_1"]["W"]
    np.testing.assert_allclose(float(got), 0.25 * (w0 * w0).sum() + 3e-3 * np.abs(w1).sum()
                               + 1e-2 * (w1 * w1).sum(), rtol=1e-5)
    plain = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _jax_dense_conf(jupd.Sgd(0.1)).to_json()), device="cpu").init()
    assert tupd.reg_score([(f"layer_{i}", l) for i, l in enumerate(plain.layers)], tparams,
                          plain.conf.global_conf) is None


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
    """AdaMax, AMSGrad and Nadam, once refused by name, against optax on a
    nested tree: the initial state leaves (AMSGrad's ``nu_max`` after
    ``count``, ``mu`` and ``nu``) and one step's updates."""
    import jax
    import jax.numpy as jnp

    from deeplearning4j_tpu.train import updaters as jupd
    rng = np.random.default_rng(5)
    params, grads = _tree(rng, shapes=NESTED["layer_0"]), _tree(rng, shapes=NESTED["layer_0"])
    for name in ("AdaMax", "AMSGrad", "Nadam"):
        tx = getattr(jupd, name)(1e-3).make()
        jstate = tx.init(jax.tree.map(jnp.asarray, params))
        upd = getattr(tupd, name)(1e-3)
        state = upd.init_state(_torch_tree(params))
        assert [tuple(np.shape(a)) for a in jax.tree.leaves(jstate)] == \
            [tuple(t.shape) for t in tree_leaves(state)]
        want, _ = tx.update(jax.tree.map(jnp.asarray, grads), jstate)
        got = upd.update(tree_leaves(_torch_tree(grads)), state,
                         tree_leaves(_torch_tree(params)))
        for t, j in zip(got, jax.tree.leaves(want), strict=True):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-12)


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
