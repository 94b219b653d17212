"""Constraints and weight noise in the port against the JAX package.

Each constraint's projection against the JAX package's on the same
weights; a layer's weights and bias through ``apply_layer_constraints``;
the configurations' JSON both ways. Then a small dense
``MultiLayerNetwork`` and ``ComputationGraph`` from one JAX archive, fit 3
steps in both packages with constraints after each update, and with weight
noise: at rate 0 (``WeightNoise(stddev=0)``, ``DropConnect(p=1)``), and
with injected draws (the same fixed mask or normals, by shape, in both
packages: the JAX package's ``jax.random`` draws are replaced inside its
constraints module, the port's ``draw`` methods in its own). The port's own
draws from its generators are held by their statistics.

Float32; weights and losses after 3 steps 1e-6 (1e-5 relative where Adam's
updates of size lr carry last-bit differences).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import constraints as jcons
from deeplearning4j_tpu_torch.models.serializer import tree_leaves
from deeplearning4j_tpu_torch.nn import constraints as tcons
from deeplearning4j_tpu_torch.runtime.environment import get_environment


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


CONSTRAINTS = [
    ("MaxNormConstraint", {"max_norm": 0.5}),
    ("MaxNormConstraint", {"max_norm": 2.0, "axes": None}),
    ("MaxNormConstraint", {"max_norm": 0.3, "axes": [0, 1]}),
    ("MinMaxNormConstraint", {"min_norm": 0.8, "max_norm": 1.2}),
    ("MinMaxNormConstraint", {"min_norm": 0.5, "max_norm": 0.9, "rate": 0.5, "axes": [1]}),
    ("UnitNormConstraint", {}),
    ("UnitNormConstraint", {"axes": [1]}),
    ("NonNegativeConstraint", {}),
]


@pytest.mark.parametrize("name,kw", CONSTRAINTS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CONSTRAINTS)])
def test_constraint_projection_matches_jax(name, kw):
    w = np.random.default_rng(0).normal(0, 0.7, (6, 5)).astype(np.float32)
    w[:, 2] = 0.0  # a zero column: the norms' 1e-12 floor
    want = getattr(jcons, name)(**kw).apply(jnp.asarray(w))
    got = getattr(tcons, name)(**kw).apply(torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    j, t = getattr(jcons, name)(**kw), getattr(tcons, name)(**kw)
    assert tcons.Constraint.from_dict(j.to_dict()).to_dict() == t.to_dict()


def test_apply_layer_constraints_and_config_json_both_ways():
    from deeplearning4j_tpu.nn import DenseLayer as JDense
    from deeplearning4j_tpu.nn.base import Layer as JLayer
    from deeplearning4j_tpu_torch.nn import DenseLayer
    from deeplearning4j_tpu_torch.nn.base import Layer
    jl = JDense(n_out=5, constraints=[jcons.MaxNormConstraint(0.4), jcons.NonNegativeConstraint()],
                bias_constraints=[jcons.UnitNormConstraint()],
                weight_noise=jcons.DropConnect(p=0.8, apply_to_bias=True))
    tl = Layer.from_dict(jl.to_dict())
    assert isinstance(tl, DenseLayer) and tl.to_dict() == jl.to_dict()
    assert [type(c).__name__ for c in tl.constraints] == ["MaxNormConstraint",
                                                          "NonNegativeConstraint"]
    assert isinstance(tl.weight_noise, tcons.DropConnect) and tl.weight_noise.p == 0.8
    assert JLayer.from_dict(tl.to_dict()).to_dict() == jl.to_dict()
    wn = Layer.from_dict(JDense(n_out=2, weight_noise=jcons.WeightNoise(0.1, 1.0, False))
                         .to_dict()).weight_noise
    assert isinstance(wn, tcons.WeightNoise) and (wn.stddev, wn.mean, wn.additive) == \
        (0.1, 1.0, False)
    rng = np.random.default_rng(1)
    p = {"W": rng.normal(0, 1, (4, 5)).astype(np.float32),
         "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    want = jcons.apply_layer_constraints(jl, {k: jnp.asarray(v) for k, v in p.items()})
    got = tcons.apply_layer_constraints(tl, {k: torch.from_numpy(v) for k, v in p.items()})
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------ networks, 3 steps
def _dense_layers(kind, **kw):
    from deeplearning4j_tpu.nn import DenseLayer, OutputLayer
    hidden = {k: v for k, v in kw.items() if k != "out"}
    out = kw.get("out", {})
    return (DenseLayer(n_out=6, activation="tanh", **hidden),
            OutputLayer(n_out=3, activation="softmax", **out))


def _jax_net(kind, updater, **kw):
    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.models.computation_graph import ComputationGraph as JGraph
    from deeplearning4j_tpu.nn import InputType, NeuralNetConfiguration
    dense, out = _dense_layers(kind, **kw)
    b = NeuralNetConfiguration.builder().seed(3).updater(updater)
    if kind == "mln":
        conf = b.list().layer(dense).layer(out).set_input_type(InputType.feed_forward(4)).build()
        return JNet(conf).init()
    g = (b.graph_builder().add_inputs("in").add_layer("dense", dense, "in")
         .add_layer("out", out, "dense").set_outputs("out")
         .set_input_types(InputType.feed_forward(4)).build())
    return JGraph(g).init()


def _batches(n=3, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 1, (8, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]) for _ in range(n)]


def _fit_both(kind, tmp_path, updater=None, **kw):
    from deeplearning4j_tpu.train.updaters import Adam
    from deeplearning4j_tpu_torch.models import ModelSerializer
    jnet = _jax_net(kind, updater or Adam(5e-2), **kw)
    path = str(tmp_path / f"{kind}.zip")
    jnet.save(path)
    net = ModelSerializer.restore_model(path, device="cpu")
    jl, tl = [], []
    for x, y in _batches():
        jnet.fit(x, y)
        net.fit(x, y)
        jl.append(float(jnet.score()))
        tl.append(float(net.score()))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for t, j in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params),
                    strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
    return jnet, net


KINDS = ["mln", "graph"]


@pytest.mark.parametrize("kind", KINDS)
def test_constraints_after_each_update(kind, tmp_path):
    jnet, net = _fit_both(
        kind, tmp_path,
        constraints=[jcons.MaxNormConstraint(0.3)], bias_constraints=[jcons.NonNegativeConstraint()],
        out={"constraints": [jcons.UnitNormConstraint()]})
    key = "layer_0" if kind == "mln" else "dense"
    w = net.params()[key]["W"].numpy()
    assert np.sqrt((w * w).sum(0)).max() <= 0.3 + 1e-6
    assert (net.params()[key]["b"].numpy() >= 0).all()
    out_key = "layer_1" if kind == "mln" else "out"
    np.testing.assert_allclose(np.sqrt((net.params()[out_key]["W"].numpy() ** 2).sum(0)), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("noise", ["weight_noise", "drop_connect"])
def test_weight_noise_at_rate_zero(kind, noise, tmp_path):
    wn = (jcons.WeightNoise(stddev=0.0, apply_to_bias=True) if noise == "weight_noise"
          else jcons.DropConnect(p=1.0, apply_to_bias=True))
    _fit_both(kind, tmp_path, weight_noise=wn, out={"weight_noise": wn})


def _fixed(shape, seed):
    return np.random.default_rng([seed, *shape])


def _fake_mask(shape, p):
    return _fixed(shape, 1).random(shape) < p


def _fake_normal(shape):
    return _fixed(shape, 2).normal(0.0, 1.0, shape).astype(np.float32)


@pytest.fixture
def injected_draws(monkeypatch):
    """The same draws in both packages: a fixed mask or fixed normals by
    shape, replacing ``jax.random`` inside the JAX constraints module and
    the port's ``draw`` methods."""
    shim = types.SimpleNamespace(
        Array=jax.Array,
        random=types.SimpleNamespace(
            fold_in=jax.random.fold_in,
            bernoulli=lambda key, p, shape: jnp.asarray(_fake_mask(tuple(shape), p)),
            normal=lambda key, shape: jnp.asarray(_fake_normal(tuple(shape)))))
    monkeypatch.setattr(jcons, "jax", shim)
    monkeypatch.setattr(tcons.DropConnect, "draw", lambda self, gen, w: torch.from_numpy(
        _fake_mask(tuple(w.shape), self.p)))
    monkeypatch.setattr(tcons.WeightNoise, "draw", lambda self, gen, w: torch.from_numpy(
        _fake_normal(tuple(w.shape))))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("noise", ["additive", "multiplicative", "drop_connect"])
def test_weight_noise_with_injected_draws(kind, noise, injected_draws, tmp_path):
    """Training forwards see the perturbed weights (the output layer's loss
    too) and the gradient flows through the perturbation; inference sees
    the weights."""
    wn = {"additive": jcons.WeightNoise(stddev=0.2),
          "multiplicative": jcons.WeightNoise(stddev=0.1, mean=1.0, additive=False,
                                              apply_to_bias=True),
          "drop_connect": jcons.DropConnect(p=0.7, apply_to_bias=True)}[noise]
    jnet, net = _fit_both(kind, tmp_path, weight_noise=wn, out={"weight_noise": wn})
    x = _batches(1, seed=9)[0][0]
    out = net.output(x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jnet.output(x)), rtol=1e-5, atol=1e-6)


def test_port_draws_by_their_statistics():
    w = torch.full((400, 500), 2.0)
    g = torch.Generator().manual_seed(11)
    dc = tcons.DropConnect(p=0.7)
    out = dc.apply(g, w)
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 2.0 / 0.7))
    noise = tcons.WeightNoise(stddev=0.5).apply(torch.Generator().manual_seed(11), w) - w
    assert abs(float(noise.mean())) < 0.005 and abs(float(noise.std()) - 0.5) < 0.005
    mult = tcons.WeightNoise(stddev=0.1, mean=1.0, additive=False).apply(
        torch.Generator().manual_seed(3), w) / w
    assert abs(float(mult.mean()) - 1.0) < 0.002 and abs(float(mult.std()) - 0.1) < 0.002
    same = tcons.WeightNoise(stddev=0.5).apply(torch.Generator().manual_seed(11), w) - w
    other = tcons.WeightNoise(stddev=0.5).apply(torch.Generator().manual_seed(12), w) - w
    assert torch.equal(noise, same) and not torch.equal(noise, other)


def test_weight_noise_only_in_training(tmp_path):
    """The port's own draws: a fit step moves the weights differently from
    the noiseless net, and the loss of ``score`` (inference) sees no noise;
    DropConnect's gradient is zero where the mask dropped a weight."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.train.updaters import Sgd
    from deeplearning4j_tpu_torch.data import DataSet
    from deeplearning4j_tpu_torch.models import ModelSerializer
    wn = jcons.DropConnect(p=0.5)
    jnet = _jax_net("mln", Sgd(0.1), weight_noise=wn)
    path = str(tmp_path / "noisy.zip")
    jnet.save(path)
    noisy = ModelSerializer.restore_model(path, device="cpu")
    (x, y), = _batches(1)
    before = noisy.params()["layer_0"]["W"].clone()
    assert noisy.score(DataSet(x, y)) == pytest.approx(jnet.score(JDataSet(x, y)), rel=1e-5)
    noisy.fit(x, y)
    moved = noisy.params()["layer_0"]["W"] - before
    assert 0.2 < float((moved == 0).float().mean()) < 0.8  # dropped weights get no gradient
