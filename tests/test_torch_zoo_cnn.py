"""The port's zoo CNNs against the JAX package's on the CPU, at the reduced
sizes ``tests/test_zoo.py`` builds them: SimpleCNN, AlexNet, VGG16, VGG19,
Darknet19, SqueezeNet, Xception, InceptionResNetV1, UNet, TinyYOLO and
YOLO2. For each: the same ``conf()`` JSON and parameter count, the same
output from the weights carried through the JAX archive, and one ``fit``
step's loss and parameters (dropout retained at 1.0 in both packages for
the step, since the two draw different masks). YOLO2's fused pairs are the
seven plain 1x1 convolution + BatchNormalization pairs, and its step runs
them through ``conv_stats``' plain version. The ``Yolo2OutputLayer`` loss
and box decoding on hand-made labels.

Inputs are numpy from a seed. Float32: outputs ``rtol=1e-4, atol=1e-5``;
losses ``rtol=1e-4``. The step's parameter updates: within ``1e-3`` of the
leaf's largest update; under Adam (SimpleCNN, UNet) within twice the
learning rate, and within ``rtol=1e-3`` for 99% of the weights (Adam moves a
weight by about its learning rate whichever its gradient's size, so a
gradient that is rounding noise may step the other way). Each deviation is
taken after four ulps of the weight.

InceptionResNetV1's and YOLO2's first step is not a smooth function of its
inputs at float32's precision: a kink of a leaky ReLU or a max-pool is
crossed by rounding alone, so an additive 1e-5 perturbation of YOLO2's
input moves its float64 update by 52%, and the two packages' float32
updates sit 5-14% from each other and from the float64 step, at batch 2 as
at 8 and 16. Their updates are held in float64 instead: the port's step,
through the same fused pairs and ``conv_stats``' plain version, against
the JAX package's step with x64 on (its BatchNormalization, which takes
its statistics in float32 whatever the input, read at float64), within
``1e-6`` of the leaf's largest update. Their float32 step's loss and layer
state are held against the JAX package's float32 step as for the others.
The Yolo2 loss ``rtol=1e-5``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.conv_layers as jconv
import deeplearning4j_tpu.zoo as jzoo
from deeplearning4j_tpu.models.computation_graph import (
    ComputationGraph as JGraph, ComputationGraphConfiguration as JGraphConf)
from deeplearning4j_tpu.models.multi_layer_network import MultiLayerNetwork as JNet
from deeplearning4j_tpu.runtime.environment import get_environment as jax_environment
from deeplearning4j_tpu.nn import extra_layers as jextra
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JScores
import deeplearning4j_tpu_torch.zoo as tzoo
from deeplearning4j_tpu_torch.models import ModelSerializer
from deeplearning4j_tpu_torch.nn import extra_layers as textra
from deeplearning4j_tpu_torch.nn.base import GlobalConfig
from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.zoo.base import without_dropout
from deeplearning4j_tpu_torch.zoo.yolo2 import synthetic_labels

YOLO2_PAIRS = {n: f"{n}_bn" for n in ("c3b", "c4b", "c5b", "c5d", "c6b", "c6d", "pt_conv")}

# (zoo name, constructor arguments, label kind, Adam learning rate or None,
# whether one float32 step from the initial weights crosses a kink by
# rounding alone, so that its updates are held in float64)
MODELS = [
    ("SimpleCNN", dict(num_classes=5), "class", 1e-3, False),
    ("AlexNet", dict(num_classes=6, height=67, width=67), "class", None, False),
    ("VGG16", dict(num_classes=10, height=32, width=32), "class", None, False),
    ("VGG19", dict(num_classes=10, height=32, width=32), "class", None, False),
    ("Darknet19", dict(num_classes=10, height=64, width=64), "class", None, False),
    ("SqueezeNet", dict(num_classes=10, height=64, width=64), "class", None, False),
    ("Xception", dict(num_classes=7, height=64, width=64, middle_blocks=2), "class", None,
     False),
    ("InceptionResNetV1", dict(num_classes=5, height=96, width=96, blocks_a=1, blocks_b=1,
                               blocks_c=1), "class", None, True),
    ("UNet", dict(height=32, width=32, base_filters=4, depth=2), "mask", 1e-3, False),
    ("TinyYOLO", dict(num_classes=3, height=128, width=128), "yolo", None, False),
    ("YOLO2", dict(num_classes=3, height=128, width=128), "yolo", None, True),
]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The port on the CPU in float32, its convolutions off oneDNN: oneDNN's
    CPU convolution backward carries 2-16% errors into VGG16's ~1e-6
    updates, where the native one matches the JAX package's."""
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _update_dev(updates, reference, before, dtype=np.float32):
    """The largest deviation of ``updates`` from ``reference`` (per-leaf
    parameter updates), relative to the leaf's largest reference update,
    after four ulps of each weight in ``dtype`` (the rounding of the stored
    result, which dominates an update of ~1e-6)."""
    return max(float((np.abs(u - r) - 4 * np.finfo(dtype).eps * np.abs(b)).max()
                     / max(float(np.abs(r).max()), 1e-30))
               for u, r, b in zip(updates, reference, before))


def _updates(after, before):
    return [np.asarray(a, dtype=np.float64) - np.asarray(b, dtype=np.float64)
            for a, b in zip(after, before)]


class _JnpFloat64:
    """``jax.numpy`` with ``float32`` read as ``float64``, for the JAX
    package's convolution layers in a float64 step: its BatchNormalization
    casts its input to float32 for the statistics whatever its dtype."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_float64_step(monkeypatch, conf, graph, params, x, y):
    """The JAX package's first ``fit`` step in float64 from ``params``
    (numpy leaves); returns the new parameters' leaves."""
    env = jax_environment()
    saved = (env.default_dtype, env.compute_dtype)
    with jax.enable_x64(True), monkeypatch.context() as m:
        m.setattr(jconv, "jnp", _JnpFloat64())
        env.default_dtype = env.compute_dtype = jnp.float64
        try:
            net = (JGraph if graph else JNet)(conf).init(
                params=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))
            net.fit(x.astype(np.float64), y.astype(np.float64))
            return [np.asarray(a) for a in jax.tree.leaves(net.train_state.params)]
        finally:
            env.default_dtype, env.compute_dtype = saved


def _labels(kind, rng, b, out_shape, zoo):
    if kind == "class":
        return np.eye(out_shape[-1], dtype=np.float32)[rng.integers(0, out_shape[-1], b)]
    if kind == "mask":
        return (rng.random((b,) + tuple(out_shape[1:])) > 0.5).astype(np.float32)
    return synthetic_labels(rng, b, out_shape[1], out_shape[2], zoo.anchors, zoo.num_classes)


@pytest.mark.parametrize("name,kw,kind,adam_lr,ill", MODELS, ids=[m[0] for m in MODELS])
def test_zoo_model_matches_jax(tmp_path, monkeypatch, name, kw, kind, adam_lr, ill):
    jz, tz = getattr(jzoo, name)(**kw), getattr(tzoo, name)(**kw)
    jconf, tconf = jz.conf(), tz.conf()
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    graph = isinstance(jconf, JGraphConf)
    jconf = without_dropout(jconf)
    jnet = (JGraph if graph else JNet)(jconf).init()
    path = str(tmp_path / f"{name}.zip")
    jnet.save(path)
    net = ModelSerializer.restore_model(path, device="cpu")
    assert net.num_params() == jnet.num_params() == tz.init(device="cpu").num_params()
    if name == "YOLO2":
        assert net.fused_pairs == YOLO2_PAIRS
    rng = np.random.default_rng(len(name))
    x = rng.normal(0, 1, (2, kw.get("height", 48), kw.get("width", 48), 3)).astype(np.float32)
    jout = np.asarray(jnet.output(x))
    _close(net.output(x), jout, "output")
    y = _labels(kind, rng, 2, jout.shape, jz)
    before = [t.numpy().copy() for t in tree_leaves(net.params())]
    initial = jax.tree.map(np.array, jnet.train_state.params)  # fit donates them
    calls = []
    real = cs._apply
    cs._apply = lambda *a: calls.append(1) or real(*a)
    try:
        jnet.set_listeners(js := JScores())
        net.set_listeners(ts := CollectScoresListener())
        jnet.fit(x, y)
        net.fit(x, y)
    finally:
        cs._apply = real
    assert len(calls) == len(getattr(net, "fused_pairs", {}))  # one plain conv_stats a pair
    _close(ts.scores[0][1], js.scores[0][1], "loss of the step", atol=0)
    got = _updates(tree_leaves(net.params()), before)
    want = _updates(jax.tree.leaves(jnet.train_state.params), before)
    if adam_lr is not None:
        # Adam moves each weight by about +-lr; a gradient that is rounding
        # noise may take the other sign
        off = 0
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * adam_lr)
            off += int(np.sum(np.abs(g - w) > 1e-3 * np.abs(w) + 1e-7))
        assert off <= 0.01 * sum(g.size for g in got), off
    elif not ill:
        assert _update_dev(got, want, before) <= 1e-3
    else:
        # the same step in float64 in both packages, the port's through its
        # fused pairs and conv_stats' plain version
        env = get_environment()
        env.set_default_dtype("float64").set_compute_dtype("float64")
        ref = ModelSerializer.restore_model(path, device="cpu")
        ref.set_params({k: {n: t.double() for n, t in v.items()}
                        for k, v in ref.params().items()})
        calls.clear()
        cs._apply = lambda *a: calls.append(1) or real(*a)
        try:
            ref.fit(x.astype(np.float64), y.astype(np.float64))
        finally:
            cs._apply = real
        assert len(calls) == len(getattr(net, "fused_pairs", {}))
        want = _updates(_jax_float64_step(monkeypatch, jconf, graph, initial, x, y), before)
        dev = _update_dev(_updates(tree_leaves(ref.params()), before), want, before, np.float64)
        assert dev <= 1e-6, dev
    for a, b in zip(tree_leaves(net._model_state), jax.tree.leaves(jnet.train_state.model_state)):
        _close(a, b, "layer state after the step", rtol=1e-3, atol=1e-5)


def test_init_pretrained_reads_a_local_archive(tmp_path, monkeypatch):
    """``init_pretrained`` restores ``<name>.zip`` from ``$DL4J_TPU_ZOO_DIR``,
    written by either package, and raises by name without one."""
    monkeypatch.setenv("DL4J_TPU_ZOO_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="DL4J_TPU_ZOO_DIR"):
        tzoo.SimpleCNN(num_classes=4).init_pretrained(device="cpu")
    jnet = jzoo.SimpleCNN(num_classes=4).init()
    jnet.save(str(tmp_path / "simplecnn.zip"))
    net = tzoo.SimpleCNN(num_classes=4).init_pretrained(device="cpu")
    x = np.random.default_rng(0).normal(0, 1, (2, 48, 48, 3)).astype(np.float32)
    _close(net.output(x), jnet.output(x), "pretrained output")
    tnet = tzoo.UNet(height=32, width=32, base_filters=4, depth=2).init(device="cpu")
    tnet.save(str(tmp_path / "unet.zip"))
    back = tzoo.UNet(height=32, width=32, base_filters=4, depth=2).init_pretrained(device="cpu")
    xi = x[:, :32, :32]
    assert torch.equal(back.output(xi), tnet.output(xi))


def test_zoo_exports_the_jax_models():
    assert sorted(tzoo.__all__) == sorted(jzoo.__all__)


def _yolo_pair(**kw):
    j, t = jextra.Yolo2OutputLayer(**kw), textra.Yolo2OutputLayer(**kw)
    t._g = GlobalConfig()
    return j, t


@pytest.mark.parametrize("classes", [0, 4])
def test_yolo2_loss_and_boxes_match_jax(classes):
    anchors = ((1.0, 1.5), (2.0, 0.5), (3.0, 3.0))
    j, t = _yolo_pair(anchors=anchors, n_classes=classes, lambda_coord=4.0, lambda_noobj=0.3)
    rng = np.random.default_rng(classes)
    b, h, w = 3, 4, 5
    x = rng.normal(0, 2, (b, h, w, len(anchors) * (5 + classes))).astype(np.float32)
    lab = synthetic_labels(rng, b, h, w, anchors, max(classes, 1))
    if not classes:
        lab = lab.reshape(b, h, w, len(anchors), 6)[..., :5].reshape(b, h, w, -1)
    want = j.compute_loss({}, jnp.asarray(x), jnp.asarray(lab))
    tx = torch.from_numpy(x).requires_grad_()
    got = t.compute_loss({}, tx, torch.from_numpy(lab))
    _close(got, want, "loss", rtol=1e-5, atol=0)
    jg = jax.grad(lambda v: j.compute_loss({}, v, jnp.asarray(lab)))(jnp.asarray(x))
    got.backward()
    _close(tx.grad, jg, "dloss/dx", rtol=1e-4, atol=1e-6)
    for a, b_ in zip(t.activate_boxes(torch.from_numpy(x)), j.activate_boxes(jnp.asarray(x))):
        _close(a, b_, "activate_boxes", rtol=1e-5, atol=1e-6)
    assert torch.equal(t.activate({}, torch.from_numpy(x)), torch.from_numpy(x))
    # the loss is divided by the batch size only
    double = t.compute_loss({}, torch.cat([torch.from_numpy(x)] * 2),
                            torch.cat([torch.from_numpy(lab)] * 2))
    _close(double, got.detach(), "batch-size normalisation", rtol=1e-6, atol=0)
    # an all-background label: only the no-object term remains
    zero = np.zeros_like(lab)
    logit = x.reshape(b, h, w, len(anchors), -1)[..., 4]
    bce = np.maximum(logit, 0) + np.log1p(np.exp(-np.abs(logit)))
    _close(t.compute_loss({}, torch.from_numpy(x), torch.from_numpy(zero)),
           0.3 * bce.sum() / b, "no-object term", rtol=1e-5, atol=0)


def test_unported_extra_layers_raise_by_name():
    from deeplearning4j_tpu_torch.nn.base import Layer
    with pytest.raises(KeyError, match="ConvLSTM2D"):
        Layer.from_dict({"@type": "ConvLSTM2D"})
