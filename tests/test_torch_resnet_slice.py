"""ResNet-50 from the port against the JAX package on the CPU, at full depth
and a small size (64x64 images, 10 classes, batch 4): a JAX archive loaded
into the port, its output, three Nesterovs ``fit`` steps, the fused 1x1
convolution + BatchNormalization pairs against the same net unfused, the
archive both ways and ``ModelRegistry`` serving.

Set-up: the JAX net's BatchNormalization running statistics are set to one
calibration batch's statistics (computed by the port, written into both
packages), so inference normalizes as training does and the softmax is not
saturated; at its initial (0, 1) statistics the output is one-hot in both
packages and a comparison would show nothing.

Tolerances, float32. Output probabilities ``atol=1e-4`` (53 normalizations
deep). Fit: ResNet-50's initial gradient has a norm near 1e3, so the loss
moves by about ``lr * |g|^2`` a step: the test steps at ``lr=1e-7``, where
three steps move the loss by ~25% and stay in the region where first-order
differences between the packages do not blow up; losses ``rtol=1e-3``
(the JAX package's own fp32 error against float64 is ~1e-4 in this
network, ten times the port's: its single-pass batch sums lose more), the
running statistics ``rtol=1e-3, atol=1e-3``. Fused against unfused, both in
the port: in float64 losses, weights, running statistics and traces
``rtol=1e-8``; in float32 the losses ``rtol=1e-3``.
"""

import dataclasses
import json
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.train.updaters import Nesterovs as JNesterovs
from deeplearning4j_tpu.zoo import ResNet50 as JResNet50
from deeplearning4j_tpu_torch.models import ComputationGraph, ModelSerializer
from deeplearning4j_tpu_torch.models.serializer import tree_leaves
from deeplearning4j_tpu_torch.ops.kernels import conv_stats as cs
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import ModelRegistry
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo import ResNet50

S, B, CLASSES, LR = 64, 4, 10, 1e-7


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _batch(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, S, S, 3)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, B)]
    return x, y


@pytest.fixture(scope="module")
def jax_net(tmp_path_factory):
    """A JAX ResNet-50 whose running statistics are one calibration batch's,
    its archive, and a copy of its train state (``fit`` donates the one it
    steps): ``(jnet, path, state)``. The tests share the net, and so its
    compiled programs."""
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    try:
        d = tmp_path_factory.mktemp("resnet")
        jnet = JResNet50(num_classes=CLASSES, height=S, width=S,
                         updater=JNesterovs(LR, momentum=0.9)).init()
        jnet.save(str(d / "init.zip"))
        net = ModelSerializer.restore_model(str(d / "init.zip"), device="cpu")
        with torch.no_grad():
            acts = net._forward_all(net._params, net._model_state,
                                    {"input": torch.from_numpy(_batch(0)[0])},
                                    training=True)[0]
        stats = {}
        for name in net._model_state:
            a = acts[net.conf.node(name).inputs[0]].double()
            stats[name] = {"mean": np.asarray(a.mean((0, 1, 2)), np.float32),
                           "var": np.asarray(a.var((0, 1, 2), unbiased=False), np.float32)}
        jnet.train_state = dataclasses.replace(
            jnet.train_state, model_state=jax.tree.map(jnp.asarray, stats))
        path = str(d / "calibrated.zip")
        jnet.save(path)
        return jnet, path, jax.tree.map(jnp.copy, jnet.train_state)
    finally:
        env.device, env.default_dtype, env.compute_dtype = saved


@pytest.fixture
def archive(jax_net):
    return jax_net[1]


@pytest.fixture
def fresh_jax_net(jax_net):
    """The shared JAX net, back at its calibrated state."""
    jnet, _, state = jax_net
    jnet.train_state = jax.tree.map(jnp.copy, state)
    return jnet


def test_config_and_node_names_match_jax():
    jconf = JResNet50(num_classes=CLASSES, height=S, width=S).conf()
    tconf = ResNet50(num_classes=CLASSES, height=S, width=S).conf()
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    assert tconf.topo_order == jconf.topo_order
    net = ComputationGraph(tconf, device="cpu").init()
    assert net.num_params() == 23528522  # 23.5M at 10 classes (25.6M at 1000)
    blocks = [f"s{s}b{b}" for s, n in enumerate((3, 4, 6, 3)) for b in range(n)]
    want = {f"{blk}_c{i}": f"{blk}_b{i}" for blk in blocks for i in (1, 3)}
    want.update({f"s{s}b0_sc": f"s{s}b0_sb" for s in range(4)})
    pairs = net.fused_pairs
    assert pairs == want and len(pairs) == 36
    strided = [c for c in pairs if net.conf.node(c).obj._geom()[1] == (2, 2)]
    assert sorted(strided) == [f"s{s}b0_{k}" for s in (1, 2, 3) for k in ("c1", "sc")]


def test_jax_archive_output(archive, fresh_jax_net):
    jnet = fresh_jax_net
    net = ModelSerializer.restore_model(archive, device="cpu")
    assert isinstance(net, ComputationGraph)
    x, _ = _batch(1)
    out = net.output(x)
    want = np.asarray(jnet.output(x))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-4)
    assert float(out.max()) < 0.999  # not saturated: the comparison means something


def test_three_nesterovs_steps_match_jax(archive, fresh_jax_net):
    """Losses, running statistics (BatchNormalization's state, carried out
    of fit) and the fused path's launches of conv_stats' plain version: 36 a
    step."""
    jnet = fresh_jax_net
    net = ModelSerializer.restore_model(archive, device="cpu")
    assert isinstance(net.conf.global_conf.updater, Nesterovs)
    calls = []
    real = cs.conv_stats_reference

    def counting(*a):
        calls.append(tuple(a[0].shape))
        return real(*a)

    cs.conv_stats_reference = counting
    x, y = _batch(2)
    jl, tl = [], []
    try:
        for _ in range(3):
            jnet.fit(x, y)
            net.fit(x, y)
            jl.append(float(jnet.score()))
            tl.append(float(net.score()))
    finally:
        cs.conv_stats_reference = real
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[2] < 0.9 * tl[0]  # the loss moved
    assert len(calls) == 36 * 3
    assert (B * (S // 4) ** 2, 64) in calls  # stage 0: s0b0_c1 on the pooled stem
    js = jnet.train_state.model_state
    for name, st in net._model_state.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(js[name][k]), rtol=1e-3,
                                       atol=1e-3, err_msg=f"{name} {k}")
    moved = net._model_state["s1b0_b1"]["mean"] - ModelSerializer.restore_model(
        archive, device="cpu")._model_state["s1b0_b1"]["mean"]
    assert float(moved.abs().max()) > 1e-3


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fused_pairs_match_the_unfused_net(archive, dtype):
    """Three steps of the same net with its 36 pairs fused and unfused. In
    float64 the two compute one function to rounding; in float32 the
    normalizations amplify the sums' order through 53 layers, and the
    losses are held to ``rtol=1e-3``."""
    get_environment().set_default_dtype(dtype).set_compute_dtype(dtype)
    nets = [ModelSerializer.restore_model(archive, device="cpu") for _ in range(2)]
    nets[1]._fused = {}
    losses = [[], []]
    for step in range(3):
        x, y = _batch(3 + step)
        for net, ls in zip(nets, losses):
            net.fit(x, y)
            ls.append(float(net.score()))
    if dtype == "float32":
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-3)
        return
    tol = dict(rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(losses[0], losses[1], **tol)
    for part in ("params", "_model_state", "updater_state"):
        a, b = (getattr(n, part) for n in nets)
        a, b = (a() if callable(a) else a), (b() if callable(b) else b)
        for u, v in zip(tree_leaves(a), tree_leaves(b), strict=True):
            assert u.dtype == torch.float64
            np.testing.assert_allclose(u.numpy(), v.numpy(), err_msg=part, **tol)


def test_archive_both_ways_and_registry_serving(archive, fresh_jax_net, tmp_path):
    """The port's archive after a step (with updaterState.npz) restores in
    the port and in the JAX package; ModelRegistry serves it to threads,
    each answer the net's own output for its rows."""
    net = ModelSerializer.restore_model(archive, device="cpu")
    x, y = _batch(6)
    net.fit(x, y)
    path = str(tmp_path / "port.zip")
    net.save(path)
    with zipfile.ZipFile(path) as zf:
        assert json.loads(zf.read("metadata.json"))["model_type"] == "ComputationGraph"
        assert "updaterState.npz" in zf.namelist()
    back = ComputationGraph.load(path, device="cpu")
    assert torch.equal(back.output(x), net.output(x))
    for a, b in zip(tree_leaves(back.updater_state()), tree_leaves(net.updater_state())):
        assert torch.equal(a, b)
    jnet = fresh_jax_net  # the JAX package's restore, into the shared net
    with zipfile.ZipFile(path) as zf:
        JSerializer._restore_state(zf, jnet, load_updater=True)
    np.testing.assert_allclose(np.asarray(jnet.output(x)), net.output(x).numpy(), atol=1e-4)
    jleaves = jax.tree.leaves(jnet.train_state.opt_state)
    for a, b in zip(tree_leaves(net.updater_state()), jleaves, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    reg = ModelRegistry()
    try:
        reg.load("resnet", path, device="cpu", max_batch_size=4)
        xs = [_batch(10 + i)[0][: 1 + i % 3] for i in range(6)]
        answers = [None] * len(xs)

        def client(i):
            answers[i] = reg.predict("resnet", xs[i])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for xi, got in zip(xs, answers):
            np.testing.assert_allclose(got, back.output(xi).numpy(), atol=1e-5)
    finally:
        reg.shutdown()
