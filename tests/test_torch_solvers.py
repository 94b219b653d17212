"""The port's line-search solvers against the JAX package's, on the CPU.

LBFGS, CONJUGATE_GRADIENT and LINE_GRADIENT_DESCENT fit a small
``MultiLayerNetwork`` (dense tanh, dense relu, softmax output) and a small
``ComputationGraph`` (two dense branches merged, softmax output) for two
batches in both packages, from one JAX archive and the same numpy batches.
The JAX package's ``solver_fit_batch`` runs with its ``lax.scan`` wrapped
(inside ``train/solvers.py``) to hand its outputs to the host through
``jax.debug.callback``, so its per-iteration values can be held against
the port's ``_solver_log``:

- float64 (the JAX package under ``jax.enable_x64(True)``, the port's
  parameters and compute dtype float64): every per-iteration value within
  1e-9 relative, the parameters after each batch within 1e-9 (relative to
  the leaf's largest entry), the final losses within 1e-9 relative;
- float32 (the port's parameters and compute dtype): per-iteration values
  and final losses within 1e-4 relative of that float64 run (one JAX run
  per network and algorithm serves both cases).

Also: a frozen layer does not move and the BatchNormalization running
statistics move as JAX's do (JAX ``test_solvers_external.py:94``, float32
within 1e-4); tBPTT with a solver raises in both networks (JAX
``test_smoke.py:209``); the step counter advances once per batch and
listeners see one score per batch; an LSTM network runs its recurrent
layer once per evaluation; the solver log keeps the last 16 batches; and
the line search alone against optax's on a
float64 objective, through its zoom, its interval growth, its safe step
and an ascent direction (steps and values within 1e-12).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.train.solvers as jsolvers
from deeplearning4j_tpu.models import ComputationGraph as JGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.nn import (BatchNormalization as JBatchNorm, DenseLayer as JDense,
                                   InputType as JInputType, OutputLayer as JOutput)
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.runtime.environment import get_environment as jax_environment
from deeplearning4j_tpu_torch.models import ModelSerializer
from deeplearning4j_tpu_torch.models import ComputationGraph, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import LSTM, InputType, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener

ALGOS = ("LBFGS", "CONJUGATE_GRADIENT", "LINE_GRADIENT_DESCENT")
B, N_IN, N_OUT = 24, 6, 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _conf(kind, algo):
    b = JConf.builder().seed(0).optimization_algo(algo).max_num_line_search_iterations(5) \
        .solver_iterations(4)
    if kind == "mln":
        return (b.list().layer(JDense(n_out=10, activation="tanh"))
                .layer(JDense(n_out=8, activation="relu"))
                .layer(JOutput(n_out=N_OUT, activation="identity", loss="MSE"))
                .set_input_type(JInputType.feed_forward(N_IN)).build())
    g = b.graph_builder().add_inputs("in")
    g.add_layer("a", JDense(n_out=8, activation="tanh"), "in")
    g.add_layer("b", JDense(n_out=5, activation="sigmoid"), "in")
    g.add_vertex("m", _merge(), "a", "b")
    g.add_layer("out", JOutput(n_out=N_OUT, activation="softmax"), "m")
    return g.set_outputs("out").set_input_types(JInputType.feed_forward(N_IN)).build()


def _merge():
    from deeplearning4j_tpu.nn.graph_vertices import MergeVertex
    return MergeVertex()


def _batches(kind, n=2):
    """Classes for the graph; for the network's regression, targets far
    from its outputs, so that the first steps overshoot and the line
    search zooms."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        x = rng.normal(0, 1, (B, N_IN)).astype(np.float32)
        y = (rng.normal(0, 3, (B, N_OUT)).astype(np.float32) if kind == "mln" else
             np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, B)])
        out.append((x, y))
    return out


class _Recording:
    """``jax`` as ``train/solvers.py`` sees it, its ``lax.scan`` handing the
    per-iteration outputs to the host (``jax.debug.callback``) each time the
    compiled solver runs."""

    def __init__(self, record):
        real_scan = jax.lax.scan

        def scan(f, init, xs, length=None):
            carry, ys = real_scan(f, init, xs, length=length)
            # as bits: the callback's thread would read float64 as float32
            dt = np.dtype(ys.dtype)
            jax.debug.callback(lambda v: record.append(np.asarray(v).view(dt).reshape(-1)),
                               jax.lax.bitcast_convert_type(ys, jnp.uint32))
            return carry, ys

        self.lax = types.SimpleNamespace(scan=scan)

    def __getattr__(self, name):
        return getattr(jax, name)


@contextlib.contextmanager
def _jax_float64():
    env = jax_environment()
    saved = (env.default_dtype, env.compute_dtype)
    with jax.enable_x64(True):
        env.default_dtype = env.compute_dtype = jnp.float64
        try:
            yield
        finally:
            env.default_dtype, env.compute_dtype = saved


def _jax_reference(kind, algo, workdir):
    """The JAX package's float64 fit over ``_batches(kind)`` (one ``fit``
    call a batch) from a fresh init: ``(archive of the init, per-batch
    per-iteration values, parameters after each batch, final score)``;
    one run serves the float64 and the float32 cases."""
    record = []
    saved = jsolvers.jax
    jsolvers.jax = _Recording(record)
    try:
        jnet = (JNet if kind == "mln" else JGraph)(_conf(kind, algo)).init()
        path = str(workdir / f"{kind}.zip")
        jnet.save(path)
        init = jax.tree.map(np.asarray, jnet.train_state.params)
        params_after = []
        with _jax_float64():
            net = (JNet if kind == "mln" else JGraph)(_conf(kind, algo)).init(
                params=jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), init))
            for x, y in _batches(kind):
                net.fit(x.astype(np.float64), y.astype(np.float64))
                params_after.append([np.asarray(a)
                                     for a in jax.tree.leaves(net.train_state.params)])
            final = float(net.score())
    finally:
        jsolvers.jax = saved
    return path, record, params_after, final


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """``_jax_reference`` once per network and algorithm in this module."""
    cache = {}

    def get(kind, algo):
        if (kind, algo) not in cache:
            cache[kind, algo] = _jax_reference(kind, algo, tmp_path_factory.mktemp("solvers"))
        return cache[kind, algo]
    return get


def _port_net(path, f64):
    if f64:
        get_environment().set_default_dtype("float64").set_compute_dtype("float64")
    net = ModelSerializer.restore_model(path, device="cpu")
    if f64:
        net.set_params({k: {n: t.double() for n, t in v.items()}
                        for k, v in net.params().items()})
    return net


@pytest.mark.parametrize("f64", [True, False], ids=["float64", "float32"])
@pytest.mark.parametrize("kind", ["mln", "graph"])
@pytest.mark.parametrize("algo", ALGOS)
def test_solver_matches_jax(algo, kind, f64, jax_reference):
    path, jrec, jparams, jfinal = jax_reference(kind, algo)
    net = _port_net(path, f64)
    assert type(net).__name__ == ("MultiLayerNetwork" if kind == "mln" else "ComputationGraph")
    dt = np.float64 if f64 else np.float32
    scores = CollectScoresListener()
    net.set_listeners(scores)
    port_params = []
    for x, y in _batches(kind):
        net.fit(x.astype(dt), y.astype(dt))
        port_params.append([t.numpy().copy() for t in tree_leaves(net.params())])
    log = net._solver_log
    assert len(log) == len(jrec) == 2
    assert [s[0] for s in scores.scores] == [1, 2]  # one score a batch
    rtol = 1e-9 if f64 else 1e-4
    for rec, ys in zip(log, jrec):
        assert rec["algorithm"] == algo and len(rec["values"]) == len(ys) == 4
        # each iteration evaluates once, plus its line search's steps
        assert rec["evaluations"] >= 2 * len(ys)
        np.testing.assert_allclose(rec["values"], ys, rtol=rtol, atol=0)
    assert log[1]["values"][-1] < log[0]["values"][0]  # the loss falls
    for mine, theirs in zip(port_params, jparams):
        for a, b in zip(mine, theirs):
            dev = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert dev <= (1e-9 if f64 else 1e-3), dev
    np.testing.assert_allclose(net.score(), jfinal, rtol=rtol)


def test_frozen_layer_and_batchnorm_state_as_jax(tmp_path, monkeypatch):
    """LBFGS on a frozen dense layer and a BatchNormalization: the frozen
    weights stay bit for bit, the running statistics move, both as the JAX
    package's (float32, 1e-4)."""
    x = np.random.default_rng(0).normal(2.0, 3.0, (64, N_IN)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[np.random.default_rng(1).integers(0, N_OUT, 64)]
    frozen = JDense(n_out=16, activation="tanh")
    frozen.frozen = True
    conf = (JConf.builder().seed(0).optimization_algo("LBFGS").solver_iterations(4).list()
            .layer(frozen).layer(JBatchNorm())
            .layer(JOutput(n_out=N_OUT, activation="softmax"))
            .set_input_type(JInputType.feed_forward(N_IN)).build())
    jnet = JNet(conf).init()
    path = str(tmp_path / "bn.zip")
    jnet.save(path)
    net = ModelSerializer.restore_model(path, device="cpu")
    w0 = net.params()["layer_0"]["W"].clone()
    mean0 = net._model_state["layer_1"]["mean"].clone()
    net.fit(x, y)
    jnet.fit(x, y)
    assert torch.equal(net.params()["layer_0"]["W"], w0)
    np.testing.assert_array_equal(np.asarray(jnet.train_state.params["layer_0"]["W"]),
                                  w0.numpy())
    assert not torch.allclose(net._model_state["layer_1"]["mean"], mean0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(net._model_state["layer_1"][k].numpy(),
                                   np.asarray(jnet.train_state.model_state["layer_1"][k]),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(net.score(), float(jnet.score()), rtol=1e-4)


def test_recurrent_line_gradient_descent_evaluations():
    """LINE_GRADIENT_DESCENT on a small LSTM char-RNN (full-sequence BPTT):
    one forward of the recurrent layer per value-and-gradient evaluation
    and one for the final forward, and the loss falls."""
    conf = (NeuralNetConfiguration.builder().seed(3).optimization_algo("LINE_GRADIENT_DESCENT")
            .solver_iterations(3).list()
            .layer(LSTM(n_in=5, n_out=8))
            .layer(RnnOutputLayer(n_out=N_OUT, activation="softmax"))
            .set_input_type(InputType.recurrent(5)).build())
    x = np.random.default_rng(0).normal(0, 1, (4, 6, 5)).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[np.random.default_rng(1).integers(0, N_OUT, (4, 6))]
    net = MultiLayerNetwork(conf, device="cpu").init()
    from deeplearning4j_tpu_torch.nn import recurrent_layers as rl
    calls = []
    real = rl.LSTM.forward
    with pytest.MonkeyPatch.context() as m:
        m.setattr(rl.LSTM, "forward",
                  lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
        net.fit(x, y)
    rec = net._solver_log[0]
    assert len(calls) == rec["evaluations"] + 1
    assert rec["values"][-1] < rec["values"][0]


@pytest.mark.parametrize("kind", ["mln", "graph"])
def test_the_solver_log_keeps_the_last_16_batches(kind):
    """A long fit under a solver keeps the records of its last 16 batches
    only, the newest last, in both networks."""
    from deeplearning4j_tpu_torch.nn import DenseLayer, OutputLayer
    b = NeuralNetConfiguration.builder().seed(0).optimization_algo("LINE_GRADIENT_DESCENT") \
        .solver_iterations(1)
    if kind == "mln":
        net = MultiLayerNetwork(b.list().layer(DenseLayer(n_out=4, activation="tanh"))
                                .layer(OutputLayer(n_out=N_OUT, activation="softmax"))
                                .set_input_type(InputType.feed_forward(N_IN)).build(),
                                device="cpu").init()
    else:
        g = b.graph_builder().add_inputs("in")
        g.add_layer("h", DenseLayer(n_out=4, activation="tanh"), "in")
        g.add_layer("out", OutputLayer(n_out=N_OUT, activation="softmax"), "h")
        net = ComputationGraph(g.set_outputs("out").set_input_types(
            InputType.feed_forward(N_IN)).build(), device="cpu").init()
    values = []
    for x, y in _batches("graph", n=20):
        net.fit(x, y)
        values.append(net._solver_log[-1]["values"][0])
    log = net._solver_log
    assert len(log) == 16 and [r["values"][0] for r in log] == values[4:]


def test_tbptt_with_a_solver_raises():
    conf = (NeuralNetConfiguration.builder().seed(3).optimization_algo("LBFGS").list()
            .layer(LSTM(n_in=5, n_out=8))
            .layer(RnnOutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.recurrent(5)).tbptt_fwd_length(4).build())
    x = np.random.default_rng(0).normal(0, 1, (8, 12, 5)).astype(np.float32)
    yy = np.eye(3, dtype=np.float32)[np.random.default_rng(1).integers(0, 3, (8, 12))]
    with pytest.raises(NotImplementedError, match="STOCHASTIC_GRADIENT_DESCENT"):
        MultiLayerNetwork(conf, device="cpu").init().fit(x, yy)
    g = (NeuralNetConfiguration.builder().seed(3).optimization_algo("CONJUGATE_GRADIENT")
         .graph_builder().add_inputs("in"))
    g.add_layer("lstm", LSTM(n_in=5, n_out=8), "in")
    g.add_layer("out", RnnOutputLayer(n_out=3, activation="softmax"), "lstm")
    gconf = g.set_outputs("out").set_input_types(InputType.recurrent(5)) \
        .tbptt_fwd_length(4).build()
    with pytest.raises(NotImplementedError, match="tBPTT"):
        ComputationGraph(gconf, device="cpu").init().fit(x, yy)


LS_CASES = [  # (id, objective scale, direction scale, max steps)
    ("zoom-overshoot", 50.0, 1.0, 15),
    ("grow-interval", 1e-3, 1.0, 15),
    ("budget-safe-step", 1e-3, 1.0, 3),
    ("ascent-direction", 1.0, -1.0, 4),
]


@pytest.mark.parametrize("case", LS_CASES, ids=[c[0] for c in LS_CASES])
def test_zoom_linesearch_matches_optax(case):
    """``ZoomLinesearch`` against optax's ``scale_by_zoom_linesearch`` on a
    float64 objective (a scaled Rosenbrock-like sum): a step that
    overshoots (zoom), one that must grow the interval, one that runs out
    of budget (the safe step), an ascent direction. Three successive
    updates (the ``keep`` guess carried), steps and values within 1e-12."""
    import optax
    from deeplearning4j_tpu_torch.train.linesearch import ZoomLinesearch
    _, a, d, steps = case
    x0 = np.linspace(-1.2, 0.8, 7)

    def f_np(x, lib):
        return a * (lib.sum((x[1:] - x[:-1] ** 2) ** 2) + 0.1 * lib.sum((1 - x) ** 2))

    with jax.enable_x64(True):
        jf = lambda x: f_np(x, jnp)  # noqa: E731
        opt = optax.scale_by_zoom_linesearch(max_linesearch_steps=steps)

        @jax.jit
        def step(xj, st):
            v, g = jax.value_and_grad(jf)(xj)
            u, st = opt.update(d * -g, st, xj, value=v, grad=g, value_fn=jf)
            return xj + u, st, v

        xj = jnp.asarray(x0)
        st = opt.init(xj)
        want = []
        for _ in range(3):
            xj, st, v = step(xj, st)
            want.append((float(st.learning_rate), int(st.info.num_linesearch_steps), float(v)))
    ls = ZoomLinesearch(steps)

    def vg(xs):
        x = xs[0].detach().requires_grad_(True)
        v = f_np(x, torch)
        return v.detach(), [torch.autograd.grad(v, x)[0]]

    x = [torch.as_tensor(x0)]
    st = ls.init(x)
    got = []
    for _ in range(3):
        v, g = vg(x)
        u, st = ls.update([d * -gi for gi in g], st, x, value=v, grad=g, value_and_grad=vg)
        x = [xi + ui for xi, ui in zip(x, u)]
        got.append((float(st.learning_rate), st.num_linesearch_steps, float(v)))
    assert [c for _, c, _ in got] == [c for _, c, _ in want]
    np.testing.assert_allclose([s for s, _, _ in got], [s for s, _, _ in want], rtol=1e-12)
    np.testing.assert_allclose([v for _, _, v in got], [v for _, _, v in want], rtol=1e-12)
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj), rtol=1e-12, atol=1e-14)
