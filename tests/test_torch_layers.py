"""The port's layers, configuration schema and ops against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; weights
cross with ``params_from_numpy``. Float32 throughout, ``rtol=1e-4,
atol=1e-5`` (the summation order of ``h @ W_rec`` over T steps differs).
The JAX layers take their scan path here (no Pallas interpret mode), which
computes the same function as their kernels.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import base as jbase
from deeplearning4j_tpu.nn import recurrent_layers as jrec
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu_torch.models.serializer import params_from_numpy, tree_leaves
from deeplearning4j_tpu_torch.nn import base as tbase
from deeplearning4j_tpu_torch.nn import config as tconfig
from deeplearning4j_tpu_torch.nn import recurrent_layers as trec
from deeplearning4j_tpu_torch.nn.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import losses as tloss
from deeplearning4j_tpu_torch.ops.initializers import WeightInit, init_weights
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.rng import RngManager

RTOL, ATOL = 1e-4, 1e-5
B, T, NIN, H = 5, 9, 12, 32


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_PALLAS_INTERPRET", raising=False)
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _pair(name, **kw):
    """The same layer config in both packages, bound to a default global
    config."""
    j = getattr(jrec, name)(**kw)
    t = getattr(trec, name)(**kw)
    j._g, t._g = jbase.GlobalConfig(), tbase.GlobalConfig()
    return j, t


def _jax_params(layer, n_in, seed):
    params, _ = layer.init(jax.random.PRNGKey(seed), JInputType.recurrent(n_in, T),
                           jbase.GlobalConfig())
    return {k: np.asarray(v) for k, v in params.items()}


def _mask(rng):
    m = (np.arange(T)[None, :] < rng.integers(2, T + 1, B)[:, None]).astype(np.float32)
    m[1] = 0.0  # a row with every step masked
    return m


CASES = [("LSTM", {}, False), ("LSTM", {}, True), ("GravesLSTM", {}, False),
         ("GravesLSTM", {}, True),
         ("LSTM", {"gate_activation": "hardsigmoid"}, False),
         ("GravesLSTM", {"activation": "softsign"}, True)]


@pytest.mark.parametrize("name,kw,masked", CASES,
                         ids=[f"{n}-{'-'.join(k.values()) or 'default'}-"
                              f"{'masked' if m else 'unmasked'}" for n, k, m in CASES])
def test_recurrent_layer_forward_matches_jax(name, kw, masked):
    rng = np.random.default_rng(11)
    jl, tl = _pair(name, n_out=H, **kw)
    p = _jax_params(jl, NIN, 3)
    if "peephole" in p:
        p["peephole"] = rng.normal(0, 0.3, p["peephole"].shape).astype(np.float32)
    x = rng.normal(0, 1, (B, T, NIN)).astype(np.float32)
    m = _mask(rng) if masked else None
    h0 = rng.normal(0, 1, (B, H)).astype(np.float32)
    c0 = rng.normal(0, 1, (B, H)).astype(np.float32)

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jm = None if m is None else jnp.asarray(m)
    jy, _ = jl.forward(jp, {}, jnp.asarray(x), mask=jm)
    jyc, (jh, jc) = jl.forward_with_carry(jp, (jnp.asarray(h0), jnp.asarray(c0)),
                                          jnp.asarray(x), mask=jm)

    tp = params_from_numpy(p)
    tm = None if m is None else torch.from_numpy(m)
    ty, _ = tl.forward(tp, {}, torch.from_numpy(x), mask=tm)
    tyc, (th, tc) = tl.forward_with_carry(tp, (torch.from_numpy(h0), torch.from_numpy(c0)),
                                          torch.from_numpy(x), mask=tm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tyc.numpy(), np.asarray(jyc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)


def test_kernel_routing_follows_the_jax_package(monkeypatch):
    """Unmasked plain LSTM -> fused_lstm; GravesLSTM and masked LSTM ->
    fused_graves_lstm; a non-default cell -> the plain time loop."""
    calls = []
    real_plain, real_graves = trec.fused_lstm, trec.fused_graves_lstm
    monkeypatch.setattr(trec, "fused_lstm",
                        lambda *a: calls.append("plain") or real_plain(*a))
    monkeypatch.setattr(trec, "fused_graves_lstm",
                        lambda *a: calls.append("graves") or real_graves(*a))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (B, T, NIN)).astype(np.float32))
    m = torch.from_numpy(_mask(rng))
    for name, kw, mask, want in (("LSTM", {}, None, "plain"), ("LSTM", {}, m, "graves"),
                                 ("GravesLSTM", {}, None, "graves"),
                                 ("GravesLSTM", {}, m, "graves"),
                                 ("LSTM", {"gate_activation": "hardsigmoid"}, None, None)):
        jl, tl = _pair(name, n_out=H, **kw)
        calls.clear()
        tl.forward(params_from_numpy(_jax_params(jl, NIN, 0)), {}, x, mask=mask)
        assert calls == ([want] if want else []), (name, kw, mask is not None)


def test_rnn_output_layer_matches_jax():
    rng = np.random.default_rng(2)
    jl = jrec.RnnOutputLayer(n_out=7, activation="softmax", loss="mcxent")
    tl = trec.RnnOutputLayer(n_out=7, activation="softmax", loss="mcxent")
    jl._g, tl._g = jbase.GlobalConfig(), tbase.GlobalConfig()
    p, _ = jl.init(jax.random.PRNGKey(0), JInputType.recurrent(NIN, T), jbase.GlobalConfig())
    p = {k: np.asarray(v) for k, v in p.items()}
    x = rng.normal(0, 1, (B, T, NIN)).astype(np.float32)
    labels = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (B, T))]
    m = _mask(rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = params_from_numpy(p)
    np.testing.assert_allclose(tl.activate(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jl.activate(jp, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tl.compute_loss(tp, torch.from_numpy(x), torch.from_numpy(labels),
                        mask=torch.from_numpy(m)).item(),
        float(jl.compute_loss(jp, jnp.asarray(x), jnp.asarray(labels), mask=jnp.asarray(m))),
        rtol=RTOL, atol=ATOL)


CORE = [("DenseLayer", dict(n_out=6, activation="relu"), "float"),
        ("DenseLayer", dict(n_out=6, has_bias=False), "float"),
        ("OutputLayer", dict(n_out=6, activation="softmax"), "float"),
        ("LossLayer", dict(activation="sigmoid"), "float"),
        ("ActivationLayer", dict(activation="tanh"), "float"),
        ("DropoutLayer", dict(dropout=0.5), "float"),
        ("EmbeddingLayer", dict(n_in=9, n_out=6, has_bias=True), "ids"),
        ("EmbeddingSequenceLayer", dict(n_in=9, n_out=6), "seq_ids")]


@pytest.mark.parametrize("name,kw,kind", CORE,
                         ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(CORE)])
def test_core_layer_inference_matches_jax(name, kw, kind):
    from deeplearning4j_tpu.nn import core_layers as jcore
    from deeplearning4j_tpu_torch.nn import core_layers as tcore
    rng = np.random.default_rng(9)
    jl, tl = getattr(jcore, name)(**kw), getattr(tcore, name)(**kw)
    jl._g, tl._g = jbase.GlobalConfig(), tbase.GlobalConfig()
    x = {"float": lambda: rng.normal(0, 1, (B, NIN)).astype(np.float32),
         "ids": lambda: rng.integers(0, 9, (B, 1)).astype(np.int32),
         "seq_ids": lambda: rng.integers(0, 9, (B, T)).astype(np.int32)}[kind]()
    p, _ = jl.init(jax.random.PRNGKey(2), JInputType.feed_forward(NIN), jbase.GlobalConfig())
    p = {k: np.asarray(v) for k, v in p.items()}
    jy, _ = jl.forward({k: jnp.asarray(v) for k, v in p.items()}, {}, jnp.asarray(x))
    ty, _ = tl.forward(params_from_numpy(p), {}, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
    tp, _ = tl.init(torch.Generator().manual_seed(0), TInputType.feed_forward(NIN),
                    tbase.GlobalConfig())
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in p.items()}


ACTIVATIONS = sorted(a.value for a in tact.Activation)


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_jax(name):
    x = np.random.default_rng(4).normal(0, 2, (6, 10)).astype(np.float32)
    want = np.asarray(jact.get_activation(name)(jnp.asarray(x)))
    got = tact.get_activation(name.upper())(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


LOSSES = [("mcxent", "softmax"), ("xent", "sigmoid"), ("mse", "identity"),
          ("l1", "tanh"), ("hinge", "identity"), ("kl_divergence", "softmax"),
          ("poisson", "softplus"), ("cosine_proximity", "identity")]


@pytest.mark.parametrize("loss,act", LOSSES, ids=[l for l, _ in LOSSES])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_loss_matches_jax(loss, act, masked):
    rng = np.random.default_rng(6)
    pre = rng.normal(0, 1, (B, T, 4)).astype(np.float32)
    labels = (np.eye(4, dtype=np.float32)[rng.integers(0, 4, (B, T))]
              if loss in ("mcxent", "kl_divergence", "xent", "hinge")
              else rng.random((B, T, 4)).astype(np.float32))
    m = _mask(rng) if masked else None
    want = jloss.compute_loss(loss, jnp.asarray(labels), jnp.asarray(pre), activation=act,
                              mask=None if m is None else jnp.asarray(m))
    got = tloss.compute_loss(loss, torch.from_numpy(labels), torch.from_numpy(pre),
                             activation=act, mask=None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)


def _textgen_confs(graves):
    from deeplearning4j_tpu.zoo import TextGenerationLSTM as JText
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM as TText
    kw = dict(vocab_size=20, hidden=H, graves=graves)
    return JText(**kw).conf(), TText(**kw).conf()


@pytest.mark.parametrize("graves", [True, False], ids=["graves", "plain"])
def test_configuration_json_is_the_same_schema(graves):
    from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JConf
    jconf, tconf = _textgen_confs(graves)
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    back = tconfig.MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert json.loads(JConf.from_json(tconf.to_json()).to_json()) == json.loads(jconf.to_json())


def test_unported_layer_and_preprocessor_are_named():
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JNN
    from deeplearning4j_tpu.nn.core_layers import OutputLayer as JOut
    # LocalResponseNormalization, the layer refused here before, is ported;
    # PReLULayer is not yet
    from deeplearning4j_tpu.nn.misc_layers import PReLULayer as JPrelu
    conf = (JNN.builder().list().layer(JPrelu())
            .layer(jrec.RnnOutputLayer(n_out=3)).set_input_type(JInputType.recurrent(5))
            .build())
    with pytest.raises(KeyError, match="PReLULayer"):
        tconfig.MultiLayerConfiguration.from_json(conf.to_json())
    # the preprocessor half, once refused by name: an image into an output
    # layer now gets the JAX package's flattening preprocessor
    conf = (JNN.builder().list().layer(JOut(n_out=3))
            .set_input_type(JInputType.convolutional(4, 5, 2)).build())
    tconf = tconfig.MultiLayerConfiguration.from_json(conf.to_json())
    assert json.loads(tconf.to_json()) == json.loads(conf.to_json())
    assert type(tconf.preprocessors[0]).__name__ == "CnnToFeedForwardPreProcessor"
    assert tconf.layer_input_types[0] == TInputType.feed_forward(40)


def test_tree_leaves_order_matches_jax():
    rng = np.random.default_rng(8)
    tree = {"params": {f"layer_{i}": {k: rng.random(i + 1) for k in ("peephole", "b",
                                                                      "W_rec", "W")}
                       for i in (0, 2, 10, 1)},
            "model_state": {"layer_3": {"mean": rng.random(2)}}}
    want = jax.tree.leaves(tree)
    got = tree_leaves(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is w


@pytest.mark.parametrize("scheme", ["xavier", "xavier_uniform", "relu", "lecun_uniform",
                                    "var_scaling_normal_fan_avg", "uniform"])
def test_initializer_scale(scheme):
    fan_in, fan_out = 300, 200
    w = init_weights(torch.Generator().manual_seed(0), (fan_in, fan_out), scheme)
    std = {"xavier": (2 / (fan_in + fan_out)) ** 0.5,
           "xavier_uniform": (2 / (fan_in + fan_out)) ** 0.5,
           "relu": (2 / fan_in) ** 0.5, "lecun_uniform": (1 / fan_in) ** 0.5,
           "var_scaling_normal_fan_avg": (2 / (fan_in + fan_out)) ** 0.5,
           "uniform": (1 / (3 * fan_in)) ** 0.5}[scheme]
    assert w.shape == (fan_in, fan_out) and w.dtype == torch.float32
    assert abs(w.std().item() / std - 1.0) < 0.05
    again = init_weights(torch.Generator().manual_seed(0), (fan_in, fan_out),
                         WeightInit(scheme))
    assert torch.equal(w, again)


def test_rng_state_round_trips_with_the_jax_package():
    from deeplearning4j_tpu.runtime.rng import RngManager as JRng
    j = JRng(42)
    j.next_key()
    state = j.get_state()
    t = RngManager(0)
    t.set_state(json.loads(json.dumps(state)))
    assert t.get_state() == state
    g1 = t.next_generator()
    after = t.get_state()
    assert after != state
    t.set_state(state)
    assert torch.equal(torch.rand(4, generator=t.next_generator()),
                       torch.rand(4, generator=g1))
    JRng(0).set_state(after)  # the JAX package reads the port's state back
