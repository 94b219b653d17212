"""The port's convolution, pooling and normalization layers against the JAX
package on the CPU: ``ConvolutionLayer``, ``SubsamplingLayer``,
``BatchNormalization`` and ``GlobalPoolingLayer`` forward from the same
parameters (numpy, from a seed) on the same NHWC inputs, their JSON, the
configuration checks, and the layer state a ``MultiLayerNetwork`` carries
out of ``fit`` (BatchNormalization's running statistics).

Float32 throughout. Convolutions and pooling ``rtol=1e-5, atol=1e-5`` (the
same products and sums in another order); BatchNormalization ``rtol=1e-5,
atol=2e-5`` (a division by the batch standard deviation amplifies the sums'
order by up to 1/std); gradients ``rtol=1e-4, atol=1e-5``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import base as jbase
from deeplearning4j_tpu.nn import conv_layers as jconv
from deeplearning4j_tpu_torch.nn import base as tbase
from deeplearning4j_tpu_torch.nn import config as tconfig
from deeplearning4j_tpu_torch.nn import conv_layers as tconv
from deeplearning4j_tpu_torch.nn.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.runtime.environment import get_environment

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _pair(name, **kw):
    """The same layer config in both packages, bound to a default global
    config."""
    j, t = getattr(jconv, name)(**kw), getattr(tconv, name)(**kw)
    j._g, t._g = jbase.GlobalConfig(), tbase.GlobalConfig()
    return j, t


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _forward_both(j, t, params, state, x, training=False, mask=None):
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, state)
    jy, jst = j.forward(jp, js, jnp.asarray(x), training=training,
                        mask=None if mask is None else jnp.asarray(mask))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    ty, tst = t.forward(tp, ts, torch.from_numpy(x.copy()), training=training,
                        mask=None if mask is None else torch.from_numpy(mask.copy()))
    return (jy, jst), (ty, tst)


CONV_CASES = [
    dict(kernel_size=(3, 3)),
    dict(kernel_size=(3, 3), convolution_mode="same"),
    dict(kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(7, 7), stride=(2, 2), convolution_mode="same", has_bias=False),
    dict(kernel_size=(1, 1), stride=(2, 2), has_bias=False, activation="identity"),
    dict(kernel_size=(1, 1), stride=(2, 1), convolution_mode="same", has_bias=False),
    dict(kernel_size=(2, 3), stride=(1, 2), padding=(1, 2), activation="relu"),
    dict(kernel_size=(3, 3), dilation=(2, 2), padding=(1, 1)),
    dict(kernel_size=(3, 2), dilation=(2, 1), stride=(2, 2), convolution_mode="same"),
    dict(kernel_size=(4, 4), stride=(3, 3), convolution_mode="same", activation="tanh"),
]


@pytest.mark.parametrize("kw", CONV_CASES, ids=lambda kw: json.dumps(kw, sort_keys=True))
def test_convolution_forward_and_gradient_match_jax(kw):
    rng = np.random.default_rng(len(json.dumps(kw)))
    j, t = _pair("ConvolutionLayer", n_out=5, **kw)
    kh, kw_ = t._geom()[0]
    x = rng.normal(0, 1, (2, 11, 9, 3)).astype(np.float32)
    params = {"W": rng.normal(0, 0.3, (kh, kw_, 3, 5)).astype(np.float32)}
    if t.has_bias:
        params["b"] = rng.normal(0, 0.1, 5).astype(np.float32)
    (jy, _), (ty, _) = _forward_both(j, t, params, {}, x)
    assert tuple(ty.shape) == jy.shape
    out = t.output_type(TInputType.convolutional(11, 9, 3))
    assert tuple(ty.shape[1:]) == (out.height, out.width, out.channels)
    _close(ty, jy, "y")
    cot = rng.normal(0, 1, jy.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(j.forward(p, {}, xx)[0] * cot)

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    (t.forward(tp, {}, tx)[0] * torch.from_numpy(cot)).sum().backward()
    for k in params:
        _close(tp[k].grad, jg[0][k], f"d{k}", rtol=1e-4)
    _close(tx.grad, jg[1], "dx", rtol=1e-4)


def test_plain_1x1_is_the_strided_product():
    """The pairs the graph fuses: a plain 1x1 convolution is ``x[:, ::sh,
    ::sw, :] @ W[0, 0]`` in both modes."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (2, 7, 6, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (1, 1, 4, 3)).astype(np.float32))
    for mode in ("truncate", "same"):
        _, t = _pair("ConvolutionLayer", n_out=3, kernel_size=(1, 1), stride=(2, 2),
                     has_bias=False, activation="identity", convolution_mode=mode)
        assert t.is_plain_1x1()
        y, _ = t.forward({"W": w}, {}, x)
        _close(y, t.subsample(x) @ w[0, 0], mode)
    for kw in (dict(has_bias=True), dict(kernel_size=(3, 3)), dict(padding=(1, 1)),
               dict(activation="relu"), dict(dropout=0.5), dict(dilation=(2, 2))):
        base = dict(n_out=3, kernel_size=(1, 1), has_bias=False, activation="identity")
        _, t = _pair("ConvolutionLayer", **{**base, **kw})
        assert not t.is_plain_1x1(), kw


POOL_CASES = [
    dict(pooling_type="max"),
    dict(pooling_type="max", kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    dict(pooling_type="max", kernel_size=(3, 3), stride=(1, 1), padding=(1, 1)),
    dict(pooling_type="avg", kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    dict(pooling_type="avg", kernel_size=(2, 3), stride=(1, 2), padding=(1, 1)),
    dict(pooling_type="sum", kernel_size=(3, 2), stride=(2, 1)),
    dict(pooling_type="sum", kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
    dict(pooling_type="pnorm", pnorm=3, kernel_size=(2, 2), stride=(2, 2)),
    dict(pooling_type="pnorm", kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"),
]


@pytest.mark.parametrize("kw", POOL_CASES, ids=lambda kw: json.dumps(kw, sort_keys=True))
def test_subsampling_forward_matches_jax(kw):
    rng = np.random.default_rng(len(json.dumps(kw)) + 1)
    j, t = _pair("SubsamplingLayer", **kw)
    x = rng.normal(0, 1, (2, 9, 8, 3)).astype(np.float32)
    (jy, _), (ty, _) = _forward_both(j, t, {}, {}, x)
    assert tuple(ty.shape) == jy.shape
    out = t.output_type(TInputType.convolutional(9, 8, 3))
    assert tuple(ty.shape[1:]) == (out.height, out.width, out.channels)
    _close(ty, jy, "y")


BN_CASES = [
    dict(),
    dict(activation="relu"),
    dict(decay=0.5, eps=1e-3),
    dict(lock_gamma_beta=True),
    dict(use_gamma_beta=False, activation="tanh"),
]


@pytest.mark.parametrize("training", [True, False], ids=["train", "infer"])
@pytest.mark.parametrize("kw", BN_CASES, ids=lambda kw: json.dumps(kw, sort_keys=True))
@pytest.mark.parametrize("shape", [(4, 5, 6, 7), (16, 7)], ids=["nhwc", "ff"])
def test_batch_normalization_matches_jax_with_its_state_update(kw, training, shape):
    """Training normalizes with the shifted single-pass batch statistics
    (around a running mean far from the batch's) and updates the running
    statistics; inference uses them. Gradients flow through the statistics."""
    rng = np.random.default_rng(len(shape) + 3 * len(kw))
    j, t = _pair("BatchNormalization", **kw)
    c = shape[-1]
    x = (rng.normal(0, 1, shape) * rng.uniform(0.5, 2.0, c) + 5.0).astype(np.float32)
    params = {}
    if t.use_gamma_beta and not t.lock_gamma_beta:
        params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                  "beta": rng.normal(0, 0.5, c).astype(np.float32)}
    state = {"mean": rng.normal(4.0, 1.0, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    (jy, jst), (ty, tst) = _forward_both(j, t, params, state, x, training=training)
    _close(ty, jy, "y", atol=2e-5)
    assert sorted(tst) == ["mean", "var"]
    for k in ("mean", "var"):
        _close(tst[k], jst[k], f"state {k}")
        assert tst[k].dtype == torch.float32 and not tst[k].requires_grad
    if not training:
        assert tst is not None and all(torch.equal(tst[k], torch.from_numpy(state[k]))
                                       for k in state)
        return
    cot = rng.normal(0, 1, shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(j.forward(p, jax.tree.map(jnp.asarray, state), xx,
                                 training=True)[0] * cot)

    jg = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    (t.forward(tp, ts, tx, training=True)[0] * torch.from_numpy(cot)).sum().backward()
    for k in params:
        _close(tp[k].grad, jg[0][k], f"d{k}", rtol=1e-4, atol=1e-4)
    _close(tx.grad, jg[1], "dx", rtol=1e-4, atol=1e-4)


def test_apply_batch_stats_equals_forward_on_the_same_sums():
    """What the graph's fused path hands the layer: the shifted sums of its
    input give exactly the forward's output and state."""
    rng = np.random.default_rng(11)
    _, t = _pair("BatchNormalization", activation="relu")
    x = torch.from_numpy(rng.normal(2.0, 1.5, (3, 4, 5, 6)).astype(np.float32))
    params = {"gamma": torch.full((6,), 1.3), "beta": torch.full((6,), -0.2)}
    state = {"mean": torch.full((6,), 1.5), "var": torch.ones(6)}
    y, st = t.forward(params, state, x, training=True)
    d = (x - state["mean"]).reshape(-1, 6)
    y2, st2 = t.apply_batch_stats(params, state, x, d.sum(0), (d * d).sum(0), d.shape[0])
    assert torch.equal(y, y2)
    assert all(torch.equal(st[k], st2[k]) for k in st)


@pytest.mark.parametrize("pooling_type", ["max", "avg", "sum", "pnorm"])
def test_global_pooling_matches_jax(pooling_type):
    rng = np.random.default_rng(7)
    j, t = _pair("GlobalPoolingLayer", pooling_type=pooling_type, pnorm=3)
    x = rng.normal(0, 1, (3, 5, 4, 6)).astype(np.float32)
    (jy, _), (ty, _) = _forward_both(j, t, {}, {}, x)
    _close(ty, jy, "nhwc")
    seq = rng.normal(0, 1, (3, 7, 6)).astype(np.float32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    for m in (None, mask):
        (jy, _), (ty, _) = _forward_both(j, t, {}, {}, seq, mask=m)
        _close(ty, jy, f"sequence, mask {m is not None}")
    assert t.output_type(TInputType.convolutional(5, 4, 6)) == TInputType.feed_forward(6)


def _jax_conf(layers, input_type):
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JNN
    b = JNN.builder().seed(5)
    lb = b.list()
    for layer in layers:
        lb.layer(layer)
    return lb.set_input_type(input_type).build()


def test_conv_configuration_json_both_ways():
    """A convolutional stack's configuration.json is the same in both
    packages, and images go into the ported layers with no preprocessor."""
    from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JConf
    from deeplearning4j_tpu.nn.inputs import InputType as JInputType
    jconf = _jax_conf([jconv.ConvolutionLayer(n_out=4, kernel_size=(3, 3), stride=(2, 2),
                                              convolution_mode="same", has_bias=False),
                       jconv.BatchNormalization(activation="relu", decay=0.8),
                       jconv.SubsamplingLayer(pooling_type="avg", kernel_size=(2, 2)),
                       jconv.GlobalPoolingLayer(pooling_type="max")],
                      JInputType.convolutional(9, 9, 3))
    tconf = tconfig.MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    assert json.loads(JConf.from_json(tconf.to_json()).to_json()) == json.loads(jconf.to_json())
    assert [it.kind for it in tconf.layer_input_types] == ["convolutional"] * 4
    assert tconf.output_type == TInputType.feed_forward(4)


def test_images_into_a_layer_that_needs_a_preprocessor_are_refused_by_name():
    """Once refused by name, now the JAX package's automatic preprocessors:
    an image into a dense layer is flattened, a flattened image into a
    convolution reshaped, a flat input into a convolution refused with JAX's
    ``ValueError``, and layers that take images as they are get none."""
    from deeplearning4j_tpu.nn import DenseLayer as JDense
    from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JConf
    from deeplearning4j_tpu.nn.inputs import InputType as JInputType
    from deeplearning4j_tpu_torch.nn import DenseLayer
    cases = [(DenseLayer(n_out=3), JDense(n_out=3), (4, 5, 3), "convolutional"),
             (tconv.ConvolutionLayer(n_out=3), jconv.ConvolutionLayer(n_out=3), (4, 5, 3),
              "convolutional_flat"),
             (tconv.SubsamplingLayer(), jconv.SubsamplingLayer(), (4, 4, 1), "convolutional"),
             (tconv.BatchNormalization(), jconv.BatchNormalization(), (4, 4, 1),
              "convolutional")]
    for tl, jl, hwc, kind in cases:
        it = getattr(TInputType, kind)(*hwc)
        got = tconfig.auto_preprocessor(it, tl)
        want = JConf._auto_preprocessor(getattr(JInputType, kind)(*hwc), jl)
        assert (got is None) == (want is None), (tl, kind)
        if got is not None:
            assert got.to_dict() == want.to_dict()
            assert got.output_type(it).to_dict() == \
                want.output_type(getattr(JInputType, kind)(*hwc)).to_dict()
    with pytest.raises(ValueError, match="convolutional_flat"):
        tconfig.auto_preprocessor(TInputType.feed_forward(16), tconv.ConvolutionLayer(n_out=3))


def test_multilayer_network_carries_batchnorm_state_out_of_fit():
    """JAX ``multi_layer_network.py:208-212``: fit keeps each layer's new
    state. Dense -> BatchNormalization -> output, three Sgd steps in both
    packages from the same weights: losses, weights and running statistics
    agree, and the statistics moved."""
    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn import core_layers as jcore
    from deeplearning4j_tpu.nn.inputs import InputType as JInputType
    from deeplearning4j_tpu.train.updaters import Sgd
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.models.serializer import params_from_numpy, tree_leaves
    conf = _jax_conf([jcore.DenseLayer(n_out=6, activation="identity"),
                      jconv.BatchNormalization(activation="relu"),
                      jcore.OutputLayer(n_out=3, activation="softmax")],
                     JInputType.feed_forward(5))
    conf.global_conf.updater = Sgd(0.1)
    jnet = JNet(conf).init()
    tnet = MultiLayerNetwork(tconfig.MultiLayerConfiguration.from_json(conf.to_json()),
                             device="cpu").init(
        params=params_from_numpy(jax.tree.map(np.asarray, jnet.train_state.params)))
    rng = np.random.default_rng(2)
    for step in range(3):
        x = (rng.normal(0, 1, (8, 5)) + 2.0).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
        jnet.fit(x, y)
        tnet.fit(x, y)
        _close(tnet.score(), float(jnet.score()), f"loss {step}")
    for tl, jl in zip(tree_leaves(tnet.params()), jax.tree.leaves(jnet.train_state.params)):
        _close(tl, jl, "weights", rtol=1e-4)
    jstate = jnet.train_state.model_state["layer_1"]
    for k in ("mean", "var"):
        _close(tnet._model_state["layer_1"][k], jstate[k], f"running {k}")
    assert not torch.equal(tnet._model_state["layer_1"]["mean"], torch.zeros(6))
