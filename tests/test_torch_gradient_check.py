"""The port's numerical gradient check on the CPU: the 9 cases of the JAX
package's ``tests/test_gradients.py``, each run by both packages' checks on
one archive in float64 (both pass, and the two float64 losses at the
archive's parameters agree within ``_LOSS_TOL``), and a layer whose
backward is wrong, which the check must catch.

On the CPU every layer takes float64 through its plain version; on the
card the kernel layers raise on float64 (``chip_smoke.py --runtime``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn as jnn
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train.gradient_check import GradientCheckUtil as JCheck
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.nn.base import register_layer
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.train.gradient_check import GradientCheckUtil

_LOSS_TOL = dict(rtol=1e-9, atol=1e-12)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _base():
    return jnn.NeuralNetConfiguration.builder().seed(12345).updater(JSgd(0.1))


def _case(name):
    """``(jax conf, x, y, mask)`` of each case of ``tests/test_gradients.py``."""
    if name == "dense":
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, (6, 5)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
        conf = (_base().l2(1e-3).list()
                .layer(jnn.DenseLayer(n_out=7, activation="tanh"))
                .layer(jnn.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(jnn.InputType.feed_forward(5)).build())
        return conf, x, y, None
    if name == "cnn":
        rng = np.random.default_rng(1)
        x = rng.normal(0, 1, (4, 8, 8, 2)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        conf = (_base().list()
                .layer(jnn.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                            convolution_mode="same", activation="tanh"))
                .layer(jnn.SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(jnn.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(jnn.InputType.convolutional(8, 8, 2)).build())
        return conf, x, y, None
    if name == "batchnorm":
        rng = np.random.default_rng(2)
        x = rng.normal(0, 1, (6, 6, 6, 2)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 6)]
        conf = (_base().list()
                .layer(jnn.ConvolutionLayer(n_out=3, kernel_size=(3, 3),
                                            convolution_mode="same", activation="identity"))
                .layer(jnn.BatchNormalization(activation="tanh"))
                .layer(jnn.GlobalPoolingLayer(pooling_type=jnn.PoolingType.AVG))
                .layer(jnn.OutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(jnn.InputType.convolutional(6, 6, 2)).build())
        return conf, x, y, None
    if name in ("rnn-lstm", "rnn-gru", "rnn-simple"):
        cell = {"lstm": jnn.LSTM, "gru": jnn.GRU, "simple": jnn.SimpleRnn}[name[4:]]
        rng = np.random.default_rng(3)
        x = rng.normal(0, 1, (3, 5, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 5))]
        conf = (_base().list().layer(cell(n_out=6, activation="tanh"))
                .layer(jnn.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(jnn.InputType.recurrent(4)).build())
        return conf, x, y, None
    if name == "rnn-mask":
        rng = np.random.default_rng(4)
        x = rng.normal(0, 1, (3, 6, 4)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 6))]
        mask = np.ones((3, 6), np.float32)
        mask[0, 4:] = 0
        mask[2, 2:] = 0
        conf = (_base().list().layer(jnn.LSTM(n_out=5, activation="tanh"))
                .layer(jnn.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(jnn.InputType.recurrent(4)).build())
        return conf, x, y, mask
    if name == "bidirectional":
        rng = np.random.default_rng(5)
        x = rng.normal(0, 1, (3, 4, 3)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (3, 4))]
        conf = (_base().list()
                .layer(jnn.Bidirectional(layer=jnn.LSTM(n_out=4, activation="tanh"),
                                         mode="concat"))
                .layer(jnn.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(jnn.InputType.recurrent(3)).build())
        return conf, x, y, None
    if name == "attention":
        rng = np.random.default_rng(6)
        x = rng.normal(0, 1, (2, 6, 8)).astype(np.float32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, (2, 6))]
        conf = (_base().list().layer(jnn.SelfAttentionLayer(n_heads=2))
                .layer(jnn.RnnOutputLayer(n_out=2, activation="softmax", loss="mcxent"))
                .set_input_type(jnn.InputType.recurrent(8)).build())
        return conf, x, y, None
    if name == "embedding":
        rng = np.random.default_rng(7)
        ids = rng.integers(0, 11, (4, 5)).astype(np.int32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 5))]
        conf = (_base().list().layer(jnn.EmbeddingSequenceLayer(n_in=11, n_out=6))
                .layer(jnn.RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(jnn.InputType.recurrent(1)).build())
        return conf, ids, y, None
    loss, act = name.split("-")[1:]
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (5, 4)).astype(np.float32)
    y = (rng.integers(0, 2, (5, 2)).astype(np.float32) if loss == "xent"
         else rng.normal(0, 1, (5, 2)).astype(np.float32))
    conf = (_base().list().layer(jnn.DenseLayer(n_out=6, activation="tanh"))
            .layer(jnn.OutputLayer(n_out=2, activation=act, loss=loss))
            .set_input_type(jnn.InputType.feed_forward(4)).build())
    return conf, x, y, None


@pytest.mark.parametrize("name", ["dense", "cnn", "batchnorm", "rnn-lstm", "rnn-gru",
                                  "rnn-simple", "rnn-mask", "bidirectional", "attention",
                                  "embedding", "loss-mse-identity", "loss-xent-sigmoid",
                                  "loss-mae-identity"])
def test_gradient_check_passes_in_both_packages(tmp_path, name):
    conf, x, y, mask = _case(name)
    jnet = JNet(conf).init()
    path = str(tmp_path / "net.zip")
    JSerializer.write_model(jnet, path)
    net = ModelSerializer.restore_model(path, device="cpu")
    assert GradientCheckUtil.check_gradients(net, x, y, fmask=mask, lmask=mask,
                                             max_per_param=4)
    assert JCheck.check_gradients(jnet, x, y, fmask=mask, lmask=mask, max_per_param=4)
    # the check works on copies: the network is as it was, in float32
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(
        {k: list(v.values()) for k, v in net.params().items()}) if t.is_floating_point())
    assert get_environment().compute_dtype == torch.float32
    # the same float64 loss at the archive's parameters in both packages
    get_environment().set_compute_dtype("float64")
    try:
        def up(a):
            return torch.as_tensor(np.asarray(a)).double() if np.asarray(a).dtype.kind == "f" \
                else torch.as_tensor(np.asarray(a))
        from deeplearning4j_tpu_torch.runtime.trees import tree_map
        params = tree_map(lambda t: t.double() if t.is_floating_point() else t, net.params())
        state = tree_map(lambda t: t.double() if t.is_floating_point() else t, net._model_state)
        m = None if mask is None else up(mask)
        loss = float(net._loss(params, state, up(x), up(y), None, m, m, training=False)[0])
    finally:
        get_environment().set_compute_dtype("float32")
    with jax.enable_x64(True):
        import jax.numpy as jnp
        from deeplearning4j_tpu.runtime.environment import get_environment as jenv
        cdt = jenv().compute_dtype
        jenv().compute_dtype = jnp.float64
        try:
            def j64(a):
                a = jnp.asarray(a)
                return a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a
            jl = float(jnet._loss(jax.tree.map(j64, jnet.train_state.params),
                                  jax.tree.map(j64, jnet.train_state.model_state),
                                  j64(x), j64(y), None, None if mask is None else j64(mask),
                                  None if mask is None else j64(mask), training=False)[0])
        finally:
            jenv().compute_dtype = cdt
            jnet._jit_cache.clear()
    np.testing.assert_allclose(loss, jl, **_LOSS_TOL)


class _WrongBackward(torch.autograd.Function):
    """The identity, whose backward scales the gradient by 1.5."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 1.5 * g


@register_layer
@dataclasses.dataclass
class _WrongGradDense(DenseLayer):
    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        y, s = super().forward(params, state, x, training=training, generator=generator,
                               mask=mask)
        return _WrongBackward.apply(y), s


def test_a_wrong_backward_is_caught(capsys):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]

    def conf(first):
        return (NeuralNetConfiguration.builder().seed(3).list()
                .layer(first(n_out=7, activation="tanh"))
                .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.feed_forward(5)).build())

    assert GradientCheckUtil.check_gradients(MultiLayerNetwork(conf(DenseLayer)).init(), x, y)
    assert not GradientCheckUtil.check_gradients(
        MultiLayerNetwork(conf(_WrongGradDense)).init(), x, y)
    assert "FAIL" in capsys.readouterr().out
