"""The port's recurrent layers in training against the JAX layers.

Gradients of every parameter, of the input and of the initial carry go
through ``torch.autograd`` of the port's layer (the kernel wrappers' plain
versions on the CPU, or the plain time loop for a cell with other
activations) and through ``jax.grad`` of the JAX layer (its scan path at
these widths). Then a recurrent network without truncated BPTT takes the
plain training step in both packages.

Float32, ``rtol=1e-4, atol=1e-5``: the two sides sum the products over T
steps in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import base as jbase
from deeplearning4j_tpu.nn import recurrent_layers as jrec
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu_torch.models.serializer import params_from_numpy, tree_leaves
from deeplearning4j_tpu_torch.nn import base as tbase
from deeplearning4j_tpu_torch.nn import recurrent_layers as trec
from deeplearning4j_tpu_torch.runtime.environment import get_environment

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


CASES = [("LSTM", {}, False), ("LSTM", {}, True), ("GravesLSTM", {}, False),
         ("GravesLSTM", {}, True), ("LSTM", {"gate_activation": "hardsigmoid"}, True),
         ("GravesLSTM", {"activation": "softsign"}, False)]


@pytest.mark.parametrize("name,kw,masked", CASES,
                         ids=[f"{n}-{'-'.join(k.values()) or 'default'}-"
                              f"{'masked' if m else 'unmasked'}" for n, k, m in CASES])
def test_recurrent_layer_gradients_match_jax(name, kw, masked):
    rng = np.random.default_rng(21)
    jl, tl = getattr(jrec, name)(n_out=H, **kw), getattr(trec, name)(n_out=H, **kw)
    jl._g, tl._g = jbase.GlobalConfig(), tbase.GlobalConfig()
    p, _ = jl.init(jax.random.PRNGKey(4), JInputType.recurrent(NIN, T), jbase.GlobalConfig())
    p = {k: np.asarray(v) for k, v in p.items()}
    if "peephole" in p:
        p["peephole"] = rng.normal(0, 0.3, p["peephole"].shape).astype(np.float32)
    x = rng.normal(0, 1, (B, T, NIN)).astype(np.float32)
    h0, c0 = (rng.normal(0, 1, (B, H)).astype(np.float32) for _ in range(2))
    dy = rng.normal(0, 1, (B, T, H)).astype(np.float32)
    dh, dc = (rng.normal(0, 1, (B, H)).astype(np.float32) for _ in range(2))
    m = None
    if masked:
        m = (np.arange(T)[None, :] < rng.integers(2, T + 1, B)[:, None]).astype(np.float32)
        m[1] = 0.0

    def jloss(params, xx, carry):
        y, (h, c) = jl.forward_with_carry(params, carry, xx,
                                          mask=None if m is None else jnp.asarray(m))
        return jnp.sum(y * dy) + jnp.sum(h * dh) + jnp.sum(c * dc)

    jg_p, jg_x, (jg_h, jg_c) = jax.grad(jloss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        (jnp.asarray(h0), jnp.asarray(c0)))

    tp = {k: v.requires_grad_() for k, v in params_from_numpy(p).items()}
    tx, th0, tc0 = (torch.from_numpy(a).requires_grad_() for a in (x, h0, c0))
    y, (h, c) = tl.forward_with_carry(tp, (th0, tc0), tx, training=True,
                                      mask=None if m is None else torch.from_numpy(m))
    loss = (y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum() + \
        (c * torch.from_numpy(dc)).sum()
    names = sorted(tp)
    got = torch.autograd.grad(loss, [tp[k] for k in names] + [tx, th0, tc0])
    for k, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_p[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    for what, g, jg in zip(("x", "h0", "c0"), got[len(names):], (jg_x, jg_h, jg_c)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL,
                                   err_msg=what)


def test_recurrent_fit_without_tbptt_matches_jax():
    """Without a tBPTT length a sequence batch takes the plain step: one
    iteration per batch, zero carries, the labels mask from the features
    mask."""
    from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
    from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu.nn import (InputType as JIn, LSTM as JLSTM,
                                       NeuralNetConfiguration as JConf,
                                       RnnOutputLayer as JOut)
    from deeplearning4j_tpu.train.listeners import CollectScoresListener as JCollect
    from deeplearning4j_tpu.train.updaters import RmsProp as JRms
    from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import (LSTM, InputType, NeuralNetConfiguration,
                                             RnnOutputLayer)
    from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
    from deeplearning4j_tpu_torch.train.updaters import RmsProp

    def conf(C, L, O, I, R):
        return (C.builder().seed(9).updater(R(1e-2)).list()
                .layer(L(n_out=H, activation="tanh"))
                .layer(O(n_out=6, activation="softmax", loss="mcxent"))
                .set_input_type(I.recurrent(NIN)).build())

    jnet = JNet(conf(JConf, JLSTM, JOut, JIn, JRms)).init()
    net = MultiLayerNetwork(conf(NeuralNetConfiguration, LSTM, RnnOutputLayer, InputType,
                                 RmsProp), device="cpu").init(
        params=params_from_numpy(jax.tree.map(np.asarray, jnet.train_state.params)))
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(3):
        x = rng.normal(0, 1, (B, T, NIN)).astype(np.float32)
        y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, (B, T))]
        m = (np.arange(T)[None, :] < rng.integers(3, T + 1, B)[:, None]).astype(np.float32)
        batches.append((x, y, m))
    jc, tc = JCollect(), CollectScoresListener()
    jnet.set_listeners(jc)
    net.set_listeners(tc)
    jnet.fit(JList([JDataSet(x, y, features_mask=m) for x, y, m in batches]))
    net.fit(ListDataSetIterator([DataSet(x, y, features_mask=m) for x, y, m in batches]))
    assert [i for i, _ in tc.scores] == [i for i, _ in jc.scores] == [1, 2, 3]
    np.testing.assert_allclose([s for _, s in tc.scores], [s for _, s in jc.scores],
                               rtol=1e-5)
    jparams = jax.tree.map(np.asarray, jnet.train_state.params)
    for k, layer in jparams.items():
        for n, leaf in layer.items():
            np.testing.assert_allclose(net.params()[k][n].numpy(), leaf, rtol=0, atol=1e-6,
                                       err_msg=f"{k}/{n}")
    for j, t in zip(jax.tree.leaves(jnet.train_state.opt_state),
                    tree_leaves(net.updater_state())):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-12)
