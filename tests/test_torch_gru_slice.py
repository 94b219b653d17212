"""The port's GRU slice against the JAX package, end to end on the CPU: the
rest of ``nn/recurrent_layers.py`` (``GRU`` in every configuration,
``SimpleRnn``, ``Bidirectional``, ``LastTimeStep``), their
``configuration.json`` schema, and a 2-layer GRU char-RNN through archives,
``ModelRegistry``, ``rnn_time_step`` and ``fit``.

Inputs are made with numpy from a seed; weights cross with
``params_from_numpy`` or through the archive. Layer checks compare the
forward from a zero carry, the forward from a random carry (outputs and the
final carry), and the gradients of ``sum(y * cot)`` with respect to the
parameters and the input. The default GRU at B=8, H=128 reaches the JAX
package's Pallas kernel in interpret mode on one side and the port's
``fused_gru`` on the other; the other configurations reach the JAX
package's ``lax.scan`` and the port's plain loop, which compute the same
function. Float32 throughout, ``rtol=1e-4, atol=1e-5`` (summation order of
the recurrent products); fit losses ``rtol=1e-5``, parameters ``atol=1e-6``
(RmsProp moves a weight by about ``lr * sign(g)``, insensitive to the last
bits of g).
"""

import json
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import base as jbase
from deeplearning4j_tpu.nn import core_layers as jcore
from deeplearning4j_tpu.nn import recurrent_layers as jrec
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JCollect
from deeplearning4j_tpu.train.updaters import RmsProp as JRmsProp
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serializer import params_from_numpy, tree_leaves
from deeplearning4j_tpu_torch.nn import NeuralNetConfiguration as TConf
from deeplearning4j_tpu_torch.nn import base as tbase
from deeplearning4j_tpu_torch.nn import config as tconfig
from deeplearning4j_tpu_torch.nn import core_layers as tcore
from deeplearning4j_tpu_torch.nn import recurrent_layers as trec
from deeplearning4j_tpu_torch.nn.inputs import InputType as TInputType
from deeplearning4j_tpu_torch.ops.kernels import fused_gru
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import ModelRegistry
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.train.updaters import RmsProp

RTOL, ATOL = 1e-4, 1e-5
T, NIN = 9, 12
VOCAB, HIDDEN, SEQ, TBPTT = 12, 32, 12, 6


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _pair(name, **kw):
    """The same layer config in both packages, bound to a default global
    config (wrappers take ``layer=(inner name, inner kw)``)."""
    if "layer" in kw:
        inner, inner_kw = kw.pop("layer")
        j = getattr(jrec, name)(layer=getattr(jrec, inner)(**inner_kw), **kw)
        t = getattr(trec, name)(layer=getattr(trec, inner)(**inner_kw), **kw)
    else:
        j, t = getattr(jrec, name)(**kw), getattr(trec, name)(**kw)
    j._g, t._g = jbase.GlobalConfig(), tbase.GlobalConfig()
    return j, t


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mask(rng, b):
    m = (np.arange(T)[None, :] < rng.integers(2, T + 1, b)[:, None]).astype(np.float32)
    m[1] = 0.0  # a row with every step masked
    return m


def _jax_forward_and_grads(jl, p, x, m, cot, carry=None):
    """The JAX layer's output and the gradients of sum(y * cot) in its
    params and input (from ``carry`` when given, else a zero carry)."""
    jm = None if m is None else jnp.asarray(m)

    def f(p_, x_):
        if carry is None:
            return jl.forward(p_, {}, x_, mask=jm)[0]
        return jl.forward_with_carry(p_, tuple(jnp.asarray(c) for c in carry), x_,
                                     mask=jm)[0]

    jp = jax.tree.map(jnp.asarray, p)
    y, vjp = jax.vjp(f, jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(cot))
    return np.asarray(y), _np_tree(gp), np.asarray(gx)


def _port_forward_and_grads(tl, p, x, m, cot, carry=None):
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(), p)
    tx = torch.from_numpy(x).requires_grad_()
    tm = None if m is None else torch.from_numpy(m)
    if carry is None:
        y, _ = tl.forward(tp, {}, tx, mask=tm)
    else:
        y, _ = tl.forward_with_carry(tp, tuple(torch.from_numpy(c) for c in carry), tx,
                                     mask=tm)
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves + [tx])
    return y.detach(), grads[:-1], grads[-1]


def _check_layer(jl, tl, p, x, m, what, carry=None):
    jm = None if m is None else jnp.asarray(m)
    y_shape = jax.eval_shape(lambda: jl.forward(jax.tree.map(jnp.asarray, p), {},
                                                jnp.asarray(x), mask=jm)[0]).shape
    cot = np.random.default_rng(5).normal(0, 1, y_shape).astype(np.float32)
    jy, jgp, jgx = _jax_forward_and_grads(jl, p, x, m, cot, carry)
    ty, tgp, tgx = _port_forward_and_grads(tl, p, x, m, cot, carry)
    _close(ty, jy, f"{what}: output")
    _close(tgx, jgx, f"{what}: d input")
    for i, (a, b) in enumerate(zip(tgp, jax.tree.leaves(jgp), strict=True)):
        _close(a, b, f"{what}: d param leaf {i}")


def _gru_params(jl, n_in, seed, b_rec=False):
    p, _ = jl.init(jax.random.PRNGKey(seed), JInputType.recurrent(n_in, T),
                   jbase.GlobalConfig())
    p = _np_tree(p)
    if b_rec:
        rng = np.random.default_rng(seed)
        p["b_rec"] = rng.normal(0, 0.3, (3 * jl.n_out,)).astype(np.float32)
    return p


# (id, GRU kwargs, masked, b_rec, batch, width): the default cell at the
# Pallas kernel's shape first, then every configuration the JAX package
# sends to lax.scan
GRU_CASES = [("kernel", {}, False, False, 8, 128),
             ("reset_before", {"reset_after": False}, False, False, 5, 32),
             ("b_rec", {}, False, True, 5, 32),
             ("reset_before_b_rec_masked", {"reset_after": False}, True, True, 5, 32),
             ("masked", {}, True, False, 5, 32),
             ("hard_sigmoid", {"gate_activation": "hard_sigmoid"}, False, False, 5, 32),
             ("softsign", {"activation": "softsign"}, True, False, 5, 32)]


@pytest.mark.parametrize("case,kw,masked,b_rec,b,hid", GRU_CASES, ids=[c[0] for c in GRU_CASES])
def test_gru_layer_matches_jax(monkeypatch, case, kw, masked, b_rec, b, hid):
    calls = []
    real = trec.fused_gru
    monkeypatch.setattr(trec, "fused_gru", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(len(case))
    jl, tl = _pair("GRU", n_out=hid, **kw)
    p = _gru_params(jl, NIN, 3, b_rec)
    x = rng.normal(0, 1, (b, T, NIN)).astype(np.float32)
    m = _mask(rng, b) if masked else None
    h0 = rng.normal(0, 1, (b, hid)).astype(np.float32)
    _check_layer(jl, tl, p, x, m, case)
    _check_layer(jl, tl, p, x, m, f"{case} from a carry", carry=(h0,))
    # the final carry
    jm = None if m is None else jnp.asarray(m)
    _, (jh,) = jl.forward_with_carry(jax.tree.map(jnp.asarray, p), (jnp.asarray(h0),),
                                     jnp.asarray(x), mask=jm)
    _, (th,) = tl.forward_with_carry(params_from_numpy(p), (torch.from_numpy(h0),),
                                     torch.from_numpy(x),
                                     mask=None if m is None else torch.from_numpy(m))
    _close(th, jh, f"{case}: final carry")
    assert bool(calls) == (case == "kernel")  # routing follows JAX :289-298


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_simple_rnn_matches_jax(masked):
    rng = np.random.default_rng(21)
    jl, tl = _pair("SimpleRnn", n_out=16, bias_init=0.1)
    p, _ = jl.init(jax.random.PRNGKey(4), JInputType.recurrent(NIN, T), jbase.GlobalConfig())
    p = _np_tree(p)
    x = rng.normal(0, 1, (5, T, NIN)).astype(np.float32)
    m = _mask(rng, 5) if masked else None
    _check_layer(jl, tl, p, x, m, "SimpleRnn")
    _check_layer(jl, tl, p, x, m, "SimpleRnn from a carry",
                 carry=(rng.normal(0, 1, (5, 16)).astype(np.float32),))


# (mode, masked, batch, width): concat at the Pallas kernel's shape (both
# directions reach the kernels), the other modes on the scan path
BIDI_CASES = [("concat", False, 8, 128), ("add", True, 5, 16), ("mul", False, 5, 16),
              ("average", True, 5, 16)]


@pytest.mark.parametrize("mode,masked,b,hid", BIDI_CASES, ids=[c[0] for c in BIDI_CASES])
def test_bidirectional_gru_matches_jax(monkeypatch, mode, masked, b, hid):
    calls = []
    real = trec.fused_gru
    monkeypatch.setattr(trec, "fused_gru", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(31)
    jl, tl = _pair("Bidirectional", layer=("GRU", {"n_out": hid}), mode=mode)
    p, _ = jl.init(jax.random.PRNGKey(6), JInputType.recurrent(NIN, T), jbase.GlobalConfig())
    p = _np_tree(p)
    assert sorted(p) == ["bwd", "fwd"]
    x = rng.normal(0, 1, (b, T, NIN)).astype(np.float32)
    m = _mask(rng, b) if masked else None
    _check_layer(jl, tl, p, x, m, f"Bidirectional {mode}")
    assert len(calls) == (0 if masked else 2)  # one call: forward and reversed
    want = jl.output_type(JInputType.recurrent(NIN, T))
    got = tl.output_type(TInputType.recurrent(NIN, T))
    assert (got.size, got.timesteps) == (want.size, want.timesteps)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_last_time_step_matches_jax(masked):
    rng = np.random.default_rng(41)
    jl, tl = _pair("LastTimeStep", layer=("GRU", {"n_out": 16}))
    p = _gru_params(jl.layer, NIN, 7)
    x = rng.normal(0, 1, (5, T, NIN)).astype(np.float32)
    m = _mask(rng, 5) if masked else None
    _check_layer(jl, tl, p, x, m, "LastTimeStep(GRU)")
    # bare: the last (mask-aware) step of its input
    jb, tb = _pair("LastTimeStep")
    jy, _ = jb.forward({}, {}, jnp.asarray(x), mask=None if m is None else jnp.asarray(m))
    ty, _ = tb.forward({}, {}, torch.from_numpy(x),
                       mask=None if m is None else torch.from_numpy(m))
    _close(ty, jy, "bare LastTimeStep")
    assert tl.output_type(TInputType.recurrent(NIN, T)).kind == "feedforward"


def _confs():
    """One configuration holding every new layer, built in both packages."""
    def build(C, rec, core, I, updater):
        return (C.builder().seed(7).updater(updater).list()
                .layer(rec.GRU(n_out=8, reset_after=False, gate_activation="hard_sigmoid"))
                .layer(rec.Bidirectional(layer=rec.GRU(n_out=6), mode="add"))
                .layer(rec.Bidirectional(layer=rec.SimpleRnn(n_out=5, activation="relu")))
                .layer(rec.LastTimeStep(layer=rec.GRU(n_out=4)))
                .layer(core.OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
                .set_input_type(I.recurrent(NIN)).build())
    return (build(JConf, jrec, jcore, JInputType, JRmsProp(1e-2)),
            build(TConf, trec, tcore, TInputType, RmsProp(1e-2)))


def test_configuration_json_round_trips_both_ways():
    from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JMLC
    jconf, tconf = _confs()
    want = json.loads(jconf.to_json())
    assert json.loads(tconf.to_json()) == want
    assert json.loads(tconfig.MultiLayerConfiguration.from_json(jconf.to_json()).to_json()) \
        == want
    assert json.loads(JMLC.from_json(tconf.to_json()).to_json()) == want
    layers = want["layers"]
    assert layers[0]["reset_after"] is False and layers[0]["gate_activation"] == "hard_sigmoid"
    assert layers[1]["layer"]["@type"] == "GRU" and layers[1]["mode"] == "add"
    assert layers[3]["layer"]["@type"] == "GRU"
    back = tconfig.MultiLayerConfiguration.from_json(jconf.to_json())
    assert isinstance(back.layers[2].layer, trec.SimpleRnn)
    assert [t.size for t in back.layer_input_types[1:]] == [8, 6, 10, 4]


def test_wrapper_network_through_archives_and_fit(tmp_path):
    """Every new layer in one network: a JAX archive restored by the port
    (nested ``{"bwd", "fwd"}`` leaves in ``coefficients.npz``) gives the
    same output; two RmsProp fits match; the port's archive resumes in JAX."""
    jconf, tconf = _confs()
    jnet = JNet(jconf).init()
    path = str(tmp_path / "jax.zip")
    JSerializer.write_model(jnet, path)
    net = MultiLayerNetwork.load(path, device="cpu")
    assert sorted(net.params()["layer_1"]) == ["bwd", "fwd"]
    rng = np.random.default_rng(51)
    x = rng.normal(0, 1, (6, T, NIN)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    _close(net.output(x), jnet.output(x), "output")
    jc, tc = JCollect(), CollectScoresListener()
    jnet.set_listeners(jc)
    net.set_listeners(tc)
    for _ in range(2):
        jnet.fit(x, y)
        net.fit(x, y)
    np.testing.assert_allclose([s for _, s in tc.scores], [s for _, s in jc.scores], rtol=1e-5)
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params),
                    strict=True):
        _close(a, b, "fitted params", rtol=0, atol=1e-6)
    out = str(tmp_path / "port.zip")
    net.save(out)
    jback = JSerializer.restore_model(out)
    _close(net.output(x), jback.output(x), "port archive in JAX")


# ---------------------------------------------------------------- char-RNN


def _char_rnn_conf(C, rec, I, updater):
    """The GRU char-RNN: ``zoo/textgen_lstm.py``'s network with GRU cells."""
    return (C.builder().seed(123).updater(updater).list()
            .layer(rec.GRU(n_out=HIDDEN, activation="tanh"))
            .layer(rec.GRU(n_out=HIDDEN, activation="tanh"))
            .layer(rec.RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(I.recurrent(VOCAB))
            .tbptt_fwd_length(TBPTT).tbptt_back_length(TBPTT).build())


def _one_hot(batch, seed, steps=SEQ):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (batch, steps + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    return eye[ids[:, :steps]], eye[ids[:, 1:]]


@pytest.fixture(scope="module")
def char_rnn_archive(tmp_path_factory):
    jnet = JNet(_char_rnn_conf(JConf, jrec, JInputType, JRmsProp(1e-3))).init()
    path = str(tmp_path_factory.mktemp("gru") / "jax-gru.zip")
    JSerializer.write_model(jnet, path)
    return path


def test_char_rnn_serves_from_the_registry_like_jax(char_rnn_archive):
    jnet = JSerializer.restore_model(char_rnn_archive)
    reference = MultiLayerNetwork.load(char_rnn_archive, device="cpu")
    assert json.loads(reference.conf.to_json()) == json.loads(jnet.conf.to_json())
    x, _ = _one_hot(3, 0)
    _close(reference.output(x), jnet.output(x), "output")
    reg = ModelRegistry()
    served = reg.load("gru", char_rnn_archive, device="cpu", max_batch_size=4,
                      batch_timeout_ms=20.0)
    requests = {i: _one_hot(1 + i % 3, 10 + i)[0] for i in range(6)}
    answers, errors = {}, []

    def client(i):
        try:
            answers[i] = reg.predict("gru", requests[i])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    reg.shutdown()
    assert not errors and not any(t.is_alive() for t in threads)
    for i, xr in requests.items():
        _close(answers[i], jnet.output(xr), f"request {i} vs JAX")
    assert not served.batcher._worker.is_alive()


def test_char_rnn_chunked_rnn_time_step_matches_jax(char_rnn_archive):
    jnet = JSerializer.restore_model(char_rnn_archive)
    net = MultiLayerNetwork.load(char_rnn_archive, device="cpu")
    x, _ = _one_hot(4, 1)
    whole = net.output(x).numpy()
    outs = []
    for s in range(0, SEQ, 4):
        out = net.rnn_time_step(x[:, s:s + 4])
        _close(out, jnet.rnn_time_step(x[:, s:s + 4]), f"chunk at {s}")
        outs.append(out.numpy())
        jstate, tstate = jnet.rnn_get_state(), net.rnn_get_state()
        assert sorted(jstate) == sorted(tstate)
        for k in jstate:
            assert len(tstate[k]) == len(jstate[k]) == 1  # the GRU carries (h,)
            _close(tstate[k][0], jstate[k][0], f"state {k} at {s}")
    _close(np.concatenate(outs, axis=1), whole, "chunks vs whole sequence")
    state = net.rnn_get_state()
    nxt, _ = _one_hot(4, 2, steps=3)
    ext, _ = net.rnn_time_step_external(nxt, state)
    net.rnn_set_state(state)
    _close(net.rnn_time_step(nxt), ext, "external step from a copied state")


def test_char_rnn_fit_with_rmsprop_matches_jax(char_rnn_archive, tmp_path):
    """Three steps: one batch of two tBPTT chunks (the GRU carry crosses the
    chunk boundary), then one of a single chunk; losses, parameters and the
    RmsProp moments; then the port's archive resumes in JAX."""
    jnet = JSerializer.restore_model(char_rnn_archive)
    net = MultiLayerNetwork.load(char_rnn_archive, device="cpu")
    jc, tc = JCollect(), CollectScoresListener()
    jnet.set_listeners(jc)
    net.set_listeners(tc)
    before = (fused_gru.save_counter.value, fused_gru.bwd_counter.value)
    for x, y in (_one_hot(8, 3), _one_hot(8, 4, steps=TBPTT)):
        jnet.fit(x, y)
        net.fit(x, y)
    assert (fused_gru.save_counter.value, fused_gru.bwd_counter.value) == before  # CPU
    assert [i for i, _ in tc.scores] == [i for i, _ in jc.scores] == [1, 2, 3]
    np.testing.assert_allclose([s for _, s in tc.scores], [s for _, s in jc.scores], rtol=1e-5)

    def same_state(jn, what):
        for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jn.train_state.params),
                        strict=True):
            _close(a, b, f"{what}: params", rtol=0, atol=1e-6)
        for a, b in zip(tree_leaves(net.updater_state()),
                        jax.tree.leaves(jn.train_state.opt_state), strict=True):
            _close(a, b, f"{what}: RmsProp moments", rtol=1e-4, atol=1e-12)

    same_state(jnet, "fit")
    path = str(tmp_path / "port-gru.zip")
    net.save(path)
    assert "updaterState.npz" in zipfile.ZipFile(path).namelist()
    jback = JSerializer.restore_model(path)
    same_state(jback, "restored in JAX")
