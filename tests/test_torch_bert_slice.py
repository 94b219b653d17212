"""The port's BERT serving slice against the JAX package, on the CPU.

Each attention layer, and ``Bert.small()`` as a whole, run on the same
weights in both packages: a JAX archive restored by the port and a port
archive restored by the JAX package, with and without a features mask,
with the encoder as blocks and as one stacked layer. Then the port's
``ModelRegistry`` serves the restored model from several threads, and a
masked row must give what the same row cut to its unmasked tokens gives.
Training parity lives in ``tests/test_torch_bert_train_slice.py``.

Float32 throughout. JAX runs off interpret mode, so its attention takes the
einsum form on the CPU while the port's takes the flash kernel's plain
version (dense scores, additive -1e30 bias where JAX replaces by -1e9: the
same softmax wherever a row attends a key). Tolerance ``rtol=atol=1e-4``:
the two sides sum the projections (128-3072 wide), the LayerNorm statistics
and the softmax in different orders, through two to twelve layers.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import attention_layers as jattn
from deeplearning4j_tpu.nn.base import GlobalConfig as JGlobalConfig
from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.inputs import InputType as JInputType
from deeplearning4j_tpu.ops.activations import single_pass_norm_stats as j_stats
from deeplearning4j_tpu.zoo import Bert as JBert
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serializer import params_from_numpy, tree_leaves
from deeplearning4j_tpu_torch.nn import attention_layers as tattn
from deeplearning4j_tpu_torch.nn.base import GlobalConfig
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import single_pass_norm_stats
from deeplearning4j_tpu_torch.ops.kernels import flash_attention as fa
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import ModelRegistry
from deeplearning4j_tpu_torch.zoo import Bert

RTOL, ATOL = 1e-4, 1e-4
VOCAB, T, BATCH = 1000, 16, 3
D, HEADS, FFN = 16, 2, 32  # per-layer checks


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_PALLAS_INTERPRET", raising=False)
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _ids(batch, seed, steps=T):
    return np.random.default_rng(seed).integers(0, VOCAB, (batch, steps))


def _mask(batch=BATCH, steps=T):
    m = np.ones((batch, steps), np.float32)
    m[1, 5:] = 0.0
    m[-1, 1:] = 0.0  # a row of one token
    return m


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.fixture(scope="module", params=[False, True], ids=["blocks", "stacked"])
def jax_archive(request, tmp_path_factory):
    net = JBert.small(stacked=request.param).init()
    path = str(tmp_path_factory.mktemp("bert") / "jax.zip")
    JSerializer.write_model(net, path)
    return net, path, request.param


# ------------------------------------------------------------- whole slice


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "features_mask"])
def test_jax_archive_restored_by_the_port_gives_the_same_probabilities(jax_archive, masked):
    jnet, path, _ = jax_archive
    net = MultiLayerNetwork.load(path, device="cpu")
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params),
                    strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = _ids(BATCH, 0)
    m = _mask() if masked else None
    got = net.output(x, mask=m).numpy()
    assert got.shape == (BATCH, 2)
    _close(got, jnet.output(x, mask=m), "probabilities")


def test_port_archive_restored_by_the_jax_package(jax_archive, tmp_path):
    _, _, stacked = jax_archive
    net = Bert.small(stacked=stacked).init(device="cpu")
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(net, path)
    jnet = JSerializer.restore_model(path)
    x = _ids(2, 1)
    for m in (None, _mask(2)):
        _close(jnet.output(x, mask=m), net.output(x, mask=m).numpy(), f"mask={m is not None}")
    again = MultiLayerNetwork.load(path, device="cpu")
    torch.testing.assert_close(again.output(x), net.output(x), rtol=0, atol=0)


def test_configuration_json_round_trips_between_packages(jax_archive):
    jnet, _, stacked = jax_archive
    conf = MultiLayerConfiguration.from_json(jnet.conf.to_json())
    assert [type(l).__name__ for l in conf.layers] == \
        [type(l).__name__ for l in jnet.conf.layers]
    assert json_layers(conf.to_json()) == json_layers(jnet.conf.to_json())
    back = JConf.from_json(Bert.small(stacked=stacked).conf().to_json())
    assert json_layers(back.to_json()) == json_layers(jnet.conf.to_json())
    assert conf.global_conf.updater.to_dict() == {"@type": "Adam", "learning_rate": 2e-5,
                                                  "beta1": 0.9, "beta2": 0.999,
                                                  "epsilon": 1e-8}


def json_layers(s):
    return json.loads(s)["layers"]


@pytest.mark.parametrize("length", [1, 5, T])
def test_masked_row_equals_the_row_cut_to_its_tokens(jax_archive, length):
    _, path, _ = jax_archive
    net = MultiLayerNetwork.load(path, device="cpu")
    x = _ids(2, 2)
    m = np.ones((2, T), np.float32)
    m[0, length:] = 0.0
    full = net.output(x, mask=m).numpy()
    cut = net.output(x[:1, :length]).numpy()
    np.testing.assert_allclose(full[:1], cut, rtol=1e-5, atol=1e-6)


def test_bfloat16_compute_stays_near_float32(jax_archive):
    _, path, _ = jax_archive
    net = MultiLayerNetwork.load(path, device="cpu")
    x = _ids(BATCH, 3)
    want = net.output(x, mask=_mask()).numpy()
    get_environment().allow_bfloat16()
    got = net.output(x, mask=_mask())
    assert got.dtype == torch.bfloat16
    # bf16 keeps 8 bits: two layers of rounded activations move a softmax
    # probability by a few hundredths at most
    np.testing.assert_allclose(got.float().numpy(), want, atol=5e-2)


def test_cpu_path_launches_no_kernel(jax_archive):
    _, path, _ = jax_archive
    before = (fa.counter.value, fa.lse_counter.value)
    MultiLayerNetwork.load(path, device="cpu").output(_ids(2, 4), mask=_mask(2))
    assert (fa.counter.value, fa.lse_counter.value) == before


def _pad(x, bucket):
    out = np.zeros((bucket,) + x.shape[1:], x.dtype)
    out[:x.shape[0]] = x
    return out


def test_registry_serves_token_ids_from_threads(jax_archive):
    _, path, _ = jax_archive
    reference = MultiLayerNetwork.load(path, device="cpu")
    reg = ModelRegistry()
    served = reg.load("bert", path, device="cpu", max_batch_size=8, batch_timeout_ms=20.0)
    requests = {i: _ids(1 + i % 4, 10 + i) for i in range(6)}
    answers, errors = {}, []

    def client(i):
        try:
            answers[i] = reg.predict("bert", requests[i])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in requests]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, x in requests.items():
        assert answers[i].shape == (x.shape[0], 2) and answers[i].dtype == np.float32
        for bucket in served.batcher.buckets:
            if bucket >= x.shape[0]:
                _close(answers[i], reference.output(_pad(x, bucket)).numpy()[:x.shape[0]],
                       f"request {i} at bucket {bucket}")
    reg.shutdown()
    assert not served.batcher._worker.is_alive()


@pytest.mark.parametrize("bad", ["too_long", "id_out_of_range", "negative_id"])
def test_embedding_refuses_what_it_cannot_look_up(jax_archive, bad):
    _, path, _ = jax_archive
    net = MultiLayerNetwork.load(path, device="cpu")
    x = {"too_long": _ids(1, 5, steps=129), "id_out_of_range": np.full((1, 4), VOCAB),
         "negative_id": np.full((1, 4), -1)}[bad]
    with pytest.raises(ValueError, match="max_len" if bad == "too_long" else "token ids"):
        net.output(x)


def test_fit_raises_by_name_on_the_unported_adam_math(jax_archive):
    """AdaMax, once refused by name here, now trains the BERT from the JAX
    archive: after one ``fit`` step under AdaMax(2e-5) the port's state has
    the leaves of the JAX network's AdaMax ``opt_state`` (order, shapes,
    dtypes), and the step is optax's ``adamax`` on the same gradients (read
    back from the first moment, mu = (1 - b1) g; dropout makes them the
    port's own, not the JAX package's)."""
    import optax

    from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
    from deeplearning4j_tpu_torch.train.updaters import AdaMax
    _, path, _ = jax_archive
    net = MultiLayerNetwork.load(path, device="cpu")
    net.conf.global_conf.updater = AdaMax(2e-5)
    before = {k: [t.numpy().copy() for t in tree_leaves(v)] for k, v in net.params().items()}
    y = np.eye(2, dtype=np.float32)[[0, 1]]
    net.fit(_ids(2, 5), y)
    jstate = JNet(JConf.from_json(net.conf.to_json())).init().train_state.opt_state
    tstate = net.updater_state()
    assert [(tuple(a.shape), np.asarray(a).dtype.name) for a in jax.tree.leaves(jstate)] == \
        [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in tree_leaves(tstate)]
    tx = optax.adamax(2e-5, b1=0.9, b2=0.999, eps=1e-8)
    for k, st in tstate.items():
        assert int(st["count"]) == 1
        grads = [jnp.asarray(m.numpy()) / (1.0 - 0.9) for m in tree_leaves(st["mu"])]
        params = [jnp.asarray(a) for a in before[k]]
        want, _ = tx.update(grads, tx.init(params))
        want = optax.apply_updates(params, want)
        for i, (w, p1) in enumerate(zip(want, tree_leaves(net.params()[k]), strict=True)):
            np.testing.assert_allclose(p1.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9,
                                       err_msg=f"{k} leaf {i}")


# -------------------------------------------------------------- each layer


def _jax_layer(layer, input_type, seed=0):
    layer._g = JGlobalConfig()
    params, _ = layer.init(jax.random.PRNGKey(seed), input_type, layer._g)
    return params


def _port(layer_cls, **kw):
    layer = layer_cls(**kw)
    layer._g = GlobalConfig()
    return layer


def _x(seed, batch=BATCH, steps=T, width=D):
    return np.random.default_rng(seed).standard_normal((batch, steps, width)).astype(np.float32)


def _run_both(jlayer, tlayer, params, x, mask=None):
    want, _ = jlayer.forward(params, {}, jnp.asarray(x), training=False, rng=None,
                             mask=None if mask is None else jnp.asarray(mask))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    got, _ = tlayer.forward(tparams, {}, torch.from_numpy(np.asarray(x)), training=False,
                            mask=None if mask is None else torch.from_numpy(mask))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_self_attention_layer(masked):
    jl = jattn.SelfAttentionLayer(n_heads=HEADS)
    params = _jax_layer(jl, JInputType.recurrent(D, T))
    want, got = _run_both(jl, _port(tattn.SelfAttentionLayer, n_heads=HEADS), params,
                          _x(1), _mask() if masked else None)
    _close(got, want, "self attention")


def test_transformer_encoder_block_with_mask():
    jl = jattn.TransformerEncoderBlock(n_heads=HEADS, ffn_size=FFN)
    params = _jax_layer(jl, JInputType.recurrent(D, T))
    assert sorted(params) == ["W_ff1", "W_ff2", "attn", "b_ff1", "b_ff2", "ln1_beta",
                              "ln1_gamma", "ln2_beta", "ln2_gamma"]
    want, got = _run_both(jl, _port(tattn.TransformerEncoderBlock, n_heads=HEADS,
                                     ffn_size=FFN), params, _x(2), _mask())
    _close(got, want, "encoder block")


def test_transformer_encoder_stack_loops_over_the_layer_axis():
    jl = jattn.TransformerEncoderStack(n_layers=3, n_heads=HEADS, ffn_size=FFN)
    params = _jax_layer(jl, JInputType.recurrent(D, T))
    assert np.asarray(params["stack"]["attn"]["W_q"]).shape == (3, D, D)
    want, got = _run_both(jl, _port(tattn.TransformerEncoderStack, n_layers=3,
                                     n_heads=HEADS, ffn_size=FFN), params, _x(3), _mask())
    _close(got, want, "encoder stack")


def test_port_init_draws_the_jax_shapes_and_names():
    it = JInputType.recurrent(D, T)
    for jl, tl in ((jattn.TransformerEncoderStack(n_layers=2, n_heads=HEADS, ffn_size=FFN),
                    _port(tattn.TransformerEncoderStack, n_layers=2, n_heads=HEADS,
                          ffn_size=FFN)),
                   (jattn.BertEmbeddingLayer(vocab_size=50, d_model=D, max_len=T),
                    _port(tattn.BertEmbeddingLayer, vocab_size=50, d_model=D, max_len=T)),
                   (jattn.LearnedPositionalEmbeddingLayer(max_len=T),
                    _port(tattn.LearnedPositionalEmbeddingLayer, max_len=T))):
        want = jax.tree.map(lambda a: np.asarray(a).shape, _jax_layer(jl, it))
        got, _ = tl.init(torch.Generator().manual_seed(0), InputType.recurrent(D, T),
                         GlobalConfig())
        assert jax.tree.map(lambda t: tuple(t.shape), got) == want


def test_bert_embedding_layer_gathers_int64_ids():
    jl = jattn.BertEmbeddingLayer(vocab_size=50, d_model=D, max_len=T)
    params = _jax_layer(jl, JInputType.recurrent(1, T))
    ids = np.random.default_rng(4).integers(0, 50, (BATCH, T - 3))
    want, got = _run_both(jl, _port(tattn.BertEmbeddingLayer, vocab_size=50, d_model=D,
                                     max_len=T), params, ids)
    _close(got, want, "embeddings")


def test_cls_pooling_and_learned_positions():
    x = _x(5)
    want, got = _run_both(jattn.ClsPoolingLayer(index=2), _port(tattn.ClsPoolingLayer, index=2),
                          {}, x)
    np.testing.assert_array_equal(got, want)
    jl = jattn.LearnedPositionalEmbeddingLayer(max_len=T + 4)
    params = _jax_layer(jl, JInputType.recurrent(D, T))
    want, got = _run_both(jl, _port(tattn.LearnedPositionalEmbeddingLayer, max_len=T + 4),
                          params, x)
    _close(got, want, "positions")


@pytest.mark.parametrize("offset", [0.0, 1e4], ids=["centred", "large_mean"])
def test_layer_norm_and_its_single_pass_stats(offset):
    x = _x(6) * 0.01 + offset
    rng = np.random.default_rng(7)
    gamma = rng.standard_normal(D).astype(np.float32)
    beta = rng.standard_normal(D).astype(np.float32)
    jm, jv = j_stats(jnp.asarray(x), -1)
    tm, tv = single_pass_norm_stats(torch.from_numpy(x), -1)
    _close(tm.numpy(), jm, "mean")
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-3, atol=1e-9)
    want = jattn.layer_norm(jnp.asarray(x), gamma, beta)
    got = tattn.layer_norm(torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta))
    _close(got.numpy(), want, "layer norm")
