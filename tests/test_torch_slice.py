"""The port's serving slice against the JAX package, end to end on the CPU.

A ``TextGenerationLSTM`` archive written by the JAX package is restored by
the port (and the other way round); ``output``, the chunked
``rnn_time_step`` and its stored states must agree. Then the port's
``ModelRegistry``/``ContinuousBatcher`` serves it from several threads.

Float32 throughout, ``rtol=1e-4, atol=1e-5``: the summation order of
``h @ W_rec`` over T steps differs between the packages.
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.zoo import TextGenerationLSTM as JText
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.kernels import fused_lstm, fused_lstm_graves
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.serving import (ContinuousBatcher, ModelRegistry,
                                              ServingShutdown, default_buckets)
from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

RTOL, ATOL = 1e-4, 1e-5
VOCAB, HIDDEN, T = 20, 128, 12


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_PALLAS_INTERPRET", raising=False)
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _one_hot(batch, seed, steps=T):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (batch, steps))
    return np.eye(VOCAB, dtype=np.float32)[ids]


@pytest.fixture(scope="module", params=[True, False], ids=["graves", "plain"])
def jax_archive(request, tmp_path_factory):
    net = JText(vocab_size=VOCAB, hidden=HIDDEN, graves=request.param).init()
    path = str(tmp_path_factory.mktemp("archives") / "jax.zip")
    JSerializer.write_model(net, path)
    return net, path


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def test_jax_archive_restored_by_the_port_gives_the_same_output(jax_archive):
    jnet, path = jax_archive
    net = MultiLayerNetwork.load(path, device="cpu")
    for k, layer in jnet.train_state.params.items():
        for name, leaf in layer.items():
            np.testing.assert_array_equal(net.params()[k][name].numpy(), np.asarray(leaf))
    x = _one_hot(3, 0)
    _close(net.output(x).numpy(), jnet.output(x), "output")
    mask = np.ones((3, T), np.float32)
    mask[1, 7:] = 0.0
    _close(net.output(x, mask=mask).numpy(), jnet.output(x, mask=mask), "masked output")


def test_chunked_rnn_time_step_and_states_match_jax(jax_archive):
    jnet, path = jax_archive
    net = ModelSerializer.restore_multi_layer_network(path, device="cpu")
    x = _one_hot(4, 1)
    whole = net.output(x).numpy()
    jnet.rnn_clear_previous_state()
    outs = []
    for s in range(0, T, 4):
        chunk = x[:, s:s + 4]
        out = net.rnn_time_step(chunk).numpy()
        _close(out, jnet.rnn_time_step(chunk), f"chunk at {s}")
        outs.append(out)
        jstate, tstate = jnet.rnn_get_state(), net.rnn_get_state()
        assert sorted(jstate) == sorted(tstate)
        for k in jstate:
            for j_leaf, t_leaf in zip(jstate[k], tstate[k]):
                _close(t_leaf.numpy(), j_leaf, f"state {k} at {s}")
    _close(np.concatenate(outs, axis=1), whole, "chunks vs whole sequence")
    # the pure-functional step from a copied state gives the same answer
    state = net.rnn_get_state()
    nxt = _one_hot(4, 2, steps=3)
    ext, new_state = net.rnn_time_step_external(nxt, state)
    _close(ext.numpy(), net.rnn_time_step(nxt).numpy(), "external step")
    for k in new_state:
        for a, b in zip(new_state[k], net.rnn_get_state()[k]):
            _close(a.numpy(), b.numpy(), "external state")
    net.rnn_set_state(state)
    _close(net.rnn_time_step(nxt).numpy(), ext.numpy(), "rnn_set_state")
    net.rnn_clear_previous_state()
    zero = net.rnn_zero_state(4, like=x)
    _close(net.rnn_time_step_external(x, zero)[0].numpy(), whole, "zero state")


def test_port_archive_restored_by_the_jax_package(tmp_path):
    for graves in (True, False):
        net = TextGenerationLSTM(vocab_size=VOCAB, hidden=HIDDEN, graves=graves).init(
            device="cpu")
        path = str(tmp_path / f"port-{graves}.zip")
        ModelSerializer.write_model(net, path)
        jnet = JSerializer.restore_model(path)
        assert type(jnet).__name__ == "MultiLayerNetwork"
        x = _one_hot(2, 3)
        _close(np.asarray(jnet.output(x)), net.output(x).numpy(), f"graves={graves}")
        again = MultiLayerNetwork.load(path, device="cpu")
        torch.testing.assert_close(again.output(x), net.output(x), rtol=0, atol=0)


def test_cpu_path_launches_no_kernel(jax_archive):
    _, path = jax_archive
    before = (fused_lstm.counter.value, fused_lstm_graves.counter.value)
    MultiLayerNetwork.load(path, device="cpu").output(_one_hot(2, 4))
    assert (fused_lstm.counter.value, fused_lstm_graves.counter.value) == before


def _pad(x, bucket):
    out = np.zeros((bucket,) + x.shape[1:], x.dtype)
    out[:x.shape[0]] = x
    return out


def test_registry_answers_from_threads_equal_output_at_the_bucket(jax_archive):
    _, path = jax_archive
    reference = MultiLayerNetwork.load(path, device="cpu")
    reg = ModelRegistry()
    served = reg.load("char-rnn", path, device="cpu", max_batch_size=8,
                      batch_timeout_ms=20.0)
    assert reg.get("char-rnn") is served
    assert served.batcher.buckets == default_buckets(8) == [1, 2, 4, 8]
    requests = {i: _one_hot(1 + i % 3, 10 + i) for i in range(8)}
    answers, errors = {}, []

    def client(i):
        try:
            answers[i] = reg.predict("char-rnn", requests[i])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4, 8)] + \
        [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sum(served.batcher.bucket_counts.values()) == served.batcher.batches >= 1
    for i, x in requests.items():
        assert answers[i].shape == (x.shape[0], T, VOCAB)
        # coalescing picks the bucket; at every bucket a row's answer is the
        # same up to summation order
        for bucket in served.batcher.buckets:
            if bucket >= x.shape[0]:
                _close(answers[i], reference.output(_pad(x, bucket)).numpy()[:x.shape[0]],
                       f"request {i} at bucket {bucket}")
    worker = served.batcher._worker
    reg.shutdown()
    assert not worker.is_alive()
    assert not [t for t in threading.enumerate() if t.name == "ContinuousBatcher"]
    with pytest.raises(KeyError):
        reg.get("char-rnn")
    with pytest.raises(ServingShutdown):
        served.predict(requests[0])


def test_batcher_drains_on_shutdown_and_splits_oversized_requests(jax_archive):
    _, path = jax_archive
    net = MultiLayerNetwork.load(path, device="cpu")
    batcher = ContinuousBatcher(net, max_batch_size=4, batch_timeout_ms=50.0)
    results = {}

    def client(i, rows):
        results[i] = batcher.submit(_one_hot(rows, 20 + i))

    threads = [threading.Thread(target=client, args=(i, r))
               for i, r in enumerate((1, 3, 6))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    batcher.shutdown(drain=True)
    assert {i: r.shape[0] for i, r in results.items()} == {0: 1, 1: 3, 2: 6}
    assert 8 in batcher.buckets  # the oversized request minted the next power of two
    assert not batcher._worker.is_alive()


class _RowTagModel:
    """A model whose every output row is its input row doubled: a request
    that got another request's rows back shows at once."""

    def output(self, x):
        return torch.from_numpy(np.asarray(x) * 2.0)


def test_batcher_stress_never_mixes_rows_between_requests():
    """More client threads than cores, a tiny switch interval, requests of
    1-5 rows: every answer must be exactly its own input doubled."""
    import sys
    batcher = ContinuousBatcher(_RowTagModel(), max_batch_size=8, batch_timeout_ms=1.0)
    errors = []

    def client(c):
        rng = np.random.default_rng(c)
        try:
            for k in range(25):
                x = rng.integers(0, 10**6, (int(rng.integers(1, 6)), 3)).astype(np.float64)
                x[:, 0] = c * 1000 + k
                got = batcher.submit(x)
                if not np.array_equal(got, 2.0 * x):
                    errors.append((c, k))
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        batcher.shutdown(drain=True)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert batcher.batches < 32 * 25  # requests were coalesced
    assert not batcher._worker.is_alive()
