"""The port's BERT fine-tuning slice against the JAX package, on the CPU.

``Bert.small(dropout_rate=0.0)`` (L=2, H=128, A=2) is initialised by the
JAX package, written to an archive and restored by the port, with the
encoder as blocks and as one stacked layer. Both packages then ``fit`` the
same three batches of T=128 token ids (rows padded by a features mask)
under the zoo's ``Adam(2e-5)``. T=128 lets the JAX side run its Pallas
flash-attention kernels, forward and backward, in interpret mode; the port
runs its flash autograd Function with the plain versions. Per-step losses,
the final parameters and Adam's count, mu and nu must agree; then archives
with ``updaterState.npz`` must resume identically in either package.

Tolerances (float32): losses ``rtol=1e-5`` (the same math summed in other
orders). Parameters ``atol=5e-6``, a quarter of one Adam step: Adam moves a
weight by about ``lr = 2e-5`` per step whatever its gradient's size, so
gradients a few ulps apart move the weights far less than a step, except
where a gradient is mostly rounding noise (some elements of ``W_k``, whose
gradient cancels along the directions the softmax ignores). The key bias
``b_k`` is all noise: a key bias adds the same ``q . b_k`` to every score of
a row, which the softmax cancels, so its gradient is zero in exact
arithmetic and each package's Adam steps follow its own rounding; it is held
only to Adam's largest steps, and its moments to noise size. mu and nu of
every other leaf within ``1e-4`` of that leaf's largest value.
"""

import zipfile

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import attention_layers as jattn
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JCollect
from deeplearning4j_tpu.zoo import Bert as JBert
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import attention_layers as tattn
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.zoo import Bert

VOCAB, T, B = 1000, 128, 4
LR = 2e-5
PARAM_ATOL = 5e-6


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PALLAS_INTERPRET", "1")
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _batches(n, seed):
    """``n`` batches of (ids, one-hot labels, features mask): row 1 padded
    after 70 tokens, row 2 a single token, row 3 a random length."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.integers(0, VOCAB, (B, T))
        m = np.ones((B, T), np.float32)
        m[1, 70:] = 0.0
        m[2, 1:] = 0.0
        m[3, rng.integers(2, T):] = 0.0
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, B)]
        out.append((x, y, m))
    return out


def _paths(tree, prefix=""):
    """Leaf paths in tree_leaves order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _assert_same_training_state(net, jnet, what):
    jparams = jax.tree.leaves(jnet.train_state.params)
    for path, t, j in zip(_paths(net.params()), tree_leaves(net.params()), jparams,
                          strict=True):
        diff = float(np.abs(t.numpy() - np.asarray(j)).max())
        # b_k: zero gradient in exact arithmetic, Adam steps of rounding noise
        limit = 2 * 3 * LR if path.endswith("/b_k") else PARAM_ATOL
        assert diff <= limit, f"{what}: parameter {path} differs by {diff:.3g} > {limit:g}"
    state = net.updater_state()
    jleaves = jax.tree.leaves(jnet.train_state.opt_state)
    tleaves = tree_leaves(state)
    assert len(jleaves) == len(tleaves)
    for path, t, j in zip(_paths(state), tleaves, jleaves):
        j = np.asarray(j)
        if path.endswith("/count"):
            assert t.dtype == torch.int32 and j.dtype == np.int32
            assert int(t) == int(j), f"{what}: {path}"
        elif path.endswith("/b_k"):
            assert float(np.abs(t.numpy()).max()) <= 1e-6 and float(np.abs(j).max()) <= 1e-6
        else:
            scale = float(np.abs(j).max())
            diff = float(np.abs(t.numpy() - j).max())
            assert diff <= 1e-4 * scale, f"{what}: {path} differs by {diff:.3g} (max {scale:.3g})"


def _assert_same_scores(port, jax_, what):
    assert [i for i, _ in port] == [i for i, _ in jax_], what
    np.testing.assert_allclose([s for _, s in port], [s for _, s in jax_], rtol=1e-5,
                               err_msg=what)


@pytest.fixture(scope="module", params=[False, True], ids=["blocks", "stacked"])
def jax_archive(request, tmp_path_factory):
    net = JBert.small(dropout_rate=0.0, stacked=request.param).init()
    path = str(tmp_path_factory.mktemp("bert_train") / "jax.zip")
    JSerializer.write_model(net, path)
    return path, request.param


def test_fit_under_adam_matches_jax(jax_archive):
    path, stacked = jax_archive
    jnet = JSerializer.restore_model(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    jc, tc = JCollect(), CollectScoresListener()
    jnet.set_listeners(jc)
    net.set_listeners(tc)
    for x, y, m in _batches(3, seed=1):
        jnet.fit(x, y, mask=m)
        net.fit(x, y, mask=m)
    assert len(tc.scores) == 3
    _assert_same_scores(tc.scores, jc.scores, f"stacked={stacked}")
    _assert_same_training_state(net, jnet, f"stacked={stacked}")
    assert int(net.updater_state()["layer_0"]["count"]) == 3


def test_jax_archive_resumes_in_the_port_with_adam_state(tmp_path):
    (x1, y1, m1), (x2, y2, m2) = _batches(2, seed=2)
    jnet = JBert.small(dropout_rate=0.0, stacked=True).init()
    jnet.fit(x1, y1, mask=m1)
    path = str(tmp_path / "jax.zip")
    JSerializer.write_model(jnet, path)
    net = MultiLayerNetwork.load(path, device="cpu")
    _assert_same_training_state(net, jnet, "restored")
    jnet.set_listeners(jc := JCollect())
    net.set_listeners(tc := CollectScoresListener())
    jnet.fit(x2, y2, mask=m2)
    net.fit(x2, y2, mask=m2)
    _assert_same_scores(tc.scores, jc.scores, "resumed")
    _assert_same_training_state(net, jnet, "resumed")


def test_port_archive_resumes_in_jax_with_adam_state(tmp_path):
    (x1, y1, m1), (x2, y2, m2) = _batches(2, seed=3)
    net = Bert.small(dropout_rate=0.0, stacked=True).init(device="cpu")
    net.fit(x1, y1, mask=m1)
    path = str(tmp_path / "port.zip")
    net.save(path)
    with zipfile.ZipFile(path) as zf:
        import io
        leaves = np.load(io.BytesIO(zf.read("updaterState.npz")))
        assert leaves["leaf_0"].dtype == np.int32 and leaves["leaf_0"].shape == ()
    jnet = JSerializer.restore_model(path)
    _assert_same_training_state(net, jnet, "restored")
    again = MultiLayerNetwork.load(path, device="cpu")
    jnet.set_listeners(jc := JCollect())
    again.set_listeners(tc := CollectScoresListener())
    jnet.fit(x2, y2, mask=m2)
    again.fit(x2, y2, mask=m2)
    _assert_same_scores(tc.scores, jc.scores, "resumed")
    _assert_same_training_state(again, jnet, "resumed")
    assert int(again.updater_state()["layer_1"]["count"]) == 2


def test_dropout_statistics_match_jax():
    """At rate 0.1 both packages keep about 90% of the activations and
    scale the kept ones by 1/0.9 (the masks come from each package's own
    stream); a block's training forward runs on them."""
    x = np.ones((64, 32, 40), np.float32)
    jl = jattn.TransformerEncoderBlock(n_heads=2, ffn_size=16, dropout_rate=0.1)
    jd = np.asarray(jl._dropout_fn(jax.numpy.asarray(x), True, jax.random.PRNGKey(0)))
    td = tattn._dropout(torch.from_numpy(x), 0.1, True, torch.Generator().manual_seed(0)).numpy()
    for d in (jd, td):
        assert set(np.unique(d)) <= {0.0, np.float32(1 / 0.9)}
        assert abs((d == 0).mean() - 0.1) < 0.01
    np.testing.assert_array_equal(tattn._dropout(torch.from_numpy(x), 0.1, False, None).numpy(), x)


def test_dropout_draws_differ_per_step_and_follow_the_rng_stream():
    """Training with dropout: two nets from one seed take identical steps
    (the masks come from the network's RngManager stream), and dropout
    changes the loss against the same net at rate 0."""
    x, y, m = _batches(1, seed=4)[0]

    def losses(rate):
        net = Bert.small(dropout_rate=rate).init(device="cpu")
        net.set_listeners(c := CollectScoresListener())
        for _ in range(2):
            net.fit(x, y, mask=m)
        return [s for _, s in c.scores]

    a, b, none = losses(0.1), losses(0.1), losses(0.0)
    assert a == b
    assert a[0] != none[0]
