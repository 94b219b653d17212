"""The port's ``DistributedTrainer`` (threshold-encoded gradient exchange)
against the JAX package (``tests/test_distributed.py``).

- Loopback (one process simulating every rank) against a hand-rolled
  sequential shard loop, bit for bit; against the live JAX loopback trainer
  from the same archive: at threshold 0 within ``rtol 1e-5, atol 1e-6`` over
  two epochs, at threshold 1e-3 within ``atol 1e-3`` in the weights over 3
  steps (a threshold decision flips on a gradient's last ulp and moves a
  weight by lr * threshold). The JAX reference's own "loss falls" checks
  fail on this problem under jax 0.9.0, so the trajectory is held to a live
  JAX run instead.
- Two gloo processes on the CPU equal the loopback oracle bit for bit, at
  threshold 0 and 1e-3; a chaos fault kills one worker and the supervisor
  restarts the group, which resumes exactly; a crash loop escalates.
- Compression, the dense transport at threshold 0, re-sync, the profiler's
  exchange headline, chaos at both points, checkpoint resume and the
  residual guard.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.train.distributed import DistributedConfig as JConfig
from deeplearning4j_tpu.train.distributed import DistributedTrainer as JTrainer
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime import chaos
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train import Adam, Sgd, TrainingProfiler
from deeplearning4j_tpu_torch.train.distributed import (DistributedConfig, DistributedSupervisor,
                                                        DistributedTrainer, ExchangeError,
                                                        live_worker_pids)
from deeplearning4j_tpu_torch.train.fault_tolerance import TrainingFailure

FEATURES, CLASSES, B, N_BATCHES = 16, 4, 8, 6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield env
    env.device, env.default_dtype, env.compute_dtype = saved
    assert not live_worker_pids()


def _conf(updater=None, seed=7):
    return (NeuralNetConfiguration.builder().seed(seed).updater(updater or Sgd(0.1)).list()
            .layer(DenseLayer(n_out=32, activation="relu"))
            .layer(OutputLayer(n_out=CLASSES, activation="softmax"))
            .set_input_type(InputType.feed_forward(FEATURES)).build())


def _arrays(n=N_BATCHES, batch=B, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(batch, FEATURES)).astype(np.float32),
             np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, batch)])
            for _ in range(n)]


def _iterator():
    return ListDataSetIterator([DataSet(x, y) for x, y in _arrays()], batch_size=B)


def _params(net):
    return [np.asarray(t) for t in tree_leaves(net.params())]


def _fit_loopback(threshold, world=2, epochs=2, updater=None, net=None, **cfg_kw):
    net = net or MultiLayerNetwork(_conf(updater)).init()
    tr = DistributedTrainer(net, DistributedConfig(threshold=threshold, **cfg_kw),
                            world=world, rank=None)
    tr.fit(_iterator(), epochs=epochs)
    return tr


# ------------------------------------------------------------------ loopback
def test_loopback_dense_matches_sequential_shard_oracle():
    """threshold 0, derived independently: the combined update is the
    rank-ordered sum of the per-shard gradients / world, applied by the
    network's optimizer."""
    tr = _fit_loopback(0.0, world=2, epochs=1)
    net = MultiLayerNetwork(_conf()).init()
    losses = []
    for x, y in _arrays():
        seed = int(torch.randint(0, 2 ** 62, (), generator=net.rng.next_generator()))
        shard_losses, flats = [], []
        for r in range(2):
            lo = r * (B // 2)
            leaves = tree_leaves(net._params)
            for t in leaves:
                t.requires_grad_(True)
            loss, _, _ = net._loss(net._params, net._model_state, torch.from_numpy(x[lo:lo + 4]),
                                   torch.from_numpy(y[lo:lo + 4]),
                                   torch.Generator().manual_seed(seed))
            grads = torch.autograd.grad(loss, leaves)
            for t in leaves:
                t.requires_grad_(False)
            shard_losses.append(float(np.float32(float(loss.detach()))))
            flats.append(torch.cat([g.reshape(-1) for g in grads]).numpy() / np.float32(2))
        combined = np.zeros_like(flats[0])
        combined += flats[0]
        combined += flats[1]
        off, per = 0, []
        for t in tree_leaves(net._params):
            per.append(torch.from_numpy(combined[off:off + t.numel()].reshape(t.shape)))
            off += t.numel()
        from deeplearning4j_tpu_torch.runtime.trees import tree_unflatten_like
        net._ensure_optimizer().step(net._params, tree_unflatten_like(net._params, per))
        losses.append((shard_losses[0] + shard_losses[1]) / 2)
    assert losses == tr.losses
    for a, b in zip(_params(net), _params(tr.net)):
        np.testing.assert_array_equal(a, b)


def _jax_pair(tmp_path, updater="sgd"):
    jconf = (JConf.builder().seed(7).updater(JSgd(0.1)).list()
             .layer(JDense(n_out=32, activation="relu"))
             .layer(JOutput(n_out=CLASSES, activation="softmax"))
             .set_input_type(JInputType.feed_forward(FEATURES)).build())
    jnet = JNet(jconf).init()
    path = str(tmp_path / "d.zip")
    JSerializer.write_model(jnet, path)
    return jnet, ModelSerializer.restore_model(path, device="cpu")


def _jax_iterator():
    return JList([JDataSet(x, y) for x, y in _arrays()], batch_size=B)


def test_loopback_dense_matches_live_jax_loopback(tmp_path):
    import jax
    jnet, net = _jax_pair(tmp_path)
    jtr = JTrainer(jnet, JConfig(threshold=0.0), world=2, rank=None)
    jtr.fit(_jax_iterator(), epochs=2)
    tr = _fit_loopback(0.0, net=net)
    np.testing.assert_allclose(tr.losses, jtr.losses, rtol=1e-5, atol=1e-6)
    for a, b in zip(_params(net), jax.tree.leaves(jnet.train_state.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    assert tr.stats.report()["comms_bytes_per_step"] == jtr.stats.report()["comms_bytes_per_step"]


def test_loopback_encoded_short_horizon_matches_live_jax(tmp_path):
    import jax
    jnet, net = _jax_pair(tmp_path)
    jtr = JTrainer(jnet, JConfig(threshold=1e-3), world=2, rank=None)
    tr = DistributedTrainer(net, DistributedConfig(threshold=1e-3), world=2, rank=None)
    for x, y in _arrays()[:3]:
        jtr.step(x, y)
        tr.step(x, y)
    np.testing.assert_allclose(tr.losses, jtr.losses, rtol=1e-5, atol=1e-5)
    for a, b in zip(_params(net), jax.tree.leaves(jnet.train_state.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3)


def test_loopback_world1_equals_collective_world1():
    tr_loop = _fit_loopback(1e-3, world=1)
    net = MultiLayerNetwork(_conf()).init()
    tr_coll = DistributedTrainer(net, DistributedConfig(threshold=1e-3))
    assert tr_coll.world == 1
    tr_coll.fit(_iterator(), epochs=2)
    assert tr_loop.losses == tr_coll.losses
    for a, b in zip(_params(tr_loop.net), _params(tr_coll.net)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("loopback", [True, False])
def test_world1_dense_applies_in_place_bit_for_bit_the_exchange(loopback):
    """At world 1 with dense transport the gradient skips the host round
    trip; the trajectory is the framed exchange's bit for bit, which a
    chaos controller (with no policy) still forces."""
    def fit():
        net = MultiLayerNetwork(_conf(Adam(1e-2))).init()
        tr = DistributedTrainer(net, DistributedConfig(threshold=0.0), world=1,
                                rank=None if loopback else -1)
        tr.fit(_iterator(), epochs=2)
        return tr

    fast = fit()
    with chaos.ChaosController(seed=0):
        framed = fit()
    assert fast.losses == framed.losses and len(fast.losses) == 2 * N_BATCHES
    for a, b in zip(_params(fast.net), _params(framed.net)):
        np.testing.assert_array_equal(a, b)
    rep_fast, rep_framed = fast.stats.report(), framed.stats.report()
    assert rep_fast["comms_bytes_per_step"] == 0 and rep_fast["encode_total_s"] == 0.0
    assert rep_framed["comms_bytes_per_step"] > rep_framed["dense_bytes_per_step"]
    assert rep_fast["dense_bytes_per_step"] == rep_framed["dense_bytes_per_step"]
    assert rep_fast["steps"] == rep_framed["steps"] == 2 * N_BATCHES


def test_loopback_encoded_compresses():
    tr = _fit_loopback(1e-3, world=2, epochs=3, updater=Adam(1e-2))
    rep = tr.stats.report()
    assert rep["comms_bytes_per_step"] < rep["dense_bytes_per_step"]
    assert rep["compression_ratio"] > 1.0
    assert any(np.count_nonzero(ex.codec.residual) for ex in tr._exchanges)
    assert all(np.isfinite(tr.losses))


def test_threshold_zero_uses_dense_transport():
    tr = _fit_loopback(0.0, world=2, epochs=1)
    assert tr.stats.report()["compression_ratio"] <= 1.01
    assert tr._exchanges[0].dense


def test_resync_preserves_f32_lockstep():
    tr_plain = _fit_loopback(1e-3, world=2, epochs=2)
    tr_resync = _fit_loopback(1e-3, world=2, epochs=2, resync_every=2)
    assert tr_plain.losses == tr_resync.losses
    for a, b in zip(_params(tr_plain.net), _params(tr_resync.net)):
        np.testing.assert_array_equal(a, b)


def test_profiler_exchange_headline():
    net = MultiLayerNetwork(_conf()).init()
    prof = TrainingProfiler()
    tr = DistributedTrainer(net, DistributedConfig(threshold=1e-3), world=2, rank=None,
                            profiler=prof)
    tr.fit(_iterator(), epochs=1)
    rep = prof.report()
    assert rep["iterations"] == N_BATCHES
    for stage in ("encode", "exchange", "decode", "apply"):
        assert rep["exchange"][f"{stage}_mean_ms"] >= 0.0
    assert rep["exchange"]["steps"] == N_BATCHES
    assert "on the wire" in prof.summary()


def test_global_batch_not_divisible_raises():
    tr = DistributedTrainer(MultiLayerNetwork(_conf()).init(), DistributedConfig(threshold=0.0),
                            world=3, rank=None)
    with pytest.raises(ValueError, match="not divisible"):
        tr.step(np.zeros((8, FEATURES), np.float32), np.zeros((8, CLASSES), np.float32))


def test_chaos_exchange_fault_fails_step_cleanly():
    net = MultiLayerNetwork(_conf()).init()
    tr = DistributedTrainer(net, DistributedConfig(threshold=1e-3), world=2, rank=None)
    with chaos.ChaosController(seed=3) as c:
        c.on("train.distributed.exchange", chaos.FailNth(4))
        with pytest.raises(chaos.ChaosError):
            tr.fit(_iterator(), epochs=2)
    assert len(tr.losses) == 3
    tr.fit(_iterator(), epochs=1)
    assert len(tr.losses) > 3


def test_chaos_corrupted_exchange_is_detected_not_silent():
    net = MultiLayerNetwork(_conf()).init()
    tr = DistributedTrainer(net, DistributedConfig(threshold=1e-3), world=2, rank=None)
    with chaos.ChaosController(seed=4) as c:
        c.on("train.distributed.exchange.bytes",
             chaos.CorruptBytes(n_bytes=4, mode="flip", nth=5))
        with pytest.raises(ExchangeError, match="CRC mismatch"):
            tr.fit(_iterator(), epochs=2)
    assert len(tr.losses) == 2


def test_checkpoint_exact_resume_loopback(tmp_path):
    tmp = str(tmp_path)
    tr_ref = _fit_loopback(1e-3, world=2, epochs=2)
    cfg = dict(threshold=1e-3, checkpoint_dir=tmp, checkpoint_every=3)
    tr_b = DistributedTrainer(MultiLayerNetwork(_conf()).init(), DistributedConfig(**cfg),
                              world=2, rank=None)
    with chaos.ChaosController(seed=1) as c:
        c.on("train.distributed.exchange", chaos.FailNth(8))
        with pytest.raises(chaos.ChaosError):
            tr_b.fit(_iterator(), epochs=2)
    net_c = MultiLayerNetwork(_conf()).init()
    tr_c = DistributedTrainer(net_c, DistributedConfig(**cfg), world=2, rank=None)
    assert tr_c.restore()
    assert net_c._iteration == 6
    tr_c.fit(_iterator(), epochs=2)
    for a, b in zip(_params(tr_ref.net), _params(net_c)):
        np.testing.assert_array_equal(a, b)
    assert tr_ref.losses[-len(tr_c.losses):] == tr_c.losses


def test_restore_without_residual_refuses_inexact_resume(tmp_path):
    tmp = str(tmp_path)
    cfg = dict(threshold=1e-3, checkpoint_dir=tmp, checkpoint_every=3)
    tr = DistributedTrainer(MultiLayerNetwork(_conf()).init(), DistributedConfig(**cfg),
                            world=2, rank=None)
    tr.fit(_iterator(), epochs=1)
    for f in os.listdir(tmp):
        if f.startswith("exchange_r"):
            os.unlink(os.path.join(tmp, f))
    tr2 = DistributedTrainer(MultiLayerNetwork(_conf()).init(), DistributedConfig(**cfg),
                             world=2, rank=None)
    with pytest.raises(TrainingFailure, match="residual"):
        tr2.restore()


# ------------------------------------------------------------- real processes
_WORKER = r"""
import json, os, sys
import numpy as np

rank = int(sys.argv[1]); world = int(sys.argv[2]); port = sys.argv[3]
threshold = float(sys.argv[4]); ckpt = sys.argv[5] or None
hb = sys.argv[6] or None; crash_marker = sys.argv[7] or None

from deeplearning4j_tpu_torch.runtime.environment import get_environment
get_environment().set_device("cpu")
from deeplearning4j_tpu_torch.runtime.mesh import initialize_multihost
initialize_multihost(f"127.0.0.1:{port}", world, rank)

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime import chaos
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train import Sgd
from deeplearning4j_tpu_torch.train.distributed import DistributedConfig, DistributedTrainer

conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1)).list()
        .layer(DenseLayer(n_out=32, activation="relu"))
        .layer(OutputLayer(n_out=4, activation="softmax"))
        .set_input_type(InputType.feed_forward(16)).build())
rng = np.random.default_rng(0)
batches = [DataSet(rng.normal(size=(8, 16)).astype(np.float32),
                   np.eye(4, dtype=np.float32)[rng.integers(0, 4, 8)]) for _ in range(6)]
it = ListDataSetIterator(batches, batch_size=8)
net = MultiLayerNetwork(conf).init()
tr = DistributedTrainer(net, DistributedConfig(threshold=threshold, checkpoint_dir=ckpt,
                                               checkpoint_every=3 if ckpt else 0,
                                               heartbeat_file=hb))
try:
    tr.restore()
    if rank == 1 and crash_marker and not os.path.exists(crash_marker):
        with open(crash_marker, "w") as f:
            f.write("armed")
        with chaos.ChaosController(seed=1) as c:
            c.on("train.distributed.exchange", chaos.FailNth(8 - int(net._iteration)))
            tr.fit(it, epochs=2)
    else:
        tr.fit(it, epochs=2)
except BaseException as e:  # noqa: BLE001
    print(f"WORKER-FAILED {type(e).__name__}: {e}", flush=True)
    os._exit(17)  # peers must see an exit code, not a stalled shutdown

print("RES" + json.dumps({
    "losses": tr.losses,
    "phash": [t.numpy().tobytes().hex() for t in tree_leaves(net.params())],
    "comms_bytes_per_step": tr.stats.report()["comms_bytes_per_step"],
}), flush=True)
os._exit(0)
"""


def _write_worker(tmp_path):
    wfile = tmp_path / "worker.py"
    wfile.write_text(_WORKER)
    return str(wfile)


def _parse(out):
    lines = [l for l in out.splitlines() if l.startswith("RES")]
    assert lines, out[-2000:]
    return json.loads(lines[0][3:])


def _hashes(net):
    return [t.numpy().tobytes().hex() for t in tree_leaves(net.params())]


@pytest.mark.parametrize("threshold", [0.0, 1e-3])
def test_two_process_trajectory_matches_oracle(tmp_path, threshold):
    """Two gloo processes are bit-deterministic across workers and equal
    the loopback oracle, at threshold 0 (dense) and 1e-3 (encoded)."""
    wfile = _write_worker(tmp_path)
    sup = DistributedSupervisor(
        lambda rank, port: [sys.executable, wfile, str(rank), "2", port, str(threshold),
                            "", "", ""],
        num_processes=2, heartbeat_files=[], max_restarts=0, heartbeat_timeout_s=120)
    outs = sup.run(round_timeout_s=150)
    res = [_parse(o) for o, _ in outs]
    assert res[0]["losses"] == res[1]["losses"] and res[0]["phash"] == res[1]["phash"]
    oracle = _fit_loopback(threshold, world=2, epochs=2)
    assert res[0]["losses"] == oracle.losses
    assert res[0]["phash"] == _hashes(oracle.net)
    if threshold > 0:
        assert res[0]["comms_bytes_per_step"] < 4 * oracle._exchanges[0].codec.size


def test_supervised_restart_exact_resume(tmp_path):
    """A chaos fault kills worker 1 at the 8th step; the supervisor kills
    the group, relaunches it on a fresh port, the workers restore the newest
    checkpoint and residuals, and the final weights equal the uninterrupted
    oracle's."""
    wfile = _write_worker(tmp_path)
    ckpt = tmp_path / "ckpts"
    ckpt.mkdir()
    hbs = [str(tmp_path / f"hb{i}") for i in range(2)]
    marker = str(tmp_path / "crash_armed")
    sup = DistributedSupervisor(
        lambda rank, port: [sys.executable, wfile, str(rank), "2", port, "1e-3", str(ckpt),
                            hbs[rank], marker],
        num_processes=2, heartbeat_files=hbs, max_restarts=2, heartbeat_timeout_s=120)
    outs = sup.run(round_timeout_s=150)
    assert os.path.exists(marker)
    assert sup.restarts == 1, sup.rounds
    assert sup.rounds[-1]["outcome"] == "success"
    res = [_parse(o) for o, _ in outs]
    assert res[0]["phash"] == res[1]["phash"]
    oracle = _fit_loopback(1e-3, world=2, epochs=2)
    assert res[0]["phash"] == _hashes(oracle.net)
    n = len(res[0]["losses"])
    assert res[0]["losses"] == oracle.losses[-n:]


def test_supervisor_restart_budget_escalates(tmp_path):
    wfile = tmp_path / "always_dies.py"
    wfile.write_text("import os; os._exit(9)\n")
    sup = DistributedSupervisor(lambda rank, port: [sys.executable, str(wfile)],
                                num_processes=2, heartbeat_files=[], max_restarts=1,
                                heartbeat_timeout_s=60)
    with pytest.raises(TrainingFailure, match="giving up"):
        sup.run(round_timeout_s=60)
    assert sup.restarts == 2
