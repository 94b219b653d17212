"""The port's checkpoints and fault tolerance on the CPU.

- The 3 cases of the JAX package's ``tests/test_fault_tolerance.py``: a
  crash restores from the newest checkpoint and finishes, the restart
  budget gives up, the heartbeat monitor sees a stall.
- A mid-epoch restart resumes at the checkpoint's epoch and batch: the
  final weights equal an uninterrupted run's, bit for bit.
- A ``CheckpointListener`` archive of the port is loaded by the JAX package
  to the same outputs (``atol=1e-5``: float32, other summation orders) and
  the same counters and updater state.
- Atomic saves and the CRC32 manifest: ``verify_checkpoint``, a corrupt
  newest archive skipped, ``keep_last``.
- ``AsyncCheckpointer`` (the JAX package's ``OrbaxCheckpointer``): save
  from a background thread, ``max_to_keep``, restore in place.
"""

import os
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu_torch.data import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.runtime.chaos import ChaosController, FailNth
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train import (Adam, FaultTolerantTrainer, HeartbeatMonitor,
                                            TrainingFailure)
from deeplearning4j_tpu_torch.train.checkpoint import (AsyncCheckpointer, CheckpointListener,
                                                       OrbaxCheckpointer, atomic_save_model,
                                                       load_manifest, verify_checkpoint)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _conf():
    return (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2)).list()
            .layer(DenseLayer(n_out=16, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())


def _data(n=96):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, n)
    x = (np.eye(3)[y] @ rng.normal(0, 1, (3, 8)) * 2
         + rng.normal(0, 0.3, (n, 8))).astype(np.float32)
    return NumpyDataSetIterator(x, np.eye(3, dtype=np.float32)[y], batch_size=32)


class _CrashOnce:
    """Listener that simulates a worker loss exactly once."""

    def __init__(self, at_iteration):
        self.at = at_iteration
        self.fired = False

    def iteration_done(self, model, iteration, epoch, score):
        if not self.fired and iteration >= self.at:
            self.fired = True
            raise RuntimeError("simulated card loss")

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def test_crash_restores_from_checkpoint_and_finishes(tmp_path):
    it = _data()
    crash = _CrashOnce(at_iteration=5)

    def make_net():
        net = MultiLayerNetwork(_conf()).init()
        net.set_listeners(crash)
        return net

    trainer = FaultTolerantTrainer(make_net, str(tmp_path / "ckpt"), every_n_iterations=2,
                                   max_restarts=2)
    net = trainer.fit(it, epochs=6)
    assert trainer.restarts == 1 and crash.fired
    assert net.evaluate(it).accuracy() > 0.8
    assert CheckpointListener.last_checkpoint_in(str(tmp_path / "ckpt"))


def test_gives_up_after_max_restarts(tmp_path):
    class _AlwaysCrash(_CrashOnce):
        def iteration_done(self, model, iteration, epoch, score):
            raise RuntimeError("hard failure")

    def make_net():
        net = MultiLayerNetwork(_conf()).init()
        net.set_listeners(_AlwaysCrash(0))
        return net

    trainer = FaultTolerantTrainer(make_net, str(tmp_path / "ckpt"), every_n_iterations=2,
                                   max_restarts=1)
    with pytest.raises(TrainingFailure, match="giving up"):
        trainer.fit(_data(), epochs=2)
    assert trainer.restarts == 2


def test_heartbeat_monitor_detects_stall():
    m = HeartbeatMonitor(timeout_s=0.05)
    m.beat()
    m.check()
    time.sleep(0.08)
    with pytest.raises(TrainingFailure, match="heartbeat"):
        m.check()


@pytest.mark.parametrize("fetch", [4, 8])
def test_mid_epoch_restart_reaches_the_uninterrupted_weights(tmp_path, fetch):
    """A chaos fault at the ``fetch``-th batch fetch: the restart loads the
    newest checkpoint (every 2 iterations), skips the epoch's trained
    batches and finishes with the weights of a run that never failed."""
    it = _data(192)  # 6 batches an epoch, unshuffled
    a = FaultTolerantTrainer(lambda: MultiLayerNetwork(_conf()).init(), str(tmp_path / "a"),
                             every_n_iterations=2)
    with ChaosController(seed=1) as c:
        c.on("train.prefetch.fetch", FailNth(fetch))
        net_a = a.fit(it, epochs=2)
    net_b = FaultTolerantTrainer(lambda: MultiLayerNetwork(_conf()).init(),
                                 str(tmp_path / "b"), every_n_iterations=2).fit(it, epochs=2)
    assert a.restarts == 1 and net_a.iteration == net_b.iteration == 12
    for u, v in zip(tree_leaves(net_a.params()), tree_leaves(net_b.params()), strict=True):
        assert torch.equal(u, v)
    for u, v in zip(tree_leaves(net_a.updater_state()), tree_leaves(net_b.updater_state()),
                    strict=True):
        assert torch.equal(u, v)


def test_checkpoint_archive_loads_in_the_jax_package(tmp_path):
    net = MultiLayerNetwork(_conf()).init()
    lst = CheckpointListener(str(tmp_path), every_n_iterations=3, keep_last=2)
    net.set_listeners(lst)
    net.fit(_data(), epochs=3)  # 9 iterations: checkpoints at 3, 6, 9
    path = CheckpointListener.last_checkpoint_in(str(tmp_path))
    assert path == lst.last_checkpoint() and path.endswith("checkpoint_2_iter9.zip")
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".zip")) == \
        ["checkpoint_1_iter6.zip", "checkpoint_2_iter9.zip"]
    manifest = load_manifest(str(tmp_path))
    assert sorted(manifest) == ["checkpoint_1_iter6.zip", "checkpoint_2_iter9.zip"]
    assert verify_checkpoint(path, manifest["checkpoint_2_iter9.zip"])
    jnet = JSerializer.restore_multi_layer_network(path)
    x = np.random.default_rng(3).normal(size=(5, 8)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(jnet.output(x)), net.output(x).numpy(), atol=1e-5)
    # written at iteration 9, inside the third epoch (index 2)
    assert (jnet._iteration, jnet._epoch) == (net.iteration, net.epoch - 1) == (9, 2)
    import jax
    for u, v in zip(tree_leaves(net.updater_state()), jax.tree.leaves(jnet.train_state.opt_state),
                    strict=True):
        np.testing.assert_array_equal(u.numpy(), np.asarray(v))


def test_corrupt_newest_checkpoint_falls_back_to_a_valid_one(tmp_path):
    net = MultiLayerNetwork(_conf()).init()
    net.fit(_data())
    d = str(tmp_path)
    lst = CheckpointListener(d, every_n_iterations=1)
    lst.iteration_done(net, 1, 0, 0.0)
    lst.iteration_done(net, 2, 0, 0.0)
    newest = os.path.join(d, "checkpoint_1_iter2.zip")
    data = bytearray(open(newest, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(newest, "wb").write(bytes(data))
    assert not verify_checkpoint(newest, load_manifest(d)["checkpoint_1_iter2.zip"])
    assert CheckpointListener.last_checkpoint_in(d) == os.path.join(d, "checkpoint_0_iter1.zip")
    # a fault at the write chaos point leaves no archive behind
    with ChaosController(seed=2) as c:
        c.on("train.checkpoint.write", FailNth(1))
        with pytest.raises(Exception, match="train.checkpoint.write"):
            atomic_save_model(net, os.path.join(d, "checkpoint_9_x.zip"))
    assert not os.path.exists(os.path.join(d, "checkpoint_9_x.zip"))


def test_async_checkpointer_saves_in_the_background_and_restores_in_place(tmp_path):
    assert OrbaxCheckpointer is AsyncCheckpointer
    net = MultiLayerNetwork(_conf()).init()
    ck = AsyncCheckpointer(str(tmp_path), max_to_keep=2)
    saved = {}
    for _ in range(3):
        net.fit(_data())
        ck.save(net)
        saved[net.iteration] = [t.clone() for t in tree_leaves(net.params())]
    ck.wait()
    assert ck.steps() == [6, 9] and ck.latest_step() == 9
    w = net.params()["layer_0"]["W"]
    other = MultiLayerNetwork(_conf()).init()
    other.fit(_data())
    ck.restore(other, step=6)
    assert other.iteration == 6 and other.epoch == 2
    for u, v in zip(tree_leaves(other.params()), saved[6], strict=True):
        assert torch.equal(u, v)
    ck.restore(net)  # the newest, copied into the live tensors
    assert net.params()["layer_0"]["W"] is w and torch.equal(w, saved[9][0])
    ck.close()
