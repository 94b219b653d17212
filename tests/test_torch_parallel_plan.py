"""One-plan parallelism in the port: ``ParallelPlan.compose`` consumed by
``ParallelWrapper`` and ``DistributedTrainer`` and keyed into the
captured-step cache (``tests/test_parallel_plan.py:71-234``; its
plan-sliced serving tests belong with the serving slice).

Bit-identity in the port (every reduction is a copy and a sum in fixed rank
order):

- a degenerate composed plan equals its single-axis factory BITWISE;
- pipe x data at ``microbatches=1`` equals plain data parallelism BITWISE;
- HSDP (data x fsdp) against flat FSDP, and pipe at ``microbatches=4``
  against data parallelism: within ``rtol 2e-5, atol 1e-6``;
- ``gpipe`` against its sequential reference and the JAX ``gpipe`` on the
  same stage weights within ``1e-6``; a composed data-parallel fit against
  the JAX package's within ``rtol 2e-5, atol 2e-6``.
"""

import json
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import NumpyDataSetIterator as JIter
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.parallel import ParallelPlan as JPlan
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel.pipeline import gpipe as jgpipe
from deeplearning4j_tpu.runtime.mesh import create_mesh as jcreate_mesh
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu_torch.data.iterators import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models import ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import DenseLayer, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu_torch.parallel import ParallelPlan, ParallelWrapper, PipePlanExecutor
from deeplearning4j_tpu_torch.parallel.pipeline import (gpipe, sequential_reference,
                                                        stack_stage_params)
from deeplearning4j_tpu_torch.runtime.compile_cache import AotCache
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.mesh import MeshSpec, create_mesh
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train import Sgd
from deeplearning4j_tpu_torch.train.distributed import DistributedConfig, DistributedTrainer

CPU8 = ["cpu"] * 8
CLOSE = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield env
    env.device, env.default_dtype, env.compute_dtype = saved


def _conf(seed=7, layers=1, width=16):
    b = NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1)).list()
    for _ in range(layers):
        b = b.layer(DenseLayer(n_out=width, activation="tanh"))
    return (b.layer(OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _flat(tree):
    return np.concatenate([np.asarray(t).ravel() for t in tree_leaves(tree)])


def _pw_fit(plan, epochs=2, layers=1, seed=7):
    x, y = _data()
    net = MultiLayerNetwork(_conf(seed=seed, layers=layers)).init()
    ParallelWrapper(net, plan, prefetch_buffer=0).fit(
        NumpyDataSetIterator(x, y, batch_size=16), epochs=epochs)
    return _flat(net.params())


def _dp(n):
    return ParallelPlan.data_parallel(create_mesh(MeshSpec({"data": n}), devices_=CPU8[:n]))


# ------------------------------------------------------- plan identity
def test_plan_signature_drift_and_stability():
    p1 = ParallelPlan.compose(data=2, pipe=4, microbatches=2, devices_=CPU8)
    p1b = ParallelPlan.compose(data=2, pipe=4, microbatches=2, devices_=CPU8)
    p2 = ParallelPlan.compose(data=2, pipe=4, microbatches=4, devices_=CPU8)
    p3 = ParallelPlan.compose(data=4, fsdp=2, devices_=CPU8)
    assert p1.signature() == p1b.signature() and p1.describe() == p1b.describe()
    assert len({p1.signature(), p2.signature(), p3.signature()}) == 3
    assert json.loads(json.dumps(p1.describe())) == p1.describe()
    assert p1.describe() == JPlan.compose(data=2, pipe=4, microbatches=2).describe()
    assert p3.signature() == JPlan.compose(data=4, fsdp=2).signature()


def test_plan_drift_mints_fresh_executable_never_stale():
    p1 = ParallelPlan.compose(data=2, fsdp=4, devices_=CPU8)
    p2 = ParallelPlan.compose(data=2, fsdp=2, tensor=2, devices_=CPU8)
    cache = AotCache("test-plan-drift")
    x = torch.ones(4)
    sig = (tuple(x.shape), x.dtype)
    cache.call((p1.signature(), sig), lambda a: a * 2.0, x)
    cache.call((p1.signature(), sig), lambda a: a * 2.0, x)
    assert len(cache) == 1
    cache.call((p2.signature(), sig), lambda a: a * 2.0, x)
    assert len(cache) == 2


def test_compose_batch_divisor_devices_per_replica_and_slices():
    p = ParallelPlan.compose(data=2, pipe=4, microbatches=2, devices_=CPU8)
    assert p.batch_axes() == ("data",) and p.batch_divisor() == 2 and p.pipe_size == 4
    assert p.devices_per_replica() == 4
    h = ParallelPlan.compose(data=2, fsdp=4, devices_=CPU8)
    assert h.batch_axes() == ("data", "fsdp") and h.batch_divisor() == 8
    s = p.replica_slice(CPU8[:4])
    assert s.mesh.shape == {"pipe": 4} and s.kind.endswith("/slice")


def _split(spec):
    return next(((d, a) for d, a in enumerate(spec) if a is not None), None)


@pytest.mark.parametrize("kind", ["compose", "fsdp", "tensor", "expert"])
def test_placement_rules_equal_the_jax_rules(kind):
    """Each leaf's split (dimension, axis) equals the JAX plan's
    PartitionSpec for the same tree, a transformer block's keys included."""
    import jax
    jd = jax.devices()
    plans = {
        "compose": (lambda: ParallelPlan.compose(data=2, fsdp=2, tensor=2, min_size=64,
                                                 devices_=CPU8),
                    lambda: JPlan.compose(data=2, fsdp=2, tensor=2, min_size=64)),
        "fsdp": (lambda: ParallelPlan.fsdp(create_mesh(devices_=CPU8[:4]), min_size=64),
                 lambda: JPlan.fsdp(jcreate_mesh({"data": 4}, devices_=jd[:4]), min_size=64)),
        "tensor": (lambda: ParallelPlan.tensor_parallel(create_mesh({"data": 1, "model": 4},
                                                                    devices_=CPU8[:4])),
                   lambda: JPlan.tensor_parallel(jcreate_mesh({"data": 1, "model": 4},
                                                              devices_=jd[:4]))),
        "expert": (lambda: ParallelPlan.expert_parallel(create_mesh({"data": 2, "expert": 4},
                                                                    devices_=CPU8)),
                   lambda: JPlan.expert_parallel(jcreate_mesh({"data": 2, "expert": 4})))}
    plan, jplan = (f() for f in plans[kind])
    shapes = {"blk": {"attn": {"W_q": (16, 16), "W_k": (16, 16), "W_v": (16, 16),
                               "W_o": (16, 16), "b_q": (16,)},
                      "W_ff1": (16, 32), "W_ff2": (32, 16), "b_ff1": (32,)},
              "stack": {"W_q": (2, 16, 32)},
              "moe": {"W_e1": (8, 16, 32), "b_e2": (8, 16)},
              "dense": {"W": (8, 64), "b": (64,)}}

    def build(node, make):
        return {k: build(v, make) for k, v in node.items()} if isinstance(node, dict) \
            else make(node)

    ours = [_split(s) for s in tree_leaves(plan.param_sharding(build(shapes, torch.zeros)))]
    theirs = [_split(tuple(s.spec)) for s in jax.tree.leaves(jplan.param_sharding(
        build(shapes, lambda sh: np.zeros(sh, np.float32))))]
    assert ours == theirs and any(ours)
    if kind == "expert":
        with pytest.raises(ValueError, match="not divisible"):
            plan.param_sharding({"W_e1": torch.zeros(6, 4)})


# ------------------------------------ degenerate composes == factories (BITWISE)
def test_compose_degenerate_data_parallel_bitwise():
    assert np.array_equal(_pw_fit(_dp(8)), _pw_fit(ParallelPlan.compose(data=8, devices_=CPU8)))


def test_compose_degenerate_fsdp_bitwise():
    mesh4 = create_mesh(MeshSpec({"data": 4}), devices_=CPU8[:4])
    ref = _pw_fit(ParallelPlan.fsdp(mesh4, min_size=64))
    got = _pw_fit(ParallelPlan.compose(fsdp=4, devices_=CPU8[:4], min_size=64))
    assert np.array_equal(ref, got)


def test_compose_degenerate_tensor_bitwise():
    mesh = create_mesh(MeshSpec({"data": 1, "model": 8}), devices_=CPU8)
    assert np.array_equal(_pw_fit(ParallelPlan.tensor_parallel(mesh)),
                          _pw_fit(ParallelPlan.compose(tensor=8, devices_=CPU8)))


def test_compose_hsdp_matches_flat_fsdp_allclose():
    mesh4 = create_mesh(MeshSpec({"data": 4}), devices_=CPU8[:4])
    ref = _pw_fit(ParallelPlan.fsdp(mesh4, min_size=64))
    got = _pw_fit(ParallelPlan.compose(data=2, fsdp=2, devices_=CPU8[:4], min_size=64))
    assert not np.isnan(got).any()
    np.testing.assert_allclose(ref, got, **CLOSE)


def test_composed_data_parallel_fit_matches_jax(tmp_path):
    x, y = _data()
    jconf = (JConf.builder().seed(7).updater(JSgd(0.1)).list()
             .layer(JDense(n_out=16, activation="tanh"))
             .layer(JOutput(n_out=4, activation="softmax"))
             .set_input_type(JInputType.feed_forward(8)).build())
    jnet = JNet(jconf).init()
    path = str(tmp_path / "n.zip")
    JSerializer.write_model(jnet, path)
    net = ModelSerializer.restore_model(path, device="cpu")
    ParallelWrapper(net, ParallelPlan.compose(data=8, devices_=CPU8), prefetch_buffer=0).fit(
        NumpyDataSetIterator(x, y, batch_size=16), epochs=2)
    JWrapper(jnet, JPlan.compose(data=8), prefetch_buffer=0).fit(JIter(x, y, batch_size=16),
                                                                 epochs=2)
    import jax
    for a, b in zip(tree_leaves(net.params()), jax.tree.leaves(jnet.train_state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------- pipe axis
def test_pipe_data_train_bitwise_at_microbatches_one():
    ref = _pw_fit(_dp(2), layers=5)
    got = _pw_fit(ParallelPlan.compose(data=2, pipe=4, microbatches=1, devices_=CPU8), layers=5)
    assert np.array_equal(ref, got)


def test_pipe_microbatched_train_allclose():
    ref = _pw_fit(_dp(2), layers=5)
    got = _pw_fit(ParallelPlan.compose(data=2, pipe=4, microbatches=4, devices_=CPU8), layers=5)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(ref, got, **CLOSE)


@pytest.mark.parametrize("kind", ["data_parallel", "fsdp", "pipe"])
def test_fit_twice_equals_one_two_epoch_fit(kind):
    """A second fit reuses the sharded state (its captured steps replay):
    two one-epoch fits are one two-epoch fit, bit for bit."""
    plans = {"data_parallel": lambda: _dp(4),
             "fsdp": lambda: ParallelPlan.compose(fsdp=4, devices_=CPU8[:4], min_size=64),
             "pipe": lambda: ParallelPlan.compose(data=2, pipe=4, devices_=CPU8)}
    x, y = _data()
    runs = []
    for fits in ((2,), (1, 1)):
        net = MultiLayerNetwork(_conf(layers=5)).init()
        pw = ParallelWrapper(net, plans[kind](), prefetch_buffer=0)
        for epochs in fits:
            pw.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=epochs)
        runs.append(_flat(net.params()))
    assert np.array_equal(*runs)


def test_pipe_needs_a_uniform_trunk():
    net = MultiLayerNetwork(_conf(layers=2)).init()
    with pytest.raises(ValueError, match="uniform trunk"):
        PipePlanExecutor(net, ParallelPlan.compose(pipe=4, devices_=CPU8[:4]))
    ex = PipePlanExecutor(MultiLayerNetwork(_conf(layers=5)).init(),
                          ParallelPlan.compose(pipe=2, devices_=CPU8[:2]))
    assert (ex.t0, ex.n_trunk, ex.k, ex.head, ex.tail) == (1, 4, 2, [0], [5])


def test_gpipe_matches_sequential_and_jax_gpipe():
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    S, d = 4, 8
    Ws = rng.normal(0, 0.5, (S, d, d)).astype(np.float32)
    bs = rng.normal(0, 0.1, (S, d)).astype(np.float32)
    x = rng.normal(size=(16, d)).astype(np.float32)
    stacked = stack_stage_params([{"W": torch.from_numpy(Ws[s]), "b": torch.from_numpy(bs[s])}
                                  for s in range(S)])
    mesh = create_mesh({"pipe": S, "data": 2}, devices_=CPU8)

    def stage(p, h):
        return torch.tanh(h @ p["W"] + p["b"])

    want = sequential_reference(stage, stacked, torch.from_numpy(x))
    for m in (1, 2, 4):
        got = gpipe(stage, stacked, torch.from_numpy(x), mesh=mesh, n_microbatches=m,
                    batch_axes=("data",))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    jmesh = jcreate_mesh({"pipe": S, "data": 2})
    jout = jgpipe(lambda p, h: jnp.tanh(h @ p["W"] + p["b"]), {"W": Ws, "b": bs}, x,
                  mesh=jmesh, n_microbatches=2, batch_axes=("data",))
    np.testing.assert_allclose(want.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="stages"):
        gpipe(stage, stacked, torch.from_numpy(x), mesh=create_mesh({"pipe": 2},
                                                                     devices_=CPU8[:2]),
              n_microbatches=1)


# ------------------------------------------- DistributedTrainer + the plan
def _dist_run(cfg=None, plan=None, steps=4, seed=11):
    rng = np.random.RandomState(3)
    X = rng.randn(steps, 16, 8).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (steps, 16))]
    net = MultiLayerNetwork(_conf(seed=seed)).init()
    tr = DistributedTrainer(net, cfg or DistributedConfig(threshold=1e-3), world=2, rank=None,
                            plan=plan)
    try:
        for i in range(steps):
            tr.step(X[i], Y[i])
        tr.flush()
    finally:
        tr.close()
    return _flat(net.params()), list(tr.losses)


def test_distributed_trainer_composed_plan_bitwise():
    mesh4 = create_mesh(MeshSpec({"data": 4}), devices_=CPU8[:4])
    ref, ref_losses = _dist_run(plan=ParallelPlan.fsdp(mesh4, min_size=64))
    got, got_losses = _dist_run(plan=ParallelPlan.compose(fsdp=4, devices_=CPU8[:4],
                                                          min_size=64))
    assert np.array_equal(ref, got) and ref_losses == got_losses
    plain, _ = _dist_run()
    np.testing.assert_allclose(ref, plain, rtol=1e-5, atol=1e-4)


def test_distributed_trainer_overlap_window_deterministic():
    """overlap_window=1 is a staleness-1 schedule: another trajectory than
    the synchronous one (losses; and weights on the dense transport, where
    the quantised encoded updates cannot coincide), deterministic run to
    run, every step applied by flush(), the exchange thread joined."""
    _, sync_l = _dist_run()
    cfg = DistributedConfig(threshold=1e-3, overlap_window=1)
    ov1, l1 = _dist_run(cfg)
    ov2, l2 = _dist_run(cfg)
    assert np.array_equal(ov1, ov2) and l1 == l2 and len(l1) == 4
    assert sync_l != l1
    dense, _ = _dist_run(DistributedConfig(threshold=0.0))
    dense_ov, _ = _dist_run(DistributedConfig(threshold=0.0, overlap_window=1))
    assert not np.array_equal(dense, dense_ov)
    assert not [t.name for t in threading.enumerate() if t.name.startswith("dist-")]


def test_distributed_trainer_overlap_with_plan_bitwise():
    mesh4 = create_mesh(MeshSpec({"data": 4}), devices_=CPU8[:4])
    cfg = DistributedConfig(threshold=1e-3, overlap_window=1)
    ref, _ = _dist_run(cfg, plan=ParallelPlan.fsdp(mesh4, min_size=64))
    got, _ = _dist_run(cfg, plan=ParallelPlan.compose(fsdp=4, devices_=CPU8[:4], min_size=64))
    assert np.array_equal(ref, got)


def test_distributed_trainer_rejects_pipe_plan():
    net = MultiLayerNetwork(_conf()).init()
    with pytest.raises(NotImplementedError):
        DistributedTrainer(net, DistributedConfig(), world=2, rank=None,
                           plan=ParallelPlan.compose(data=2, pipe=4, devices_=CPU8))
