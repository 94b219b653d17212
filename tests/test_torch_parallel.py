"""``ParallelWrapper`` and ring attention of the port on a CPU mesh, against
the JAX package (``tests/test_parallel.py`` minus ``ParallelInference``,
which comes with the serving slice).

The port's mesh is 8 entries of the CPU device (one process drives every
replica: the copies, the gathers and the rank-order sums all run); the JAX
side runs on its 8 virtual CPU devices. Both packages start from the same
weights through the archive. Tolerances, float32: data-parallel and FSDP
fits against JAX's within ``rtol 2e-5, atol 2e-6`` (the JAX reference's
own DP-vs-single-device bound: XLA's all-reduce sums in another order);
tensor parallelism within ``1e-5`` (the row-split products are summed in
pieces); ring attention within ``rtol 2e-4, atol 2e-5`` of a dense softmax
and of JAX's ring.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import NumpyDataSetIterator as JIter
from deeplearning4j_tpu.models import ComputationGraph as JGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.parallel import ParallelWrapper as JWrapper
from deeplearning4j_tpu.parallel import ShardingStrategy as JStrategy
from deeplearning4j_tpu.parallel.ring_attention import (
    sequence_parallel_attention as jseq_attention)
from deeplearning4j_tpu.runtime.mesh import create_mesh as jcreate_mesh
from deeplearning4j_tpu.train import Adam as JAdam
from deeplearning4j_tpu.train import Sgd as JSgd
from deeplearning4j_tpu.zoo import Bert as JBert
from deeplearning4j_tpu_torch.data.iterators import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models import ComputationGraph, ModelSerializer, MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import (DenseLayer, GravesLSTM, InputType,
                                         NeuralNetConfiguration, OutputLayer, RnnOutputLayer)
from deeplearning4j_tpu_torch.parallel import ParallelWrapper, ShardingStrategy
from deeplearning4j_tpu_torch.parallel.ring_attention import sequence_parallel_attention
from deeplearning4j_tpu_torch.parallel.sharding import placements_of, shard_batch
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.mesh import (MeshSpec, SEQ_AXIS, create_mesh, devices)
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train import Sgd
from deeplearning4j_tpu_torch.zoo import Bert

CPU8 = ["cpu"] * 8
DP_TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield env
    env.device, env.default_dtype, env.compute_dtype = saved


def _jconf(seed=7):
    return (JConf.builder().seed(seed).updater(JSgd(0.1)).list()
            .layer(JDense(n_out=16, activation="tanh"))
            .layer(JOutput(n_out=4, activation="softmax"))
            .set_input_type(JInputType.feed_forward(8)).build())


def _conf(seed=7):
    return (NeuralNetConfiguration.builder().seed(seed).updater(Sgd(0.1)).list()
            .layer(DenseLayer(n_out=16, activation="tanh"))
            .layer(OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _pair(jnet, tmp_path, name="net.zip"):
    """A JAX network and the port's copy of it through the archive."""
    path = str(tmp_path / name)
    JSerializer.write_model(jnet, path)
    return jnet, ModelSerializer.restore_model(path, device="cpu")


def _leaves(tree):
    return [np.asarray(t) for t in tree_leaves(tree)]


def _jleaves(jnet):
    import jax
    return [np.asarray(l) for l in jax.tree.leaves(jnet.train_state.params)]


def test_port_mesh_repeats_a_device():
    mesh = create_mesh(devices_=CPU8)
    assert mesh.shape == {"data": 8} and len(set(map(str, mesh.device_list()))) == 1
    assert devices() == [torch.device("cpu")]
    m2 = create_mesh(MeshSpec({"data": 2, "model": -1}), devices_=CPU8)
    assert m2.shape == {"data": 2, "model": 4} and m2.device_at(data=1, model=3).type == "cpu"
    # the builder's meshes over this process's devices (one CPU here)
    net = MultiLayerNetwork(_conf()).init()
    for name, axes in (("data_parallel", {"data": 1}), ("fsdp", {"data": 1}),
                       ("tensor_parallel", {"data": 1, "model": 1})):
        pw = ParallelWrapper.builder(net).strategy(name).workers(8).prefetch_buffer(0).build()
        assert pw.strategy.mesh.shape == axes and pw.strategy.kind == name
        assert pw.prefetch_buffer == 0


def test_mesh_spec_and_loopback_hosts_match_jax():
    import dataclasses

    from deeplearning4j_tpu.runtime.mesh import MeshSpec as JMeshSpec
    from deeplearning4j_tpu.runtime.mesh import loopback_hosts as jloopback_hosts
    from deeplearning4j_tpu_torch.runtime.mesh import loopback_hosts
    for spec in ({"data": -1}, {"data": 2, "model": -1}, {"pipe": 2, "data": 4}):
        assert MeshSpec(spec).resolve(8) == JMeshSpec(spec).resolve(8)
    for bad in ({"data": -1, "model": -1}, {"data": 3}):
        with pytest.raises(ValueError):
            MeshSpec(bad).resolve(8)
    assert [dataclasses.asdict(h) for h in loopback_hosts(3, "w")] == \
        [dataclasses.asdict(h) for h in jloopback_hosts(3, "w")]


def test_dp_matches_single_device_and_jax(tmp_path):
    x, y = _data()
    jnet, net = _pair(JNet(_jconf()).init(), tmp_path)
    single = ModelSerializer.restore_model(str(tmp_path / "net.zip"), device="cpu")
    single.fit(NumpyDataSetIterator(x, y, batch_size=32), epochs=3)
    pw = ParallelWrapper.builder(net).strategy("data_parallel").workers(8).build()
    pw.strategy = ShardingStrategy.data_parallel(create_mesh(devices_=CPU8))
    pw.fit(NumpyDataSetIterator(x, y, batch_size=32), epochs=3)
    JWrapper.builder(jnet).strategy("data_parallel").build().fit(JIter(x, y, batch_size=32),
                                                                epochs=3)
    for a, b, c in zip(_leaves(net.params()), _leaves(single.params()), _jleaves(jnet)):
        np.testing.assert_allclose(a, b, **DP_TOL)
        np.testing.assert_allclose(a, c, **DP_TOL)
    assert net.iteration == 6 and net.epoch == 3


def test_fsdp_matches_jax_fsdp(tmp_path):
    x, y = _data()
    jnet, net = _pair(JNet(_jconf()).init(), tmp_path)
    ParallelWrapper(net, ShardingStrategy.fsdp(create_mesh(devices_=CPU8), min_size=64),
                    prefetch_buffer=0).fit(NumpyDataSetIterator(x, y, batch_size=32), epochs=2)
    JWrapper(jnet, JStrategy.fsdp(jcreate_mesh(), min_size=64), prefetch_buffer=0).fit(
        JIter(x, y, batch_size=32), epochs=2)
    assert np.isfinite(net.score())
    for a, c in zip(_leaves(net.params()), _jleaves(jnet)):
        np.testing.assert_allclose(a, c, **DP_TOL)


def test_computation_graph_through_parallel_wrapper(tmp_path):
    """A graph's step under DP matches its own fit and JAX's wrapper."""
    def jconf():
        return (JConf.builder().seed(5).updater(JAdam(1e-2)).graph_builder()
                .add_inputs("in")
                .add_layer("h", JDense(n_out=32, activation="relu"), "in")
                .add_layer("out", JOutput(n_out=3, activation="softmax", loss="mcxent"), "h")
                .set_outputs("out").set_input_types(JInputType.feed_forward(12)).build())

    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 12)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    jnet, net = _pair(JGraph(jconf()).init(), tmp_path)
    own = ModelSerializer.restore_model(str(tmp_path / "net.zip"), device="cpu")
    assert isinstance(net, ComputationGraph)
    own.fit(NumpyDataSetIterator(x, y, batch_size=32), epochs=3)
    ParallelWrapper(net, ShardingStrategy.data_parallel(create_mesh(devices_=CPU8))).fit(
        NumpyDataSetIterator(x, y, batch_size=32), epochs=3)
    JWrapper.builder(jnet).strategy("data_parallel").build().fit(JIter(x, y, batch_size=32),
                                                                epochs=3)
    for a, b, c in zip(_leaves(net.params()), _leaves(own.params()), _jleaves(jnet)):
        np.testing.assert_allclose(a, b, **DP_TOL)
        np.testing.assert_allclose(a, c, rtol=2e-5, atol=1e-5)
    # Adam's moments came back into the graph's optimizer
    assert int(net.updater_state()["h"]["count"]) == 6


@pytest.mark.parametrize("kind", ["fsdp", "tensor_parallel", "compose"])
def test_computation_graph_under_split_plans(kind):
    """A graph under FSDP, tensor parallelism (no tensor key: one replica)
    and data x fsdp matches its own fit."""
    def conf():
        from deeplearning4j_tpu_torch.train import Adam
        return (NeuralNetConfiguration.builder().seed(5).updater(Adam(1e-2)).graph_builder()
                .add_inputs("in")
                .add_layer("h", DenseLayer(n_out=32, activation="relu"), "in")
                .add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
                .set_outputs("out").set_input_types(InputType.feed_forward(12)).build())

    plans = {"fsdp": lambda: ShardingStrategy.fsdp(create_mesh(devices_=CPU8[:4]), min_size=64),
             "tensor_parallel": lambda: ShardingStrategy.tensor_parallel(
                 create_mesh({"data": 1, "model": 2}, devices_=CPU8[:2])),
             "compose": lambda: ShardingStrategy.compose(data=2, fsdp=2, min_size=64,
                                                         devices_=CPU8[:4])}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 12)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 64)]
    own, net = ComputationGraph(conf()).init(), ComputationGraph(conf()).init()
    own.fit(NumpyDataSetIterator(x, y, batch_size=32), epochs=2)
    ParallelWrapper(net, plans[kind](), prefetch_buffer=0).fit(
        NumpyDataSetIterator(x, y, batch_size=32), epochs=2)
    for a, b in zip(_leaves(net.params()), _leaves(own.params())):
        np.testing.assert_allclose(a, b, **DP_TOL)


def _tiny_bert(pkg):
    return pkg(vocab_size=50, d_model=32, n_layers=2, n_heads=2, ffn_size=64, max_len=16,
               dropout_rate=0.0, updater=(JSgd(0.05) if pkg is JBert else Sgd(0.05)))


def test_tensor_parallel_bert_matches_single_device_and_jax(tmp_path):
    """``.strategy("tensor_parallel")`` builds a mesh with a ``model`` axis
    and splits W_q/W_k/W_v/W_ff1 by columns and W_o/W_ff2 by rows: each
    device runs one head; the fit matches the single-device fit and JAX's
    tensor-parallel fit."""
    jnet, net = _pair(_tiny_bert(JBert).init(), tmp_path)
    single = ModelSerializer.restore_model(str(tmp_path / "net.zip"), device="cpu")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (16, 8)).astype(np.int32)
    labels = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    pw = ParallelWrapper(net, ShardingStrategy.tensor_parallel(
        create_mesh({"data": 1, "model": -1}, devices_=CPU8[:2])), prefetch_buffer=0)
    assert pw.strategy.mesh.shape["model"] == 2
    # W_q/W_k/W_v/W_ff1, their biases, W_o and W_ff2 of each of the 2 blocks
    axes = [p.axis for p in placements_of(pw.strategy, net.params())]
    assert axes.count("model") == 2 * 10 and set(axes) == {None, "model"}
    pw.fit(NumpyDataSetIterator(ids, labels, batch_size=8), epochs=2)
    single.fit(NumpyDataSetIterator(ids, labels, batch_size=8), epochs=2)
    import jax
    jmesh = jcreate_mesh({"data": 1, "model": 2}, devices_=jax.devices()[:2])
    JWrapper(jnet, JStrategy.tensor_parallel(jmesh), prefetch_buffer=0).fit(
        JIter(ids, labels, batch_size=8), epochs=2)
    assert np.isfinite(net.score())
    for a, b, c in zip(_leaves(net.params()), _leaves(single.params()), _jleaves(jnet)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)


def test_tensor_parallel_heads_must_split():
    net = Bert(vocab_size=50, d_model=24, n_layers=1, n_heads=3, ffn_size=48, max_len=16,
               dropout_rate=0.0).init()
    ids = np.zeros((4, 8), np.int32)
    labels = np.eye(2, dtype=np.float32)[[0, 1, 0, 1]]
    pw = ParallelWrapper(net, ShardingStrategy.tensor_parallel(
        create_mesh({"data": 1, "model": 2}, devices_=CPU8[:2])), prefetch_buffer=0)
    with pytest.raises(ValueError, match="heads"):
        pw.fit(NumpyDataSetIterator(ids, labels, batch_size=4), epochs=1)


def test_batch_not_divisible_raises():
    strat = ShardingStrategy.data_parallel(create_mesh(devices_=CPU8))
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(strat, np.zeros((5, 3), np.float32))
    parts = shard_batch(strat, np.arange(16, dtype=np.float32).reshape(8, 2))
    assert len(parts) == 8 and torch.equal(parts[3], torch.tensor([[6.0, 7.0]]))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_full_softmax_and_jax(causal):
    import jax
    mesh = create_mesh({SEQ_AXIS: 8}, devices_=CPU8)
    B, H, T, D = 2, 4, 64, 16
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(0, 1, (B, H, T, D)).astype(np.float32) for _ in range(3))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
    if causal:
        s = np.where(np.tril(np.ones((T, T), bool)), s, -1e30)
    w = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)
    out = sequence_parallel_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), mesh, causal=causal).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    jout = np.asarray(jseq_attention(q, k, v, jcreate_mesh({"seq": 8},
                                                           devices_=jax.devices()[:8]),
                                     causal=causal))
    np.testing.assert_allclose(out, jout, rtol=2e-4, atol=2e-5)


def test_parallel_wrapper_refuses_tbptt_and_solvers():
    conf_t = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1)).list()
              .layer(GravesLSTM(n_out=8))
              .layer(RnnOutputLayer(n_out=4, activation="softmax", loss="mcxent"))
              .set_input_type(InputType.recurrent(6))
              .tbptt_fwd_length(4).tbptt_back_length(4).build())
    net = MultiLayerNetwork(conf_t).init()
    pw = ParallelWrapper(net, ShardingStrategy.data_parallel(create_mesh(devices_=CPU8)))
    x = np.zeros((8, 12, 6), np.float32)
    y = np.zeros((8, 12, 4), np.float32)
    with pytest.raises(NotImplementedError, match="tBPTT"):
        pw.fit(NumpyDataSetIterator(x, y, batch_size=8), epochs=1)

    conf_s = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1))
              .optimization_algo("LBFGS").list()
              .layer(DenseLayer(n_out=8, activation="tanh"))
              .layer(OutputLayer(n_out=4, activation="softmax"))
              .set_input_type(InputType.feed_forward(8)).build())
    net2 = MultiLayerNetwork(conf_s).init()
    pw2 = ParallelWrapper(net2, ShardingStrategy.data_parallel(create_mesh(devices_=CPU8)))
    xf, yf = _data(16)
    with pytest.raises(NotImplementedError, match="SGD only"):
        pw2.fit(NumpyDataSetIterator(xf, yf, batch_size=16), epochs=1)


def test_parallel_wrapper_tbptt_conf_with_nonsequence_data_trains():
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1)).list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.feed_forward(8))
            .tbptt_fwd_length(4).tbptt_back_length(4).build())
    net = MultiLayerNetwork(conf).init()
    x, y = _data(16)
    ParallelWrapper(net, ShardingStrategy.data_parallel(create_mesh(devices_=CPU8))).fit(
        NumpyDataSetIterator(x, y, batch_size=16), epochs=1)
    assert np.isfinite(net.score())


def test_stateful_layers_refuse_several_replicas():
    from deeplearning4j_tpu_torch.nn import BatchNormalization
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(0.1)).list()
            .layer(DenseLayer(n_out=8, activation="tanh")).layer(BatchNormalization())
            .layer(OutputLayer(n_out=4, activation="softmax"))
            .set_input_type(InputType.feed_forward(8)).build())
    net = MultiLayerNetwork(conf).init()
    x, y = _data(16)
    with pytest.raises(NotImplementedError, match="BatchNormalization"):
        ParallelWrapper(net, ShardingStrategy.data_parallel(create_mesh(devices_=CPU8[:2]))
                        ).fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=1)
    # one replica keeps the network's own statistics
    own = MultiLayerNetwork(conf).init()
    own.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=1)
    ParallelWrapper(net, ShardingStrategy.data_parallel(create_mesh(devices_=CPU8[:1]))).fit(
        NumpyDataSetIterator(x, y, batch_size=16), epochs=1)
    for a, b in zip(_leaves(net._model_state), _leaves(own._model_state)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves(net.params()), _leaves(own.params())):
        np.testing.assert_array_equal(a, b)


def test_listeners_prefetch_and_grouped_dispatch_keep_the_trajectory():
    """prefetch 2 + 3-step groups + a stateless listener: the same bits as
    the synchronous one-step loop, every iteration delivered."""
    from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
    x, y = _data(96)
    env = get_environment()
    runs = []
    for unroll, prefetch in ((1, 0), (3, 2)):
        saved = env.dispatch_unroll
        env.set_dispatch_unroll(unroll)
        try:
            net = MultiLayerNetwork(_conf()).init()
            lst = CollectScoresListener()
            net.set_listeners(lst)
            ParallelWrapper(net, ShardingStrategy.data_parallel(create_mesh(devices_=CPU8[:4])),
                            prefetch_buffer=prefetch).fit(
                NumpyDataSetIterator(x, y, batch_size=16), epochs=2)
        finally:
            env.set_dispatch_unroll(saved)
        runs.append(([float(s) for _, s in lst.scores], _leaves(net.params())))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 12
    for a, b in zip(runs[0][1], runs[1][1]):
        np.testing.assert_array_equal(a, b)
