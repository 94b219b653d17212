"""The port's training runtime on the CPU: state packing, grouped dispatch
and the captured-step protocol, against the JAX package.

- ``LeafPacker``: pack and unpack bitwise, the network's tensors become
  views into the buffers, mismatches raise.
- ``GroupedDispatch``: submission order, flush on an incompatible batch,
  the snapshot-and-clear rule (a raising listener never trains a group
  twice) and ``drain_on_error``.
- ``MultiLayerNetwork``, ``ComputationGraph`` and ``SameDiff`` fits with
  ``dispatch_unroll`` 1, 3 and 4, packing on and off and the AOT path on and
  off: losses and final weights bit for bit against the plain loop, and
  against live JAX fits from the same archive within ``_TOL`` (float32:
  the two packages sum in other orders; Adam steps of 1e-2 amplify that
  to a few 1e-6 in the weights).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTrainingConfig
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.iterators import ListDataSetIterator as JList
from deeplearning4j_tpu.models import ComputationGraph as JGraph
from deeplearning4j_tpu.models import MultiLayerNetwork as JNet
from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
from deeplearning4j_tpu.nn import DenseLayer as JDense
from deeplearning4j_tpu.nn import InputType as JInputType
from deeplearning4j_tpu.nn import OutputLayer as JOutput
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph_vertices import ElementWiseVertex as JAdd
from deeplearning4j_tpu.train import Adam as JAdam
from deeplearning4j_tpu.train import CollectScoresListener as JCollect
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.data import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.models import ModelSerializer
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.state_packing import (GroupedDispatch, LeafPacker,
                                                            step_args_signature)
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener, TrainingListener
from deeplearning4j_tpu_torch.train.updaters import Adam

_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype, env.packed_state,
             env.dispatch_unroll, env.aot_dispatch)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield env
    (env.device, env.default_dtype, env.compute_dtype, env.packed_state,
     env.dispatch_unroll, env.aot_dispatch) = saved


# ------------------------------------------------------------------ packer
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"W": torch.randn(7, 5, generator=g), "b": torch.randn(5, generator=g)},
            "big": torch.randn(600, 600, generator=g),  # 1.44 MB: kept standalone
            "conv": torch.randn(2, 3, 4, 4, generator=g),  # 4-d: kept
            "n": [torch.randint(0, 9, (3,), generator=g, dtype=torch.int32),
                  torch.zeros((), dtype=torch.int32)],
            "h": torch.randn(9, generator=g).to(torch.bfloat16)}


def test_pack_unpack_is_bitwise_and_views_alias_the_buffers():
    tree = _tree()
    packer = LeafPacker(tree)
    assert (packer.n_packed, packer.n_kept) == (5, 2)
    packed = packer.pack(tree)
    assert sorted(packed[0]) == ["bfloat16", "float32", "int32"]
    back = packer.unpack(packed)
    for u, v in zip(tree_leaves(tree), tree_leaves(back), strict=True):
        assert u.dtype == v.dtype and torch.equal(u, v)
    assert back["big"] is tree["big"] and back["conv"] is tree["conv"]
    assert packer.is_packed(back, packed) and not packer.is_packed(tree, packed)
    back["a"]["W"].add_(1.0)  # an in-place update lands in the buffer
    assert torch.equal(packer.unpack(packed)["a"]["W"], tree["a"]["W"] + 1.0)
    stats = packer.stats()
    assert stats["leaves"] == 7 and stats["buffer_bytes"]["float32"] == 2 * 1024 * 4


@pytest.mark.parametrize("change", ["structure", "dtype", "shape"])
def test_packer_rejects_a_changed_state(change):
    tree = _tree()
    packer = LeafPacker(tree)
    other = _tree()
    if change == "structure":
        other["extra"] = torch.zeros(2)
    elif change == "dtype":
        other["a"]["b"] = other["a"]["b"].double()
    else:
        other["a"]["b"] = torch.zeros(6)
    with pytest.raises(ValueError, match="LeafPacker"):
        packer.pack(other)


def test_step_args_signature():
    x = torch.zeros(4, 3)
    a = step_args_signature((x, {"m": None, "k": torch.ones(2, dtype=torch.int64)},
                             torch.Generator()))
    assert a == (((4, 3), torch.float32, torch.device("cpu")),
                 (("k", ((2,), torch.int64, torch.device("cpu"))), ("m", None)),
                 ("Generator", torch.device("cpu")))
    assert step_args_signature((torch.zeros(5, 3),)) != step_args_signature((x,))


# ---------------------------------------------------------- grouped dispatch
def _dispatch(unroll, log, compatible=lambda a, b: a[0] == b[0], deliver=None):
    return GroupedDispatch(
        unroll, compatible,
        run_single=lambda a: log.append(("single", a)) or a[1],
        run_group=lambda todo: log.append(("group", tuple(todo))) or [a[1] for a in todo],
        deliver=deliver or (lambda args, loss: log.append(("deliver", loss))))


def test_grouped_dispatch_order_and_flush_rules():
    log = []
    gd = _dispatch(3, log)
    for i in range(4):
        gd.submit(("s", i))
    gd.submit(("t", 4))  # incompatible: flushes the one pending as a single step
    gd.flush()
    assert log == [("group", (("s", 0), ("s", 1), ("s", 2))),
                   ("deliver", 0), ("deliver", 1), ("deliver", 2),
                   ("single", ("s", 3)), ("deliver", 3),
                   ("single", ("t", 4)), ("deliver", 4)]
    log.clear()
    gd1 = _dispatch(1, log)
    gd1.submit(("s", 0))
    assert log == [("single", ("s", 0)), ("deliver", 0)]


def test_grouped_dispatch_never_runs_a_group_twice():
    """A deliver that raises mid-group leaves nothing buffered: the
    exceptional-exit drain does not dispatch the executed group again."""
    log = []

    def deliver(args, loss):
        log.append(("deliver", loss))
        if loss == 0:
            raise RuntimeError("listener boom")

    gd = _dispatch(2, log, deliver=deliver)
    gd.submit(("s", 0))
    with pytest.raises(RuntimeError, match="boom"):
        gd.submit(("s", 1))
    gd.drain_on_error()
    assert [e for e in log if e[0] == "group"] == [("group", (("s", 0), ("s", 1)))]
    # a pending batch is delivered by the drain; a drain that raises clears
    log.clear()
    gd.submit(("s", 2))
    gd.drain_on_error()
    assert log == [("single", ("s", 2)), ("deliver", 2)]


# ----------------------------------------------------------------- networks
def _jconf(seed=7):
    return (JConf.builder().seed(seed).updater(JAdam(1e-2)).list()
            .layer(JDense(n_out=32, activation="relu"))
            .layer(JDense(n_out=24, activation="tanh"))
            .layer(JOutput(n_out=5, activation="softmax", loss="mcxent"))
            .set_input_type(JInputType.feed_forward(12)).build())


def _batches(n, seed=3, rows=8, width=12, classes=5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(rows, width)).astype(np.float32),
             np.eye(classes, dtype=np.float32)[rng.integers(0, classes, rows)])
            for _ in range(n)]


@pytest.fixture(scope="module")
def mln_archive(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pack") / "mln.zip")
    JSerializer.write_model(JNet(_jconf()).init(), path)
    return path


def _port_fit(path, batches, epochs=2, unroll=1, packed=True, aot=True, listener=None):
    get_environment().set_dispatch_unroll(unroll).set_packed_state(packed).set_aot_dispatch(aot)
    net = ModelSerializer.restore_model(path, device="cpu")
    coll = CollectScoresListener()
    net.set_listeners(coll, *([listener] if listener else []))
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]), epochs=epochs)
    return [s for _, s in coll.scores], net


def _same(a, b):
    assert a[0] == b[0]
    for u, v in zip(tree_leaves(a[1].params()), tree_leaves(b[1].params()), strict=True):
        assert torch.equal(u, v)
    for u, v in zip(tree_leaves(a[1].updater_state()), tree_leaves(b[1].updater_state()),
                    strict=True):
        assert torch.equal(u, v)


@pytest.mark.parametrize("unroll,packed,aot", [(1, True, True), (3, True, True),
                                               (4, True, True), (3, True, False),
                                               (4, False, True), (1, False, False)])
def test_mln_fit_modes_bitwise_against_the_plain_loop_and_jax(mln_archive, unroll, packed, aot):
    batches = _batches(7)  # 7 % 3 and 7 % 4 != 0: partial tail groups
    got = _port_fit(mln_archive, batches, unroll=unroll, packed=packed, aot=aot)
    plain = _port_fit(mln_archive, batches, unroll=1, packed=False, aot=False)
    _same(got, plain)
    assert got[1].iteration == 14 and int(got[1].updater_state()["layer_0"]["count"]) == 14
    jnet = JSerializer.restore_multi_layer_network(mln_archive)
    jc = JCollect()
    jnet.set_listeners(jc)
    jnet.fit(JList([JDataSet(x, y) for x, y in batches], batch_size=8), epochs=2)
    np.testing.assert_allclose(got[0], [s for _, s in jc.scores], **_TOL)
    import jax
    for u, v in zip(tree_leaves(got[1].params()), jax.tree.leaves(jnet.train_state.params),
                    strict=True):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), **_TOL)


def test_packing_keeps_the_state_as_views_between_fits(mln_archive):
    _, net = _port_fit(mln_archive, _batches(3), epochs=1)
    packer, packed = net._runtime_cache["__packed__"]
    assert packer.is_packed(net._state_tree(), packed)
    aot = net._runtime_cache["__aot__"]
    n = len(aot)
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in _batches(2)]))
    assert net._runtime_cache["__packed__"][1] is packed and len(aot) == n
    net.set_params(net.params())  # rebinds the tensors: the next fit packs anew
    net.fit(ListDataSetIterator([DataSet(x, y) for x, y in _batches(2)]))
    assert net._runtime_cache["__packed__"][1] is not packed


class _Grabby(TrainingListener):
    """Reads the state: iteration k must see the Adam count after step k."""

    def __init__(self):
        self.counts = []

    def iteration_done(self, model, iteration, epoch, score):
        self.counts.append(int(model.updater_state()["layer_0"]["count"]))


def test_stateful_listener_turns_packing_and_grouping_off(mln_archive):
    lst = _Grabby()
    _, net = _port_fit(mln_archive, _batches(4), epochs=1, unroll=4, listener=lst)
    assert lst.counts == [1, 2, 3, 4]
    assert "__packed__" not in net._runtime_cache


class _RaiseOnFirst(TrainingListener):
    needs_model_state = False

    def __init__(self):
        self.calls = 0

    def iteration_done(self, model, iteration, epoch, score):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("listener boom")


def test_raising_listener_does_not_train_a_group_twice(mln_archive):
    get_environment().set_dispatch_unroll(2)
    net = ModelSerializer.restore_model(mln_archive, device="cpu")
    net.set_listeners(_RaiseOnFirst())
    with pytest.raises(RuntimeError, match="listener boom"):
        net.fit(ListDataSetIterator([DataSet(x, y) for x, y in _batches(2)]))
    assert int(net.updater_state()["layer_0"]["count"]) == 2


def test_iterator_death_with_unroll_trains_the_buffered_batches(mln_archive):
    batches = _batches(3)

    class Exploding:
        def __init__(self):
            self._i = 0

        def reset(self):
            self._i = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self._i >= 3:
                raise RuntimeError("died")
            self._i += 1
            return DataSet(*batches[self._i - 1])

    get_environment().set_dispatch_unroll(4)
    net = ModelSerializer.restore_model(mln_archive, device="cpu")
    with pytest.raises(RuntimeError, match="died"):
        net.fit(Exploding())
    assert int(net.updater_state()["layer_0"]["count"]) == 3


# ----------------------------------------------------------- graph, SameDiff
@pytest.fixture(scope="module")
def graph_archive(tmp_path_factory):
    g = (JConf.builder().seed(13).updater(JAdam(1e-2)).graph_builder().add_inputs("in"))
    g.add_layer("d1", JDense(n_out=16, activation="relu"), "in")
    g.add_layer("d2", JDense(n_out=16, activation="relu"), "d1")
    g.add_vertex("add", JAdd(op="add"), "d1", "d2")
    g.add_layer("out", JOutput(n_out=3, activation="softmax", loss="mcxent"), "add")
    g.set_outputs("out")
    g.set_input_types(JInputType.feed_forward(8))
    path = str(tmp_path_factory.mktemp("pack") / "cg.zip")
    JSerializer.write_model(JGraph(g.build()).init(), path)
    return path


@pytest.mark.parametrize("unroll,packed", [(1, True), (3, True), (4, True), (4, False)])
def test_graph_fit_modes_bitwise_and_against_jax(graph_archive, unroll, packed):
    batches = _batches(7, seed=12, rows=10, width=8, classes=3)
    got = _port_fit(graph_archive, batches, unroll=unroll, packed=packed)
    plain = _port_fit(graph_archive, batches, unroll=1, packed=False, aot=False)
    _same(got, plain)
    jnet = JSerializer.restore_computation_graph(graph_archive)
    jc = JCollect()
    jnet.set_listeners(jc)
    jnet.fit(JList([JDataSet(x, y) for x, y in batches], batch_size=10), epochs=2)
    np.testing.assert_allclose(got[0], [s for _, s in jc.scores], **_TOL)


def _sd_mlp(cls, tc, updater):
    rng = np.random.default_rng(5)
    sd = cls() if cls is JSameDiff else cls(device="cpu")
    x = sd.placeholder("x", shape=(None, 6))
    y = sd.placeholder("y", shape=(None, 3))
    w1 = sd.var("w1", array=rng.normal(size=(6, 16)).astype(np.float32) * 0.3)
    b1 = sd.var("b1", array=np.zeros(16, np.float32))
    w2 = sd.var("w2", array=rng.normal(size=(16, 3)).astype(np.float32) * 0.3)
    h = sd.nn.relu(x.mmul(w1) + b1)
    logits = h.mmul(w2)
    loss = sd.loss.softmax_cross_entropy("loss", y, logits)
    sd.set_loss_variables(loss)
    sd.set_training_config(tc(updater=updater, data_set_feature_mapping=["x"],
                              data_set_label_mapping=["y"]))
    return sd


@pytest.mark.parametrize("unroll,packed", [(1, True), (3, True), (4, True), (4, False)])
def test_samediff_fit_modes_bitwise_and_against_jax(_port_on_cpu, unroll, packed):
    batches = _batches(7, seed=4, rows=10, width=6, classes=3)
    runs = []
    for u, p, a in [(unroll, packed, True), (1, False, False)]:
        _port_on_cpu.set_dispatch_unroll(u).set_packed_state(p).set_aot_dispatch(a)
        sd = _sd_mlp(SameDiff, TrainingConfig, Adam(1e-2))
        hist = sd.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]), epochs=2)
        runs.append((list(hist), {n: sd.arrays[n].clone() for n in ("w1", "b1", "w2")}))
    assert runs[0][0] == runs[1][0]
    for n in runs[0][1]:
        assert torch.equal(runs[0][1][n], runs[1][1][n])
    jsd = _sd_mlp(JSameDiff, JTrainingConfig, JAdam(1e-2))
    jh = jsd.fit(JList([JDataSet(x, y) for x, y in batches], batch_size=10), epochs=2)
    np.testing.assert_allclose(runs[0][0], list(jh), **_TOL)
    for n, t in runs[0][1].items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jsd.arrays[n]), **_TOL)
