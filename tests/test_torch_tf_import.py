"""The port's TF GraphDef importer against the JAX package's, on the CPU.

Each TensorFlow case of ``tests/test_imports.py`` (the MLP, the attention
block, PartitionedCall, functional While and If, lowered Switch/Merge
conditionals in both ``lazy_conditionals`` modes, the branch-heavy and
static-fold conditionals, the untaken branch's clean gradient, einsum /
deconvolution / resize / a computed reshape, the simple-op batch, dropout
live in ``fit``, TF1 while frames with invariants, nested frames, and the
differentiable ``while_max_iterations`` form with a fine-tune through the
loop; the SavedModel entry point) is imported by both packages from one
GraphDef: the same op list (op, inputs, outputs, attrs; a control-flow
callable on both sides at the same place), the same variables, and the
same outputs within 1e-5 (absolute and relative), both also within 1e-5
of TensorFlow. The port reads the GraphDef with its own reader, given as
the tensorflow message, as its bytes' path, and as the reader's message.

TF1's corner-aligned resizes (``ResizeBilinear`` with
``half_pixel_centers=False`` or ``align_corners``, ``ResizeNearestNeighbor``
with ``align_corners``) are refused by both importers with one message.

The tiny BERT of ``tests/test_tf_bert_import.py``: the port's import
before ``optimize()`` has exactly ``build_bert_samediff``'s op list, and
after it the JAX import's; grafted and fine-tuned three Adam steps in both
packages from the same weights, the losses agree within 1e-5 and the
weights within 1e-5 (1e-5 + lr on the key biases Adam steps by rounding
noise).
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import _torch_tf_graphs as graphs  # noqa: E402
import jax  # noqa: E402
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff  # noqa: E402
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTrainingConfig  # noqa: E402
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet  # noqa: E402
from deeplearning4j_tpu.imports import TFGraphMapper as JMapper  # noqa: E402
from deeplearning4j_tpu.imports import tf_oracles as joracles  # noqa: E402
from deeplearning4j_tpu.train.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu.train.updaters import Sgd as JSgd  # noqa: E402
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, TrainingConfig  # noqa: E402
from deeplearning4j_tpu_torch.data import MultiDataSet  # noqa: E402
from deeplearning4j_tpu_torch.imports import TFGraphMapper, tf_oracles  # noqa: E402
from deeplearning4j_tpu_torch.imports import graphdef_proto  # noqa: E402
from deeplearning4j_tpu_torch.runtime.environment import get_environment  # noqa: E402
from deeplearning4j_tpu_torch.train.updaters import Adam, Sgd  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _norm(v):
    if isinstance(v, (tuple, list)):
        return [_norm(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


def _ops(sd):
    return [(n.op, list(n.inputs), list(n.outputs),
             {} if n.op == "__callable__" else {k: _norm(v) for k, v in n.attrs.items()})
            for n in sd.ops]


def assert_same_graph(sd, jsd):
    assert _ops(sd) == _ops(jsd)
    assert {n: v.vtype.value for n, v in sd.vars.items()} == \
        {n: v.vtype.value for n, v in jsd.vars.items()}
    assert sorted(sd.arrays) == sorted(jsd.arrays)
    for n, a in jsd.arrays.items():
        np.testing.assert_array_equal(sd.arrays[n].numpy(), np.asarray(a), err_msg=n)


def _import_both(case):
    kw = case.get("kw", {})
    return TFGraphMapper.import_graph(case["gd"], **kw), JMapper.import_graph(case["gd"], **kw)


OUTPUT_CASES = ["mlp", "attention_block", "partitioned_call", "while_loop", "cond",
                "cond_branch_heavy", "cond_static_fold", "cond_eager_optout", "functional_if",
                "einsum_deconv_resize", "simple_op_batch", "tf1_frames",
                "tf1_invariant_multi_carry", "tf1_nested", "while_max_iterations"]


@pytest.mark.parametrize("name", OUTPUT_CASES)
def test_import_matches_jax(name):
    case = graphs.build(name)
    sd, jsd = _import_both(case)
    assert_same_graph(sd, jsd)
    if "lazy" in case:  # the Merge lowered lazily (a callable) or to where
        merges = {n.name for n in case["gd"].node if n.op == "Merge"}
        lowered = [o.op for o in sd.ops if o.outputs[0] in merges]
        assert lowered and set(lowered) == {"__callable__" if case["lazy"] else "where"}
    for feeds, want in zip(case["feeds"], case["want"]):
        for name_, w in zip(case["out"], want):
            got = sd.output(feeds, name_).numpy()
            jgot = np.asarray(jsd.output(feeds, name_))
            np.testing.assert_allclose(got, jgot, rtol=TOL, atol=TOL, err_msg=name_)
            np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-5, err_msg=name_)


LEGACY_RESIZES = [  # (id, raw op, align_corners, half_pixel_centers)
    ("bilinear-legacy-origin", "ResizeBilinear", False, False),
    ("bilinear-align-corners", "ResizeBilinear", True, False),
    ("nearest-align-corners", "ResizeNearestNeighbor", True, False),
]


@pytest.mark.parametrize("case", LEGACY_RESIZES, ids=[c[0] for c in LEGACY_RESIZES])
def test_legacy_resizes_are_refused_by_name_as_jax(case):
    """TF1's corner-aligned resizes are refused by both importers, with the
    same message naming the node."""
    _, op, align, half = case

    def model(x):
        return getattr(tf.raw_ops, op)(images=x, size=[6, 4], align_corners=align,
                                       half_pixel_centers=half, name="legacy_resize")

    gd, _, _ = graphs.frozen_graphdef(model, [tf.TensorSpec((1, 3, 2, 2), tf.float32, name="x")])
    errors = []
    for mapper in (TFGraphMapper, JMapper):
        with pytest.raises(NotImplementedError, match="'legacy_resize'") as e:
            mapper.import_graph(gd)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_graphdef_forms_and_device(tmp_path):
    """The tensorflow message, a ``str`` or ``bytes`` path and the reader's
    message import alike; the arrays live on the requested device."""
    case = graphs.build("mlp")
    path = tmp_path / "mlp.pb"
    path.write_bytes(case["gd"].SerializeToString())
    forms = [case["gd"], str(path), str(path).encode(), graphdef_proto.read_graph_def(str(path))]
    ref = TFGraphMapper.import_graph(forms[0])
    for form in forms[1:]:
        sd = TFGraphMapper.import_graph(form, device="cpu")
        assert _ops(sd) == _ops(ref)
        assert all(a.device.type == "cpu" for a in sd.arrays.values())
        np.testing.assert_array_equal(sd.output(case["feeds"][0], case["out"][0]).numpy(),
                                      ref.output(case["feeds"][0], case["out"][0]).numpy())


def test_eager_optout_archive_crosses_packages(tmp_path):
    """``lazy_conditionals=False`` keeps the graph serializable: the port's
    archive loads in the JAX package and the JAX one in the port."""
    case = graphs.build("cond_eager_optout")
    sd, jsd = _import_both(case)
    sd.save(str(tmp_path / "t.sdz"))
    jsd.save(str(tmp_path / "j.sdz"))
    j_from_t, t_from_j = JSameDiff.load(str(tmp_path / "t.sdz")), SameDiff.load(
        str(tmp_path / "j.sdz"))
    for feeds in case["feeds"]:
        a = np.asarray(j_from_t.output(feeds, case["out"][0]))
        b = t_from_j.output(feeds, case["out"][0]).numpy()
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_untaken_branch_gradient_is_clean():
    """The lazy cond runs only the taken branch's backward: the untaken
    ``sqrt`` at zero does not poison the constant's gradient."""
    case = graphs.build("cond_untaken_branch")
    grads = []
    for sd in _import_both(case):
        sd.convert_to_variable("w_const")
        loss = sd.invoke("reduce_sum", sd.vars[case["out"][0]], name="probe_loss")
        sd.set_loss_variables(loss.name)
        grads.append(np.asarray(sd.calculate_gradients(case["feeds"][0], "w_const")["w_const"]))
    assert np.all(np.isfinite(grads[0]))
    np.testing.assert_allclose(grads[0], grads[1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(grads[0], np.full_like(grads[0], 3.0), rtol=1e-6)


def test_while_max_iterations_fine_tunes_like_jax():
    """Eight SGD steps through the masked fixed-length loop in both
    packages: the same losses, falling."""
    case = graphs.build("while_max_iterations")
    x = case["feeds"][0][case["inputs"][0]]
    y = np.zeros((2, 4), np.float32)
    losses = []
    tsd, jsd = _import_both(case)
    for sd, tc, sgd in ((tsd, TrainingConfig, Sgd), (jsd, JTrainingConfig, JSgd)):
        out_v = sd.vars[case["out"][0]]
        labels = sd.placeholder("labels", (None, 4))
        sd.loss.mean_squared_error("loss", labels, out_v)
        sd.set_loss_variables("loss")
        sd.convert_to_variable(*sd.trainable_float_constants())
        sd.set_training_config(tc(updater=sgd(0.05), data_set_feature_mapping=[case["inputs"][0]],
                                  data_set_label_mapping=["labels"]))
        run = []
        for _ in range(8):
            run.extend(sd.fit(x, y, epochs=1))
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=TOL, atol=TOL)
    assert losses[0][-1] < losses[0][0] * 0.9


def test_training_dropout_is_live_in_fit():
    """An exported dropout (a RandomUniform node): deterministic in
    ``output``, a fresh mask at every ``fit`` step (lr 0, the loss moves),
    and its draws keep the law (about half the units dropped, the kept
    ones scaled by 2)."""
    case = graphs.build("training_dropout")
    sd = TFGraphMapper.import_graph(case["gd"])
    jsd = JMapper.import_graph(case["gd"])
    assert _ops(sd) == _ops(jsd)
    x = case["x"]
    o1 = sd.output({case["inputs"][0]: x}, case["out"][0]).numpy()
    o2 = sd.output({case["inputs"][0]: x}, case["out"][0]).numpy()
    np.testing.assert_array_equal(o1, o2)
    dense = x @ np.random.default_rng(0).normal(0, 1, (8, 8)).astype(np.float32)
    kept = o1 != 0
    assert 0.35 < kept.mean() < 0.65
    np.testing.assert_allclose(o1[kept], 2 * dense[kept], rtol=1e-5, atol=1e-5)
    labels = sd.placeholder("labels", (None, 8))
    sd.loss.mean_squared_error("loss", labels, sd.vars[case["out"][0]])
    sd.set_loss_variables("loss")
    sd.set_training_config(TrainingConfig(updater=Sgd(0.0),
                                          data_set_feature_mapping=[case["inputs"][0]],
                                          data_set_label_mapping=["labels"]))
    losses = []
    for _ in range(3):
        losses.extend(sd.fit(x, np.zeros((16, 8), np.float32), epochs=1))
    assert len(set(np.round(losses, 10))) > 1, losses


def test_saved_model(tmp_path):
    path = str(tmp_path / "sm")
    x, want = graphs.saved_model(path)
    sd, inputs, outputs = TFGraphMapper.import_saved_model(path)
    jsd, jin, jout = JMapper.import_saved_model(path)
    assert (inputs, outputs) == (jin, jout)
    got = sd.output({inputs[0]: x}, outputs[0]).numpy()
    np.testing.assert_allclose(got, np.asarray(jsd.output({jin[0]: x}, jout[0])), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_saved_model_without_tensorflow_names_it(monkeypatch, tmp_path):
    import builtins
    real = builtins.__import__

    def no_tf(name, *a, **k):
        if name.split(".")[0] == "tensorflow":
            raise ImportError("No module named 'tensorflow'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tf)
    with pytest.raises(ImportError, match="tensorflow"):
        TFGraphMapper.import_saved_model(str(tmp_path / "sm"))


# ---------------------------------------------------------------- tiny BERT
BERT = dict(batch=2, seq_len=32, hidden=64, layers=4, heads=4, intermediate=128, vocab=97,
            seed=0)
LR = 5e-4
KEY_BIASES = {f"add_{5 + 14 * i}/y" for i in range(BERT["layers"])}


@pytest.fixture(scope="module")
def bert_graphdef():
    return joracles.build_bert_graphdef(**BERT)


def test_tiny_bert_op_list_is_the_builders(bert_graphdef):
    gd, inputs, outputs, _ = bert_graphdef
    sd = TFGraphMapper.import_graph(gd, optimize=False)
    built, b_in, b_out, _ = tf_oracles.build_bert_samediff(**BERT, device="cpu")
    assert (b_in, b_out) == (inputs, outputs)
    assert _ops(sd) == _ops(built)
    assert sorted(sd.arrays) == sorted(built.arrays)
    for n, a in built.arrays.items():
        assert sd.arrays[n].dtype == a.dtype
        assert np.array_equal(sd.arrays[n].numpy(), a.numpy()), n


def test_tiny_bert_fine_tune_matches_jax(bert_graphdef):
    gd, inputs, outputs, _ = bert_graphdef
    sd, jsd = TFGraphMapper.import_graph(gd), JMapper.import_graph(gd)
    assert _ops(sd) == _ops(jsd)
    batches = [joracles.bert_synthetic_batch(2, 32, 97, seed=1 + i) for i in range(3)]
    losses = []
    for g, oracles, tc, adam, mds in ((sd, tf_oracles, TrainingConfig, Adam, MultiDataSet),
                                      (jsd, joracles, JTrainingConfig, JAdam, JMultiDataSet)):
        oracles.graft_classifier(g, "pooled_output", hidden=BERT["hidden"], n_classes=2)
        g.convert_to_variable(*g.trainable_float_constants())
        g.set_loss_variables("finetune_loss")
        g.set_training_config(tc(updater=adam(LR), data_set_feature_mapping=list(inputs),
                                 data_set_label_mapping=["labels"]))
        run = []
        for b in batches:
            run.extend(g.fit(mds(features=list(b[:3]), labels=[b[3]]), epochs=1))
        losses.append(run)
    np.testing.assert_allclose(losses[0], losses[1], rtol=TOL, atol=TOL)
    for n, a in jsd.arrays.items():
        np.testing.assert_allclose(sd.arrays[n].numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL + (LR if n in KEY_BIASES else 0.0), err_msg=n)
    assert jax.tree.leaves(jsd._opt_state)[0] == 3


# ---------------------------------------------------------- BERT fixture
def test_stripped_graph_imports_as_the_unstripped_one(bert_graphdef):
    """The fixture's stripping (one-value fills, weight matrices zeroed) and
    the port's refill from ``bert_weights``, at the tiny width: the port's
    import of the refilled graph equals the JAX import of the unstripped
    one (op list, arrays bit for bit, outputs within 1e-5)."""
    from _torch_bert_fixture import strip
    gd, inputs, outputs, weights = bert_graphdef
    stripped, refill = strip(gd, weights)
    data = stripped.SerializeToString(deterministic=True)
    assert len(data) < len(gd.SerializeToString()) / 5
    msg = graphdef_proto.parse_graph_def(data)
    tf_oracles.refill_bert_graphdef(msg, refill, tf_oracles.bert_weights(
        BERT["seq_len"], BERT["hidden"], BERT["layers"], BERT["intermediate"], BERT["vocab"],
        seed=BERT["seed"]))
    sd, jsd = TFGraphMapper.import_graph(msg), JMapper.import_graph(gd)
    assert_same_graph(sd, jsd)
    ids, types, mask, _ = joracles.bert_synthetic_batch(2, 32, 97, seed=4)
    feeds = dict(zip(inputs, [ids, types, mask]))
    for name in outputs:
        np.testing.assert_allclose(sd.output(feeds, name).numpy(),
                                   np.asarray(jsd.output(feeds, name)), rtol=TOL, atol=TOL)


def test_committed_bert_base_fixture_reads():
    """The committed BERT-base fixture: BASELINE config #4's shape, under
    1 MB, and its 76 stripped matrices named for their ``bert_weights``
    keys (each a zero fill of a matrix's shape)."""
    import json
    from _torch_bert_fixture import CONFIG, PB, SIDECAR
    import os
    assert os.path.getsize(PB) + os.path.getsize(SIDECAR) < 1 << 20
    with open(SIDECAR) as f:
        side = json.load(f)
    assert side["config"] == CONFIG
    keys = {"word_emb", "pos_emb", "type_emb", "pool_w"} | {
        f"l{i}_{nm}_w" for i in range(12) for nm in ("q", "k", "v", "ao", "ff1", "ff2")}
    assert set(side["refill"].values()) == keys
    gd = graphdef_proto.read_graph_def(PB)
    nodes = {n.name: n for n in gd.node}
    for name in side["refill"]:
        arr = graphdef_proto.make_ndarray(nodes[name].attr["value"].tensor)
        assert arr.ndim == 2 and not arr.any()
    assert [n.name for n in gd.node if n.op == "Placeholder"] and \
        set(side["inputs"]) <= set(nodes)


@pytest.mark.slow
def test_bert_base_fixture_rebuilds_byte_for_byte():
    """Rebuilding the fixture with tensorflow (a 440 MB graph before it is
    stripped) gives the committed bytes and sidecar."""
    import json
    from _torch_bert_fixture import PB, SIDECAR, build
    data, sidecar = build()
    with open(PB, "rb") as f:
        assert f.read() == data
    with open(SIDECAR) as f:
        assert json.load(f) == json.loads(json.dumps(sidecar))
