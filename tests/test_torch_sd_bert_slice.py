"""The imported-BERT fine-tuning slice (BASELINE config #4 as
``bench_imported_bert`` runs it) in the port against the JAX package.

A BERT of 2 layers, hidden 32, 2 heads, T=16, vocab 50: the port's
``build_bert_samediff`` against the JAX package's TF import of
``build_bert_graphdef`` from the same seed (the same ops in the same order,
the same variables and arrays, the same outputs), the port's ``optimize()``
on its own graph against the JAX package's on the import; then the JAX
package's recipe (import, optimize, ``graft_classifier``,
``convert_to_variable``, Adam) written to an archive and fit five steps over
``ExistingDataSetIterator`` of MultiDataSets in both packages, in float32
and once with bf16 compute over fp32 masters; ``calculate_gradients``;
archives with ``updaterState.npz`` both ways, and an exact resume.

Float32: outputs, losses, gradients and weights 1e-5 (an Adam step moves a
weight by about lr whatever its gradient's size, so the key biases, whose
gradient is rounding noise, may step apart: they are held to 1e-5 plus
lr). bf16: the two packages round different intermediates to
bf16 (XLA keeps float32 inside a fusion, PyTorch rounds every op's output),
so the losses are held to 2e-2, the bf16 fine-tuning tolerance of
``chip_smoke.py``.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402

from deeplearning4j_tpu.autodiff.graph_optimizer import optimize as joptimize  # noqa: E402
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff  # noqa: E402
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTrainingConfig  # noqa: E402
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet  # noqa: E402
from deeplearning4j_tpu.data.iterators import (  # noqa: E402
    ExistingDataSetIterator as JExistingDataSetIterator)
from deeplearning4j_tpu.imports import TFGraphMapper  # noqa: E402
from deeplearning4j_tpu.imports import tf_oracles as joracles  # noqa: E402
from deeplearning4j_tpu.runtime.environment import \
    get_environment as jax_environment  # noqa: E402
from deeplearning4j_tpu.train.updaters import Adam as JAdam  # noqa: E402
from deeplearning4j_tpu_torch.autodiff.graph_optimizer import optimize  # noqa: E402
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff  # noqa: E402
from deeplearning4j_tpu_torch.data import ExistingDataSetIterator, MultiDataSet  # noqa: E402
from deeplearning4j_tpu_torch.imports import tf_oracles  # noqa: E402
from deeplearning4j_tpu_torch.runtime.environment import get_environment  # noqa: E402
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves  # noqa: E402

KW = dict(batch=2, seq_len=16, hidden=32, layers=2, heads=2, intermediate=64, vocab=50, seed=0)
LR = 1e-3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


@pytest.fixture(scope="module")
def graphdef():
    gd, inputs, outputs, weights = joracles.build_bert_graphdef(**KW)
    return gd, inputs, outputs, weights


def _feeds(inputs, seed):
    ids, types, mask, labels = joracles.bert_synthetic_batch(2, 16, 50, seed=seed)
    return dict(zip(inputs, [ids, types, mask])), labels


def _batches(n, seed0=10):
    return [joracles.bert_synthetic_batch(2, 16, 50, seed=seed0 + i) for i in range(n)]


def test_builder_is_the_jax_import(graphdef):
    gd, inputs, outputs, weights = graphdef
    jsd = TFGraphMapper.import_graph(gd, optimize=False)
    sd, t_in, t_out, t_w = tf_oracles.build_bert_samediff(**KW)
    assert (t_in, t_out) == (inputs, outputs)
    assert sorted(t_w) == sorted(weights)
    for k in weights:
        np.testing.assert_array_equal(t_w[k], weights[k])
    assert [(n.op, n.inputs, n.outputs, n.attrs) for n in sd.ops] == \
        [(n.op, n.inputs, n.outputs, n.attrs) for n in jsd.ops]
    # the GraphDef lists its placeholders in an order of its own; the rest
    # are made in op order
    assert {n: (v.vtype.value, v.shape) for n, v in sd.vars.items()} == \
        {n: (v.vtype.value, v.shape) for n, v in jsd.vars.items()}
    not_ph = [n for n, v in jsd.vars.items() if v.vtype.value != "placeholder"]
    assert [n for n, v in sd.vars.items() if v.vtype.value != "placeholder"] == not_ph
    assert list(sd.arrays) == list(jsd.arrays)
    for n, a in jsd.arrays.items():
        assert str(sd.arrays[n].dtype).replace("torch.", "") == np.asarray(a).dtype.name
        np.testing.assert_array_equal(sd.arrays[n].numpy(), np.asarray(a))
    from collections import Counter
    assert Counter(n.op for n in sd.ops) == Counter(n.op for n in jsd.ops)
    feeds, _ = _feeds(inputs, 1)
    for name in ("sequence_output", "pooled_output", *outputs):
        np.testing.assert_allclose(sd.output(feeds, name).numpy(),
                                   np.asarray(jsd.output(feeds, name)), rtol=1e-5, atol=1e-5)


def test_optimize_the_builder_as_jax_optimizes_the_import(graphdef):
    gd, inputs, _, _ = graphdef
    jsd = TFGraphMapper.import_graph(gd, optimize=False)
    sd, _, _, _ = tf_oracles.build_bert_samediff(**KW)
    js, ts = joptimize(jsd), optimize(sd)
    assert ts == js
    assert (ts["layer_norm"], ts["gelu_erf"], ts["attention"]) == (5, 2, 2)
    assert [(n.op, n.inputs, n.outputs) for n in sd.ops] == \
        [(n.op, n.inputs, n.outputs) for n in jsd.ops]
    ops = {n.op for n in sd.ops}
    assert ops == {"add", "cast", "gather", "gelu", "identity", "layer_norm", "matmul", "mul",
                   "reshape", "scaled_dot_product_attention", "strided_slice", "sub", "tanh",
                   "transpose"}
    feeds, _ = _feeds(inputs, 2)
    np.testing.assert_allclose(sd.output(feeds, "pooled_output").numpy(),
                               np.asarray(jsd.output(feeds, "pooled_output")), rtol=1e-5,
                               atol=1e-5)


def _jax_recipe(gd, inputs, tmp_path, name="recipe.sdz"):
    """bench_imported_bert's recipe at the small size, in the JAX package,
    and its archive."""
    jsd = TFGraphMapper.import_graph(gd)
    joracles.graft_classifier(jsd, "pooled_output", hidden=KW["hidden"], n_classes=2)
    jsd.convert_to_variable(*jsd.trainable_float_constants())
    jsd.set_loss_variables("finetune_loss")
    jsd.set_training_config(JTrainingConfig(
        updater=JAdam(LR), data_set_feature_mapping=list(inputs),
        data_set_label_mapping=["labels"]))
    path = str(tmp_path / name)
    jsd.save(path)
    return jsd, path


def _jfit(jsd, batches):
    it = JExistingDataSetIterator([JMultiDataSet(features=list(b[:3]), labels=[b[3]])
                                   for b in batches])
    return list(jsd.fit(it))


def _tfit(sd, batches):
    it = ExistingDataSetIterator([MultiDataSet(features=list(b[:3]), labels=[b[3]])
                                  for b in batches])
    return list(sd.fit(it))


# the key projections' biases (``add_{5 + 14 i}/y``, layer i): the softmax
# cancels them, so their gradient is zero in exact arithmetic and Adam steps
# them by rounding noise
KEY_BIASES = {f"add_{5 + 14 * i}/y" for i in range(KW["layers"])}


def _assert_weights(sd, jsd, atol=1e-5):
    for n, a in jsd.arrays.items():
        tol = atol + (LR if n in KEY_BIASES else 0.0)
        np.testing.assert_allclose(sd.arrays[n].numpy(), np.asarray(a), rtol=1e-5, atol=tol,
                                   err_msg=n)


def test_fit_five_steps_from_one_archive(graphdef, tmp_path):
    gd, inputs, _, _ = graphdef
    jsd, path = _jax_recipe(gd, inputs, tmp_path)
    sd = SameDiff.load(path)
    assert len(sd._trainable()) == len(jsd._trainable()) == 16 * 2 + 9
    feeds, labels = _feeds(inputs, 3)
    feeds["labels"] = labels
    tg, jg = sd.calculate_gradients(feeds), jsd.calculate_gradients(feeds)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n].numpy(), np.asarray(jg[n]), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    batches = _batches(5)
    jl, tl = _jfit(jsd, batches), _tfit(sd, batches)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    _assert_weights(sd, jsd)
    jleaves, tleaves = jax.tree.leaves(jsd._opt_state), tree_leaves(sd._opt_state)
    assert [np.shape(a) for a in jleaves] == [tuple(t.shape) for t in tleaves]
    assert int(tleaves[0]) == int(jleaves[0]) == 5


def test_fit_bf16_compute_over_fp32_masters(graphdef, tmp_path):
    gd, inputs, _, _ = graphdef
    jsd, path = _jax_recipe(gd, inputs, tmp_path)
    sd = SameDiff.load(path)
    batches = _batches(5)
    jenv = jax_environment()
    get_environment().allow_bfloat16()
    jenv.allow_bfloat16()
    try:
        jl = _jfit(jsd, batches)
        tl = _tfit(sd, batches)
    finally:
        import jax.numpy as jnp
        jenv.set_compute_dtype(jnp.float32)
    np.testing.assert_allclose(tl, jl, atol=2e-2)
    assert all(sd.arrays[n].dtype.is_floating_point and str(sd.arrays[n].dtype) ==
               "torch.float32" for n in sd._trainable())
    # the fp32 masters moved by the same Adam steps, but where bf16 rounding
    # flips the sign of a gradient that is near zero: Adam steps such a
    # weight by about lr either way, so 5 steps may part it by up to 10 lr
    _assert_weights(sd, jsd, atol=10 * LR)


def test_archives_resume_both_ways(graphdef, tmp_path):
    gd, inputs, _, _ = graphdef
    jsd, path = _jax_recipe(gd, inputs, tmp_path)
    sd = SameDiff.load(path)
    batches = _batches(7)
    _jfit(jsd, batches[:5])
    _tfit(sd, batches[:5])
    p_port, p_jax = str(tmp_path / "port.sdz"), str(tmp_path / "jax.sdz")
    sd.save(p_port, save_updater_state=True)
    jsd.save(p_jax, save_updater_state=True)
    j_from_port, t_from_jax = JSameDiff.load(p_port), SameDiff.load(p_jax)
    assert j_from_port._train_iter == t_from_jax._train_iter == 5
    for a, b in zip(jax.tree.leaves(j_from_port._opt_state), tree_leaves(sd._opt_state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jax.tree.leaves(jsd._opt_state), tree_leaves(t_from_jax._opt_state)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jl, tl = _jfit(j_from_port, batches[5:]), _tfit(t_from_jax, batches[5:])
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    _assert_weights(t_from_jax, j_from_port)


def test_exact_resume_in_the_port(graphdef, tmp_path):
    gd, inputs, _, _ = graphdef
    _, path = _jax_recipe(gd, inputs, tmp_path)
    batches = _batches(5)
    whole = SameDiff.load(path)
    full = _tfit(whole, batches)
    first = SameDiff.load(path)
    head = _tfit(first, batches[:3])
    mid = str(tmp_path / "mid.sdz")
    first.save(mid, save_updater_state=True)
    second = SameDiff.load(mid)
    tail = _tfit(second, batches[3:])
    np.testing.assert_array_equal(np.asarray(head + tail), np.asarray(full))
    for n in whole._trainable():
        np.testing.assert_array_equal(second.arrays[n].numpy(), whole.arrays[n].numpy())


def test_learns_a_learnable_rule(graphdef, tmp_path):
    """Rows of their label's token only: the small net's loss falls under
    Adam(1e-2)."""
    from deeplearning4j_tpu_torch.autodiff import TrainingConfig
    from deeplearning4j_tpu_torch.train.updaters import Adam
    gd, inputs, _, _ = graphdef
    _, path = _jax_recipe(gd, inputs, tmp_path)
    sd = SameDiff.load(path)
    sd.set_training_config(TrainingConfig(updater=Adam(1e-2),
                                          data_set_feature_mapping=list(inputs),
                                          data_set_label_mapping=["labels"]))
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(20):
        y = rng.integers(0, 2, 2)
        ids = np.repeat(np.where(y == 1, 20, 10)[:, None], 16, axis=1).astype(np.int32)
        batches.append((ids, np.zeros_like(ids), np.ones_like(ids),
                        np.eye(2, dtype=np.float32)[y]))
    losses = _tfit(sd, batches)
    assert np.mean(losses[-3:]) < 0.5 * np.mean(losses[:3]), losses
