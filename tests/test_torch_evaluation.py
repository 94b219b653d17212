"""The port's evaluation classes against the JAX package's, on the CPU.

Both are host numpy over the same seeded predictions, so the confusion
matrices, counts and ``stats()`` text must be identical and every metric
equal: ``Evaluation`` (one-hot and integer labels, top-N, sequence output
under a mask, ``merge`` of partial evaluations), ``RegressionEvaluation``
(with and without a mask) and ``ROC``/``ROCBinary``/``ROCMultiClass``
(exact and thresholded). The networks' ``evaluate``,
``evaluate_regression`` and ``evaluate_roc`` run in
``tests/test_torch_lenet_slice.py``.
"""

import numpy as np
import pytest

from deeplearning4j_tpu.evaluation import evaluation as jev
from deeplearning4j_tpu.evaluation import regression as jreg
from deeplearning4j_tpu.evaluation import roc as jroc
from deeplearning4j_tpu_torch.evaluation import evaluation as tev
from deeplearning4j_tpu_torch.evaluation import regression as treg
from deeplearning4j_tpu_torch.evaluation import roc as troc


def _probs(rng, n, c):
    z = rng.normal(0, 1.5, (n, c))
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _same(t, j):
    np.testing.assert_array_equal(t.confusion_matrix(), j.confusion_matrix())
    assert t.total == j.total and t.top_n_correct == j.top_n_correct
    assert t.stats() == j.stats()
    for m in ("accuracy", "top_n_accuracy", "precision", "recall", "f1",
              "matthews_correlation"):
        a, b = getattr(t, m)(), getattr(j, m)()
        assert a == b or (np.isnan(a) and np.isnan(b)), m
    for cls in range(t.num_classes):
        assert (t.precision(cls), t.recall(cls), t.f1(cls)) == \
            (j.precision(cls), j.recall(cls), j.f1(cls))


@pytest.mark.parametrize("top_n,int_labels,names", [(1, False, None), (3, True, None),
                                                    (1, True, ["zero", "one", "two", "three",
                                                               "four"])],
                         ids=["onehot", "int_labels_top3", "label_names"])
def test_evaluation_matches_jax(top_n, int_labels, names):
    rng = np.random.default_rng(0)
    t, j = tev.Evaluation(labels=names, top_n=top_n), jev.Evaluation(labels=names, top_n=top_n)
    for _ in range(3):
        p = _probs(rng, 50, 5)
        lab = rng.integers(0, 5, 50)
        y = lab if int_labels else np.eye(5, dtype=np.float32)[lab]
        t.eval(y, p)
        j.eval(y, p)
    _same(t, j)
    assert t.stats().startswith("========================Evaluation Metrics")


def test_evaluation_of_masked_sequences_and_merge_matches_jax():
    """Rank-3 output flattened over time, masked steps dropped; partial
    evaluations merged as a distributed evaluation would."""
    rng = np.random.default_rng(1)
    parts_t, parts_j = [], []
    for _ in range(3):
        p = _probs(rng, 4 * 7, 3).reshape(4, 7, 3)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (4, 7))]
        mask = (rng.random((4, 7)) > 0.4).astype(np.float32)
        t, j = tev.Evaluation(), jev.Evaluation()
        t.eval(y, p, mask=mask)
        j.eval(y, p, mask=mask)
        _same(t, j)
        parts_t.append(t)
        parts_j.append(j)
    t, j = tev.Evaluation(), jev.Evaluation()
    for a, b in zip(parts_t, parts_j):
        t.merge(a)
        j.merge(b)
    t.merge(tev.Evaluation())  # an empty part changes nothing
    _same(t, j)
    assert t.total == sum(a.total for a in parts_t)
    assert tev.Evaluation().stats() == jev.Evaluation().stats() == "Evaluation: no data"


@pytest.mark.parametrize("masked", [False, True], ids=["rows", "masked_sequences"])
def test_regression_evaluation_matches_jax(masked):
    rng = np.random.default_rng(2)
    t, j = treg.RegressionEvaluation(), jreg.RegressionEvaluation()
    for _ in range(3):
        shape = (5, 6, 3) if masked else (40, 3)
        y = rng.normal(0, 2, shape).astype(np.float32)
        p = (y + rng.normal(0, 0.5, shape)).astype(np.float32)
        m = (rng.random(shape[:2]) > 0.3).astype(np.float32) if masked else None
        t.eval(y, p, mask=m)
        j.eval(y, p, mask=m)
    assert t.n == j.n and t.stats() == j.stats()
    for c in range(3):
        for name in ("mean_squared_error", "mean_absolute_error", "root_mean_squared_error",
                     "r_squared", "pearson_correlation"):
            assert getattr(t, name)(c) == getattr(j, name)(c), (name, c)
    assert t.average_mean_squared_error() == j.average_mean_squared_error()
    assert t.average_r_squared() == j.average_r_squared()
    one_t, one_j = treg.RegressionEvaluation(), jreg.RegressionEvaluation()
    y = rng.normal(0, 1, 20)
    one_t.eval(y, y * 0.9)
    one_j.eval(y, y * 0.9)
    assert one_t.stats() == one_j.stats()


@pytest.mark.parametrize("steps", [0, 10], ids=["exact", "thresholded"])
def test_roc_matches_jax(steps):
    rng = np.random.default_rng(3)
    t, j = troc.ROC(steps), jroc.ROC(steps)
    tb, jb = troc.ROCBinary(steps), jroc.ROCBinary(steps)
    tm, jm = troc.ROCMultiClass(steps), jroc.ROCMultiClass(steps)
    for i in range(3):
        lab = rng.integers(0, 2, 60)
        p = _probs(rng, 60, 2)
        p[:, 1] = np.where(lab == 1, np.minimum(p[:, 1] + 0.3, 1.0), p[:, 1])
        y = np.eye(2, dtype=np.float32)[lab] if i else lab[:, None].astype(np.float32)
        t.eval(y, p if i else p[:, 1:])
        j.eval(y, p if i else p[:, 1:])
        yb = rng.integers(0, 2, (60, 3)).astype(np.float32)
        pb = rng.random((60, 3)).astype(np.float32)
        tb.eval(yb, pb)
        jb.eval(yb, pb)
        cls = rng.integers(0, 4, 60)
        pm = _probs(rng, 60, 4)
        tm.eval(cls, pm)
        jm.eval(cls, pm)
    for a, b in zip(t.roc_curve(), j.roc_curve()):
        np.testing.assert_array_equal(a, b)
    assert t.calculate_auc() == j.calculate_auc() > 0.5
    assert t.calculate_auprc() == j.calculate_auprc()
    assert t.stats() == j.stats()
    assert [tb.calculate_auc(c) for c in range(3)] == [jb.calculate_auc(c) for c in range(3)]
    assert tb.calculate_average_auc() == jb.calculate_average_auc()
    assert [tm.calculate_auc(c) for c in range(4)] == [jm.calculate_auc(c) for c in range(4)]
    assert tm.calculate_average_auc() == jm.calculate_average_auc()
