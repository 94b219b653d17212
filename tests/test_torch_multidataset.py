"""DataSet, MultiDataSet and the iterators over them, in the port against
the JAX package: the same arrays and seed give the same bits.

``DataSet.num_examples``, ``split_test_and_train``, ``shuffle(seed)`` and
``save``/``load`` (files written by either package read by the other);
``MultiDataSet``; ``ListDataSetIterator`` and ``ExistingDataSetIterator``
over MultiDataSets; ``AsyncDataSetIterator`` (the base's batches in order,
reset mid-epoch, close, an error in the worker surfacing at the next
batch); and ``SameDiff.fit`` fed one MultiDataSet. Host numpy throughout;
comparisons are bit for bit.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu_torch.data import dataset as tds
from deeplearning4j_tpu_torch.data import iterators as tit
from deeplearning4j_tpu_torch.runtime.environment import get_environment


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _arrays(seed=0, n=11):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 3, 4)).astype(np.float32),
            np.eye(5, dtype=np.float32)[rng.integers(0, 5, n)],
            (rng.random((n, 3)) < 0.7).astype(np.float32),
            (rng.random((n, 3)) < 0.5).astype(np.float32))


def _equal(a, b):
    for f in ("features", "labels", "features_mask", "labels_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("masks", [True, False])
def test_dataset_methods_match_jax(masks):
    f, l, fm, lm = _arrays()
    args = (f, l, fm, lm) if masks else (f, l)
    j, t = jds.DataSet(*args), tds.DataSet(*args)
    assert t.num_examples() == j.num_examples() == 11 == len(t)
    for jpart, tpart in zip(j.split_test_and_train(7), t.split_test_and_train(7)):
        _equal(tpart, jpart)
    for seed in (0, 3, None):
        j2, t2 = jds.DataSet(*args), tds.DataSet(*args)
        if seed is None:  # unseeded shuffles differ; the rows stay whole
            t2.shuffle()
            order = [int(np.flatnonzero((f == row).all(axis=(1, 2)))[0]) for row in t2.features]
            assert sorted(order) == list(range(11))
            np.testing.assert_array_equal(t2.labels, l[order])
            continue
        j2.shuffle(seed)
        t2.shuffle(seed)
        _equal(t2, j2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dataset_save_load_across_packages(writer, tmp_path):
    f, l, fm, _ = _arrays(1)
    path = str(tmp_path / "ds.npz")
    (jds if writer == "jax" else tds).DataSet(f, l, features_mask=fm).save(path)
    j, t = jds.DataSet.load(path), tds.DataSet.load(path)
    _equal(t, j)
    assert t.labels_mask is None and t.features_mask is not None


def test_multidataset_matches_jax():
    f, l, fm, lm = _arrays(2)
    feats, labels = [f, f[:, 0]], [l]
    j = jds.MultiDataSet(feats, labels, features_masks=[fm, None], labels_masks=[lm])
    t = tds.MultiDataSet(feats, labels, features_masks=[fm, None], labels_masks=[lm])
    assert len(t) == len(j) == t.num_examples() == 11
    for a, b in zip(t.features + t.labels, j.features + j.labels):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)
    assert t.features_masks[1] is None and t.labels_masks[0] is lm
    lists = tds.MultiDataSet([[1.0, 2.0]], [[0.0, 1.0]])
    assert isinstance(lists.features[0], np.ndarray) and lists.features[0].shape == (2,)


def _mds_list(n=4):
    out = []
    for s in range(n):
        f, l, _, _ = _arrays(10 + s, n=3)
        out.append((f, l))
    return out


@pytest.mark.parametrize("kind", ["existing", "list"])
def test_iterators_over_multidatasets(kind):
    data = _mds_list()
    jmk = jit.ExistingDataSetIterator if kind == "existing" else jit.ListDataSetIterator
    tmk = tit.ExistingDataSetIterator if kind == "existing" else tit.ListDataSetIterator
    j = jmk([jds.MultiDataSet([f, f * 2], [l]) for f, l in data])
    t = tmk([tds.MultiDataSet([f, f * 2], [l]) for f, l in data])
    for _ in range(2):  # each pass starts again
        jb, tb = list(j), list(t)
        assert len(tb) == len(jb) == 4
        for a, b in zip(tb, jb):
            assert isinstance(a, tds.MultiDataSet)
            for x, y in zip(a.features + a.labels, b.features + b.labels):
                np.testing.assert_array_equal(x, y)


def test_async_iterator_yields_the_base_batches():
    f, l, _, _ = _arrays(4, n=23)
    base = tit.NumpyDataSetIterator(f, l, batch_size=5, shuffle=True, seed=7)
    jbase = jit.NumpyDataSetIterator(f, l, batch_size=5, shuffle=True, seed=7)
    it = tit.AsyncDataSetIterator(base, queue_size=2)
    jasync = jit.AsyncDataSetIterator(jbase, queue_size=2)
    assert it.batch() == 5
    for _ in range(2):
        got, want = list(it), list(jasync)
        assert [len(b) for b in got] == [5, 5, 5, 5, 3]
        for a, b in zip(got, want):
            _equal(a, b)
    it.close()
    jasync.close()


def test_async_iterator_reset_mid_epoch_and_close():
    f, l, _, _ = _arrays(5, n=40)
    it = tit.AsyncDataSetIterator(tit.NumpyDataSetIterator(f, l, batch_size=4), queue_size=1)
    it.reset()
    first = it.next()
    np.testing.assert_array_equal(first.features, f[:4])
    it.reset()  # stops the worker parked on its full queue and starts again
    np.testing.assert_array_equal(it.next().features, f[:4])
    it.close()
    assert it._thread is None
    assert len(list(it)) == 10  # a later pass starts afresh


def test_async_iterator_surfaces_worker_errors():
    class Failing(tit.DataSetIterator):
        def __init__(self):
            self.i = 0

        def reset(self):
            self.i = 0

        def has_next(self):
            return True

        def next(self):
            self.i += 1
            if self.i == 3:
                raise RuntimeError("etl failed at batch 3")
            return tds.DataSet(np.zeros((1, 2)), np.zeros((1, 1)))

        def batch(self):
            return 1

    it = tit.AsyncDataSetIterator(Failing(), queue_size=4)
    seen = 0
    with pytest.raises(RuntimeError, match="batch 3"):
        for _ in it:
            seen += 1
    assert seen <= 2
    assert it._thread is None or not it._thread.is_alive()
    assert not [t for t in threading.enumerate()
                if t.name == "async-dataset-iterator" and t.is_alive()]


def test_samediff_fit_on_one_multidataset():
    """``sd.fit(MultiDataSet)`` takes one step over it, features and labels
    to their placeholders in order (JAX ``samediff.py:741-744``)."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.train.updaters import Sgd
    sd = SameDiff.create()
    a = sd.placeholder("a", (None, 3))
    b = sd.placeholder("b", (None, 3))
    w = sd.var("w", array=np.ones((3, 1), np.float32))
    y = sd.placeholder("y", (None, 1))
    sd.loss.mean_squared_error("loss", y, (a - b).mmul(w))
    sd.set_loss_variables("loss")
    sd.set_training_config(TrainingConfig(updater=Sgd(0.1), data_set_feature_mapping=["a", "b"],
                                          data_set_label_mapping=["y"]))
    rng = np.random.default_rng(0)
    fa, fb = (rng.normal(0, 1, (4, 3)).astype(np.float32) for _ in range(2))
    yv = rng.normal(0, 1, (4, 1)).astype(np.float32)
    hist = sd.fit(tds.MultiDataSet([fa, fb], [yv]))
    assert len(hist) == 1 and sd._train_iter == 1
    np.testing.assert_allclose(hist[0], np.mean(((fa - fb).sum(1, keepdims=True) - yv) ** 2),
                               rtol=1e-6)
