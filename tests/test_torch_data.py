"""The port's host data path against the JAX package's, on the CPU.

Host numpy on both sides, so every comparison is exact: the synthetic
MNIST arrays, the IDX reader, the batch order of shuffled iterators over
several epochs (``np.random.default_rng(seed).shuffle`` drawn at the same
points), the four normalizers' ``fit``/``transform``/``revert`` and their
``.npz`` files, an iterator's preprocessor hook, and ``normalizer.npz``
inside model archives written by either package and read by the other.
"""

import gzip
import struct

import numpy as np
import pytest

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu.data import mnist as jmnist
from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu_torch.data import dataset as tds
from deeplearning4j_tpu_torch.data import iterators as tit
from deeplearning4j_tpu_torch.data import mnist as tmnist
from deeplearning4j_tpu_torch.data import normalizers as tnorm
from deeplearning4j_tpu_torch.runtime.environment import get_environment


@pytest.fixture(autouse=True)
def _port_on_cpu():
    env = get_environment()
    saved = (env.device, env.default_dtype, env.compute_dtype)
    env.set_device("cpu").set_default_dtype("float32").set_compute_dtype("float32")
    yield
    env.device, env.default_dtype, env.compute_dtype = saved


def _batches(it, epochs=1):
    out = []
    for _ in range(epochs):
        it.reset()  # as fit does, before iterating (which resets again)
        out.extend((b.features, b.labels, b.features_mask, b.labels_mask) for b in it)
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            if u is None or v is None:
                assert u is None and v is None
            else:
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("n,seed", [(1, 6), (257, 6), (1000, 7)])
def test_synthetic_mnist_is_the_jax_arrays(n, seed):
    ji, jl = jmnist._synthetic_mnist(n, seed)
    ti, tl = tmnist._synthetic_mnist(n, seed)
    assert ti.dtype == ji.dtype and tl.dtype == jl.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("train,shuffle,flatten", [(True, None, True), (False, None, True),
                                                   (True, False, False), (True, True, True)],
                         ids=["train", "test", "train_unshuffled_images", "shuffled"])
def test_mnist_iterator_batches_match_jax(train, shuffle, flatten):
    kw = dict(train=train, num_examples=300, shuffle=shuffle, flatten=flatten, seed=11)
    j, t = jmnist.MnistDataSetIterator(64, **kw), tmnist.MnistDataSetIterator(64, **kw)
    assert t.synthetic and j.synthetic
    assert t.shuffle == j.shuffle == (train if shuffle is None else shuffle)
    _same_batches(_batches(t, epochs=3), _batches(j, epochs=3))
    assert t.features.shape == ((300, 784) if flatten else (300, 28, 28, 1))


def test_idx_files_read_as_jax_reads_them(tmp_path, monkeypatch):
    """IDX files, plain and gzipped, found through ``DL4J_TPU_DATA_DIR``:
    the port reads what the JAX reader reads and serves them, not the
    synthetic set."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (70, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 70, dtype=np.uint8)

    def idx(arr):
        return struct.pack(">I", 0x0800 | arr.ndim) + \
            struct.pack(">" + "I" * arr.ndim, *arr.shape) + arr.tobytes()

    (tmp_path / "train-images-idx3-ubyte").write_bytes(idx(images))
    (tmp_path / "train-labels-idx1-ubyte").write_bytes(idx(labels))
    with gzip.open(tmp_path / "t10k-images-idx3-ubyte.gz", "wb") as f:
        f.write(idx(images[:20]))
    with gzip.open(tmp_path / "t10k-labels-idx1-ubyte.gz", "wb") as f:
        f.write(idx(labels[:20]))
    for name in ("train-images-idx3-ubyte", "t10k-labels-idx1-ubyte.gz"):
        np.testing.assert_array_equal(tmnist._read_idx(str(tmp_path / name)),
                                      jmnist._read_idx(str(tmp_path / name)))
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    it = tmnist.MnistDataSetIterator(32, train=True, shuffle=False)
    assert not it.synthetic and it.features.shape == (70, 784)
    np.testing.assert_array_equal(it.features, images.reshape(70, -1) / np.float32(255.0))
    np.testing.assert_array_equal(it.labels.argmax(1), labels)
    test = tmnist.MnistDataSetIterator(8, train=False, num_examples=12)
    assert not test.synthetic and len(test.features) == 12


def test_numpy_iterator_shuffle_masks_and_drop_last_match_jax():
    rng = np.random.default_rng(3)
    x, y = rng.normal(0, 1, (23, 4, 2)).astype(np.float32), rng.random((23, 3))
    fm = (rng.random((23, 4)) > 0.3).astype(np.float32)
    for kw in ({"shuffle": True, "seed": 5}, {"shuffle": True, "seed": 5, "drop_last": True},
               {"shuffle": False}):
        j = jit.NumpyDataSetIterator(x, y, 5, features_mask=fm, labels_mask=fm, **kw)
        t = tit.NumpyDataSetIterator(x, y, 5, features_mask=fm, labels_mask=fm, **kw)
        _same_batches(_batches(t, epochs=4), _batches(j, epochs=4))
        assert t.batch() == j.batch() == 5


def test_existing_iterator_and_preprocessor_hook():
    data = [tds.DataSet(np.full((2, 3), i, np.float32), np.eye(2, dtype=np.float32))
            for i in range(3)]
    t = tit.ExistingDataSetIterator(data)
    assert [float(b.features[0, 0]) for b in t] == [0.0, 1.0, 2.0]
    assert [float(b.features[0, 0]) for b in t] == [0.0, 1.0, 2.0]  # iterating resets
    assert t.batch() == -1
    scaler = tnorm.ImagePreProcessingScaler(0.0, 1.0, max_pixel=4.0)
    t.set_pre_processor(scaler)
    j = jit.ExistingDataSetIterator([jds.DataSet(d.features, d.labels) for d in data])
    j.set_pre_processor(jnorm.ImagePreProcessingScaler(0.0, 1.0, max_pixel=4.0))
    _same_batches(_batches(t), _batches(j))
    assert float(next(iter(t)).features[0, 0]) == 0.0


def _fit_data(seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.normal(3, 2, (40, 2, 3, 2)) * np.array([1, 50], np.float32)).astype(np.float32)
    return x, np.eye(2, dtype=np.float32)[rng.integers(0, 2, 40)]


NORMALIZERS = [("NormalizerStandardize", {}), ("NormalizerMinMaxScaler", {}),
               ("NormalizerMinMaxScaler", {"min_range": -1.0, "max_range": 2.0}),
               ("ImagePreProcessingScaler", {"min_range": -0.5, "max_range": 0.5}),
               ("VGG16ImagePreProcessor", {})]


@pytest.mark.parametrize("name,kw", NORMALIZERS,
                         ids=["standardize", "minmax", "minmax_range", "image", "vgg16"])
def test_normalizer_matches_jax(name, kw, tmp_path):
    """fit (on a DataSet and on an iterator), transform, revert and the
    saved ``.npz``, loaded by either package: the same arrays."""
    x, y = _fit_data()
    if name == "VGG16ImagePreProcessor":
        x = x[..., :1].repeat(3, -1)
    j, t = getattr(jnorm, name)(**kw), getattr(tnorm, name)(**kw)
    j.fit(jit.NumpyDataSetIterator(x, y, 7))
    t.fit(tit.NumpyDataSetIterator(x, y, 7))
    probe = _fit_data(5)[0]
    if name == "VGG16ImagePreProcessor":
        probe = probe[..., :1].repeat(3, -1)
    want = j.transform(probe)
    got = t.transform(probe)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.revert(got), j.revert(want))
    t2 = getattr(tnorm, name)(**kw).fit(tds.DataSet(x, y))
    np.testing.assert_array_equal(t2.transform(probe), got)
    t.save(str(tmp_path / "t.npz"))
    j.save(str(tmp_path / "j.npz"))
    # a loaded scaler holds its ranges as float64 numpy scalars, which
    # promote where Python floats do not: its bits are the JAX package's
    # loaded scaler's, not always the fitted one's
    want = jnorm.Normalizer.load(str(tmp_path / "j.npz")).transform(probe)
    for loaded in (jnorm.Normalizer.load(str(tmp_path / "t.npz")),
                   tnorm.Normalizer.load(str(tmp_path / "j.npz")),
                   tnorm.Normalizer.load(str(tmp_path / "t.npz"))):
        assert type(loaded).__name__ == name
        np.testing.assert_array_equal(loaded.transform(probe), want)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_normalizer_npz_in_archives_crosses_packages(direction, tmp_path):
    """``write_model(normalizer=...)`` stores ``normalizer.npz`` under the
    JAX package's keys; ``restore_normalizer`` of the other package gives a
    normalizer that transforms alike. An archive without one gives None."""
    from deeplearning4j_tpu.models.serializer import ModelSerializer as JSerializer
    from deeplearning4j_tpu.zoo import LeNet as JLeNet
    from deeplearning4j_tpu_torch.models import ModelSerializer
    from deeplearning4j_tpu_torch.zoo import LeNet
    x, y = _fit_data()
    x = x.reshape(len(x), -1)
    path, bare = str(tmp_path / "with.zip"), str(tmp_path / "without.zip")
    if direction == "jax_to_port":
        norm = jnorm.NormalizerStandardize().fit(jds.DataSet(x, y))
        jnet = JLeNet(height=4, width=3, channels=1).init()
        JSerializer.write_model(jnet, path, normalizer=norm)
        JSerializer.write_model(jnet, bare)
        got = ModelSerializer.restore_normalizer(path)
        assert ModelSerializer.restore_normalizer(bare) is None
    else:
        norm = tnorm.NormalizerStandardize().fit(tds.DataSet(x, y))
        net = LeNet(height=4, width=3, channels=1).init(device="cpu")
        ModelSerializer.write_model(net, path, normalizer=norm)
        ModelSerializer.write_model(net, bare)
        got = JSerializer.restore_normalizer(path)
        assert JSerializer.restore_normalizer(bare) is None
    assert type(got).__name__ == "NormalizerStandardize"
    np.testing.assert_array_equal(got.mean, norm.mean)
    np.testing.assert_array_equal(got.transform(x), norm.transform(x))
