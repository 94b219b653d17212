"""MNIST iterator.

Counterpart of ``deeplearning4j_tpu/data/mnist.py`` (reference
``MnistDataSetIterator``). Nothing is downloaded. The IDX files are looked
for where the JAX package looks, so both packages read the same files:
``$DL4J_TPU_DATA_DIR``, ``~/.deeplearning4j_tpu/mnist`` and
``~/.deeplearning4j/mnist``, each file plain or ``.gz``. Where they are not
found, the iterator serves the JAX package's deterministic synthetic MNIST
(class-conditional blobs plus noise, bit for bit the same arrays) and says
so in ``.synthetic``.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.iterators import NumpyDataSetIterator


def _search_dirs() -> Tuple[str, ...]:
    return (os.environ.get("DL4J_TPU_DATA_DIR", ""),
            os.path.expanduser("~/.deeplearning4j_tpu/mnist"),
            os.path.expanduser("~/.deeplearning4j/mnist"))


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def _find_idx_files(train: bool) -> Optional[Tuple[str, str]]:
    img = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    lab = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    for d in _search_dirs():
        if not d:
            continue
        for suffix in ("", ".gz"):
            ip, lp = os.path.join(d, img + suffix), os.path.join(d, lab + suffix)
            if os.path.exists(ip) and os.path.exists(lp):
                return ip, lp
    return None


def _synthetic_mnist(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-separable 28x28 images in [0, 255]: each class a
    Gaussian blob at its own place, plus noise (JAX ``mnist.py:55-69``)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    images = np.empty((n, 28, 28), np.float32)
    for c in range(10):
        cx, cy = 6 + (c % 5) * 4, 8 + (c // 5) * 10
        base = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 9.0)))
        idx = labels == c
        k = int(idx.sum())
        images[idx] = base[None] * 200.0 + rng.normal(0, 20, (k, 28, 28))
    return np.clip(images, 0, 255).astype(np.float32), labels.astype(np.int64)


class MnistDataSetIterator(NumpyDataSetIterator):
    """Batches of MNIST scaled to [0, 1] with one-hot labels: features
    ``(n, 784)``, or ``(n, 28, 28, 1)`` with ``flatten=False``. Shuffled
    (from ``seed``) by default for the training set."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 6,
                 num_examples: Optional[int] = None, flatten: bool = True,
                 shuffle: Optional[bool] = None):
        files = _find_idx_files(train)
        if files is not None:
            images = _read_idx(files[0]).astype(np.float32)
            labels = _read_idx(files[1]).astype(np.int64)
            self.synthetic = False
        else:
            n = num_examples or (60000 if train else 10000)
            images, labels = _synthetic_mnist(n, seed + (0 if train else 1))
            self.synthetic = True
        if num_examples is not None:
            images, labels = images[:num_examples], labels[:num_examples]
        images = images / 255.0
        features = images.reshape(len(images), -1) if flatten else images[..., None]
        onehot = np.zeros((len(labels), 10), np.float32)
        onehot[np.arange(len(labels)), labels] = 1.0
        super().__init__(features, onehot, batch_size,
                         shuffle=train if shuffle is None else shuffle, seed=seed)
