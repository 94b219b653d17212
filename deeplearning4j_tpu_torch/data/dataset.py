"""The ``DataSet`` and ``MultiDataSet`` containers (counterpart of
``deeplearning4j_tpu/data/dataset.py``, reference
``org.nd4j.linalg.dataset.DataSet``/``MultiDataSet``): features, labels and
optional masks as host numpy arrays, with the same shuffle (numpy's
``default_rng(seed).permutation``), split and ``.npz`` save/load as the JAX
package, so the same arrays and seed give the same bits in both; ``fit``
moves each minibatch to the network's device."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def __post_init__(self):
        self.features = np.asarray(self.features)
        self.labels = np.asarray(self.labels)

    def __len__(self) -> int:
        return self.features.shape[0]

    def num_examples(self) -> int:
        return len(self)

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        return self.range(0, n_train), self.range(n_train, len(self))

    def range(self, start: int, end: int) -> "DataSet":
        sl = slice(start, end)
        return DataSet(
            self.features[sl], self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl])

    def shuffle(self, seed: Optional[int] = None) -> None:
        """Permute the examples in place by ``default_rng(seed)``."""
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self))
        self.features = self.features[idx]
        self.labels = self.labels[idx]
        if self.features_mask is not None:
            self.features_mask = self.features_mask[idx]
        if self.labels_mask is not None:
            self.labels_mask = self.labels_mask[idx]

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        return [self.range(i, min(i + batch_size, len(self)))
                for i in range(0, len(self), batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        return DataSet(
            np.concatenate([d.features for d in datasets]),
            np.concatenate([d.labels for d in datasets]),
            _cat_masks([d.features_mask for d in datasets]),
            _cat_masks([d.labels_mask for d in datasets]))

    def save(self, path: str) -> None:
        """``np.savez_compressed`` of the arrays under their field names."""
        arrays = {"features": self.features, "labels": self.labels}
        if self.features_mask is not None:
            arrays["features_mask"] = self.features_mask
        if self.labels_mask is not None:
            arrays["labels_mask"] = self.labels_mask
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "DataSet":
        z = np.load(path)
        return DataSet(z["features"], z["labels"],
                       z["features_mask"] if "features_mask" in z else None,
                       z["labels_mask"] if "labels_mask" in z else None)


def _cat_masks(masks):
    if all(m is None for m in masks):
        return None
    if any(m is None for m in masks):
        raise ValueError("Cannot merge DataSets with mixed mask presence")
    return np.concatenate(masks)


@dataclasses.dataclass
class MultiDataSet:
    """Several feature and label arrays (reference ``MultiDataSet``): a
    ComputationGraph's inputs and outputs, or a SameDiff graph's feature and
    label placeholders, in order."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def __post_init__(self):
        self.features = [np.asarray(f) for f in self.features]
        self.labels = [np.asarray(l) for l in self.labels]

    def __len__(self) -> int:
        return self.features[0].shape[0]

    def num_examples(self) -> int:
        return len(self)
