"""The ``DataSet`` container (counterpart of
``deeplearning4j_tpu/data/dataset.py``, reference
``org.nd4j.linalg.dataset.DataSet``): features, labels and optional masks as
host numpy arrays; ``fit`` moves each minibatch to the network's device."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

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

    def range(self, start: int, end: int) -> "DataSet":
        sl = slice(start, end)
        return DataSet(
            self.features[sl], self.labels[sl],
            None if self.features_mask is None else self.features_mask[sl],
            None if self.labels_mask is None else self.labels_mask[sl])

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


def _cat_masks(masks):
    if all(m is None for m in masks):
        return None
    if any(m is None for m in masks):
        raise ValueError("Cannot merge DataSets with mixed mask presence")
    return np.concatenate(masks)
