"""Data normalizers.

Counterpart of ``deeplearning4j_tpu/data/normalizers.py`` (reference
``org.nd4j.linalg.dataset.api.preprocessor``): ``NormalizerStandardize``
(zero mean, unit variance per feature), ``NormalizerMinMaxScaler``,
``ImagePreProcessingScaler`` (a pixel range map) and
``VGG16ImagePreProcessor`` (ImageNet channel means), each with ``fit``,
``transform``, ``revert``, ``save`` and ``load``. Host numpy with the JAX
package's arithmetic, so the same arrays give the same bits; ``save``
writes the ``.npz`` the JAX package writes (``kind`` and its arrays under
the same keys), so a normalizer crosses between the packages both ways.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class Normalizer:
    def fit(self, data) -> "Normalizer":
        """``data``: a DataSet or a DataSetIterator."""
        raise NotImplementedError

    def transform(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def revert(self, features: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def transform_dataset(self, ds: DataSet) -> DataSet:
        return DataSet(self.transform(ds.features), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def _iter_features(self, data):
        if isinstance(data, DataSet):
            yield data.features
        else:
            data.reset()
            for b in data:
                yield b.features
            data.reset()

    def save(self, path) -> None:
        np.savez(path, kind=type(self).__name__, **self._state())

    @staticmethod
    def load(path) -> "Normalizer":
        """From a path or a binary file object holding what :meth:`save`
        (of either package) wrote."""
        z = np.load(path, allow_pickle=False)
        kind = str(z["kind"])
        cls = {c.__name__: c for c in (NormalizerStandardize, NormalizerMinMaxScaler,
                                       ImagePreProcessingScaler, VGG16ImagePreProcessor)}[kind]
        obj = cls.__new__(cls)
        obj._load_state(z)
        return obj

    def _state(self) -> dict:
        return {}

    def _load_state(self, z) -> None:
        pass


class NormalizerStandardize(Normalizer):
    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def fit(self, data):
        """Per-feature mean and standard deviation, summed in float64."""
        n, s, s2 = 0, 0.0, 0.0
        for f in self._iter_features(data):
            f = f.reshape(len(f), -1).astype(np.float64)
            n += f.shape[0]
            s = s + f.sum(0)
            s2 = s2 + (f ** 2).sum(0)
        self.mean = (s / n).astype(np.float32)
        var = s2 / n - (s / n) ** 2
        self.std = np.sqrt(np.maximum(var, 1e-12)).astype(np.float32)
        return self

    def transform(self, features):
        shape = features.shape
        flat = features.reshape(len(features), -1)
        return ((flat - self.mean) / self.std).reshape(shape).astype(np.float32)

    def revert(self, features):
        shape = features.shape
        flat = features.reshape(len(features), -1)
        return (flat * self.std + self.mean).reshape(shape)

    def _state(self):
        return {"mean": self.mean, "std": self.std}

    def _load_state(self, z):
        self.mean, self.std = z["mean"], z["std"]


class NormalizerMinMaxScaler(Normalizer):
    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range, self.max_range = float(min_range), float(max_range)
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, data):
        mn, mx = None, None
        for f in self._iter_features(data):
            f = f.reshape(len(f), -1)
            bmn, bmx = f.min(0), f.max(0)
            mn = bmn if mn is None else np.minimum(mn, bmn)
            mx = bmx if mx is None else np.maximum(mx, bmx)
        self.data_min, self.data_max = mn.astype(np.float32), mx.astype(np.float32)
        return self

    def transform(self, features):
        shape = features.shape
        flat = features.reshape(len(features), -1)
        rng = np.maximum(self.data_max - self.data_min, 1e-12)
        scaled = (flat - self.data_min) / rng
        out = scaled * (self.max_range - self.min_range) + self.min_range
        return out.reshape(shape).astype(np.float32)

    def revert(self, features):
        shape = features.shape
        flat = features.reshape(len(features), -1)
        rng = np.maximum(self.data_max - self.data_min, 1e-12)
        return (((flat - self.min_range) / (self.max_range - self.min_range)) * rng
                + self.data_min).reshape(shape)

    def _state(self):
        return {"data_min": self.data_min, "data_max": self.data_max,
                "ranges": np.array([self.min_range, self.max_range])}

    def _load_state(self, z):
        self.data_min, self.data_max = z["data_min"], z["data_max"]
        self.min_range, self.max_range = z["ranges"]


class ImagePreProcessingScaler(Normalizer):
    """Pixel scaler (reference ``ImagePreProcessingScaler``): maps [0,
    ``max_pixel``] to [``min_range``, ``max_range``]; nothing to fit."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0,
                 max_pixel: float = 255.0):
        self.min_range, self.max_range, self.max_pixel = min_range, max_range, max_pixel

    def fit(self, data):
        return self

    def transform(self, features):
        return (features / self.max_pixel * (self.max_range - self.min_range)
                + self.min_range).astype(np.float32)

    def revert(self, features):
        return (features - self.min_range) / (self.max_range - self.min_range) * self.max_pixel

    def _state(self):
        return {"ranges": np.array([self.min_range, self.max_range, self.max_pixel])}

    def _load_state(self, z):
        self.min_range, self.max_range, self.max_pixel = z["ranges"]


class VGG16ImagePreProcessor(Normalizer):
    """Subtract the ImageNet channel means (reference
    ``VGG16ImagePreProcessor``), NHWC; nothing to fit."""

    MEANS = np.array([123.68, 116.779, 103.939], np.float32)

    def fit(self, data):
        return self

    def transform(self, features):
        return (features - self.MEANS).astype(np.float32)

    def revert(self, features):
        return features + self.MEANS
