"""ROC and AUC evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/roc.py`` (reference
``org.nd4j.evaluation.classification.ROC``, ``ROCBinary``,
``ROCMultiClass``). ``threshold_steps=0`` keeps every score (exact AUROC and
AUPRC); more steps round the scores to that many thresholds. Host numpy
with the JAX package's arithmetic.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ROC:
    """Binary ROC: positive-class probability vs 0/1 label."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = int(threshold_steps)
        self._scores: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []

    def eval(self, labels: np.ndarray, predictions: np.ndarray) -> None:
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim == 2 and labels.shape[1] == 2:  # one-hot binary
            labels = labels[:, 1]
            predictions = predictions[:, 1]
        elif labels.ndim == 2 and labels.shape[1] == 1:
            labels, predictions = labels[:, 0], predictions[:, 0]
        self._labels.append(labels.astype(np.float64).ravel())
        self._scores.append(predictions.astype(np.float64).ravel())

    def _collect(self):
        y = np.concatenate(self._labels) if self._labels else np.zeros(0)
        s = np.concatenate(self._scores) if self._scores else np.zeros(0)
        if self.threshold_steps > 0:
            s = np.round(s * self.threshold_steps) / self.threshold_steps
        return y, s

    def roc_curve(self):
        """Returns (fpr, tpr, thresholds) exact curve."""
        y, s = self._collect()
        order = np.argsort(-s, kind="stable")
        y, s = y[order], s[order]
        tps = np.cumsum(y)
        fps = np.cumsum(1 - y)
        # keep last point per distinct threshold
        distinct = np.r_[np.diff(s) != 0, True]
        tps, fps, thr = tps[distinct], fps[distinct], s[distinct]
        P, N = max(tps[-1], 1e-12) if len(tps) else 1, max(fps[-1], 1e-12) if len(fps) else 1
        tpr = np.r_[0.0, tps / P]
        fpr = np.r_[0.0, fps / N]
        return fpr, tpr, np.r_[np.inf, thr]

    def calculate_auc(self) -> float:
        fpr, tpr, _ = self.roc_curve()
        return float(np.trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        y, s = self._collect()
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tps = np.cumsum(y)
        precision = tps / np.arange(1, len(y) + 1)
        recall = tps / max(tps[-1] if len(tps) else 1, 1e-12)
        return float(np.trapezoid(precision, recall))

    def stats(self) -> str:
        return (f"ROC (exact={self.threshold_steps == 0}): "
                f"AUROC={self.calculate_auc():.4f}, AUPRC={self.calculate_auprc():.4f}")


class ROCBinary:
    """Independent binary ROC per output column (multi-label)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._per_col: Optional[List[ROC]] = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray) -> None:
        labels, predictions = np.asarray(labels), np.asarray(predictions)
        if labels.ndim == 1:
            labels, predictions = labels[:, None], predictions[:, None]
        if self._per_col is None:
            self._per_col = [ROC(self.threshold_steps) for _ in range(labels.shape[1])]
        for c, roc in enumerate(self._per_col):
            roc._labels.append(labels[:, c].astype(np.float64))
            roc._scores.append(predictions[:, c].astype(np.float64))

    def calculate_auc(self, col: int = 0) -> float:
        return self._per_col[col].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._per_col]))


class ROCMultiClass:
    """One-vs-all ROC per class (reference ``ROCMultiClass``)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._per_class: Optional[List[ROC]] = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray) -> None:
        labels, predictions = np.asarray(labels), np.asarray(predictions)
        n_classes = predictions.shape[-1]
        if labels.ndim == 1:
            labels = np.eye(n_classes)[labels.astype(np.int64)]
        if self._per_class is None:
            self._per_class = [ROC(self.threshold_steps) for _ in range(n_classes)]
        for c, roc in enumerate(self._per_class):
            roc._labels.append(labels[:, c].astype(np.float64))
            roc._scores.append(predictions[:, c].astype(np.float64))

    def calculate_auc(self, cls: int) -> float:
        return self._per_class[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._per_class]))
