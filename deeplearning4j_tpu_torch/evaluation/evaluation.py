"""Classification evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/evaluation.py`` (reference
``org.nd4j.evaluation.classification.Evaluation``): confusion matrix,
accuracy, per-class and averaged precision/recall/F1, Matthews correlation,
top-N accuracy, ``merge`` of partial evaluations and the ``stats()`` report.
Host numpy with the JAX package's arithmetic: the same predictions give the
same confusion matrix and the same text.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None,
                 labels: Optional[List[str]] = None, top_n: int = 1):
        self.num_classes = num_classes
        self.label_names = labels
        self.top_n = max(1, int(top_n))
        self.confusion: Optional[np.ndarray] = None
        self.top_n_correct = 0
        self.total = 0

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes), np.int64)

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None) -> None:
        """labels: one-hot (N,C) / int (N,); predictions: probs (N,C).
        Rank-3 sequence outputs are flattened over time with the mask applied
        (reference ``evalTimeSeries``)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if predictions.ndim == 3:
            b, t, c = predictions.shape
            predictions = predictions.reshape(b * t, c)
            labels = labels.reshape(b * t, -1) if labels.ndim == 3 else labels.reshape(b * t)
            if mask is not None:
                keep = np.asarray(mask).reshape(b * t) > 0
                predictions, labels = predictions[keep], labels[keep]
        n_classes = predictions.shape[-1]
        self._ensure(n_classes)
        true_idx = labels.argmax(-1) if labels.ndim == 2 else labels.astype(np.int64)
        pred_idx = predictions.argmax(-1)
        np.add.at(self.confusion, (true_idx, pred_idx), 1)
        self.total += len(true_idx)
        if self.top_n > 1:
            top = np.argsort(-predictions, axis=-1)[:, :self.top_n]
            self.top_n_correct += int((top == true_idx[:, None]).any(-1).sum())
        else:
            self.top_n_correct += int((pred_idx == true_idx).sum())

    # ---- metrics ----
    def accuracy(self) -> float:
        if self.confusion is None or self.total == 0:
            return float("nan")
        return float(np.trace(self.confusion)) / self.total

    def top_n_accuracy(self) -> float:
        return self.top_n_correct / max(1, self.total)

    def _tp(self):
        return np.diag(self.confusion).astype(np.float64)

    def precision(self, cls: Optional[int] = None) -> float:
        col = self.confusion.sum(0).astype(np.float64)
        p = np.divide(self._tp(), col, out=np.zeros_like(col), where=col > 0)
        if cls is not None:
            return float(p[cls])
        return float(p[col > 0].mean() if (col > 0).any() else 0.0)

    def recall(self, cls: Optional[int] = None) -> float:
        row = self.confusion.sum(1).astype(np.float64)
        r = np.divide(self._tp(), row, out=np.zeros_like(row), where=row > 0)
        if cls is not None:
            return float(r[cls])
        return float(r[row > 0].mean() if (row > 0).any() else 0.0)

    def f1(self, cls: Optional[int] = None) -> float:
        if cls is not None:
            p, r = self.precision(cls), self.recall(cls)
            return 2 * p * r / (p + r) if p + r > 0 else 0.0
        col = self.confusion.sum(0).astype(np.float64)
        row = self.confusion.sum(1).astype(np.float64)
        tp = self._tp()
        p = np.divide(tp, col, out=np.zeros_like(col), where=col > 0)
        r = np.divide(tp, row, out=np.zeros_like(row), where=row > 0)
        f = np.divide(2 * p * r, p + r, out=np.zeros_like(p), where=(p + r) > 0)
        valid = (row > 0) | (col > 0)
        return float(f[valid].mean() if valid.any() else 0.0)

    def matthews_correlation(self) -> float:
        """Multiclass MCC (Gorodkin R_k)."""
        C = self.confusion.astype(np.float64)
        t = C.sum()
        s = np.trace(C)
        row, col = C.sum(1), C.sum(0)
        cov_xy = s * t - row @ col
        cov_xx = t * t - row @ row
        cov_yy = t * t - col @ col
        denom = np.sqrt(cov_xx * cov_yy)
        return float(cov_xy / denom) if denom > 0 else 0.0

    def confusion_matrix(self) -> np.ndarray:
        return self.confusion.copy() if self.confusion is not None else np.zeros((0, 0))

    def merge(self, other: "Evaluation") -> None:
        """Combine partial evaluations (reference: distributed eval merge)."""
        if other.confusion is None:
            return
        self._ensure(other.confusion.shape[0])
        self.confusion += other.confusion
        self.total += other.total
        self.top_n_correct += other.top_n_correct

    def stats(self) -> str:
        if self.confusion is None:
            return "Evaluation: no data"
        names = self.label_names or [str(i) for i in range(self.num_classes)]
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {self.num_classes}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f" Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append("")
        lines.append("=========================Confusion Matrix=========================")
        width = max(5, max(len(n) for n in names) + 1)
        header = " " * width + "".join(f"{n:>{width}}" for n in names)
        lines.append(header)
        for i, n in enumerate(names):
            lines.append(f"{n:>{width}}" + "".join(
                f"{self.confusion[i, j]:>{width}}" for j in range(self.num_classes)))
        return "\n".join(lines)
