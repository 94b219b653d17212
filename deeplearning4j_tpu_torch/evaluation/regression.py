"""Regression evaluation.

Counterpart of ``deeplearning4j_tpu/evaluation/regression.py`` (reference
``org.nd4j.evaluation.regression.RegressionEvaluation``): per-column MSE,
MAE, RMSE, R^2 and Pearson correlation from float64 running sums, host
numpy with the JAX package's arithmetic.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RegressionEvaluation:
    def __init__(self, n_columns: Optional[int] = None):
        self.n = 0
        self._init_cols(n_columns)

    def _init_cols(self, c):
        self.n_columns = c
        if c:
            z = np.zeros(c, np.float64)
            self.sum_err_sq, self.sum_abs_err = z.copy(), z.copy()
            self.sum_label, self.sum_label_sq = z.copy(), z.copy()
            self.sum_pred, self.sum_pred_sq = z.copy(), z.copy()
            self.sum_label_pred = z.copy()

    def eval(self, labels: np.ndarray, predictions: np.ndarray,
             mask: Optional[np.ndarray] = None) -> None:
        labels = np.asarray(labels, np.float64)
        predictions = np.asarray(predictions, np.float64)
        if labels.ndim == 3:
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
            if mask is not None:
                keep = np.asarray(mask).reshape(-1) > 0
                labels, predictions = labels[keep], predictions[keep]
        if labels.ndim == 1:
            labels, predictions = labels[:, None], predictions[:, None]
        if self.n_columns is None:
            self._init_cols(labels.shape[1])
        err = predictions - labels
        self.n += labels.shape[0]
        self.sum_err_sq += (err ** 2).sum(0)
        self.sum_abs_err += np.abs(err).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label_sq += (labels ** 2).sum(0)
        self.sum_pred += predictions.sum(0)
        self.sum_pred_sq += (predictions ** 2).sum(0)
        self.sum_label_pred += (labels * predictions).sum(0)

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err_sq[col] / max(1, self.n))

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs_err[col] / max(1, self.n))

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self.sum_label_sq[col] - self.sum_label[col] ** 2 / max(1, self.n)
        ss_res = self.sum_err_sq[col]
        return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else float("nan")

    def pearson_correlation(self, col: int = 0) -> float:
        n = max(1, self.n)
        cov = self.sum_label_pred[col] - self.sum_label[col] * self.sum_pred[col] / n
        var_l = self.sum_label_sq[col] - self.sum_label[col] ** 2 / n
        var_p = self.sum_pred_sq[col] - self.sum_pred[col] ** 2 / n
        denom = np.sqrt(var_l * var_p)
        return float(cov / denom) if denom > 0 else float("nan")

    def average_mean_squared_error(self) -> float:
        return float(np.mean(self.sum_err_sq / max(1, self.n)))

    def average_r_squared(self) -> float:
        return float(np.nanmean([self.r_squared(c) for c in range(self.n_columns)]))

    def stats(self) -> str:
        lines = ["=================Regression Evaluation=================",
                 f" columns: {self.n_columns}, examples: {self.n}",
                 f"{'col':>5}{'MSE':>14}{'MAE':>14}{'RMSE':>14}{'R^2':>14}{'corr':>14}"]
        for c in range(self.n_columns or 0):
            lines.append(f"{c:>5}{self.mean_squared_error(c):>14.6f}"
                         f"{self.mean_absolute_error(c):>14.6f}"
                         f"{self.root_mean_squared_error(c):>14.6f}"
                         f"{self.r_squared(c):>14.6f}{self.pearson_correlation(c):>14.6f}")
        return "\n".join(lines)
