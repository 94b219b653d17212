"""Evaluation (counterpart of ``deeplearning4j_tpu.evaluation``): the
classification, regression and ROC evaluations that ``evaluate``,
``evaluate_regression`` and ``evaluate_roc`` return."""

from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
from deeplearning4j_tpu_torch.evaluation.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.evaluation.roc import ROC, ROCBinary, ROCMultiClass

__all__ = ["Evaluation", "ROC", "ROCBinary", "ROCMultiClass", "RegressionEvaluation"]
