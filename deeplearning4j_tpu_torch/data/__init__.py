"""Datasets and iterators (counterpart of ``deeplearning4j_tpu.data``)."""

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import DataSetIterator, ListDataSetIterator

__all__ = ["DataSet", "DataSetIterator", "ListDataSetIterator"]
