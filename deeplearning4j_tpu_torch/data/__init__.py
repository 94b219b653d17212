"""Datasets, iterators and normalizers (counterpart of
``deeplearning4j_tpu.data``)."""

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterators import (AsyncDataSetIterator, DataSetIterator,
                                                     ExistingDataSetIterator, ListDataSetIterator,
                                                     NumpyDataSetIterator)
from deeplearning4j_tpu_torch.data.mnist import MnistDataSetIterator
from deeplearning4j_tpu_torch.data.normalizers import (ImagePreProcessingScaler, Normalizer,
                                                       NormalizerMinMaxScaler,
                                                       NormalizerStandardize,
                                                       VGG16ImagePreProcessor)

__all__ = ["AsyncDataSetIterator", "DataSet", "DataSetIterator", "ExistingDataSetIterator",
           "ImagePreProcessingScaler", "ListDataSetIterator", "MnistDataSetIterator", "MultiDataSet", "Normalizer",
           "NormalizerMinMaxScaler", "NormalizerStandardize", "NumpyDataSetIterator",
           "VGG16ImagePreProcessor"]
