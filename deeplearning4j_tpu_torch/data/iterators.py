"""Dataset iterators (counterpart of ``deeplearning4j_tpu/data/iterators.py``):
the ``DataSetIterator`` interface and ``ListDataSetIterator``."""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """An iterable of DataSet minibatches with ``reset``."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        return self.next()

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError


class ListDataSetIterator(DataSetIterator):
    """Iterate pre-built DataSets, optionally re-batched (reference
    ``ListDataSetIterator``)."""

    def __init__(self, datasets: Sequence[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None:
            self._batches = DataSet.merge(list(datasets)).batch_by(batch_size)
            self._batch_size = batch_size
        else:
            self._batches = list(datasets)
            self._batch_size = len(self._batches[0]) if self._batches else 0
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._batches)

    def next(self) -> DataSet:
        ds = self._batches[self._pos]
        self._pos += 1
        return ds

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        return self._batch_size
