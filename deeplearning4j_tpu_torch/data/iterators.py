"""Dataset iterators (counterpart of ``deeplearning4j_tpu/data/iterators.py``):
the ``DataSetIterator`` interface with its preprocessor hook,
``ListDataSetIterator``, ``NumpyDataSetIterator``,
``ExistingDataSetIterator`` (each also over ``MultiDataSet``s) and
``AsyncDataSetIterator``, a background thread that prefetches the batches of
another iterator. Host numpy, as in the JAX package: the same arrays and
seed give the same batches in the same order in both packages."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet


class DataSetIterator:
    """An iterable of DataSet minibatches with ``reset``; a preprocessor (a
    normalizer, :meth:`set_pre_processor`) transforms each batch."""

    pre_processor = None

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds = self.next()
        if self.pre_processor is not None:
            ds = self.pre_processor.transform_dataset(ds)
        return ds

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def set_pre_processor(self, p) -> None:
        self.pre_processor = p


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


class NumpyDataSetIterator(DataSetIterator):
    """Batches over in-memory arrays. With ``shuffle`` the order is drawn by
    ``np.random.default_rng(seed).shuffle`` at construction and again at
    every ``reset`` (so at every pass, which starts with one), as the JAX
    package draws it."""

    def __init__(self, features: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False,
                 features_mask: Optional[np.ndarray] = None,
                 labels_mask: Optional[np.ndarray] = None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.features_mask = features_mask
        self.labels_mask = labels_mask
        self._batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._order = np.arange(len(self.features))
        self._pos = 0
        if shuffle:
            self._rng.shuffle(self._order)

    def has_next(self) -> bool:
        remaining = len(self._order) - self._pos
        return remaining >= (self._batch_size if self.drop_last else 1)

    def next(self) -> DataSet:
        idx = self._order[self._pos:self._pos + self._batch_size]
        self._pos += len(idx)
        return DataSet(
            self.features[idx], self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx])

    def reset(self) -> None:
        self._pos = 0
        if self.shuffle:
            self._rng.shuffle(self._order)

    def batch(self) -> int:
        return self._batch_size


class ExistingDataSetIterator(DataSetIterator):
    """Wrap any Python iterable of DataSets (reference
    ``ExistingDataSetIterator``); ``reset`` starts it again."""

    def __init__(self, iterable):
        self._iterable = iterable
        self._iter = None
        self._peek = None

    def reset(self) -> None:
        self._iter = iter(self._iterable)
        self._peek = None

    def has_next(self) -> bool:
        if self._iter is None:
            self.reset()
        if self._peek is None:
            try:
                self._peek = next(self._iter)
            except StopIteration:
                return False
        return True

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds, self._peek = self._peek, None
        return ds

    def batch(self) -> int:
        return -1


_SENTINEL = object()


def stop_aware_put(q: queue.Queue, item, stop: threading.Event, tick: float = 0.1) -> bool:
    """``put`` with backpressure that still answers a stop event (a worker
    parked on a full queue could never be joined). False when the stop
    came first and the item was not queued."""
    while not stop.is_set():
        try:
            q.put(item, timeout=tick)
            return True
        except queue.Full:
            continue
    return False


def drain_and_join(q: queue.Queue, thread: threading.Thread, tick: float = 0.1) -> None:
    """Join a worker that feeds ``q``, draining the queue so that a worker
    blocked on ``put`` wakes within one tick."""
    while thread.is_alive():
        try:
            q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=tick)


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (reference ``AsyncDataSetIterator``, JAX
    ``iterators.py:191-289``): a worker thread runs the ``base`` iterator
    ``queue_size`` batches ahead of the training loop. ``reset``/``close``
    stop the worker and join it instead of draining the rest of the base
    iterator. An error in the worker surfaces at the consumer's next
    ``has_next``/``next``, and the batches queued behind it are dropped."""

    def __init__(self, base: DataSetIterator, queue_size: int = 8):
        self.base = base
        self.queue_size = max(1, int(queue_size))
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._peek = None
        self._error: Optional[BaseException] = None
        self._exhausted = False  # the sentinel was taken by has_next

    def _start(self) -> None:
        self._queue = queue.Queue(maxsize=self.queue_size)
        self._error = None
        self._exhausted = False
        stop = self._stop = threading.Event()
        q = self._queue

        def worker():
            try:
                self.base.reset()
                while not stop.is_set() and self.base.has_next():
                    if not stop_aware_put(q, self.base.next(), stop):
                        return
            except BaseException as e:  # surfaced on the consumer side
                self._error = e
            finally:
                stop_aware_put(q, _SENTINEL, stop)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="async-dataset-iterator")
        self._thread.start()

    def _shutdown_worker(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        drain_and_join(self._queue, self._thread)
        self._thread = None

    def reset(self) -> None:
        self._shutdown_worker()
        self._start()
        self._peek = None

    def close(self) -> None:
        """Stop the worker without starting another (a later ``reset``
        starts afresh). Safe at any point."""
        self._shutdown_worker()
        self._queue = None
        self._peek = None

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            self._exhausted = True
            self._shutdown_worker()  # nothing consumes after the raise
            raise err

    def has_next(self) -> bool:
        if self._queue is None:
            self.reset()
        if self._peek is None:
            if self._exhausted:
                return False
            self._raise_pending()
            item = self._queue.get()
            if item is _SENTINEL:
                self._exhausted = True
                self._raise_pending()
                return False
            self._peek = item
        return True

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        ds, self._peek = self._peek, None
        return ds

    def batch(self) -> int:
        return self.base.batch()
