"""Overlapped training feed path: device prefetch + async loss readback.

Counterpart of ``deeplearning4j_tpu/train/prefetch.py``. The fit loops'
feed path is explicit stages that overlap with the device, while the
dispatch order — and with it every random draw and the whole trajectory —
stays the synchronous loop's, so results are bit-identical.

- :class:`DevicePrefetcher` — a background stage that pulls from any
  ``DataSetIterator``, coerces each batch and copies it to the device ahead
  of the step, keeping up to ``prefetch_buffer`` batches staged. On a CUDA
  device the copy goes from pinned host memory on the prefetcher's own
  stream, and an event recorded after it orders the step's stream behind
  the copy before the step reads the batch. A ``train.prefetch.fetch``
  chaos point fires per fetch; a worker fault surfaces on the consumer's
  next pull, and ``close()`` never leaves a live thread.
- :class:`AsyncLossDelivery` — listener delivery (``iteration_done``,
  ``PerformanceListener.record_batch``) on one worker thread, in submission
  order with the same arguments, so a listener that reads ``float(loss)``
  waits for the device there instead of in the dispatch loop.
- :func:`coerce_training_batch` — the one batch-coercion helper.

Only listeners that declare ``needs_model_state = False`` may be delivered
asynchronously: a state-reading listener must observe the state of *its*
iteration, which forces one-at-a-time dispatch (the same gate
:meth:`~..runtime.state_packing.PackedStepLoop.for_network` applies).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime import chaos

#: Queue tokens. ``_DONE`` ends a stream; never user data.
_DONE = object()
_STOP = object()

#: Chaos point fired once per fetched batch on the training feed path,
#: before coercion/transfer — in the prefetch worker when prefetching,
#: inline on the synchronous path, so one drill schedule covers both.
FETCH_POINT = "train.prefetch.fetch"


def stateless_listeners(model) -> bool:
    """True when every attached listener declares it never reads the
    model's state — the gate for async loss readback (and for packing)."""
    return all(not getattr(l, "needs_model_state", True)
               for l in getattr(model, "_listeners", []))


def as_device_tensor(x, device, staged: bool = False) -> torch.Tensor:
    """``x`` (an array or tensor) as a tensor on ``device``; float64 becomes
    float32, as the JAX package (64-bit off) reads it. ``staged``: a host
    tensor goes to a CUDA device through pinned memory without waiting
    (the caller's stream orders the copy)."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.dtype == torch.float64:
        t = t.float()
    if staged and t.device.type == "cpu" and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def coerce_training_batch(model, batch, staged: bool = False):
    """A ``DataSet`` minibatch as step arguments ``(x, y, fm, lm)`` on the
    model's device (the model's ``_coerce_batch``; the labels mask of
    per-timestep labels defaults to the features mask). ``staged`` copies
    from pinned host memory without waiting (the prefetcher's path)."""
    return model._coerce_batch(batch, staged=staged)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class _SyncBatchSource:
    """Degenerate source: fetch+coerce inline on the consumer thread —
    the synchronous loop, plus data-wait timing."""

    def __init__(self, iterator, prepare, profiler=None):
        self._iterator = iterator
        self._prepare = prepare
        self._profiler = profiler

    def __iter__(self) -> Iterator[Any]:
        # explicit reset BEFORE iterating, as the JAX fit loops do: not every
        # iterator's __iter__ resets (the fault-tolerance fence and skip
        # wrappers iterate from their current position)
        if hasattr(self._iterator, "reset"):
            self._iterator.reset()
        it = iter(self._iterator)
        while True:
            t0 = time.perf_counter() if self._profiler else 0.0
            try:
                ds = next(it)
            except StopIteration:
                return
            chaos.inject(FETCH_POINT)
            item = self._prepare(ds)
            if self._profiler:
                self._profiler.record_data_wait(time.perf_counter() - t0)
            yield item

    def close(self) -> None:
        pass


class DevicePrefetcher:
    """Background fetch/coerce/transfer stage over a ``DataSetIterator``.

    The worker iterates the base iterator (after an explicit ``reset()``),
    fires the ``train.prefetch.fetch`` chaos point, runs ``prepare(ds)`` —
    on a CUDA ``device`` inside the prefetcher's stream, from pinned host
    memory — records an event after the copy, and stages the result in a
    bounded queue of ``buffer`` batches. The consumer makes its current
    stream wait on that event and hands each tensor's memory to its stream
    (``record_stream``) before it yields the batch, in FIFO order: the step
    sequence is the synchronous loop's.

    A worker fault surfaces on the consumer's next pull (batches staged
    after it are dropped) and the worker exits. ``close()`` (every exit
    path calls it) stops the worker even when it is blocked on a full
    queue, and closes the underlying iterator's own worker when it has one.
    """

    def __init__(self, iterator, prepare: Callable[[Any], Any], buffer: int = 2,
                 profiler=None, name: str = "train-prefetch", device=None):
        self._iterator = iterator
        self._prepare = prepare
        self._profiler = profiler
        dev = None if device is None else torch.device(device)
        self._stream = (torch.cuda.Stream(device=dev)
                        if dev is not None and dev.type == "cuda" else None)
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(buffer)))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, name=name, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- worker
    def _stage(self, ds):
        if self._stream is None:
            return self._prepare(ds), None
        with torch.cuda.stream(self._stream):
            item = self._prepare(ds)
            ev = torch.cuda.Event()
            ev.record(self._stream)
        return item, ev

    def _worker(self) -> None:
        from deeplearning4j_tpu_torch.data.iterators import stop_aware_put
        try:
            if hasattr(self._iterator, "reset"):
                self._iterator.reset()
            for ds in self._iterator:
                if self._stop.is_set():
                    return
                chaos.inject(FETCH_POINT)
                if not stop_aware_put(self._queue, self._stage(ds), self._stop):
                    return
        except BaseException as e:  # surfaced on the consumer side
            self._error = e
        finally:
            stop_aware_put(self._queue, _DONE, self._stop)

    # ----------------------------------------------------------- consumer
    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def __iter__(self) -> Iterator[Any]:
        while True:
            # a fault that already happened surfaces NOW, before any batch
            # staged behind it
            self._raise_pending()
            t0 = time.perf_counter() if self._profiler else 0.0
            got = self._queue.get()
            if self._profiler:
                self._profiler.record_data_wait(time.perf_counter() - t0)
            if got is _DONE:
                self._raise_pending()
                return
            item, ev = got
            if ev is not None:
                cur = torch.cuda.current_stream(self._stream.device)
                cur.wait_event(ev)
                for t in _tensors(item):
                    if t.is_cuda:
                        t.record_stream(cur)
            yield item

    def close(self) -> None:
        """Stop the worker and join it; idempotent, called on every fit
        exit path (epoch end, fault, KeyboardInterrupt)."""
        from deeplearning4j_tpu_torch.data.iterators import drain_and_join
        self._stop.set()
        drain_and_join(self._queue, self._thread)
        closer = getattr(self._iterator, "close", None)
        if callable(closer):
            closer()


def batch_source(iterator, prepare, prefetch_buffer: int = 0, profiler=None,
                 name: str = "train-prefetch", device=None, staged_prepare=None):
    """The fit loops' one switch between the synchronous feed path and the
    staged pipeline: ``prefetch_buffer == 0`` fetches inline with
    ``prepare``, ``> 0`` stages that many batches ahead with
    ``staged_prepare`` (default ``prepare``) on ``device``."""
    if prefetch_buffer and int(prefetch_buffer) > 0:
        return DevicePrefetcher(iterator, staged_prepare or prepare,
                                buffer=int(prefetch_buffer), profiler=profiler,
                                name=name, device=device)
    return _SyncBatchSource(iterator, prepare, profiler=profiler)


class AsyncLossDelivery:
    """Completion-path listener delivery (single worker, FIFO).

    ``submit(args, loss)`` snapshots the step's bookkeeping arguments and
    returns at once; the worker calls ``deliver(args, loss)`` — the fit
    loop's score/iteration/listener bookkeeping — in submission order.
    With a profiler, ``submit`` records a CUDA event after the step and the
    worker waits for it to time the step (submit to done).

    Submit only what deliver reads (the fit loops pass the batch SIZE, not
    the batch). Same callbacks, same arguments, same order as the
    synchronous loop; only the thread (and so *when* a listener exception
    surfaces) differs. A listener exception is recorded, later deliveries
    are skipped, and the error re-raises on the next
    ``submit``/``flush``/``raise_pending`` — ``fit`` drains on every exit
    path, so it never passes silently.
    """

    def __init__(self, deliver: Callable[[Any, Any], None], max_pending: int = 64,
                 profiler=None, name: str = "train-listener-delivery"):
        self._deliver = deliver
        self._profiler = profiler
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(max_pending)))
        self._error: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(target=self._worker, name=name, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is _STOP:
                    return
                args, loss, t0, done = item
                if self._error is not None:
                    continue  # keep draining so submit() can't deadlock
                try:
                    if self._profiler is not None:
                        if done is not None:
                            done.synchronize()
                        self._profiler.record_step(time.perf_counter() - t0)
                    self._deliver(args, loss)
                except BaseException as e:
                    self._error = e
            finally:
                self._queue.task_done()

    def submit(self, args, loss) -> None:
        self.raise_pending()
        done = None
        if self._profiler is not None and isinstance(loss, torch.Tensor) and loss.is_cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(loss.device))
        self._queue.put((args, loss, time.perf_counter(), done))

    def flush(self) -> None:
        """Barrier: every submitted delivery has run (epoch boundaries —
        ``on_epoch_end`` must observe all of its epoch's iterations)."""
        self._queue.join()
        self.raise_pending()

    def raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def shutdown(self) -> None:
        """Drain remaining deliveries and stop the worker; never raises.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(_STOP)
        self._thread.join()
