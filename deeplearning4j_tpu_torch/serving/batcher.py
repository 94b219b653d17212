"""Shape-bucketed continuous batcher, core path.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py``. Any number of
threads call :meth:`ContinuousBatcher.submit`; one coalescer thread takes a
window of requests (one deadline for the whole window, at most
``max_batch_size`` rows, one input signature), pads them to the smallest
power-of-two bucket of :func:`default_buckets` that holds them, runs ONE
``model.output`` on the padded batch, and splits the rows back out. Padding
rows are dead weight: rows never interact in inference.

A request of ``n`` rows served at bucket ``b`` returns
``model.output(pad_to_b(x))[:n]``. Outputs come back as numpy arrays;
bfloat16 outputs are widened to float32 (exactly).

Deadlines and admission limits, replicas, the pipelined in-flight window,
AOT warm-up, paging, quantized policies, sessions, chaos and tracing are
later slices.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

_SENTINEL = object()  # queue wake-up token: shutdown/drain, never a request


class ServingError(RuntimeError):
    """Explicit rejection by the serving layer (not a model fault)."""


class ServingShutdown(ServingError):
    """The batcher was shut down before the request was served."""


def default_buckets(max_batch_size: int) -> List[int]:
    """Powers of two up to ``max_batch_size`` (plus the max itself)."""
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(int(max_batch_size))
    return sorted(set(out))


class _Request:
    __slots__ = ("x", "rows", "event", "result", "error")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.rows = x.shape[0]
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


def _to_numpy(out: torch.Tensor) -> np.ndarray:
    out = out.detach()
    if out.dtype == torch.bfloat16:
        out = out.float()
    return out.to("cpu").numpy()


class ContinuousBatcher:
    """Continuous batching over one model with a ``model.output(x)``."""

    def __init__(self, model, max_batch_size: int = 32, batch_timeout_ms: float = 2.0,
                 buckets: Optional[Sequence[int]] = None):
        self.model = model
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1000.0
        self.buckets = sorted(set(int(b) for b in
                                  (buckets or default_buckets(max_batch_size))))
        self._queue: "queue.Queue" = queue.Queue()
        self._carry: Optional[_Request] = None  # request deferred to the next window
        self._saw_sentinel = False
        self._draining = False
        self._submit_lock = threading.Lock()  # guards: _draining
        self._stats_lock = threading.Lock()   # guards: batches, bucket_counts
        self.batches = 0
        self.bucket_counts: dict = {}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="ContinuousBatcher")
        self._worker.start()

    # ------------------------------------------------------------ submit
    def submit(self, x) -> np.ndarray:
        """Blocking inference; safe from many threads at once. Raises
        :class:`ServingShutdown` after shutdown, and the model's error if
        its batch failed."""
        xs = np.asarray(x)
        if xs.ndim == 0:
            raise ValueError("request must have a leading batch dimension")
        req = _Request(xs)
        with self._submit_lock:
            if self._draining:
                raise ServingShutdown("batcher is shut down")
            self._queue.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    # ------------------------------------------------------------ worker
    @staticmethod
    def _sig(x: np.ndarray):
        return (x.shape[1:], x.dtype.str)

    def _collect(self, first: _Request) -> List[_Request]:
        """One deadline for the whole window; a request that would overflow
        ``max_batch_size`` or has another signature waits for the next."""
        batch, total, sig = [first], first.rows, self._sig(first.x)
        deadline = time.monotonic() + self.batch_timeout_s
        while total < self.max_batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                self._saw_sentinel = True
                break
            if total + nxt.rows > self.max_batch_size or self._sig(nxt.x) != sig:
                self._carry = nxt
                break
            batch.append(nxt)
            total += nxt.rows
        return batch

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        b = self.buckets[-1]  # oversized single request: next power of two
        while b < rows:
            b *= 2
        self.buckets = sorted(set(self.buckets + [b]))
        return b

    def _dispatch(self, live: List[_Request]) -> None:
        try:
            rows = sum(r.rows for r in live)
            bucket = self._bucket_for(rows)
            x = np.zeros((bucket,) + live[0].x.shape[1:], live[0].x.dtype)
            ofs = 0
            for r in live:
                x[ofs:ofs + r.rows] = r.x
                ofs += r.rows
            out = _to_numpy(self.model.output(x))
            with self._stats_lock:
                self.batches += 1
                self.bucket_counts[bucket] = self.bucket_counts.get(bucket, 0) + 1
            ofs = 0
            for r in live:
                r.result = out[ofs:ofs + r.rows]
                ofs += r.rows
        except Exception as e:  # fail this batch, keep the coalescer alive
            logger.exception("batch of %d requests failed", len(live))
            for r in live:
                r.error = e
        finally:
            for r in live:
                r.x = None
                r.event.set()

    def _run(self) -> None:
        while True:
            if self._carry is not None:
                first, self._carry = self._carry, None
            elif self._saw_sentinel:
                break  # drained: everything before the sentinel is served
            else:
                first = self._queue.get()
                if first is _SENTINEL:
                    break
            self._dispatch(self._collect(first))

    # ---------------------------------------------------------- shutdown
    def shutdown(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the coalescer and join its thread. ``drain=True`` serves
        what is already queued first; either way every request still
        pending gets :class:`ServingShutdown` — no caller hangs."""
        with self._submit_lock:
            self._draining = True
            dropped = [] if drain else self._drain_queue()
            self._queue.put(_SENTINEL)
        self._worker.join(timeout=timeout_s)
        if self._worker.is_alive():
            raise RuntimeError(f"batcher worker did not stop within {timeout_s}s")
        leftovers = dropped + self._drain_queue()
        if self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        for r in leftovers:
            r.error = ServingShutdown("batcher shut down before this request was served")
            r.event.set()

    def _drain_queue(self) -> List[_Request]:
        out = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return out
            if item is not _SENTINEL:
                out.append(item)
