"""ParallelInference: batched serving over device replicas.

Counterpart of ``deeplearning4j_tpu/parallel/inference.py`` (upstream
``org.deeplearning4j.parallelism.ParallelInference``): the reference keeps N
model replicas with worker threads and a dynamic batching observable. Here
the dynamic batcher is :class:`~..serving.batcher.ContinuousBatcher` —
``ParallelInference`` is its single-model case, kept as the
reference-shaped API (``Builder``, ``output()``, ``shutdown()``) — and
``Builder.workers(n)`` means N model replicas, parameter copies served
least-loaded by the batcher's :class:`~..serving.replica.ReplicaPool` on
captured CUDA graphs, clamped to the visible devices with a warning (as the
JAX package clamps to its local devices). The full serving subsystem
(registry, admission control, metrics) lives in
:mod:`deeplearning4j_tpu_torch.serving`.

Semantics of the shared batcher: the coalesce window is one deadline for the
whole batch; ``shutdown()`` drains queued requests and fails the rest with
an explicit error instead of leaving concurrent callers blocked; multi-input
``ComputationGraph`` batches concatenate per input name.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.parallel.sharding import ShardingStrategy
from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher


class ParallelInference:
    """Usage::

        pi = ParallelInference(net, max_batch_size=64)
        y = pi.output(x)          # thread-safe; concurrent calls are batched
        pi.shutdown()
    """

    def __init__(self, model, strategy: Optional[ShardingStrategy] = None,
                 max_batch_size: int = 32, queue_limit: int = 256,
                 batch_timeout_ms: float = 2.0, workers: int = 1,
                 pipeline_depth: int = 2):
        self.model = model
        self.strategy = strategy  # kept for API parity; the replicas are classic
        self.max_batch_size = int(max_batch_size)
        self._batcher = ContinuousBatcher(
            model, max_batch_size=max_batch_size, queue_limit=queue_limit,
            batch_timeout_ms=batch_timeout_ms, replicas=workers,
            pipeline_depth=pipeline_depth)

    @property
    def workers(self) -> int:
        """Actual replica count (requested workers clamped to the visible
        devices)."""
        return self._batcher.replica_count

    class Builder:
        """Reference ``ParallelInference.Builder`` surface."""

        def __init__(self, model):
            self._model = model
            self._kw = {}

        def max_batch_size(self, n: int):
            self._kw["max_batch_size"] = int(n)
            return self

        def batch_timeout_ms(self, ms: float):
            self._kw["batch_timeout_ms"] = float(ms)
            return self

        def queue_limit(self, n: int):
            self._kw["queue_limit"] = int(n)
            return self

        def workers(self, n: int):
            """Reference ``workers(n)``: N replicas of the model, routed
            least-loaded (clamped to the visible devices)."""
            self._kw["workers"] = int(n)
            return self

        def pipeline_depth(self, n: int):
            """Batches allowed in flight between dispatch and readback
            (0 = synchronous)."""
            self._kw["pipeline_depth"] = int(n)
            return self

        def inference_mode(self, mode: str):
            mode = str(mode).lower()
            if mode not in ("batched", "sequential"):
                raise ValueError(f"unknown inference mode {mode!r}; "
                                 f"'BATCHED' or 'SEQUENTIAL'")
            self._mode = mode
            return self

        def build(self) -> "ParallelInference":
            # resolve the mode LAST so call order doesn't matter:
            # SEQUENTIAL == batch size 1 regardless of max_batch_size()
            kw = dict(self._kw)
            if getattr(self, "_mode", "batched") == "sequential":
                kw["max_batch_size"] = 1
            return ParallelInference(self._model, **kw)

    @staticmethod
    def builder(model) -> "ParallelInference.Builder":
        return ParallelInference.Builder(model)

    def output(self, x):
        """Blocking inference; safe from many threads at once. ``x`` is a
        single array, or a ``{input_name: array}`` dict for multi-input
        ``ComputationGraph`` models; returns np arrays (a list for
        multi-output graphs)."""
        out = self._batcher.submit(x)
        if isinstance(out, list):
            return [np.asarray(o) for o in out]
        return np.asarray(out)

    def shutdown(self):
        self._batcher.shutdown(drain=True)
