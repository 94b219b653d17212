"""Shape-bucketed continuous batcher with a pipelined executor.

Counterpart of ``deeplearning4j_tpu/serving/batcher.py``. Coalesced batches
are padded up to a fixed set of power-of-two row buckets that are warmed at
model load (one captured CUDA graph per (bucket, replica)), so the number of
captures is bounded by ``buckets x replicas``, not by traffic. Padding rows
are dead weight (rows never interact at inference time — BN uses running
stats).

The executor is split into stages that overlap:

1. **Coalescer/dispatcher** (one thread): blocking ``queue.get`` (shutdown
   uses a sentinel), coalesces a window, copies request rows into a
   *preallocated per-bucket pad buffer* in pinned host memory, checks
   deadlines at coalesce AND again at dispatch, then issues the forward on
   the least-loaded :class:`~.replica.ReplicaPool` replica WITHOUT waiting:
   on the replica's CUDA stream the pad buffer is copied in, the graph
   replays and the output is copied into pinned host memory, followed by an
   event.
2. **In-flight window**: at most ``pipeline_depth`` dispatched batches may
   await readback (a semaphore — the backpressure that bounds memory and
   keeps deadline checks honest). ``pipeline_depth=0`` is the synchronous
   loop (coalesce, pad, forward, readback, scatter).
3. **Completion** (one thread): waits on the batch's event, scatters rows to
   requests, records metrics (the dispatch-to-completion histogram and
   per-replica batch counts), and only then returns the pad buffer to its
   pool and the slot to the window (the copy in has landed by then).

A failure anywhere — an injected ``serving.batcher.forward`` /
``serving.batcher.complete`` chaos fault, a real device error at readback —
fails only that batch's requests; later batches keep flowing.

Dtype policy (``dtype_policy=``, a :class:`~.quantize.DtypePolicy`): warm-up
also captures the quantized-dtype twin of each bucket the policy pre-warms,
int8 and f32 requests coalesce apart by signature into dtype-keyed pad
buffer pools, the quantized share of traffic is counted and latency-split in
the metrics, and the manifest records the policy. Plan slices (``plan=``,
a :class:`~..parallel.sharding.ParallelPlan`): each replica is one plan
slice (:class:`~.replica.ReplicaPool`), and the manifest records
``plan.describe()``.

Session steps (:meth:`ContinuousBatcher.enable_sessions`,
:meth:`ContinuousBatcher.submit_step`) run on a second coalescer at ONE
fixed bucket, one captured graph per replica, the carries as static inputs
and outputs.

Exactness contract: a request of ``n`` rows served at bucket ``b`` returns
``model.output(pad_to_b(x))[:n]`` — at a fixed program shape a row's result
is independent of its neighbours and of its offset in the batch, and a
replica runs the model's own forward on copies of its tensors. Outputs come
back as numpy arrays; bfloat16 outputs are widened to float32 (exactly).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime import chaos, trace
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map, tree_unflatten_like
from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionController,
    DeadlineExceeded,
    Overloaded,
    ServingError,
    ServingShutdown,
)
from deeplearning4j_tpu_torch.serving.metrics import ServingMetrics
from deeplearning4j_tpu_torch.serving.replica import Pending, Replica, ReplicaPool

ArrayOrDict = Union[np.ndarray, Dict[str, np.ndarray]]

__all__ = ["ArrayOrDict", "ContinuousBatcher", "ServingError", "ServingShutdown",
           "default_buckets"]

logger = logging.getLogger(__name__)

_SENTINEL = object()  # queue wake-up token: shutdown/drain, never a request


def _batch_span(requests, name: str):
    """Stage span for a coalesced batch on a worker thread: parented to the
    FIRST traced request of the batch (the other requests are stamped with
    bucket/replica on their own spans instead). The shared no-op span when
    nothing is traced."""
    for r in requests:
        if r.span is not None and r.span.recording:
            return r.span.child(name)
    return trace.NOOP


def default_buckets(max_batch_size: int) -> List[int]:
    """Powers of two up to ``max_batch_size`` (plus the max itself)."""
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(int(max_batch_size))
    return sorted(set(out))


class _Request:
    __slots__ = ("x", "rows", "deadline", "enqueued_at", "event",
                 "result", "error", "quantized", "span")

    def __init__(self, x: ArrayOrDict, rows: int, deadline: Optional[float],
                 quantized: bool = False):
        self.x = x
        self.rows = rows
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.quantized = quantized
        # the submitting context's active span: batch stage spans on the
        # worker threads parent to it — None while tracing is disabled
        self.span = trace.current_span()


class _StepRequest:
    """One session step awaiting the session coalescer: a single stream row
    plus its batch-1 carry tree. Duck-types the ``_Request`` fields
    ``_expire``/``_fail`` touch."""

    __slots__ = ("x", "carries", "rows", "deadline", "enqueued_at", "event",
                 "result", "error", "quantized", "span")

    def __init__(self, x, carries, deadline: Optional[float]):
        self.x = x
        self.carries = carries
        self.rows = 1
        self.deadline = deadline
        self.enqueued_at = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.quantized = False
        self.span = trace.current_span()


class _InFlight:
    """One dispatched batch awaiting readback."""

    __slots__ = ("requests", "rows", "bucket", "replica", "pending", "buffers",
                 "forward_at", "dispatched_at")

    def __init__(self, requests, rows, bucket, replica, pending, buffers,
                 forward_at, dispatched_at):
        self.requests: List[_Request] = requests
        self.rows = rows
        self.bucket = bucket
        self.replica: Replica = replica
        self.pending: Pending = pending   # on its way to the host
        self.buffers = buffers            # [(pool_key, pad buffer), ...]
        self.forward_at = forward_at      # just before the forward was issued
        self.dispatched_at = dispatched_at  # when dispatch returned


class _PadBuffer:
    """One pooled pad buffer: a (pinned, on a CUDA pool) host tensor and
    the numpy view the rows are copied through."""

    __slots__ = ("tensor", "array")

    def __init__(self, shape, dtype: np.dtype, pinned: bool):
        t = torch.from_numpy(np.empty(0, dtype))
        self.tensor = torch.empty(shape, dtype=t.dtype, pin_memory=pinned)
        self.array = self.tensor.numpy()


class ContinuousBatcher:
    """Continuous batching over one model (MultiLayerNetwork or
    ComputationGraph, or any model with an ``output``).

    Thread-safe: any number of threads call :meth:`submit` concurrently; a
    coalescer thread forms bucketed batches and dispatches them onto
    replicas without waiting for readback; a completion thread scatters
    results. ``replicas=N`` serves from N parameter copies (least-loaded
    routing) on ``devices`` (default: the visible CUDA devices, or the CPU
    when the model lives there; ``devices=[d, d]`` puts two on one
    device); ``pipeline_depth`` bounds the dispatched-but-unread batches in
    flight (0 = synchronous).

    Inputs: a single array for ``MultiLayerNetwork``-style models, or a
    ``{input_name: array}`` dict for multi-input ``ComputationGraph``s.
    ``dtype_policy`` serves quantized traffic beside float traffic;
    ``plan`` makes each replica a plan slice (see the module docstring).
    """

    def __init__(self, model, max_batch_size: int = 32,
                 batch_timeout_ms: float = 2.0, queue_limit: int = 256,
                 buckets: Optional[Sequence[int]] = None,
                 admission: Optional[AdmissionController] = None,
                 metrics: Optional[ServingMetrics] = None,
                 warmup_example: Optional[ArrayOrDict] = None,
                 replicas: int = 1, pipeline_depth: int = 2,
                 devices: Optional[Sequence] = None,
                 dtype_policy=None, plan=None):
        self.model = model
        self.plan = plan
        self.dtype_policy = dtype_policy
        if getattr(model, "_params", 1) is None:
            model._ensure_init()
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1000.0
        self.buckets = sorted(set(int(b) for b in
                                  (buckets or default_buckets(max_batch_size))))
        self.pipeline_depth = max(0, int(pipeline_depth))
        self.admission = admission or AdmissionController(queue_limit=queue_limit)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pool = ReplicaPool(model, n_replicas=replicas, devices=devices, plan=plan)
        self._pinned = any(r.device.type == "cuda" for r in self._pool.replicas)
        self.metrics = metrics or ServingMetrics(
            queue_depth_fn=self._queue.qsize,
            # the pool's count, not a method of the batcher: a bound method
            # would close a reference cycle through the batcher, and an evicted
            # model would wait for the collector to leave the card
            compile_count_fn=self._pool.aot_count,
            inflight_fn=self._pool.total_in_flight)
        if self.dtype_policy is not None:
            self.metrics.set_dtype_policy(self.dtype_policy.label())
        self._graph_inputs = list(getattr(getattr(model, "conf", None), "inputs", []) or [])
        self._warmed_pairs: List[tuple] = []  # (bucket, replica, dtype)
        # worker thread mints buckets while a control thread resizes
        self._warm_lock = threading.Lock()  # guards: _warmed_pairs
        # a whole grow/shrink to a target count (the server's replicas
        # endpoint), so two racing resizes never overshoot
        self.resize_lock = threading.Lock()
        self._shutdown = False
        self._draining = False
        self._saw_sentinel = False
        self._carry: Optional[_Request] = None  # deferred overflow request
        # vs shutdown: no orphan enqueues after the drain flag flips
        self._submit_lock = threading.Lock()  # guards: _draining
        self._example: Optional[ArrayOrDict] = None  # 1-row zeros template
        self._batch_seq = itertools.count(1)  # failure keys (breaker dedup)
        # pad-buffer pools: (bucket, input, shape, dtype) -> free buffers
        self._buf_lock = threading.Lock()  # guards: _buf_pool
        self._buf_pool: Dict[tuple, List[_PadBuffer]] = {}
        self._stats_lock = threading.Lock()  # guards: batches, bucket_counts
        self.batches = 0
        self.bucket_counts: Dict[int, int] = {}
        # at most `depth` dispatched-unread batches; completion releases
        self._slots = (threading.BoundedSemaphore(self.pipeline_depth)
                       if self.pipeline_depth >= 1 else None)
        self._completion_q: "queue.Queue[_InFlight]" = queue.Queue()
        self._completion_lock = threading.Lock()  # guards: _completion_closed
        self._completion_closed = False  # set once shutdown drained the queue
        # session-step path: a parallel coalescer for stateful rnn_time_step
        # traffic, off until enable_sessions(). Every step batch executes at
        # ONE fixed padded bucket, so a serial oracle padded to the same
        # shape reproduces every stream bit for bit.
        self._session_q: Optional["queue.Queue"] = None
        self._session_bucket: Optional[int] = None
        self._session_template = None    # batch-1 zero-carry tree (numpy)
        self._session_carry: Optional[_StepRequest] = None
        self._session_saw_sentinel = False
        self._session_worker: Optional[threading.Thread] = None
        if warmup_example is not None:
            self.warmup(warmup_example)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="ContinuousBatcher")
        self._completer: Optional[threading.Thread] = None
        if self.pipeline_depth >= 1:
            self._completer = threading.Thread(
                target=self._complete_loop, daemon=True,
                name="ContinuousBatcher-complete")
            self._completer.start()
        self._worker.start()

    # -------------------------------------------------------------- replicas
    @property
    def replica_count(self) -> int:
        return len(self._pool)

    def add_replica(self) -> int:
        """Grow the pool by one replica at runtime. The new replica is warmed
        from the live :meth:`warmup_manifest` — every recorded bucket,
        including traffic-minted ones — BEFORE it is published for routing,
        so it never captures on live traffic. Safe to call from a control
        thread while traffic flows. Returns the new replica count."""
        rep = self._pool.create_replica()
        manifest = self.warmup_manifest()
        if manifest is not None:
            example = manifest.example()
            for b in manifest.buckets:
                self._warm_forward(rep, example, b)
                self._record_warmed(b, rep.index, example)
            qex = self._quantized_example(example)
            if qex is not None:
                for b in self.dtype_policy.buckets_for(manifest.buckets):
                    self._warm_forward(rep, qex, b)
                    self._record_warmed(b, rep.index, qex)
        if self._session_bucket is not None:
            self._warm_session(rep)
        return self._pool.publish_replica(rep)

    def remove_replica(self) -> int:
        """Shrink the pool by one replica (the newest; replica 0 stays).
        In-flight batches on the retired replica complete normally — only
        new routing stops. Raises ``ValueError`` at one replica. Returns the
        new replica count."""
        rep = self._pool.retire_replica()
        if rep is None:
            raise ValueError("cannot remove the last replica")
        # the manifest describes the LIVE pool: drop the retired replica's
        # pairs (under the warm lock: the worker may be minting a bucket)
        with self._warm_lock:
            self._warmed_pairs[:] = [p for p in self._warmed_pairs
                                     if p[1] != rep.index]
        return self.replica_count

    # ------------------------------------------------------------ warmup
    def warmup(self, example: ArrayOrDict) -> int:
        """Capture every (bucket, replica) graph from zero rows shaped like
        ``example`` (any leading row count), and preallocate one pad buffer
        per bucket. Returns the number of programs warmed. After this,
        steady-state traffic captures nothing. Every warmed (bucket,
        replica, dtype) pair is recorded for :meth:`warmup_manifest`."""
        chaos.inject("serving.batcher.warmup")
        example = self._normalize(example)[0]
        self._example = self._zeros_with_rows(example, 1)
        # the policy's quantized twin: its pairs are captured beside the
        # float ones, and its pad buffers pool under their own dtype
        qex = self._quantized_example(example)
        qbuckets = self.dtype_policy.buckets_for(self.buckets) if qex is not None else []
        n = 0
        for rep in list(self._pool.replicas):
            for b in self.buckets:
                self._warm_forward(rep, example, b)
                self._record_warmed(b, rep.index, example)
                n += 1
            for b in qbuckets:
                self._warm_forward(rep, qex, b)
                self._record_warmed(b, rep.index, qex)
                n += 1
        for b in self.buckets:  # preallocate the pad buffers
            self._release_buffers(self._gather([], 0, b, template=example)[1])
        for b in qbuckets:
            self._release_buffers(self._gather([], 0, b, template=qex)[1])
        return n

    def _quantized_example(self, example: ArrayOrDict) -> Optional[ArrayOrDict]:
        """The dtype policy's quantized zeros shaped like ``example``, or
        ``None`` (no policy, or it quantizes no input)."""
        if self.dtype_policy is None:
            return None
        return self.dtype_policy.quantized_zeros(example)

    def _warm_forward(self, rep: Replica, example: ArrayOrDict, rows: int) -> None:
        """Capture ``rep``'s graph at ``rows`` rows: a zero pad buffer from
        the pool (what the dispatch hands the pool), returned once the
        forward has read back."""
        x, held = self._gather([], 0, rows, template=example)
        try:
            self._pool.forward_blocking(rep, x)
        finally:
            self._release_buffers(held)

    def _record_warmed(self, bucket: int, replica: int,
                       example: Optional[ArrayOrDict] = None) -> None:
        example = example if example is not None else self._example
        if example is None:
            dt = "?"
        elif isinstance(example, dict):
            dt = ",".join(sorted({str(v.dtype) for v in example.values()}))
        else:
            dt = str(example.dtype)
        with self._warm_lock:
            self._warmed_pairs.append((int(bucket), int(replica), dt))

    def warmup_manifest(self):
        """Manifest of everything this batcher warmed — buckets (including
        any minted under live traffic), replica count, the input signature,
        and every recorded (bucket, replica, dtype) pair. ``None`` until the
        batcher has been warmed or has seen traffic."""
        from deeplearning4j_tpu_torch.serving.manifest import WarmupManifest
        if self._example is None:
            return None
        with self._warm_lock:
            pairs = list(self._warmed_pairs)
        return WarmupManifest.from_example(
            self._example, buckets=list(self.buckets),
            replicas=self.replica_count, pairs=pairs,
            max_batch_size=self.max_batch_size,
            model=type(self.model).__name__,
            policy=self.dtype_policy.to_dict() if self.dtype_policy is not None else None,
            plan=self.plan.describe() if self.plan is not None else None)

    @staticmethod
    def _zeros_with_rows(x: ArrayOrDict, rows: int) -> ArrayOrDict:
        if isinstance(x, dict):
            return {k: np.zeros((rows,) + v.shape[1:], v.dtype)
                    for k, v in x.items()}
        return np.zeros((rows,) + x.shape[1:], x.dtype)

    def compile_count(self) -> int:
        """Programs behind this model's served path: the replica pool's
        captured graphs plus its eager ledger (``aot_dispatch`` off),
        session steps included. A warmed pipeline holds exactly
        ``len(buckets) x replica_count``, plus one per replica once
        sessions are on."""
        return self._pool.aot_count()

    # ------------------------------------------------------------ submit
    def _normalize(self, x: ArrayOrDict):
        if isinstance(x, dict):
            xs = {k: np.asarray(v) for k, v in x.items()}
            rows = {v.shape[0] for v in xs.values()}
            if len(rows) != 1:
                raise ValueError(f"inconsistent leading dims across inputs: "
                                 f"{ {k: v.shape for k, v in xs.items()} }")
            return xs, rows.pop()
        xs = np.asarray(x)
        if xs.ndim == 0:
            raise ValueError("request must have a leading batch dimension")
        return xs, xs.shape[0]

    def _drain_ms_per_request(self) -> Optional[float]:
        """Recent per-request service estimate (mean batch latency spread
        over a full bucket) — the drain rate behind the ``Retry-After``
        hint on :class:`Overloaded` rejections. ``None`` until a batch has
        been measured."""
        hist = self.metrics.batch_latency
        if hist.count == 0:
            return None
        return hist.mean * 1000.0 / max(1, self.max_batch_size)

    def submit(self, x: ArrayOrDict, timeout_ms: Optional[float] = None):
        """Blocking inference; safe from many threads at once.

        Raises :class:`Overloaded` when the queue is full,
        :class:`DeadlineExceeded` when the deadline passed before the model
        ran the request, :class:`ServingShutdown` if shut down first, and
        the model's error if its batch failed.
        """
        chaos.inject("serving.batcher.submit")
        xs, rows = self._normalize(x)
        if (any(not v.flags.writeable for v in xs.values())
                if isinstance(xs, dict) else not xs.flags.writeable):
            self.metrics.record_zero_copy(rows)
        with self._submit_lock:
            if self._shutdown or self._draining:
                raise ServingShutdown("batcher is shut down")
            try:
                self.admission.admit(self._queue.qsize(),
                                     self._drain_ms_per_request())
            except Overloaded:
                self.metrics.record_rejection("overload")
                trace.flag_current("shed")  # tail sampling keeps sheds
                raise
            quant = (self.dtype_policy is not None
                     and self.dtype_policy.is_quantized_request(xs))
            req = _Request(xs, rows, self.admission.deadline_for(timeout_ms), quantized=quant)
            self.metrics.record_admitted(quantized=quant)
            self._queue.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def evaluate(self, x: ArrayOrDict) -> np.ndarray:
        """``x``'s rows through the replicas' graphs at the buckets warmed
        for their dtype, outside the queue, the admission and the metrics:
        the accuracy gate's serving path. Chunks of at most the largest
        such bucket, each padded to the smallest one that holds it; the
        first output's rows, concatenated."""
        xs, rows = self._normalize(x)
        like = next(iter(xs.values())) if isinstance(xs, dict) else xs
        with self._warm_lock:
            warmed = sorted({b for b, _, dt in self._warmed_pairs if dt == str(like.dtype)})
        buckets = warmed or self.buckets
        outs = []
        for i in range(0, rows, buckets[-1]):
            n = min(buckets[-1], rows - i)
            bucket = next(b for b in buckets if b >= n)
            part = ({k: v[i:i + n] for k, v in xs.items()} if isinstance(xs, dict)
                    else xs[i:i + n])
            padded = self._zeros_with_rows(part, bucket)
            if isinstance(padded, dict):
                for k in padded:
                    padded[k][:n] = part[k]
            else:
                padded[:n] = part
            rep = self._pool.acquire()
            try:
                out = self._pool.dispatch(rep, padded).wait()
            finally:
                self._pool.release(rep)
            outs.append((out[0] if isinstance(out, list) else out)[:n])
        return np.concatenate(outs, axis=0)

    # ----------------------------------------------------- session steps
    def enable_sessions(self, example: ArrayOrDict,
                        session_bucket: int = 8) -> None:
        """Switch on the stateful session-step path.

        ``example`` is ONE stream row of step input — shape ``(1, T, F)`` —
        used to pin the carry dtype and capture the fixed session graph on
        every replica before traffic. ``session_bucket`` is the single
        padded batch size every step batch executes at: one FIXED program
        shape, so every step is bit for bit a serial ``rnn_time_step`` loop
        padded to the same shape. Idempotent."""
        if self._session_q is not None:
            return
        model = self.model
        if not hasattr(model, "rnn_zero_state") or self._pool.fallback:
            raise ValueError("model has no recurrent-state API "
                             "(rnn_zero_state); sessions need an RNN")
        xs, rows = self._normalize(example)
        if isinstance(xs, dict):
            if len(xs) != 1:
                raise ValueError("session steps support single-input models only")
            xs = next(iter(xs.values()))
        if rows != 1:
            raise ValueError("session warmup example must be exactly one stream row")
        outputs = list(getattr(model.conf, "outputs", []) or [])
        if self._graph_inputs and len(outputs) != 1:
            raise ValueError("session steps support single-output graphs only")
        template = model.rnn_zero_state(1, like=xs)
        if not tree_leaves(template):
            raise ValueError("model has no recurrent layers; use submit()")
        if any(t.dtype == torch.bfloat16 for t in tree_leaves(template)):
            raise ValueError("session carries in bfloat16 have no numpy dtype to "
                             "spill; send float32 steps")
        self._session_template = tree_map(lambda t: t.detach().cpu().numpy(), template)
        self._session_example = np.zeros((1,) + xs.shape[1:], xs.dtype)
        self._session_bucket = max(1, int(session_bucket))
        # capture the one fixed shape on every replica now — first session
        # traffic must never pay a capture
        for rep in list(self._pool.replicas):
            self._warm_session(rep)
        self._session_q = queue.Queue()
        self._session_worker = threading.Thread(
            target=self._run_sessions, daemon=True,
            name="ContinuousBatcher-session")
        self._session_worker.start()

    def _warm_session(self, rep: Replica) -> None:
        xb = np.zeros((self._session_bucket,) + self._session_example.shape[1:],
                      self._session_example.dtype)
        carries = self._stack_carries([], self._session_bucket)
        self._pool.warm(lambda: self._pool.step(rep, carries, xb))

    @property
    def session_bucket(self) -> Optional[int]:
        return self._session_bucket

    def session_state_template(self):
        """Fresh copy of the batch-1 zero-carry tree a new stream starts
        from (numpy leaves, carry dtype pinned by the warm-up)."""
        if self._session_template is None:
            raise RuntimeError("sessions not enabled on this batcher")
        return tree_map(np.copy, self._session_template)

    def _stack_carries(self, trees, bucket: int):
        """Gather per-stream batch-1 carry trees into one batch-``bucket``
        tree: concatenate along axis 0, zero-pad the tail rows with the
        template. Padding rows cannot perturb live rows (fixed program
        shape, row-independent results)."""
        trees = list(trees) + [self._session_template] * (bucket - len(trees))
        columns = zip(*[tree_leaves(t) for t in trees])
        return tree_unflatten_like(
            self._session_template,
            [np.concatenate([np.asarray(l) for l in col], axis=0) for col in columns])

    def submit_step(self, x: ArrayOrDict, carries,
                    timeout_ms: Optional[float] = None):
        """Blocking session step: advance ONE stream row by one input
        chunk. ``carries`` is the stream's batch-1 carry tree (``None`` for
        a fresh stream). Returns ``(out_row, new_carries)`` with numpy
        leaves. Steps coalesce with other streams' concurrent steps into the
        fixed session bucket; admission, deadlines and shutdown are shared
        with :meth:`submit`."""
        if self._session_q is None:
            raise RuntimeError("sessions not enabled on this batcher "
                               "(call enable_sessions first)")
        chaos.inject("serving.batcher.submit")
        xs, rows = self._normalize(x)
        if isinstance(xs, dict):
            if len(xs) != 1:
                raise ValueError("session steps support single-input models only")
            xs = next(iter(xs.values()))
        if rows != 1:
            raise ValueError("a session step carries exactly one stream row")
        with self._submit_lock:
            if self._shutdown or self._draining:
                raise ServingShutdown("batcher is shut down")
            try:
                self.admission.admit(self._session_q.qsize(),
                                     self._drain_ms_per_request())
            except Overloaded:
                self.metrics.record_rejection("overload")
                trace.flag_current("shed")
                raise
            req = _StepRequest(xs, carries, self.admission.deadline_for(timeout_ms))
            self.metrics.record_admitted()
            self._session_q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _collect_steps(self, first: _StepRequest) -> List[_StepRequest]:
        """Session-window coalescing: the one-deadline-per-window rule of
        :meth:`_collect`, capped at the fixed session bucket; a step whose
        input signature differs from the window's carries over."""
        batch = [first]
        sig = self._sig(first.x)
        deadline = time.monotonic() + self.batch_timeout_s
        while len(batch) < self._session_bucket:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._session_q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                self._session_saw_sentinel = True
                break
            if self._sig(nxt.x) != sig:
                self._session_carry = nxt
                break
            batch.append(nxt)
        return batch

    def _dispatch_steps(self, batch: List[_StepRequest]) -> None:
        live = self._expire(batch, "session-dispatch")
        if not live:
            return
        bucket = self._session_bucket
        rows = len(live)
        replica = None
        t0 = time.monotonic()
        dsp = _batch_span(live, "batcher.session_step")
        try:
            with dsp:
                if dsp.recording:
                    dsp.set("bucket", bucket)
                    dsp.set("rows", rows)
                xb = np.zeros((bucket,) + live[0].x.shape[1:], live[0].x.dtype)
                for i, r in enumerate(live):
                    xb[i] = r.x[0]
                carries = self._stack_carries(
                    [r.carries if r.carries is not None
                     else self._session_template for r in live], bucket)
                chaos.inject("serving.batcher.forward")
                replica = self._pool.acquire()
                out, new = self._pool.step(replica, carries, xb).wait()
                if dsp.recording:
                    dsp.set("replica", replica.index)
        except BaseException as e:
            # fail only this window — an injected fault or a bad step mix
            # must not kill the session coalescer
            if replica is not None:
                self._pool.release(replica)
            self._fail(live, e)
            return
        t1 = time.monotonic()
        self._pool.release(replica)
        self.metrics.record_batch(rows, bucket, t1 - t0, replica=replica.index)
        for i, r in enumerate(live):
            row_out = np.ascontiguousarray(out[i:i + 1])
            row_new = tree_map(lambda l, _i=i: np.ascontiguousarray(l[_i:_i + 1]), new)
            r.result = (row_out, row_new)
            self.metrics.record_response(t1 - r.enqueued_at)
            r.event.set()

    def _run_sessions(self) -> None:
        while True:
            if self._shutdown:
                break
            if self._session_carry is not None:
                first, self._session_carry = self._session_carry, None
            elif self._session_saw_sentinel:
                break  # drained: every step before the sentinel is served
            else:
                first = self._session_q.get()
                if first is _SENTINEL:
                    break
            batch = self._collect_steps(first)
            try:
                self._dispatch_steps(batch)
            except BaseException as e:
                logger.exception("unexpected error dispatching a session step window")
                self._fail([r for r in batch if not r.event.is_set()], e)

    # ----------------------------------------------------------- coalesce
    @staticmethod
    def _sig(x: ArrayOrDict):
        """Coalescing signature: feature shape + dtype per input. Only
        same-signature requests may share a pad buffer."""
        if isinstance(x, dict):
            return tuple(sorted((k, v.shape[1:], v.dtype.str) for k, v in x.items()))
        return (x.shape[1:], x.dtype.str)

    def _collect(self, first: _Request) -> List[_Request]:
        """Coalesce: one deadline for the WHOLE window. A request that would
        push the batch past ``max_batch_size`` — or one whose shape/dtype
        signature differs from the window's — is carried into the next
        window instead of overflowing or poisoning this one."""
        batch = [first]
        total = first.rows
        sig = self._sig(first.x)
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
            if (total + nxt.rows > self.max_batch_size
                    or self._sig(nxt.x) != sig):
                self._carry = nxt
                break
            batch.append(nxt)
            total += nxt.rows
        return batch

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        # oversized single request (rows > max bucket): round up to the next
        # power of two, remember it, and warm it on every replica NOW — the
        # creating request pays the capture once and the bound
        # `captures <= buckets x replicas` stays truthful for later traffic
        b = self.buckets[-1]
        while b < rows:
            b *= 2
        self.buckets = sorted(set(self.buckets + [b]))
        self._warm_bucket(b)
        return b

    def _warm_bucket(self, b: int) -> None:
        if self._example is None:
            return  # never warmed and no traffic yet: first dispatch captures
        qex = self._quantized_example(self._example)
        if qex is not None and b not in self.dtype_policy.buckets_for([b]):
            qex = None
        for rep in list(self._pool.replicas):
            self._warm_forward(rep, self._example, b)
            self._record_warmed(b, rep.index)
            if qex is not None:  # minted buckets stay policy-complete
                self._warm_forward(rep, qex, b)
                self._record_warmed(b, rep.index, qex)

    # ---------------------------------------------------------- pad buffers
    def _acquire_buf(self, bucket: int, name, like: np.ndarray):
        dt = np.dtype(np.float32) if like.dtype == np.float64 else like.dtype
        k = (bucket, name, like.shape[1:], dt.str)
        with self._buf_lock:
            free = self._buf_pool.get(k)
            if free:
                return k, free.pop()
        return k, _PadBuffer((bucket,) + like.shape[1:], dt, self._pinned)

    def _release_buffers(self, buffers) -> None:
        # a buffer returns only after its batch's readback completed, so the
        # copy to the device has landed and nothing reads it any more
        cap = self.pipeline_depth + 2
        with self._buf_lock:
            for k, buf in buffers:
                free = self._buf_pool.setdefault(k, [])
                if len(free) < cap:
                    free.append(buf)

    def _gather(self, live: List[_Request], rows: int, bucket: int,
                template: Optional[ArrayOrDict] = None) -> Tuple[ArrayOrDict, list]:
        """Copy request rows into a pooled per-bucket pad buffer and zero the
        tail — bit-identical to pad(concat(rows)). Returns what the pool
        dispatches (tensors over the buffers, numpy for a fallback model)
        and the buffers held."""
        template = template if template is not None else live[0].x
        fallback = self._pool.fallback

        def fill(name, like, pick):
            k, buf = self._acquire_buf(bucket, name, like)
            ofs = 0
            for r in live:
                buf.array[ofs:ofs + r.rows] = pick(r)
                ofs += r.rows
            if ofs < bucket:
                buf.array[ofs:] = 0
            held.append((k, buf))
            return buf.array if fallback else buf.tensor

        held: list = []
        if isinstance(template, dict):
            x = {name: fill(name, v, lambda r, _n=name: r.x[_n])
                 for name, v in template.items()}
        else:
            x = fill(None, template, lambda r: r.x)
        for r in live:
            r.x = None  # drop the row reference now: the rows are in the buffer
        return x, held

    # ------------------------------------------------------------ dispatch
    def _forward(self, x):
        """Issue the forward on the least-loaded replica; returns
        ``(pending, replica)`` WITHOUT waiting for readback."""
        chaos.inject("serving.batcher.forward")
        replica = self._pool.acquire()
        try:
            pending = self._pool.dispatch(replica, x)
        except BaseException:
            self._pool.release(replica)
            raise
        return pending, replica

    def _expire(self, batch: List[_Request], stage: str) -> List[_Request]:
        now = time.monotonic()
        live: List[_Request] = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                r.error = DeadlineExceeded(
                    f"deadline passed {now - r.deadline:.3f}s before "
                    f"execution at the {stage} stage "
                    f"(queued {now - r.enqueued_at:.3f}s)")
                self.metrics.record_rejection("deadline")
                if r.span is not None:
                    r.span.flag("deadline")
                    r.span.event("expired", stage=stage)
                r.event.set()
            else:
                live.append(r)
        return live

    def _tag_failure(self, e: BaseException) -> None:
        """Stamp a per-batch key so the circuit breaker counts one faulted
        batch once, not once per coalesced request. Stamped
        UNCONDITIONALLY: a chaos policy may raise the same exception
        instance for every hit."""
        try:
            e._serving_failure_key = f"batch-{id(self)}-{next(self._batch_seq)}"
        except Exception:
            pass  # exceptions with __slots__: breaker falls back to per-request

    def _fail(self, requests: List[_Request], e: BaseException) -> None:
        self._tag_failure(e)
        for r in requests:
            r.error = e
            self.metrics.record_rejection("error")
            r.event.set()

    def _abort(self, requests: List[_Request], e: BaseException,
               buffers=(), replica=None, slot_held: bool = False,
               reuse_buffers: bool = False) -> None:
        """Fail ONE batch and release whatever it held. ``reuse_buffers``
        only when no copy can still be reading the pad buffers (the forward
        was never dispatched, or its dispatch waited for its stream)."""
        if reuse_buffers:
            self._release_buffers(buffers)
        if replica is not None:
            self._pool.release(replica)
        if slot_held and self._slots is not None:
            self._slots.release()
        self._fail(requests, e)

    def _dispatch(self, batch: List[_Request]) -> None:
        live = self._expire(batch, "coalesce")
        if not live:
            return
        slot_held = False
        buffers: list = []
        pending = replica = None
        try:
            if self._example is None:
                self._example = self._zeros_with_rows(live[0].x, 1)
            if self._slots is not None:
                # backpressure: wait for an in-flight slot (bounded poll so a
                # hard shutdown can't strand us here)
                while not self._slots.acquire(timeout=0.1):
                    if self._shutdown:
                        self._fail(live, ServingShutdown(
                            "batcher shut down before this batch was dispatched"))
                        return
                slot_held = True
                # a slot wait can outlive a deadline: re-check at dispatch
                live = self._expire(live, "dispatch")
                if not live:
                    self._slots.release()
                    return
            rows = sum(r.rows for r in live)
            bucket = self._bucket_for(rows)      # may mint + warm a bucket
            dsp = _batch_span(live, "batcher.dispatch")
            with dsp:
                if dsp.recording:
                    dsp.set("bucket", bucket)
                    dsp.set("rows", rows)
                    dsp.set("requests", len(live))
                x, buffers = self._gather(live, rows, bucket)
                forward_at = time.monotonic()
                # AotCache.call annotates "aot" hit/miss on this span
                pending, replica = self._forward(x)
                if dsp.recording:
                    dsp.set("replica", replica.index)
                    for r in live:
                        if r.span is not None and r.span.recording:
                            r.span.set("bucket", bucket)
                            r.span.set("replica", replica.index)
        except BaseException as e:
            # fail only this batch — a bad request mix, a failed bucket warm,
            # or an injected fault must not kill the coalescer (a failed
            # dispatch waited for its stream, so its buffers may be reused)
            self._abort(live, e, buffers=buffers, replica=replica,
                        slot_held=slot_held, reuse_buffers=pending is None)
            return
        rec = _InFlight(live, rows, bucket, replica, pending, buffers,
                        forward_at, time.monotonic())
        if self._slots is None:
            self._complete(rec)          # synchronous mode
            return
        with self._completion_lock:
            if not self._completion_closed:
                self._completion_q.put(rec)
                return
        # shutdown already drained the completion queue (this worker outlived
        # its join timeout): nobody will read this record — fail it here
        self._abort(live, ServingShutdown(
            "batcher shut down before this batch could complete"),
            buffers=buffers, replica=replica, slot_held=True)

    # ---------------------------------------------------------- completion
    def _complete(self, rec: _InFlight) -> None:
        csp = _batch_span(rec.requests, "batcher.complete")
        try:
            with csp:
                if csp.recording:
                    csp.set("bucket", rec.bucket)
                    csp.set("replica", rec.replica.index)
                    csp.set("rows", rec.rows)
                chaos.inject("serving.batcher.complete")
                out = rec.pending.wait()          # blocking readback
            t1 = time.monotonic()
            # readback done => the copy in has landed long ago; only NOW may
            # the pad buffers return to the pool
            self._release_buffers(rec.buffers)
            self.metrics.record_batch(rec.rows, rec.bucket, t1 - rec.forward_at,
                                      replica=rec.replica.index)
            self.metrics.record_dispatch(t1 - rec.dispatched_at)
            with self._stats_lock:
                self.batches += 1
                self.bucket_counts[rec.bucket] = self.bucket_counts.get(rec.bucket, 0) + 1
            ofs = 0
            for r in rec.requests:
                sl = slice(ofs, ofs + r.rows)
                r.result = [o[sl] for o in out] if isinstance(out, list) else out[sl]
                ofs += r.rows
                self.metrics.record_response(t1 - r.enqueued_at, quantized=r.quantized)
        except BaseException as e:
            # fault before/at readback: the buffers are dropped, not pooled
            self._tag_failure(e)
            for r in rec.requests:
                r.error = e
                self.metrics.record_rejection("error")
        finally:
            self._pool.release(rec.replica)
            if self._slots is not None:
                self._slots.release()
            for r in rec.requests:
                r.event.set()

    def _complete_loop(self) -> None:
        while True:
            rec = self._completion_q.get()
            if rec is _SENTINEL:
                break
            self._complete(rec)

    # -------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            if self._shutdown:
                break
            if self._carry is not None:
                first, self._carry = self._carry, None
            elif self._saw_sentinel:
                break  # drained: everything before the sentinel is served
            else:
                first = self._queue.get()  # blocking — no idle busy-wake
                if first is _SENTINEL:
                    break
            batch = self._collect(first)
            try:
                self._dispatch(batch)
            except BaseException as e:  # last resort: never kill the coalescer
                logger.exception("unexpected error dispatching a batch")
                self._fail([r for r in batch if not r.event.is_set()], e)

    # ---------------------------------------------------------- shutdown
    def shutdown(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the pipeline. ``drain=True`` (default) serves whatever is
        already queued AND waits for every in-flight batch to read back;
        either way every still-pending request gets an explicit
        :class:`ServingShutdown` error — no caller hangs. Then the replica
        pool is closed (:meth:`~.replica.ReplicaPool.close`): what the
        replicas held on the device is freed."""
        with self._submit_lock:
            if drain:
                self._draining = True
            else:
                self._shutdown = True
        self._queue.put(_SENTINEL)  # wake the blocking coalescer
        if self._session_q is not None:
            self._session_q.put(_SENTINEL)  # wake the session coalescer
        self._worker.join(timeout=timeout_s)
        if self._session_worker is not None:
            self._session_worker.join(timeout=timeout_s)
        if self._completer is not None:
            self._completion_q.put(_SENTINEL)
            self._completer.join(timeout=timeout_s)
            # No record may be left for a consumer that will never read it.
            # Close the queue (a straggling worker now fails its own batches
            # at dispatch), then drain: finish stragglers inline if the
            # completer exited cleanly; if it is WEDGED, fail them instead.
            with self._completion_lock:
                self._completion_closed = True
            wedged = self._completer.is_alive()
            while True:
                try:
                    rec = self._completion_q.get_nowait()
                except queue.Empty:
                    break
                if rec is _SENTINEL:
                    continue
                if wedged:
                    self._abort(rec.requests, ServingShutdown(
                        "batcher completion stage wedged at shutdown; this "
                        "batch was dispatched but never read back"),
                        buffers=rec.buffers, replica=rec.replica, slot_held=True)
                else:
                    self._complete(rec)
        with self._submit_lock:
            self._shutdown = True
            self._draining = True
        leftovers = []
        if self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        if self._session_carry is not None:
            leftovers.append(self._session_carry)
            self._session_carry = None
        drainable = [self._queue]
        if self._session_q is not None:
            drainable.append(self._session_q)
        for q in drainable:
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if item is not _SENTINEL:
                    leftovers.append(item)
        for r in leftovers:
            r.error = ServingShutdown("batcher shut down before this request was served")
            r.event.set()
        # a worker that outlived its join timeout may have re-parked in the
        # blocking get AFTER the drain above swallowed the first sentinel;
        # leave one more so it can never be parked forever
        running = False
        if self._worker.is_alive():
            self._queue.put(_SENTINEL)
            running = True
        if self._session_worker is not None and self._session_worker.is_alive():
            self._session_q.put(_SENTINEL)
            running = True
        if self._completer is not None and self._completer.is_alive():
            running = True
        if not running:
            # nothing runs on the replicas any more: their tensors, graphs and
            # streams go, and the pinned pad buffers with them (a stage that
            # outlived its join keeps everything it may still touch)
            self._pool.close()
            with self._buf_lock:
                self._buf_pool.clear()
