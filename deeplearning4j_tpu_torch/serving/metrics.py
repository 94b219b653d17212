"""SLO metrics for the serving subsystem.

The port's own copy of ``deeplearning4j_tpu/serving/metrics.py`` (pure
Python); its ``LatencyHistogram`` is the profilers' histogram.

The reference stack exposes serving health through the konduit model-server's
Prometheus endpoint; here the same signals — request latency percentiles,
QPS, queue depth, batch occupancy, rejection counts, and XLA compile counts —
are collected in-process and rendered on ``/metrics`` in Prometheus text
format. The pipelined executor adds its own observability: an
in-flight depth gauge (dispatched batches awaiting readback), per-replica
batch counts, and a dispatch-to-completion latency histogram. :class:`LatencyHistogram` is deliberately stdlib-only so
``runtime.profiler`` can reuse it for section-latency percentiles without
pulling the serving stack into the training import graph.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class LatencyHistogram:
    """Fixed log-spaced latency histogram with percentile queries.

    Buckets are geometric (factor 2) from ``lo`` seconds to ``hi`` seconds
    plus an overflow bucket, so a p99 over millions of observations costs
    O(#buckets) memory and the percentile error is bounded by one bucket
    width (the standard Prometheus-histogram trade).
    """

    def __init__(self, lo: float = 1e-4, hi: float = 64.0):
        self._bounds: List[float] = []
        b = lo
        while b <= hi:
            self._bounds.append(b)
            b *= 2.0
        self._counts = [0] * (len(self._bounds) + 1)  # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, seconds: float) -> None:
        seconds = float(seconds)
        i = 0
        for i, b in enumerate(self._bounds):
            if seconds <= b:
                break
        else:
            i = len(self._bounds)
        self._counts[i] += 1
        self.count += 1
        self.sum += seconds
        if seconds > self.max:
            self.max = seconds

    def percentile(self, p: float) -> float:
        """p in [0, 100]; returns the upper bound of the bucket holding the
        p-th observation (0.0 when empty) — a conservative (>=) estimate."""
        if self.count == 0:
            return 0.0
        rank = max(1, int(round(p / 100.0 * self.count)))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                return self._bounds[i] if i < len(self._bounds) else self.max
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    # ------------------------------------------------------ merge / wire
    def to_wire(self) -> Dict[str, object]:
        """JSON-able form carrying the raw bucket state, so a remote
        reader (the fleet router's ``/metrics`` aggregation, ) can
        :meth:`merge` histograms instead of averaging percentiles —
        percentiles of a merged histogram are exact (to bucket width),
        percentiles averaged across workers are meaningless."""
        return {"bounds": list(self._bounds), "counts": list(self._counts),
                "count": self.count, "sum": self.sum, "max": self.max}

    @classmethod
    def from_wire(cls, wire: Dict[str, object]) -> "LatencyHistogram":
        h = cls.__new__(cls)
        h._bounds = [float(b) for b in wire["bounds"]]
        h._counts = [int(c) for c in wire["counts"]]
        if len(h._counts) != len(h._bounds) + 1:
            raise ValueError("histogram wire form has mismatched "
                             f"{len(h._bounds)} bounds / "
                             f"{len(h._counts)} counts")
        h.count = int(wire["count"])
        h.sum = float(wire["sum"])
        h.max = float(wire["max"])
        return h

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Accumulate ``other``'s buckets into this histogram (in place;
        returns self). Both must share the same bucket bounds — every
        histogram built with the default ``lo``/``hi`` does."""
        if other._bounds != self._bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket bounds")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.max > self.max:
            self.max = other.max
        return self


class ServingMetrics:
    """Per-model serving counters, gauges and histograms (thread-safe)."""

    def __init__(self, queue_depth_fn: Optional[Callable[[], int]] = None,
                 compile_count_fn: Optional[Callable[[], int]] = None,
                 inflight_fn: Optional[Callable[[], int]] = None):
        # guards: requests_total, responses_total, rejected_overload, rejected_deadline, rejected_circuit, retries_total, errors_total, batches_total, rows_real_total, rows_padded_total, zero_copy_rows_total, request_latency, batch_latency, dispatch_latency, quant_latency, float_latency, quantized_requests_total, dtype_policy_label, replica_batches, warmup_seconds, _qps_slots, _qps_times, _window_started_at
        self._lock = threading.Lock()
        self.started_at = time.monotonic()
        self._window_started_at = self.started_at  # reset_window restarts it
        self.requests_total = 0          # admitted into the queue
        self.responses_total = 0         # completed successfully
        self.rejected_overload = 0
        self.rejected_deadline = 0
        self.rejected_circuit = 0        # shed by an open circuit breaker
        self.retries_total = 0           # resubmits after transient failures
        self.errors_total = 0            # model/runtime failures
        self.batches_total = 0
        self.rows_real_total = 0         # pre-padding rows executed
        self.rows_padded_total = 0       # post-padding rows executed
        # zero-copy ingest observability: rows that arrived as
        # read-only views over a binary wire frame (or shared-memory
        # segment) and were copied exactly once — into the pad buffer
        self.zero_copy_rows_total = 0
        self.request_latency = LatencyHistogram()
        self.batch_latency = LatencyHistogram()
        # quantized-serving observability: how much traffic rides
        # the reduced-precision path, and its latency split vs float
        # traffic (also surfaced by runtime.profiler.quant_split_stats)
        self.quantized_requests_total = 0
        self.dtype_policy_label: Optional[str] = None
        self.quant_latency = LatencyHistogram()
        self.float_latency = LatencyHistogram()
        # pipeline observability: time from async dispatch to
        # readback completion, and which replica served each batch
        self.dispatch_latency = LatencyHistogram()
        self.replica_batches: Dict[int, int] = {}
        # cold-start observability: build+warmup wall time of the
        # served model, stamped by the registry at register/load/hot-swap
        self.warmup_seconds = 0.0
        self._queue_depth_fn = queue_depth_fn or (lambda: 0)
        self._compile_count_fn = compile_count_fn or (lambda: 0)
        self._inflight_fn = inflight_fn or (lambda: 0)
        self._breaker = None             # CircuitBreaker, attached post-init
        # 60-slot per-second ring for windowed QPS
        self._qps_slots = [0] * 60
        self._qps_times = [0] * 60

    # ------------------------------------------------------------ recording
    def record_admitted(self, quantized: bool = False) -> None:
        with self._lock:
            self.requests_total += 1
            if quantized:
                self.quantized_requests_total += 1

    def record_zero_copy(self, rows: int) -> None:
        """Count rows ingested as zero-copy wire views."""
        with self._lock:
            self.zero_copy_rows_total += int(rows)

    def set_dtype_policy(self, label: str) -> None:
        """Attach the served model's dtype-policy label (rendered as the
        ``serving_dtype_policy`` info gauge)."""
        with self._lock:
            self.dtype_policy_label = str(label)

    def record_response(self, latency_s: float,
                        quantized: bool = False) -> None:
        with self._lock:
            self.responses_total += 1
            self.request_latency.observe(latency_s)
            (self.quant_latency if quantized
             else self.float_latency).observe(latency_s)
            now = int(time.monotonic())
            slot = now % 60
            if self._qps_times[slot] != now:
                self._qps_times[slot] = now
                self._qps_slots[slot] = 0
            self._qps_slots[slot] += 1

    def record_rejection(self, reason: str) -> None:
        with self._lock:
            if reason == "overload":
                self.rejected_overload += 1
            elif reason == "deadline":
                self.rejected_deadline += 1
            elif reason == "circuit":
                self.rejected_circuit += 1
            else:
                self.errors_total += 1

    def record_retry(self) -> None:
        with self._lock:
            self.retries_total += 1

    def set_warmup_seconds(self, seconds: float) -> None:
        """Time-to-first-ready for this served model (build + AOT warmup,
        manifest replay included) — the number ``bench.py --coldstart``
        A/Bs cold vs warm."""
        with self._lock:
            self.warmup_seconds = float(seconds)

    def attach_breaker(self, breaker) -> None:
        """Attach the model's CircuitBreaker so snapshots and the
        Prometheus rendering expose its state (gauge: 0 closed,
        1 half-open, 2 open) and open count."""
        self._breaker = breaker

    def record_batch(self, real_rows: int, padded_rows: int,
                     latency_s: float, replica: Optional[int] = None) -> None:
        with self._lock:
            self.batches_total += 1
            self.rows_real_total += int(real_rows)
            self.rows_padded_total += int(padded_rows)
            self.batch_latency.observe(latency_s)
            if replica is not None:
                self.replica_batches[int(replica)] = \
                    self.replica_batches.get(int(replica), 0) + 1

    def record_dispatch(self, latency_s: float) -> None:
        """Dispatch-to-completion: async dispatch returned -> readback done
        (device queue wait + execution + readback for one batch)."""
        with self._lock:
            self.dispatch_latency.observe(latency_s)

    def reset_window(self) -> None:
        """Start a fresh measurement window: zero the latency histograms,
        batch counters and per-replica counts. Cumulative service totals
        (requests/responses/rejections) keep counting. Benchmarks call
        this between rounds so percentiles describe ONE load window, not
        warmup plus every discarded round."""
        with self._lock:
            self.request_latency = LatencyHistogram()
            self.batch_latency = LatencyHistogram()
            self.dispatch_latency = LatencyHistogram()
            self.quant_latency = LatencyHistogram()
            self.float_latency = LatencyHistogram()
            self.replica_batches = {}
            self.batches_total = 0
            self.rows_real_total = 0
            self.rows_padded_total = 0
            self._window_started_at = time.monotonic()

    # -------------------------------------------------------------- reading
    @property                                           # holds: _lock
    def batch_occupancy(self) -> float:
        """Fraction of executed rows that were real requests (1.0 = no
        padding waste)."""
        return (self.rows_real_total / self.rows_padded_total
                if self.rows_padded_total else 0.0)

    def qps(self, window_s: int = 10) -> float:
        now = int(time.monotonic())
        with self._lock:
            n = sum(c for c, t in zip(self._qps_slots, self._qps_times)
                    if now - t < window_s)
        return n / float(window_s)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            req_lat, bat_lat = self.request_latency, self.batch_latency
            snap = {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "rejected_overload": self.rejected_overload,
                "rejected_deadline": self.rejected_deadline,
                "rejected_circuit": self.rejected_circuit,
                "retries_total": self.retries_total,
                "errors_total": self.errors_total,
                "batches_total": self.batches_total,
                "rows_real_total": self.rows_real_total,
                "rows_padded_total": self.rows_padded_total,
                "zero_copy_rows_total": self.zero_copy_rows_total,
                "batch_occupancy": round(self.batch_occupancy, 4),
                "latency_p50_s": req_lat.percentile(50),
                "latency_p99_s": req_lat.percentile(99),
                "latency_mean_s": req_lat.mean,
                "batch_latency_p50_s": bat_lat.percentile(50),
                "dispatch_p50_s": self.dispatch_latency.percentile(50),
                "dispatch_p99_s": self.dispatch_latency.percentile(99),
                "replica_batches": dict(self.replica_batches),
                "warmup_seconds": round(self.warmup_seconds, 4),
                "uptime_s": round(time.monotonic() - self.started_at, 3),
                "quantized_requests_total": self.quantized_requests_total,
                "dtype_policy": self.dtype_policy_label,
                "latency_quant_p50_s": self.quant_latency.percentile(50),
                "latency_quant_p99_s": self.quant_latency.percentile(99),
                "latency_float_p50_s": self.float_latency.percentile(50),
                "latency_float_p99_s": self.float_latency.percentile(99),
                "quant_responses": self.quant_latency.count,
                "float_responses": self.float_latency.count,
            }
        snap["qps_10s"] = self.qps(10)
        snap["queue_depth"] = int(self._queue_depth_fn())
        snap["compile_count"] = int(self._compile_count_fn())
        snap["inflight_depth"] = int(self._inflight_fn())
        if self._breaker is not None:
            b = self._breaker.snapshot()
            snap["breaker_state"] = b["state"]
            snap["breaker_opens_total"] = b["opens_total"]
            snap["breaker_failures_in_window"] = b["failures_in_window"]
        return snap

    def utilization_snapshot(self) -> Dict[str, object]:
        """The raw pieces ``serving/capacity.py`` derives replica
        busy-fractions from, captured in ONE lock acquisition so the
        parts are mutually consistent: the dispatch-to-completion
        histogram's *sum* is the pipeline's measured busy-seconds (a
        depth>1 pipeline can legitimately exceed the window — overlap
        reads as utilization > 1, i.e. queue pressure), apportioned per
        replica by batch share; ``window_s`` is the metrics window
        (since construction, or the last :meth:`reset_window`)."""
        with self._lock:
            return {
                "window_s": time.monotonic() - self._window_started_at,
                "busy_s": self.dispatch_latency.sum,
                "batches_total": self.batches_total,
                "replica_batches": dict(self.replica_batches),
                "dispatch_wire": self.dispatch_latency.to_wire(),
            }

    def wire_snapshot(self) -> Dict[str, object]:
        """Machine-readable snapshot for the fleet router's ``/metrics``
        aggregation: summable counters plus raw-bucket
        histograms (:meth:`LatencyHistogram.to_wire`) so one scrape of the
        router sees fleet-wide counts and MERGED latency percentiles.
        Ships the model's own breaker verdict too: what a
        freshly (re)started router warm-starts its passive per-worker
        breaker from, so it never re-routes traffic into a worker its
        peers already isolated."""
        breaker = (self._breaker.snapshot()
                   if self._breaker is not None else None)
        with self._lock:
            return {
                "breaker": breaker,
                "counters": {
                    "requests_total": self.requests_total,
                    "responses_total": self.responses_total,
                    "rejected_overload": self.rejected_overload,
                    "rejected_deadline": self.rejected_deadline,
                    "rejected_circuit": self.rejected_circuit,
                    "retries_total": self.retries_total,
                    "errors_total": self.errors_total,
                    "batches_total": self.batches_total,
                    "rows_real_total": self.rows_real_total,
                    "rows_padded_total": self.rows_padded_total,
                    "zero_copy_rows_total": self.zero_copy_rows_total,
                    "quantized_requests_total": self.quantized_requests_total,
                },
                "histograms": {
                    # request_latency only: it is what the router's
                    # aggregation merges; shipping the batch/dispatch
                    # histograms too would inflate every scrape for no
                    # consumer (add them here WHEN something merges them)
                    "request_latency": self.request_latency.to_wire(),
                },
            }

    def render_prometheus(self, model: str) -> str:
        s = self.snapshot()
        lbl = f'{{model="{model}"}}'
        lines = [
            f"serving_requests_total{lbl} {s['requests_total']}",
            f"serving_responses_total{lbl} {s['responses_total']}",
            f'serving_rejected_total{{model="{model}",reason="overload"}} '
            f"{s['rejected_overload']}",
            f'serving_rejected_total{{model="{model}",reason="deadline"}} '
            f"{s['rejected_deadline']}",
            f'serving_rejected_total{{model="{model}",reason="circuit_open"}} '
            f"{s['rejected_circuit']}",
            f"serving_retries_total{lbl} {s['retries_total']}",
            f"serving_errors_total{lbl} {s['errors_total']}",
            f"serving_batches_total{lbl} {s['batches_total']}",
            f"serving_batch_occupancy{lbl} {s['batch_occupancy']}",
            f"serving_zero_copy_rows_total{lbl} {s['zero_copy_rows_total']}",
            f'serving_latency_seconds{{model="{model}",quantile="0.5"}} '
            f"{s['latency_p50_s']}",
            f'serving_latency_seconds{{model="{model}",quantile="0.99"}} '
            f"{s['latency_p99_s']}",
            f"serving_qps{lbl} {s['qps_10s']}",
            f"serving_queue_depth{lbl} {s['queue_depth']}",
            f"serving_xla_compile_count{lbl} {s['compile_count']}",
            f"serving_inflight_depth{lbl} {s['inflight_depth']}",
            f'serving_dispatch_to_completion_seconds'
            f'{{model="{model}",quantile="0.5"}} {s["dispatch_p50_s"]}',
            f'serving_dispatch_to_completion_seconds'
            f'{{model="{model}",quantile="0.99"}} {s["dispatch_p99_s"]}',
            f"serving_warmup_seconds{lbl} {s['warmup_seconds']}",
        ]
        lines.append(f"serving_quantized_requests_total{lbl} "
                     f"{s['quantized_requests_total']}")
        if s["dtype_policy"] is not None:
            # info gauge: the label IS the payload, the value is always 1
            lines.append(f'serving_dtype_policy{{model="{model}",'
                         f'policy="{s["dtype_policy"]}"}} 1')
            for cls, p50, p99 in (
                    ("quantized", s["latency_quant_p50_s"],
                     s["latency_quant_p99_s"]),
                    ("float", s["latency_float_p50_s"],
                     s["latency_float_p99_s"])):
                lines.append(f'serving_dtype_latency_seconds'
                             f'{{model="{model}",class="{cls}",'
                             f'quantile="0.5"}} {p50}')
                lines.append(f'serving_dtype_latency_seconds'
                             f'{{model="{model}",class="{cls}",'
                             f'quantile="0.99"}} {p99}')
        for idx in sorted(s["replica_batches"]):
            lines.append(
                f'serving_replica_batches_total'
                f'{{model="{model}",replica="{idx}"}} '
                f"{s['replica_batches'][idx]}")
        if "breaker_state" in s:
            state_gauge = {"CLOSED": 0, "HALF_OPEN": 1, "OPEN": 2}.get(
                s["breaker_state"], -1)
            lines.append(f"serving_breaker_state{lbl} {state_gauge}")
            lines.append(f"serving_breaker_opens_total{lbl} "
                         f"{s['breaker_opens_total']}")
        return "\n".join(lines) + "\n"
