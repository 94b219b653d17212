"""Step-time profiler for the overlapped training pipeline.

Counterpart of ``deeplearning4j_tpu/train/profiler.py``, with the same
stages and the same :meth:`TrainingProfiler.report` keys.

``bench.py --serving`` proved the serving overlap win with measured stage
latencies; this is the training-side counterpart. A :class:`TrainingProfiler`
attached to ``fit(..., profiler=...)`` (MultiLayerNetwork, ComputationGraph,
ParallelWrapper) splits every iteration's wall time into the three pipeline
stages:

- **data wait** — time the consumer loop spent blocked waiting for the next
  coerced batch (the whole ETL+transfer cost when synchronous; the queue
  wait when a :class:`~deeplearning4j_tpu_torch.train.prefetch.DevicePrefetcher`
  hides it),
- **dispatch** — host time to issue the step (a graph replay, or an eager
  step's launches, and the grouped-dispatch bookkeeping) — CUDA launches
  return before the device finishes,
- **step** — submit→loss-ready latency, observed on the completion path
  (async loss readback, which waits on a CUDA event recorded after the
  step), where syncing is free because dispatch is not waiting on it.

``report()['data_wait_fraction']`` is the headline number: the fraction of
fit wall time the device spent starved for data. The overlap win is thereby
*observable* (sync fit shows the ETL fraction; prefetched fit shows it
collapsing toward 0), not asserted. Histograms reuse
:class:`~deeplearning4j_tpu_torch.serving.metrics.LatencyHistogram` — one
percentile implementation across training and serving.

Thread-safety: stages are recorded from the fit loop, the prefetch worker
and the completion worker concurrently; all mutation is behind one lock.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from deeplearning4j_tpu_torch.runtime import trace


class TrainingProfiler:
    """Per-iteration stage timing for ``fit``. Attach one instance per fit
    call (``net.fit(it, profiler=TrainingProfiler())``); read
    :meth:`report` after fit returns."""

    STAGES = ("data_wait", "dispatch", "step")

    def __init__(self):
        from deeplearning4j_tpu_torch.serving.metrics import LatencyHistogram
        # guards: _totals, _counts, _hists, _t_start, _t_stop
        self._lock = threading.Lock()
        self._hists = {s: LatencyHistogram() for s in self.STAGES}
        self._totals = {s: 0.0 for s in self.STAGES}
        self._counts = {s: 0 for s in self.STAGES}
        self._t_start: Optional[float] = None
        self._t_stop: Optional[float] = None
        self._exchange = None  # ExchangeStats from a DistributedTrainer

    def attach_exchange(self, stats) -> "TrainingProfiler":
        """Attach a :class:`~deeplearning4j_tpu_torch.runtime.profiler.ExchangeStats`
        (the distributed trainer does this when handed a profiler): its
        encode/exchange/decode/apply split and compression counters merge
        into :meth:`report` under ``exchange_*`` keys and onto the
        :meth:`summary` headline."""
        self._exchange = stats
        return self

    # ------------------------------------------------------------ recording
    def start(self) -> "TrainingProfiler":
        """Mark the window start (``fit`` calls this; explicit calls allow
        profiling a sub-window)."""
        with self._lock:
            if self._t_start is None:
                self._t_start = time.perf_counter()
        return self

    def stop(self) -> "TrainingProfiler":
        with self._lock:
            self._t_stop = time.perf_counter()
        return self

    def _record(self, stage: str, seconds: float) -> None:
        # stage split onto the active span, when one is open in this
        # thread — the trace-tree view of the same numbers
        trace.stage_event(stage, seconds)
        with self._lock:
            if self._t_start is None:
                self._t_start = time.perf_counter() - seconds
            self._totals[stage] += seconds
            self._counts[stage] += 1
            self._hists[stage].observe(seconds)

    def record_data_wait(self, seconds: float) -> None:
        self._record("data_wait", seconds)

    def record_dispatch(self, seconds: float) -> None:
        self._record("dispatch", seconds)

    def record_step(self, seconds: float) -> None:
        self._record("step", seconds)

    # ------------------------------------------------------------ reporting
    @property
    def iterations(self) -> int:
        with self._lock:
            return self._counts["dispatch"]

    def elapsed(self) -> float:
        with self._lock:
            if self._t_start is None:
                return 0.0
            end = self._t_stop if self._t_stop is not None else time.perf_counter()
            return max(0.0, end - self._t_start)

    def report(self) -> Dict[str, float]:
        """Aggregate stage report. ``data_wait_fraction`` is data-wait time
        over the profiled wall-clock window; ``steps_per_sec`` counts
        dispatched iterations over the same window."""
        elapsed = self.elapsed()
        with self._lock:
            out: Dict[str, float] = {
                "iterations": self._counts["dispatch"],
                "elapsed_s": round(elapsed, 4),
            }
            for s in self.STAGES:
                n = self._counts[s]
                out[f"{s}_total_s"] = round(self._totals[s], 4)
                out[f"{s}_mean_ms"] = round(
                    self._totals[s] / n * 1e3, 3) if n else 0.0
                out[f"{s}_p99_ms"] = round(
                    self._hists[s].percentile(99) * 1e3, 3)
            out["data_wait_fraction"] = round(
                self._totals["data_wait"] / elapsed, 4) if elapsed else 0.0
            out["steps_per_sec"] = round(
                self._counts["dispatch"] / elapsed, 2) if elapsed else 0.0
            # the step stage is observed on the async completion path; a
            # state-reading listener forces synchronous delivery, where it
            # is never recorded — flag that rather than report 0 as "free"
            out["step_measured"] = self._counts["step"] > 0
        if self._exchange is not None:
            out["exchange"] = self._exchange.report()
        return out

    def summary(self) -> str:
        r = self.report()
        step = (f"step {r['step_mean_ms']:.2f}ms submit->ready"
                if r["step_measured"] else
                "step unmeasured (synchronous delivery)")
        line = (f"TrainingProfiler: {r['iterations']} iterations in "
                f"{r['elapsed_s']:.2f}s ({r['steps_per_sec']:.1f} steps/s); "
                f"data wait {r['data_wait_total_s']:.2f}s "
                f"({r['data_wait_fraction']:.0%} of wall), dispatch "
                f"{r['dispatch_mean_ms']:.2f}ms/iter, {step}")
        if self._exchange is not None:
            line += "; " + self._exchange.headline()
        return line


def submit_timed(gd, args, profiler: Optional[TrainingProfiler] = None) -> None:
    """``gd.submit(args)`` with optional dispatch timing — the one submit
    wrapper shared by the three fit loops (MultiLayerNetwork,
    ComputationGraph, ParallelWrapper)."""
    if profiler is None:
        gd.submit(args)
        return
    t0 = time.perf_counter()
    gd.submit(args)
    profiler.record_dispatch(time.perf_counter() - t0)
