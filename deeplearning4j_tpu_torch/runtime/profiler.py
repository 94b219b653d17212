"""Profiling and debugging hooks.

Counterpart of ``deeplearning4j_tpu/runtime/profiler.py``:

- ``OpProfiler`` / ``ProfilerConfig`` (upstream
  ``org.nd4j.linalg.profiler.OpProfiler``): section timing + NaN panic
  modes. The unit of timing is a *section* (a step, an epoch, an ETL
  stage), as in the JAX package; a step replayed from a CUDA graph has no
  per-op host hooks either.
- SameDiff ``ProfilingListener`` Chrome-trace output → ``torch.profiler``
  traces (CPU and CUDA activity, one Chrome trace file per session,
  viewable in Perfetto), exposed via :func:`trace`.
- :class:`ExchangeStats` for the distributed trainer, the registries of
  router, quantization and capacity providers (kept until serving has
  them), :func:`compile_cache_stats` and :func:`device_memory_stats`
  (``torch.cuda.memory_stats``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

# aliased: this module's own `trace` is the device-trace context
# manager; the distributed-tracing module must not shadow (or be
# shadowed by) it
from deeplearning4j_tpu_torch.runtime import trace as _dtrace


@dataclasses.dataclass
class ProfilerConfig:
    """Modes mirror the reference's enum."""

    enabled: bool = False
    check_for_nan: bool = False  # reference NAN_PANIC
    check_for_inf: bool = False  # reference INF_PANIC


class OpProfiler:
    """Section timer with aggregate stats.

    Usage::

        prof = OpProfiler()
        with prof.section("train_step"):
            state = step(state, batch)
        prof.summary()
    """

    def __init__(self, config: Optional[ProfilerConfig] = None):
        from deeplearning4j_tpu_torch.serving.metrics import LatencyHistogram
        self.config = config or ProfilerConfig(enabled=True)
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        # serving's SLO histogram doubles as the section-latency histogram:
        # one percentile implementation across training and serving
        self._hists: Dict[str, "LatencyHistogram"] = defaultdict(LatencyHistogram)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        if not self.config.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1
            self._hists[name].observe(dt)

    def timings(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self._totals[name],
                "count": self._counts[name],
                "mean_s": self._totals[name] / max(1, self._counts[name]),
                "p50_s": self._hists[name].percentile(50),
                "p99_s": self._hists[name].percentile(99),
            }
            for name in self._totals
        }

    def summary(self) -> str:
        lines = ["OpProfiler summary:"]
        for name, t in sorted(self.timings().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"  {name:30s} total={t['total_s'] * 1e3:9.2f}ms "
                f"n={t['count']:6d} mean={t['mean_s'] * 1e3:9.3f}ms"
            )
        cc = compile_cache_stats()
        if cc["compiles"] or cc["hits"] or cc["aot_compiles"]:
            lines.append(
                f"  compile cache: hits={cc['hits']} misses={cc['misses']} "
                f"corrupt={cc['corrupt_entries']} "
                f"compile={cc['compile_seconds']:.2f}s "
                f"aot={cc['aot_compiles']} "
                f"(+{cc['aot_compile_seconds']:.2f}s)")
        return "\n".join(lines)

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()
        self._hists.clear()


class ExchangeStats:
    """Per-step stage split + compression counters for the distributed
    trainer's gradient exchange: ``encode`` (threshold codec),
    ``exchange`` (the collective), ``decode`` (peer-contribution
    accumulate), ``apply`` (updater step). Reuses the serving
    :class:`~deeplearning4j_tpu_torch.serving.metrics.LatencyHistogram` — one
    percentile implementation across serving, training and distributed
    training. Attach to a
    :class:`~deeplearning4j_tpu_torch.train.profiler.TrainingProfiler` via
    ``profiler.attach_exchange(stats)`` to surface the split and the
    compression ratio on the training headline.

    Thread-safety: recorded from the worker's step loop only, but guarded
    by a lock anyway so a supervisor thread may snapshot mid-run.
    """

    STAGES = ("encode", "exchange", "decode", "apply")

    def __init__(self):
        import threading

        from deeplearning4j_tpu_torch.serving.metrics import LatencyHistogram
        # guards: _totals, _counts, _hists, _wire_bytes, _dense_bytes, _payload_bytes, _steps
        self._lock = threading.Lock()
        self._hists = {s: LatencyHistogram() for s in self.STAGES}
        self._totals = {s: 0.0 for s in self.STAGES}
        self._counts = {s: 0 for s in self.STAGES}
        self._dense_bytes = 0      # what a dense f32 exchange would move
        self._wire_bytes = 0       # what this worker actually put on the wire
        self._payload_bytes = 0    # unpadded encoded payload
        self._steps = 0

    def record(self, stage: str, seconds: float) -> None:
        _dtrace.stage_event(stage, seconds)  # onto the active train.step span
        with self._lock:
            self._totals[stage] += seconds
            self._counts[stage] += 1
            self._hists[stage].observe(seconds)

    def record_bytes(self, dense_bytes: int, wire_bytes: int,
                     payload_bytes: int) -> None:
        with self._lock:
            self._dense_bytes += int(dense_bytes)
            self._wire_bytes += int(wire_bytes)
            self._payload_bytes += int(payload_bytes)
            self._steps += 1

    @property
    def steps(self) -> int:
        with self._lock:
            return self._steps

    def report(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = {"steps": self._steps}
            for s in self.STAGES:
                n = self._counts[s]
                out[f"{s}_total_s"] = round(self._totals[s], 4)
                out[f"{s}_mean_ms"] = round(
                    self._totals[s] / n * 1e3, 3) if n else 0.0
                out[f"{s}_p99_ms"] = round(
                    self._hists[s].percentile(99) * 1e3, 3)
            steps = max(1, self._steps)
            out["comms_bytes_per_step"] = round(self._wire_bytes / steps)
            out["dense_bytes_per_step"] = round(self._dense_bytes / steps)
            out["payload_bytes_per_step"] = round(self._payload_bytes / steps)
            out["compression_ratio"] = round(
                self._dense_bytes / self._wire_bytes, 2) \
                if self._wire_bytes else 1.0
        return out

    def headline(self) -> str:
        r = self.report()
        return (f"exchange {r['exchange_mean_ms']:.2f}ms/step "
                f"(encode {r['encode_mean_ms']:.2f} decode "
                f"{r['decode_mean_ms']:.2f} apply {r['apply_mean_ms']:.2f}), "
                f"{r['comms_bytes_per_step']} B/step on the wire "
                f"({r['compression_ratio']}x vs dense)")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace (Chrome-trace analog of ``ProfilingListener``)
    with ``torch.profiler``: CPU activity, and CUDA activity when a GPU is
    present, written to ``log_dir`` as a Chrome trace when the block ends.
    View with Perfetto or ``chrome://tracing``."""
    import os
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))


def compile_cache_stats() -> Dict[str, object]:
    """Persistent-executable-cache and AOT-dispatch counters (hit/miss/
    corrupt, backend compile seconds, AOT executables minted) — the same
    numbers the serving ``/metrics`` endpoint renders; see
    :mod:`deeplearning4j_tpu_torch.runtime.compile_cache`."""
    from deeplearning4j_tpu_torch.runtime import compile_cache
    return compile_cache.stats()


_ROUTER_METRICS = None


def attach_router(metrics) -> None:
    """Register the process's live
    :class:`~deeplearning4j_tpu_torch.serving.router.RouterMetrics`
    so profiling tooling can read the fleet gauges without holding a
    router reference. Called by ``FleetRouter.start``; the newest router
    wins (one routing tier per process)."""
    global _ROUTER_METRICS
    _ROUTER_METRICS = metrics


def router_stats() -> Dict[str, object]:
    """Fleet-router gauges for the process's attached router: forwards,
    hedges launched/won/discarded-duplicates, failovers, shed skips,
    rolling deploys, and request-latency percentiles. Empty dict when no
    router is attached (the single-process serving topology)."""
    if _ROUTER_METRICS is None:
        return {}
    return _ROUTER_METRICS.snapshot()


_QUANT_METRICS: Dict[str, object] = {}


def attach_quant_metrics(name: str, metrics) -> None:
    """Register a model's :class:`~deeplearning4j_tpu_torch.serving.metrics
    .ServingMetrics` under its served name when it carries a serving dtype
    policy so profiling tooling can read the quantized-vs-f32
    latency split without holding a registry reference. Called by
    ``ModelRegistry.register`` for policy-carrying models; a hot-swap
    re-attaches the replacement's metrics (newest wins per name)."""
    _QUANT_METRICS[str(name)] = metrics


def quant_split_stats() -> Dict[str, Dict[str, object]]:
    """Per-model quantized-vs-f32 serving split for every attached
    policy-carrying model: the dtype-policy label, how much traffic rode
    the reduced-precision path, and the latency percentiles of each dtype
    class side by side — the profiler-side view of the
    ``serving_dtype_latency_seconds`` / ``serving_quantized_requests_total``
    series on ``/metrics``. Empty dict when nothing quantized is being
    served."""
    out: Dict[str, Dict[str, object]] = {}
    for name, m in list(_QUANT_METRICS.items()):
        s = m.snapshot()
        out[name] = {
            "dtype_policy": s.get("dtype_policy"),
            "requests_total": s.get("requests_total", 0),
            "quantized_requests_total": s.get("quantized_requests_total", 0),
            "quant_responses": s.get("quant_responses", 0),
            "float_responses": s.get("float_responses", 0),
            "latency_quant_p50_s": s.get("latency_quant_p50_s"),
            "latency_quant_p99_s": s.get("latency_quant_p99_s"),
            "latency_float_p50_s": s.get("latency_float_p50_s"),
            "latency_float_p99_s": s.get("latency_float_p99_s"),
        }
    return out


def detach_quant_metrics(name: str) -> None:
    """Drop a served name's attached quantized metrics (tests and graceful
    undeploy; absent names are a no-op)."""
    _QUANT_METRICS.pop(str(name), None)


_CAPACITY_PROVIDER = None


def attach_capacity(provider) -> None:
    """Register a capacity provider (a zero-arg callable returning the
    ``serving/capacity.py`` registry payload — ) so profiling
    tooling can read per-model resource accounting without holding a
    registry reference. Called by ``ModelServer.start``; the newest
    provider wins (mirrors :func:`attach_router`)."""
    global _CAPACITY_PROVIDER
    _CAPACITY_PROVIDER = provider


def detach_capacity(provider=None) -> None:
    """Drop the attached capacity provider. When ``provider`` is given,
    detach only if it is still the CURRENT one — a stopping server must
    not clobber a newer server's attachment (``ModelServer.stop`` passes
    its own provider)."""
    global _CAPACITY_PROVIDER
    if provider is None or _CAPACITY_PROVIDER is provider:
        _CAPACITY_PROVIDER = None


def capacity_stats() -> Dict[str, object]:
    """The attached registry's capacity ledger (per-model parameter /
    device bytes, replica utilization, queue headroom, compile footprint
    — the same payload ``/v1/capacity`` serves). Empty dict when no
    serving registry is attached."""
    if _CAPACITY_PROVIDER is None:
        return {}
    return _CAPACITY_PROVIDER()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-device memory statistics (``torch.cuda.memory_stats``: the
    allocator's current, peak and reserved bytes, allocation counts) for
    every visible CUDA device; feeds the crash report. Empty without a
    GPU."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[f"cuda:{i}"] = {k: int(v) for k, v in stats.items()}
    return out
