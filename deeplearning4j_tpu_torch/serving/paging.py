"""HBM-budgeted model residency: the policy side of the registry pager.

The port's copy of ``deeplearning4j_tpu/serving/paging.py`` (pure Python).
A :class:`~.registry.ModelRegistry` under a device-memory budget
(``DL4J_TPU_HBM_BUDGET_BYTES``, the constructor's ``hbm_budget_bytes``, or
the measured device budget) keeps only the most valuable models RESIDENT;
the rest stay COLD: an archive path, the warm-up manifest and this module's
per-name :class:`Residency` record (traffic EWMA, measured bytes, measured
page-in cost). A request for a cold model pages it in single-flight from
its manifest (nothing captured on live traffic) while concurrent requests
wait; one whose deadline cannot cover the wait gets
:class:`~.admission.PagingInProgress` with a ``Retry-After`` from the
measured page-in cost.

Eviction is **cost-weighted LRU**: the victim is the resident model with
the lowest retention weight ``traffic_ewma x recompile_risk / bytes``, ties
broken by ``last_used``. A pinned model (an in-flight request) is never a
victim, and a model registered from a live network (nothing to rehydrate
from) is never evictable.

The registry owns the state machine; this module owns the policy pieces:
the budget resolution, the decayed traffic estimate, the retention weight,
and the paging counters and histograms.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.serving.metrics import LatencyHistogram

logger = logging.getLogger(__name__)

__all__ = ["ENV_BUDGET", "RESIDENT", "COLD", "TrafficEWMA", "Residency",
           "PagingMetrics", "env_hbm_budget", "measured_device_budget",
           "recompile_risk", "retention_weight", "dtype_density",
           "policy_adjusted_archive_bytes"]

ENV_BUDGET = "DL4J_TPU_HBM_BUDGET_BYTES"

#: residency states (strings, not an enum — they ride JSON payloads)
RESIDENT = "resident"
COLD = "cold"


def env_hbm_budget(environ=None) -> Optional[int]:
    """The ``DL4J_TPU_HBM_BUDGET_BYTES`` knob as an int, or ``None`` when
    unset/empty/invalid (a malformed value logs and disables the budget
    rather than crashing the registry at import time)."""
    raw = (environ if environ is not None else os.environ).get(ENV_BUDGET)
    if raw is None or not str(raw).strip():
        return None
    try:
        v = int(str(raw).strip())
    except ValueError:
        logger.warning("ignoring non-integer %s=%r", ENV_BUDGET, raw)
        return None
    if v <= 0:
        logger.warning("ignoring non-positive %s=%r", ENV_BUDGET, raw)
        return None
    return v


def measured_device_budget() -> Optional[int]:
    """The measured device memory budget from the capacity ledger
    (``serving/capacity.py``), or ``None`` on backends that do not report
    one (CPU) — paging is then off unless the env knob sets an explicit
    budget."""
    try:
        from deeplearning4j_tpu_torch.serving import capacity
        return capacity.process_capacity().get("device_budget_bytes")
    except Exception:
        return None


class TrafficEWMA:
    """Exponentially decayed request mass: each :meth:`update` adds one
    request, and the mass halves every ``halflife_s`` seconds of silence
    — a relative traffic weight that forgets, so a model that was hot an
    hour ago does not outrank one that is hot now. Callers synchronize
    (the registry updates under its own lock); ``now`` is injectable so
    the eviction-policy unit tests are deterministic."""

    __slots__ = ("halflife_s", "_mass", "_t")

    def __init__(self, halflife_s: float = 60.0):
        self.halflife_s = float(halflife_s)
        self._mass = 0.0
        self._t: Optional[float] = None

    def _decay(self, now: float) -> None:
        if self._t is None:
            self._t = now
            return
        dt = now - self._t
        if dt > 0:
            self._mass *= 0.5 ** (dt / self.halflife_s)
            self._t = now

    def update(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._decay(now)
        self._mass += 1.0

    def rate(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        self._decay(now)
        return self._mass


def recompile_risk(archive_path: Optional[str]) -> float:
    """How expensive a page-in of this archive would be, as a weight in
    (0, 1]: 1.0 with no warm-up manifest (the first requests capture on
    the request path's clock), 0.5 with a manifest (the restore replays the
    recorded pairs, nothing captured on traffic), 0.25 with a manifest AND
    the build cache on (the kernels load without a rebuild). Higher risk =
    keep resident longer. The JAX package's tiers, kept as they are."""
    if archive_path is None:
        return 1.0
    from deeplearning4j_tpu_torch.serving.manifest import manifest_path
    if not os.path.exists(manifest_path(archive_path)):
        return 1.0
    try:
        from deeplearning4j_tpu_torch.runtime import compile_cache
        cached = compile_cache.cache_dir() is not None
    except Exception:
        cached = False
    return 0.25 if cached else 0.5


def retention_weight(nbytes: int, traffic: float, risk: float) -> float:
    """Cost-weighted LRU key: how much it hurts, per byte freed, to evict
    this model — ``traffic x recompile_risk / bytes``. The eviction
    victim is the resident model with the MINIMUM weight (big, idle,
    cheap-to-restore models go first); the registry breaks ties by
    ``last_used`` (plain LRU).

    ``nbytes`` must be the model's ACTUAL per-dtype device bytes: an
    int8-resident quantized
    model occupies 4x fewer device bytes than its f32 twin, so at equal
    traffic and risk its weight is 4x higher — 4x cheaper to keep
    resident, evicted last. The registry feeds measured per-dtype bytes
    for resident models (:meth:`Residency.retention`) and the
    dtype-policy-corrected estimate for cold ones
    (:func:`policy_adjusted_archive_bytes`)."""
    return (float(traffic) + 1e-9) * float(risk) / float(max(1, nbytes))


def _weight_itemsize(policy) -> int:
    """Bytes per weight element at the policy's STORAGE dtype (1 on any
    failure — the conservative, largest-inflation fallback)."""
    try:
        import numpy as np
        return max(1, int(np.dtype(getattr(policy, "weight_dtype",
                                           "int8")).itemsize))
    except Exception:
        return 1


def dtype_density(policy) -> float:
    """Device-byte density of an archive's dtype policy relative to f32,
    in (0, 1]: an ``int8``-resident policy (in-graph dequant) keeps its
    weights on device at 1 byte/param — density 0.25 — while a
    ``dequantized`` policy mints f32 device copies at load (density 1.0
    no matter how small the archive is). ``None`` (no policy: a plain
    f32 archive) is density 1.0."""
    if policy is None:
        return 1.0
    if getattr(policy, "weight_residency", "dequantized") != "int8":
        return 1.0
    return _weight_itemsize(policy) / 4.0


def policy_adjusted_archive_bytes(archive_path: str,
                                  file_bytes: int) -> int:
    """Dtype-policy-aware DEVICE-byte estimate for a cold archive: the archive's on-disk size reflects its STORAGE dtype
    (int8 payloads are ~4x smaller), but what the budget ledger must
    reserve is the RESIDENCY dtype — a ``dequantized`` policy's device
    copies are f32, so its file size underestimates the page-in cost by
    ~4x (exactly the kind of optimistic estimate that over-admits and
    busts the budget); an ``int8``-resident policy's file size is about
    right. One formula: f32-equivalent bytes (file x 4/storage-itemsize)
    scaled back down by :func:`dtype_density` — the residency rule lives
    in exactly one place. No sidecar = plain archive = file size
    stands."""
    try:
        from deeplearning4j_tpu_torch.serving.quantize import DtypePolicy
        policy = DtypePolicy.load_for_archive(archive_path)
    except Exception:
        policy = None
    if policy is None:
        return int(file_bytes)
    return int(file_bytes * (4.0 / _weight_itemsize(policy))
               * dtype_density(policy))


class Residency:
    """One name's residency record. It outlives evictions: the traffic
    EWMA, measured byte footprint and measured page-in cost carry across
    resident<->cold transitions, so the policy keeps learning while the
    model itself is unloaded."""

    __slots__ = ("name", "state", "evictable", "archive_path", "version",
                 "load_kwargs", "gate_report", "bytes", "bytes_estimated",
                 "dtype_bytes", "device_map", "last_used", "ewma",
                 "page_in_s", "page_ins", "evictions", "risk")

    def __init__(self, name: str, halflife_s: float = 60.0):
        self.name = name
        self.state = COLD
        self.evictable = False          # True once archive-backed
        #: cached :func:`recompile_risk` — refreshed when the manifest is
        #: (re)persisted, so victim selection never stats the filesystem
        #: under the registry lock
        self.risk = 1.0
        self.archive_path: Optional[str] = None
        self.version: Optional[int] = None
        self.load_kwargs: Dict[str, Any] = {}
        self.gate_report = None         # survives deploy_quantized evictions
        self.bytes = 0                  # measured (or estimated) device bytes
        self.bytes_estimated = True
        #: per-dtype breakdown of ``bytes`` when measured: the ACTUAL
        #: device dtypes — an int8-resident model
        #: shows {"int8": ...} 4x smaller than its f32 twin — feeding
        #: dtype-aware eviction scoring and the residency snapshot
        self.dtype_bytes: Dict[str, int] = {}
        #: measured per-position byte map (shard-aware, keyed by mesh
        #: position ``"<device>#<i>"``): what each position holds for this model — a plan-sliced replica
        #: charges each device only its local shards, so the per-device
        #: budget check never sees the full tree on every device
        self.device_map: Dict[str, int] = {}
        self.last_used = 0.0
        self.ewma = TrafficEWMA(halflife_s)
        self.page_in_s = 0.0            # decayed page-in cost estimate
        self.page_ins = 0
        self.evictions = 0

    def record_page_in_cost(self, seconds: float) -> None:
        """Keep a decayed estimate of what paging this model in costs —
        the denominator of the honest ``Retry-After`` hint."""
        self.page_ins += 1
        if self.page_in_s <= 0:
            self.page_in_s = float(seconds)
        else:
            self.page_in_s = 0.5 * self.page_in_s + 0.5 * float(seconds)

    def retention(self, now: Optional[float] = None) -> float:
        """This record's cost-weighted-LRU retention weight from its
        ACTUAL per-dtype device bytes (falls back to the scalar estimate
        while unmeasured) — the dtype-aware eviction score: a 4x-denser
        int8-resident model weighs 4x more per byte, so it is evicted
        last among equals."""
        now = time.monotonic() if now is None else now
        nbytes = (sum(self.dtype_bytes.values()) if self.dtype_bytes
                  else int(self.bytes or 0))
        return retention_weight(nbytes, self.ewma.rate(now), self.risk)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now is None else now
        return {
            "state": self.state,
            "bytes": int(self.bytes or 0),
            "bytes_estimated": bool(self.bytes_estimated),
            "dtype_bytes": dict(self.dtype_bytes),
            "device_map": dict(self.device_map),
            "retention_weight": self.retention(now),
            "evictable": bool(self.evictable),
            "traffic_ewma": round(self.ewma.rate(now), 4),
            "idle_s": (round(now - self.last_used, 3)
                       if self.last_used else None),
            "page_in_s": round(self.page_in_s, 4) if self.page_in_s else None,
            "page_ins": self.page_ins,
            "evictions": self.evictions,
            "version": self.version,
        }


class PagingMetrics:
    """Pager counters + histograms (thread-safe), rendered on
    ``/metrics`` via ``capacity.render_prometheus`` and shipped on
    ``/v1/capacity``'s ``residency.paging`` section so the fleet router
    can sum them."""

    def __init__(self):
        # guards: page_ins_total, evictions_total, page_in_queue_waits_total, page_in_rejections_total, page_in_failures_total, resident_hits_total, cold_hits_total, page_in_seconds, page_in_wait_seconds
        self._lock = threading.Lock()
        self.page_ins_total = 0
        self.page_in_failures_total = 0
        self.evictions_total = 0
        self.page_in_queue_waits_total = 0  # requests that waited on a flight
        self.page_in_rejections_total = 0   # deadline could not cover the wait
        self.resident_hits_total = 0
        self.cold_hits_total = 0
        self.page_in_seconds = LatencyHistogram()
        self.page_in_wait_seconds = LatencyHistogram()

    def record_page_in(self, seconds: float) -> None:
        with self._lock:
            self.page_ins_total += 1
            self.page_in_seconds.observe(seconds)

    def record_page_in_failure(self) -> None:
        with self._lock:
            self.page_in_failures_total += 1

    def record_eviction(self) -> None:
        with self._lock:
            self.evictions_total += 1

    def record_queue_wait(self, seconds: Optional[float] = None) -> None:
        with self._lock:
            self.page_in_queue_waits_total += 1
            if seconds is not None:
                self.page_in_wait_seconds.observe(seconds)

    def record_wait_seconds(self, seconds: float) -> None:
        with self._lock:
            self.page_in_wait_seconds.observe(seconds)

    def record_rejection(self) -> None:
        with self._lock:
            self.page_in_rejections_total += 1

    def record_hit(self, resident: bool) -> None:
        with self._lock:
            if resident:
                self.resident_hits_total += 1
            else:
                self.cold_hits_total += 1

    def hit_rate(self) -> float:
        """Fraction of routed requests that found their model RESIDENT
        (1.0 until the first cold hit)."""
        with self._lock:
            total = self.resident_hits_total + self.cold_hits_total
            return self.resident_hits_total / total if total else 1.0

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "page_ins_total": self.page_ins_total,
                "page_in_failures_total": self.page_in_failures_total,
                "evictions_total": self.evictions_total,
                "page_in_queue_waits_total": self.page_in_queue_waits_total,
                "page_in_rejections_total": self.page_in_rejections_total,
                "resident_hits_total": self.resident_hits_total,
                "cold_hits_total": self.cold_hits_total,
                "page_in_p50_s": self.page_in_seconds.percentile(50),
                "page_in_p99_s": self.page_in_seconds.percentile(99),
                "page_in_wait_p99_s": self.page_in_wait_seconds.percentile(99),
            }
