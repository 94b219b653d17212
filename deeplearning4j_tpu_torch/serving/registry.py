"""Named/versioned model registry with hot-swap, warmup, failure
containment, HBM-budgeted paging and accuracy-gated quantized deploys.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``. Models are
registered under a name (from a live ``MultiLayerNetwork``/
``ComputationGraph``, a ``ModelSerializer`` archive, or a zoo class); each
gets its own :class:`~.batcher.ContinuousBatcher` +
:class:`~.metrics.ServingMetrics` + a per-model
:class:`~.resilience.CircuitBreaker` and :class:`~.resilience.RetryPolicy`,
and ``predict(name, x)`` routes traffic. Re-registering a name hot-swaps:
the replacement is built and warmed (its graphs captured) *before* the swap,
then the old batcher drains — in-flight and already-queued requests complete
against the old version, new traffic hits the new one, and nothing is
captured on the serving path during the cut-over.

Cold start: archive loads replay the :class:`~.manifest.WarmupManifest`
recorded next to the archive (and hot-swaps inherit the live entry's
manifest), so a restart pre-warms every (bucket, replica) pair the previous
process served. Manifests are refreshed at graceful undeploy/shutdown and
eviction to capture traffic-minted buckets.

Failure semantics:

- **Hot-swap rollback**: an exception during the replacement's build or
  warmup propagates to the caller but leaves the OLD entry serving.
- **Retry**: a transient batcher failure is retried with exponential
  backoff + full jitter, up to ``retry.max_attempts``. Explicit admission
  rejections (``Overloaded`` / ``DeadlineExceeded`` / ``ServingShutdown``)
  are never retried.
- **Circuit breaking**: repeated model failures open the per-model breaker;
  while open, ``predict`` sheds instantly with :class:`CircuitOpen`; after
  the reset timeout one probe request decides whether to close it again.
- **Health**: every served model exposes a
  :class:`~.resilience.HealthState` (STARTING during build/warmup, READY,
  DEGRADED while the breaker is not closed, DRAINING during undeploy).

HBM-budgeted paging: under a budget (``DL4J_TPU_HBM_BUDGET_BYTES``, the
constructor's ``hbm_budget_bytes``, or the measured device budget: the
card's total memory) the registry keeps only part of its catalogue
RESIDENT. Archive-backed entries page out to COLD under cost-weighted-LRU
eviction (``paging.py``; the manifest is refreshed first, so the page-in
replays every traffic-minted bucket) and page back in on demand:
:meth:`acquire` resolves a name to a PINNED resident entry, rehydrating a
cold one single-flight (N concurrent requests, one load; the rest wait, and
the leader does not hold the registry lock across the capture). A request
whose deadline cannot cover the wait gets
:class:`~.admission.PagingInProgress` with a ``Retry-After`` from the
measured page-in cost. Pins make eviction in-flight-safe. Room is
*reserved* before a load mints its device copies, so the ledger
(``resident_bytes()``) never exceeds the budget, and the budget is held per
mesh position (``capacity.py``).

The ledger (``ServedModel.device_bytes``, from ``capacity.py``) counts
every distinct storage the entry holds: the replicas' copies and, for an
entry the registry restored from an archive, the restored model's own
tensors on the card. An eviction drops all of them: the replicas' tensors,
graphs, graph memory pools and streams (``ReplicaPool.close``), the pinned
pad buffers, and the restored model.

Quantized deploys (:meth:`deploy_quantized`): the accuracy gate runs after
the candidate's batcher is built and warmed and before the hot-swap, on
both sides' serving paths; a failure leaves the f32 version serving.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.runtime import chaos, journal, trace
from deeplearning4j_tpu_torch.serving import paging
from deeplearning4j_tpu_torch.serving.admission import (
    HBMBudgetExceeded,
    PagingInProgress,
    ServingError,
    page_in_retry_after_ms,
)
from deeplearning4j_tpu_torch.serving.batcher import ArrayOrDict, ContinuousBatcher
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker,
    CircuitOpen,
    CircuitState,
    HealthState,
    RetryPolicy,
)

logger = logging.getLogger(__name__)


class ServedModel:
    """One registered (name, version) with its batcher, metrics, breaker,
    retry policy, and health state."""

    def __init__(self, name: str, version: int, model,
                 batcher: ContinuousBatcher,
                 breaker: Optional[CircuitBreaker] = None,
                 retry: Optional[RetryPolicy] = None):
        self.name = name
        self.version = int(version)
        self.model = model
        self.batcher = batcher
        self.breaker = breaker or CircuitBreaker()
        # journal events from this breaker name the model
        self.breaker.journal_scope = f"model:{name}"
        self.retry = retry or RetryPolicy()
        self.loaded_at = time.time()
        self.archive_path: Optional[str] = None  # set by ModelRegistry.load
        self.gate_report: Optional[Dict[str, Any]] = None  # deploy_quantized
        self.device_bytes = 0  # the ledger's bytes (capacity.served_device_bytes)
        # restored by the registry from an archive: its own tensors are the
        # entry's, counted in the ledger and freed by an eviction
        self.owns_model = False
        self._draining = False
        self._started = False  # flipped by the registry after the swap
        self._pins = 0         # in-flight requests holding this entry
        self._pin_lock = threading.Lock()  # guards: _pins
        self.batcher.metrics.attach_breaker(self.breaker)

    # ------------------------------------------------------------- pinning
    # In-flight-safe eviction: the registry pins an entry for each request
    # it routes (acquire() under the registry lock), and the pager evicts
    # only entries with zero pins.
    def pin(self) -> None:
        with self._pin_lock:
            self._pins += 1

    def unpin(self) -> None:
        with self._pin_lock:
            self._pins -= 1

    @property
    def pins(self) -> int:
        with self._pin_lock:
            return self._pins

    @property
    def metrics(self):
        return self.batcher.metrics

    @property
    def health(self) -> HealthState:
        if self._draining:
            return HealthState.DRAINING
        if not self._started:
            return HealthState.STARTING
        if self.breaker.state is not CircuitState.CLOSED:
            return HealthState.DEGRADED
        return HealthState.READY

    def predict(self, x: ArrayOrDict, timeout_ms: Optional[float] = None):
        """One request through the batcher, wrapped in the breaker and the
        retry policy. Raises :class:`CircuitOpen` when the breaker sheds,
        admission errors unretried, or the last model error after the retry
        budget is spent. Each attempt gets a fresh deadline."""
        last_err: Optional[BaseException] = None
        for attempt in range(self.retry.max_attempts):
            if not self.breaker.allow():
                self.metrics.record_rejection("circuit")
                raise CircuitOpen(
                    f"model {self.name!r} circuit is "
                    f"{self.breaker.state.name}; shedding request") from last_err
            try:
                out = self.batcher.submit(x, timeout_ms=timeout_ms)
            except ServingError:
                # explicit admission/drain rejection: not a model fault —
                # does not trip the breaker, is not retried, and returns a
                # half-open probe slot it may have consumed
                self.breaker.record_discard()
                raise
            except BaseException as e:
                # one key per faulted batch: N coalesced requests sharing a
                # fault count once
                self.breaker.record_failure(key=getattr(e, "_serving_failure_key", None))
                last_err = e
                if attempt + 1 < self.retry.max_attempts:
                    self.metrics.record_retry()
                    self.retry.sleep_before_retry(attempt)
                continue
            self.breaker.record_success()
            return out
        raise last_err

    def describe(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "residency": paging.RESIDENT,
            "version": self.version,
            "model_type": type(self.model).__name__,
            "buckets": list(self.batcher.buckets),
            "max_batch_size": self.batcher.max_batch_size,
            "replicas": self.batcher.replica_count,
            "pipeline_depth": self.batcher.pipeline_depth,
            "loaded_at": self.loaded_at,
            "health": self.health.value,
            "breaker": self.breaker.snapshot(),
            "metrics": self.metrics.snapshot(),
        }


class _PageFlight:
    """Single-flight coordination for one cold model's page-in: the first
    requester (the leader) loads; every concurrent requester waits on the
    event. Exactly one rehydration per cold miss."""

    __slots__ = ("event", "error", "started_at")

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.started_at = time.monotonic()


class ModelRegistry:
    """Thread-safe registry of served models.

    ``hbm_budget_bytes`` caps the ledger's device bytes of RESIDENT models
    (default: ``DL4J_TPU_HBM_BUDGET_BYTES``, else the measured device
    budget where the backend reports one, else unbounded: paging off)."""

    def __init__(self, hbm_budget_bytes: Optional[int] = None):
        # guards: _models, _residency, _reserved, _reserved_maps
        self._lock = threading.Lock()
        self._models: Dict[str, ServedModel] = {}
        self._explicit_budget = hbm_budget_bytes
        self._budget_resolved = False
        self._budget: Optional[int] = None
        self._residency: Dict[str, paging.Residency] = {}
        self._reserved: Dict[str, int] = {}  # in-build byte reservations
        # per-position reservation maps: the shard-aware twin of _reserved
        self._reserved_maps: Dict[str, Dict[str, int]] = {}
        self._flights: Dict[str, _PageFlight] = {}
        self._flight_lock = threading.Lock()  # guards: _flights
        self.paging = paging.PagingMetrics()

    # ----------------------------------------------------------- HBM budget
    @property
    def hbm_budget_bytes(self) -> Optional[int]:
        """The resident-byte ceiling, resolved once: the constructor's
        value, else ``DL4J_TPU_HBM_BUDGET_BYTES``, else the measured device
        budget, else ``None`` (paging off; cold registration still works)."""
        if not self._budget_resolved:
            b = self._explicit_budget
            if b is None:
                b = paging.env_hbm_budget()
            if b is None:
                b = paging.measured_device_budget()
            self._budget = int(b) if b else None
            self._budget_resolved = True
        return self._budget

    def resident_bytes(self) -> int:
        """The ledger's bytes of RESIDENT models, reservations for in-build
        loads included (a sample taken mid-page-in never exceeds the
        budget)."""
        with self._lock:
            return self._resident_bytes_locked()

    def _resident_bytes_locked(self, exclude: str = "") -> int:  # holds: _lock
        total = sum(int(r.bytes or 0) for n, r in self._residency.items()
                    if r.state == paging.RESIDENT and n != exclude)
        return total + sum(v for n, v in self._reserved.items() if n != exclude)

    # ----------------------------------------------------------- register
    def register(self, name: str, model, version: Optional[int] = None,
                 warmup_example: Optional[ArrayOrDict] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 retry: Optional[RetryPolicy] = None,
                 manifest=None, _archive_info=None, _gate=None,
                 **batcher_kw) -> ServedModel:
        """Serve ``model`` under ``name``. Re-registering an existing name
        hot-swaps (version auto-bumps unless given); the new batcher is
        warmed before it takes traffic and the old one drains — queued
        requests are served AND every dispatched batch reads back against
        the old version before its pipeline stops. A failure during the
        replacement's build/warmup leaves the old entry serving (rollback).
        ``batcher_kw`` forwards to :class:`ContinuousBatcher`
        (``max_batch_size``, ``batch_timeout_ms``, ``queue_limit``,
        ``buckets``, ``admission``, ``replicas``, ``pipeline_depth``,
        ``devices``, ``dtype_policy``, ``plan``).

        ``manifest`` takes a :class:`~.manifest.WarmupManifest` to REPLAY:
        the batcher is built with the recorded buckets/replicas and warmed
        from the recorded input signature. A hot-swap with no explicit
        ``manifest``/``warmup_example`` inherits the replaced entry's
        manifest. Explicit ``batcher_kw`` always wins over manifest-recorded
        values. Room is reserved under the HBM budget before the replicas
        are minted (evicting cost-weighted-LRU victims as needed)."""
        chaos.inject("serving.registry.register")
        if getattr(model, "_params", 1) is None:
            model._ensure_init()
        # a quantized model's embedded dtype policy is authoritative
        if "dtype_policy" not in batcher_kw:
            pol = getattr(model, "dtype_policy", None)
            if pol is not None:
                batcher_kw["dtype_policy"] = pol
        with self._lock:
            prev_entry = self._models.get(name)
        if manifest is None and warmup_example is None and prev_entry is not None:
            # hot-swap replay: warm the replacement with everything the live
            # entry is serving (incl. traffic-minted buckets)
            manifest = prev_entry.batcher.warmup_manifest()
        if manifest is not None:
            if warmup_example is None:
                warmup_example = manifest.example()
            batcher_kw.setdefault("buckets", list(manifest.buckets))
            batcher_kw.setdefault("replicas", manifest.replicas)
            batcher_kw.setdefault("max_batch_size",
                                  manifest.max_batch_size or max(manifest.buckets))
        owns = _archive_info is not None
        est = self._estimate_device_bytes(model, batcher_kw, manifest, owns)
        est_map = self._estimate_per_device(model, batcher_kw, manifest, owns)
        self._reserve_room(name, est, est_map=est_map)
        # stat the manifest outside the lock: victim selection never touches
        # the filesystem
        risk = paging.recompile_risk(_archive_info[0]) if owns else 1.0
        # Build + warm OUTSIDE the lock and BEFORE the swap: if this raises
        # nothing has been swapped — the previous version keeps serving.
        t0 = time.monotonic()
        batcher = None
        try:
            batcher = ContinuousBatcher(model, warmup_example=warmup_example, **batcher_kw)
            report = _gate(batcher) if _gate is not None else None
        except BaseException:
            with self._lock:
                self._reserved.pop(name, None)
                self._reserved_maps.pop(name, None)
            if batcher is not None:
                batcher.shutdown(drain=False)
            logger.warning("register(%r): replacement build/warmup/gate failed; previous "
                           "version (if any) keeps serving", name)
            raise
        served = ServedModel(name, 0, model, batcher, breaker=breaker, retry=retry)
        served.owns_model = owns
        served.gate_report = report
        served.metrics.set_warmup_seconds(time.monotonic() - t0)
        from deeplearning4j_tpu_torch.serving import capacity
        try:
            dtype_bytes = capacity.served_device_dtype_bytes(served)
            served.device_bytes = sum(dtype_bytes.values())
            device_map = capacity.served_per_device_bytes(served)
        except Exception:
            logger.exception("register(%r): device accounting failed; the ledger keeps "
                             "the estimate", name)
            dtype_bytes, device_map = {}, dict(est_map)
            served.device_bytes = est
        with self._lock:
            self._reserved.pop(name, None)
            self._reserved_maps.pop(name, None)
            prev = self._models.get(name)
            if version is None:
                version = prev.version + 1 if prev else 1
            served.version = int(version)
            self._models[name] = served
            served._started = True  # STARTING -> READY at the swap point
            res = self._residency.get(name)
            if res is None:
                res = paging.Residency(name)
                self._residency[name] = res
            res.state = paging.RESIDENT
            res.bytes = int(served.device_bytes)
            res.bytes_estimated = False
            res.dtype_bytes = dict(dtype_bytes)
            res.device_map = dict(device_map)
            res.version = served.version
            res.last_used = time.monotonic()
            if owns:
                # the rehydration recipe, recorded atomically with the swap
                res.evictable = True
                res.archive_path = _archive_info[0]
                res.load_kwargs = dict(_archive_info[1])
                res.risk = risk
            else:
                # a live-net register has nothing to rehydrate from
                res.evictable = False
                res.archive_path = None
        if prev is not None:
            journal.emit("registry.hot_swap", model=name, old_version=prev.version,
                         new_version=served.version, device_bytes=served.device_bytes)
        from deeplearning4j_tpu_torch.runtime import profiler
        if batcher.dtype_policy is not None:
            profiler.attach_quant_metrics(name, served.metrics)
        else:
            # a plain model replacing a quantized one must not leave the old
            # split (and its batcher) attached
            profiler.detach_quant_metrics(name)
        if prev is not None:
            prev._draining = True
            try:
                prev.batcher.shutdown(drain=True)
            except Exception:
                logger.exception("register(%r): drain of replaced v%d failed (new "
                                 "version is serving)", name, prev.version)
        return served

    def load(self, name: str, path: str, load_updater: bool = False,
             replay_manifest: bool = True, save_manifest: bool = True,
             resident: bool = True, device=None, **kw) -> Optional[ServedModel]:
        """Register from a ``ModelSerializer`` archive (MultiLayerNetwork,
        ComputationGraph or a quantized archive — the archive dispatches the
        type), restored on ``device`` (``cuda`` unless the caller or the
        environment asks for the CPU).

        When a warmup manifest exists next to the archive
        (``<path>.warmup.json``, written by either package) it is replayed,
        so the model reaches READY without capturing on live traffic. After
        warmup the up-to-date manifest is written back (best effort).
        ``replay_manifest=False`` forces the cold path; ``save_manifest=False``
        skips the write-back.

        ``resident=False`` registers the archive COLD without restoring it:
        no device bytes until the first request (or :meth:`page_in`)
        rehydrates it. Returns ``None`` in that case."""
        load_kwargs = {k: v for k, v in kw.items() if k not in ("manifest", "version")}
        load_kwargs.update(load_updater=load_updater, replay_manifest=replay_manifest,
                           save_manifest=save_manifest, device=device)
        if not resident:
            self.register_cold(name, path, version=kw.get("version"), **load_kwargs)
            return None
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        from deeplearning4j_tpu_torch.serving.manifest import WarmupManifest
        model = ModelSerializer.restore_model(path, device=device, load_updater=load_updater)
        manifest = kw.pop("manifest", None)
        if manifest is None and replay_manifest:
            manifest = WarmupManifest.load_for_archive(path)
        served = self.register(name, model, manifest=manifest,
                               _archive_info=(path, load_kwargs), **kw)
        served.archive_path = path if save_manifest else None
        if save_manifest:
            self.save_manifest(name)
        return served

    def register_cold(self, name: str, path: str, version: Optional[int] = None,
                      **load_kwargs) -> "paging.Residency":
        """Register ``name`` COLD, archive-backed, WITHOUT loading it: no
        restore, no warmup, no device bytes. The byte cost is estimated from
        the warmup manifest's recorded ``device_bytes`` when the archive was
        served before, else from the archive's size under its dtype policy;
        the first :meth:`acquire` (or :meth:`page_in`) rehydrates with
        ``load_kwargs`` forwarded to :meth:`load`. Raises ``ValueError`` when
        ``name`` is resident."""
        from deeplearning4j_tpu_torch.serving.manifest import WarmupManifest
        m = WarmupManifest.load_for_archive(path)
        est = int(m.device_bytes) if m is not None and m.device_bytes else 0
        if est <= 0:
            try:
                est = paging.policy_adjusted_archive_bytes(path, os.path.getsize(path))
            except OSError:
                est = 0
        load_kwargs.pop("version", None)
        risk = paging.recompile_risk(path)  # stat outside the lock
        with self._lock:
            if name in self._models:
                raise ValueError(f"{name!r} is already resident; evict() or undeploy() "
                                 f"before re-registering it cold")
            res = self._residency.get(name)
            if res is None:
                res = paging.Residency(name)
                self._residency[name] = res
            res.state = paging.COLD
            res.evictable = True
            res.archive_path = path
            res.load_kwargs = dict(load_kwargs)
            res.risk = risk
            res.bytes = int(est)
            res.bytes_estimated = True
            if version is not None:
                res.version = int(version)
            if m is not None and m.page_in_s and res.page_in_s <= 0:
                res.page_in_s = float(m.page_in_s)
        return res

    def deploy_quantized(self, name: str, path: str, eval_inputs, eval_labels=None,
                         golden=None, gate=None, **kw) -> ServedModel:
        """Accuracy-gated deploy of a quantized archive over the serving f32
        version of ``name``.

        The candidate's batcher is built and warmed, then the gate evaluates
        ``eval_inputs`` on both sides' serving paths (``ContinuousBatcher
        .evaluate``: the captured graphs at the warmed buckets, outside the
        queue and the metrics) — the golden (default: the serving entry)
        through its replicas, the candidate through its own with the rows
        quantized per its policy — with the threshold
        declared in the archive's dtype policy (override via ``gate``). All
        of that before the hot-swap: a failed gate raises
        :class:`~.quantize.AccuracyGateFailed` with the report attached, the
        candidate's batcher is shut down, and the old version keeps serving.
        On success the candidate hot-swaps in as the next version and the
        report stays on ``served.gate_report``."""
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        from deeplearning4j_tpu_torch.serving.quantize import (AccuracyGate, QuantizedModel,
                                                               quantize_requests)
        chaos.inject("serving.registry.deploy_quantized")
        device = kw.pop("device", None)
        model = ModelSerializer.restore_model(path, device=device, load_updater=False)
        if not isinstance(model, QuantizedModel):
            raise ValueError(f"{path!r} is not a quantized archive; use load() for "
                             f"plain archives")
        if golden is None:
            live = self.get(name)
            golden_fn = live.batcher.evaluate
        else:
            golden_fn = None
        gate = gate or AccuracyGate.from_policy(model.dtype_policy)

        def run_gate(batcher):
            return gate.check(golden, model, eval_inputs, labels=eval_labels,
                              golden_fn=golden_fn,
                              candidate_fn=lambda x: batcher.evaluate(
                                  quantize_requests(x, model.dtype_policy)))

        # a page-in of this archive does not re-run the gate (it passed):
        # plain load() is the rehydration recipe, and the gate report
        # survives evictions on the residency record
        lkw = {k: v for k, v in kw.items() if k not in ("manifest", "version")}
        lkw["device"] = device
        served = self.register(name, model, _archive_info=(path, lkw), _gate=run_gate, **kw)
        served.archive_path = path
        with self._lock:
            res = self._residency.get(name)
            if res is not None:
                res.gate_report = served.gate_report
        self.save_manifest(name)
        return served

    def save_manifest(self, name: str, archive_path: Optional[str] = None) -> Optional[str]:
        """Persist ``name``'s CURRENT warmup manifest next to its archive (or
        ``archive_path``), capturing buckets minted under live traffic since
        load. Called automatically at load, eviction, graceful undeploy and
        shutdown. Best effort. Returns the manifest path, or ``None`` when
        there is nothing to record or nowhere to put it."""
        return self._persist_manifest(self.get(name), archive_path)

    def register_zoo(self, name: str, zoo_model, device=None, **kw) -> ServedModel:
        """Register a zoo entry: either an already-constructed ``ZooModel``
        instance or a zoo class name string looked up in
        ``deeplearning4j_tpu_torch.zoo``."""
        if isinstance(zoo_model, str):
            import deeplearning4j_tpu_torch.zoo as zoo
            zoo_model = getattr(zoo, zoo_model)()
        return self.register(name, zoo_model.init(device=device), **kw)

    # ------------------------------------------------------------ routing
    def get(self, name: str) -> ServedModel:
        """The RESIDENT entry for ``name`` (introspection; the request path
        uses :meth:`acquire`, which also pages in and pins). Raises
        ``KeyError`` for unknown and for cold names — the message says
        which."""
        with self._lock:
            served = self._models.get(name)
            have = sorted(self._models)
            cold = name in self._residency and self._residency[name].state == paging.COLD
        if served is None:
            if cold:
                raise KeyError(f"no model registered under {name!r} (it is COLD — "
                               f"acquire()/page_in() rehydrates it); resident: {have}")
            raise KeyError(f"no model registered under {name!r}; have {have}")
        return served

    def acquire(self, name: str, timeout_ms: Optional[float] = None) -> ServedModel:
        """Resolve ``name`` to a PINNED resident entry, paging it in from its
        archive when COLD. The caller MUST ``unpin()`` the returned entry
        when its request finishes. Concurrent cold requests single-flight:
        one rehydration, everyone else waits (up to ``timeout_ms``; a
        deadline that cannot cover the wait raises
        :class:`PagingInProgress`). Raises ``KeyError`` for names that are
        neither resident nor cold-registered."""
        deadline = None if timeout_ms is None else time.monotonic() + float(timeout_ms) / 1e3
        cold_hit = False
        while True:
            with self._lock:
                served = self._models.get(name)
                res = self._residency.get(name)
                if served is not None:
                    served.pin()
                    if res is not None and not cold_hit:
                        # touch once per request: a cold hit touched below
                        now = time.monotonic()
                        res.ewma.update(now)
                        res.last_used = now
                    self.paging.record_hit(resident=not cold_hit)
                    return served
                if res is None or res.archive_path is None:
                    have = sorted(self._models)
                    raise KeyError(f"no model registered under {name!r}; have {have}")
                if not cold_hit:
                    now = time.monotonic()
                    res.ewma.update(now)
                    res.last_used = now
            cold_hit = True
            self._page_in(name, deadline)

    def predict(self, name: str, x: ArrayOrDict, timeout_ms: Optional[float] = None):
        """Route one request through ``name``'s served model (breaker +
        retry + batcher), paging a cold model in first. Raises ``KeyError``
        for unknown names, ``Overloaded``/``DeadlineExceeded``/
        ``PagingInProgress`` under pressure, ``CircuitOpen`` while the
        breaker sheds — never hangs on a registered model. The deadline is
        spent once: the time waited on a page-in is taken from what the
        batcher sees."""
        deadline = None if timeout_ms is None else time.monotonic() + float(timeout_ms) / 1e3
        served = self.acquire(name, timeout_ms=timeout_ms)
        try:
            remaining = (None if deadline is None
                         else max(0.0, (deadline - time.monotonic()) * 1e3))
            return served.predict(x, timeout_ms=remaining)
        finally:
            served.unpin()

    # --------------------------------------------------------------- paging
    def page_in(self, name: str, timeout_ms: Optional[float] = None) -> ServedModel:
        """Rehydrate a cold model (no-op when resident). Blocks until
        resident; single-flight with any request-triggered page-in."""
        deadline = None if timeout_ms is None else time.monotonic() + float(timeout_ms) / 1e3
        while True:
            with self._lock:
                served = self._models.get(name)
                if served is not None:
                    return served
                if name not in self._residency or self._residency[name].archive_path is None:
                    raise KeyError(f"no archive-backed model registered under {name!r}")
            self._page_in(name, deadline)

    def _page_in(self, name: str, deadline: Optional[float]) -> None:
        """Single-flight page-in: the first caller (leader) rehydrates;
        concurrent callers wait on its flight. Neither holds the registry
        lock across the load."""
        with self._flight_lock:
            fl = self._flights.get(name)
            leader = fl is None
            if leader:
                fl = _PageFlight()
                self._flights[name] = fl
        if leader:
            t0 = time.monotonic()
            try:
                loaded = self._rehydrate(name)
            except BaseException as e:
                fl.error = e
                self.paging.record_page_in_failure()
                raise
            finally:
                with self._flight_lock:
                    self._flights.pop(name, None)
                fl.event.set()
            if not loaded:
                return  # raced: someone else made it resident
            seconds = time.monotonic() - t0
            self.paging.record_page_in(seconds)
            with self._lock:
                res = self._residency.get(name)
                if res is not None:
                    res.record_page_in_cost(seconds)
                bytes_in = int(res.bytes) if res is not None else None
            journal.emit("registry.page_in", model=name, seconds=round(seconds, 4),
                         bytes=bytes_in)
            return
        # follower: wait in the page-in queue, bounded by the request's own
        # deadline; the rejection hint is the measured page-in cost less
        # what the flight already spent
        t0 = time.monotonic()
        remaining = None if deadline is None else deadline - t0
        sp = trace.current_span()
        if remaining is not None and remaining <= 0:
            self.paging.record_rejection()
            raise PagingInProgress(
                f"model {name!r} is paging in and the request deadline has already expired",
                retry_after_ms=self._page_in_hint_ms(name, fl))
        ok = fl.event.wait(remaining)
        waited = time.monotonic() - t0
        self.paging.record_queue_wait(waited)
        if sp is not None and sp.recording:
            sp.event("page_in_wait", model=name, waited_ms=round(waited * 1e3, 2),
                     completed=ok)
        if not ok:
            self.paging.record_rejection()
            raise PagingInProgress(
                f"model {name!r} is still paging in after a {waited * 1e3:.0f} ms wait; "
                f"deadline too short to keep waiting",
                retry_after_ms=self._page_in_hint_ms(name, fl))
        if fl.error is not None:
            raise RuntimeError(f"page-in of {name!r} failed") from fl.error

    def _page_in_hint_ms(self, name: str, fl: _PageFlight) -> float:
        """``Retry-After`` for a rejected page-in waiter: the measured
        page-in cost (1 s before the first measurement) less the flight's
        elapsed time, floored."""
        with self._lock:
            res = self._residency.get(name)
            est_ms = (res.page_in_s * 1000.0
                      if res is not None and res.page_in_s > 0 else 1000.0)
        elapsed_ms = (time.monotonic() - fl.started_at) * 1000.0
        return page_in_retry_after_ms(est_ms, elapsed_ms)

    def _rehydrate(self, name: str) -> bool:
        """The leader's load: the archive and its warmup manifest through
        :meth:`load` (room is reserved and victims evicted inside
        :meth:`register`), traced as a ``registry.page_in`` span. ``False``
        when the model turned out to be resident already."""
        chaos.inject("serving.registry.page_in")
        with self._lock:
            res = self._residency.get(name)
            if res is None or res.archive_path is None:
                raise KeyError(f"no archive-backed model registered under {name!r}")
            if name in self._models:
                return False  # raced: already resident
            path = res.archive_path
            version = res.version
            kwargs = dict(res.load_kwargs)
            gate_report = res.gate_report
        cur = trace.current_span()
        if cur is not None and cur.recording:
            sp = cur.child("registry.page_in")
        elif trace.enabled():
            sp = trace.server_span("registry.page_in")
        else:
            sp = trace.NOOP
        with sp:
            if sp.recording:
                sp.flag("page_in")
                sp.set("model", name)
            served = self.load(name, path, version=version, **kwargs)
            served.gate_report = gate_report
            if sp.recording:
                sp.set("bytes", served.device_bytes)
                sp.set("version", served.version)
        return True

    def evict(self, name: str) -> bool:
        """Page ``name`` out to COLD: drain its batcher, refresh its warmup
        manifest (traffic-minted buckets included) and drop what it holds on
        the device. ``False`` — touching nothing — when it cannot now: not
        resident, not archive-backed, or pinned by in-flight requests."""
        with self._lock:
            served = self._models.get(name)
            res = self._residency.get(name)
            if served is None or res is None or not res.evictable:
                return False
            if served.pins > 0:
                return False
            del self._models[name]
            res.state = paging.COLD
            res.bytes = int(served.device_bytes) or res.bytes
            res.bytes_estimated = False
            res.evictions += 1
            res.gate_report = served.gate_report or res.gate_report
        cur = trace.current_span()
        if cur is not None and cur.recording:
            sp = cur.child("registry.evict")
        elif trace.enabled():
            sp = trace.server_span("registry.evict")
        else:
            sp = trace.NOOP
        with sp:
            if sp.recording:
                sp.flag("evict")
                sp.set("model", name)
                sp.set("bytes", served.device_bytes)
            journal.emit("registry.evict", model=name, bytes=int(served.device_bytes or 0))
            served._draining = True
            try:
                served.batcher.shutdown(drain=True)
            except Exception:
                logger.exception("evict(%r): drain failed; the device copies are "
                                 "dropped regardless", name)
            # AFTER the drain: a queued oversized request may mint a bucket
            # while draining, and the page-in must replay it
            self._persist_manifest(served)
        from deeplearning4j_tpu_torch.runtime import profiler
        profiler.detach_quant_metrics(name)
        self.paging.record_eviction()
        logger.info("evicted %r to cold (%d bytes freed)", name, served.device_bytes)
        return True

    def _entry_bytes(self, model, owns: bool):
        """``(bytes of one replica at the compute dtype, bytes of the
        model's own tensors the ledger counts)``."""
        import torch

        from deeplearning4j_tpu_torch.runtime.environment import get_environment
        from deeplearning4j_tpu_torch.runtime.trees import tree_leaves
        item = torch.empty((), dtype=get_environment().compute_dtype).element_size()
        params = [t for t in tree_leaves(getattr(model, "_params", None))
                  if isinstance(t, torch.Tensor)]
        state = [t for t in tree_leaves(getattr(model, "_model_state", None))
                 if isinstance(t, torch.Tensor)]
        # the replicas cast floating parameters to the compute dtype, and
        # copy the layer state as it is
        rep = sum(t.numel() * (item if t.is_floating_point() else t.element_size())
                  for t in params)
        rep += sum(t.numel() * t.element_size() for t in state)
        own = sum(t.numel() * t.element_size() for t in params + state
                  if owns and t.is_cuda)
        return rep, own

    def _serving_devices(self, model, batcher_kw: Dict[str, Any]):
        import torch

        from deeplearning4j_tpu_torch.serving.replica import _visible_devices
        devs = batcher_kw.get("devices")
        return [torch.device(d) for d in devs] if devs else _visible_devices(model)

    def _estimate_device_bytes(self, model, batcher_kw: Dict[str, Any], manifest,
                               owns: bool) -> int:
        """What registering ``model`` will cost in the ledger: one replica's
        bytes (at the compute dtype) times the replica count, plus the
        model's own tensors on the card for an entry the registry restored
        — the math ``capacity.served_device_bytes`` measures afterwards."""
        rep, own = self._entry_bytes(model, owns)
        replicas = batcher_kw.get("replicas")
        if not replicas and manifest is not None:
            replicas = manifest.replicas
        return rep * max(1, int(replicas or 1)) + own

    def _estimate_per_device(self, model, batcher_kw: Dict[str, Any], manifest,
                             owns: bool) -> Dict[str, int]:
        """Shard-aware reservation estimate: the per-position charges the
        load will place (a classic replica whole on one position, a plan
        slice spread evenly over its group). Approximate; the measurement
        after the build replaces it."""
        from deeplearning4j_tpu_torch.serving.capacity import position_key
        rep, own = self._entry_bytes(model, owns)
        replicas = batcher_kw.get("replicas")
        if not replicas and manifest is not None:
            replicas = manifest.replicas
        replicas = max(1, int(replicas or 1))
        plan = batcher_kw.get("plan")
        devices = self._serving_devices(model, batcher_kw)
        out: Dict[str, int] = {}
        gs = max(1, plan.devices_per_replica()) if plan is not None else 1
        n_groups = max(1, len(devices) // gs)
        per_pos = -(-rep // gs)  # even shards, rounded up
        for i in range(replicas):
            g = i % n_groups
            for p in range(g * gs, (g + 1) * gs):
                key = position_key(devices[p], p)
                out[key] = out.get(key, 0) + per_pos
        if own:
            dev = getattr(model, "device", None)
            p = next((i for i, d in enumerate(devices) if d == dev), 0)
            key = position_key(devices[p], p)
            out[key] = out.get(key, 0) + own
        return out

    def _resident_per_device_locked(self, exclude: str = "") -> Optional[Dict[str, int]]:  # holds: _lock
        """Per-position resident charges (measured maps + in-build
        reservation maps), or ``None`` when a counted entry lacks a map (the
        caller then holds the summed total, the more conservative check)."""
        out: Dict[str, int] = {}
        for n, r in self._residency.items():
            if r.state != paging.RESIDENT or n == exclude:
                continue
            if not r.device_map:
                if int(r.bytes or 0) > 0:
                    return None
                continue
            for d, b in r.device_map.items():
                out[d] = out.get(d, 0) + int(b)
        for n, m in self._reserved_maps.items():
            if n == exclude:
                continue
            for d, b in m.items():
                out[d] = out.get(d, 0) + int(b)
        return out

    def _reserve_room(self, name: str, est: int, est_map: Optional[Dict[str, int]] = None) -> None:
        """Block until the load fits under the HBM budget (evicting
        cost-weighted-LRU victims), then reserve its bytes under ``name`` so
        a concurrent load cannot double-book the headroom. No-op without a
        budget. Raises :class:`HBMBudgetExceeded` when no victim frees
        enough room within a bounded wait. The budget is held per position
        (``max_p(in_use_p + est_p) <= budget``) where every counted entry
        has a map, else on the summed total."""
        budget = self.hbm_budget_bytes
        if budget is None:
            return
        give_up = time.monotonic() + 10.0
        while True:
            with self._lock:
                in_use = self._resident_bytes_locked(exclude=name)
                in_use_map = self._resident_per_device_locked(exclude=name) if est_map else None
                if in_use_map is not None:
                    fits = all(in_use_map.get(d, 0) + b <= budget for d, b in est_map.items())
                else:
                    fits = in_use + est <= budget
                if fits:
                    # a hot-swap replaces the OLD version's bytes, which stay
                    # counted until the swap: reserve only the DELTA
                    res = self._residency.get(name)
                    old = (int(res.bytes or 0) if res is not None
                           and res.state == paging.RESIDENT else 0)
                    self._reserved[name] = max(0, int(est) - old)
                    if est_map:
                        oldm = (res.device_map if res is not None
                                and res.state == paging.RESIDENT else {})
                        self._reserved_maps[name] = {
                            d: max(0, int(b) - int((oldm or {}).get(d, 0)))
                            for d, b in est_map.items()}
                    return
                victim = self._pick_victim_locked(exclude=name)
                # can waiting ever help? yes while something evictable is
                # resident (pins are transient) or another load holds a
                # reservation; otherwise fail fast
                could_ever = any(
                    n != name and (r := self._residency.get(n)) is not None and r.evictable
                    for n in self._models) or any(n != name for n in self._reserved)
            if victim is not None:
                if self.evict(victim):
                    continue
            if not could_ever or time.monotonic() >= give_up:
                raise HBMBudgetExceeded(
                    f"cannot fit {name!r} ({est} bytes) under the HBM budget ({budget} "
                    f"bytes, {in_use} in use) — "
                    + ("every evictable model is pinned by in-flight requests" if could_ever
                       else "nothing evictable remains (the model alone exceeds the "
                            "budget, or every resident entry is live-registered)"))
            time.sleep(0.005)  # pins are request-scoped; retry shortly

    def _pick_victim_locked(self, exclude: str = "") -> Optional[str]:  # holds: _lock
        """The cost-weighted-LRU victim among evictable, unpinned resident
        models (``Residency.retention`` on the measured per-dtype bytes; LRU
        tie-break)."""
        now = time.monotonic()
        best = None
        for n, served in self._models.items():
            if n == exclude:
                continue
            res = self._residency.get(n)
            if res is None or not res.evictable or served.pins > 0:
                continue
            key = (res.retention(now), res.last_used, n)
            if best is None or key < best:
                best = key
        return best[2] if best is not None else None

    def refresh_device_bytes(self, name: str) -> int:
        """Re-measure a resident model's device bytes and update the ledger
        (after a runtime replica resize, which mints or drops copies the
        register-time measurement cannot know). If the new footprint is
        over the budget, other models are paged out best-effort. Returns
        the measured bytes (0 when ``name`` is not resident)."""
        with self._lock:
            served = self._models.get(name)
        if served is None:
            return 0
        from deeplearning4j_tpu_torch.serving import capacity
        try:
            dtype_bytes = capacity.served_device_dtype_bytes(served)
            measured = sum(dtype_bytes.values())
            device_map = capacity.served_per_device_bytes(served)
        except Exception:
            return served.device_bytes
        with self._lock:
            served.device_bytes = measured
            res = self._residency.get(name)
            if res is not None:
                res.bytes = measured
                res.bytes_estimated = False
                res.dtype_bytes = dict(dtype_bytes)
                res.device_map = dict(device_map)
        budget = self.hbm_budget_bytes
        if budget is not None:
            while True:
                with self._lock:
                    over = self._resident_bytes_locked() > budget
                    victim = self._pick_victim_locked(exclude=name) if over else None
                if victim is None:
                    if over:
                        logger.warning("replica resize of %r left the registry %d bytes over "
                                       "the HBM budget with nothing evictable", name,
                                       self.resident_bytes() - budget)
                    break
                if not self.evict(victim):
                    break
        return measured

    def residency_snapshot(self) -> Dict[str, Any]:
        """The pager's ledger: budget, resident bytes (reservations
        included), per-position and per-card bytes, per-name state, and the
        paging counters."""
        from deeplearning4j_tpu_torch.serving.capacity import physical
        budget = self.hbm_budget_bytes  # resolve outside the lock
        now = time.monotonic()
        with self._lock:
            models = {n: r.snapshot(now) for n, r in sorted(self._residency.items())}
            resident = self._resident_bytes_locked()
            per_device = self._resident_per_device_locked() or {}
        per_card: Dict[str, int] = {}
        for k, b in per_device.items():
            per_card[physical(k)] = per_card.get(physical(k), 0) + b
        return {
            "hbm_budget_bytes": budget,
            "resident_bytes": resident,
            "per_device_bytes": per_device,
            "per_physical_device_bytes": per_card,
            "models": models,
            "paging": self.paging.snapshot(),
        }

    # ---------------------------------------------------------- lifecycle
    def names(self) -> List[str]:
        """Every registered name, resident AND cold."""
        with self._lock:
            return sorted(set(self._models) | set(self._residency))

    def resident_names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def describe(self) -> List[Dict[str, Any]]:
        with self._lock:
            served = list(self._models.values())
            cold = [(n, r) for n, r in sorted(self._residency.items())
                    if n not in self._models and r.archive_path is not None]
        out = [s.describe() for s in served]
        now = time.monotonic()
        for n, r in cold:
            out.append({"name": n, "residency": paging.COLD, "version": r.version,
                        "archive": r.archive_path,
                        **{k: v for k, v in r.snapshot(now).items() if k != "state"}})
        return out

    def health(self) -> Dict[str, str]:
        """Per-model health map for a readiness probe. Cold archive-backed
        entries report ``"cold"``: they are servable (a request pages them
        in)."""
        with self._lock:
            served = list(self._models.values())
            cold = [n for n, r in self._residency.items()
                    if n not in self._models and r.archive_path is not None]
        out = {s.name: s.health.value for s in served}
        for n in cold:
            out[n] = "cold"
        return out

    @staticmethod
    def ready_from(health: Dict[str, str]) -> bool:
        """Readiness derived from ONE health snapshot: at least one model
        registered and every model READY (or cold-servable)."""
        return bool(health) and all(v in (HealthState.READY.value, "cold")
                                    for v in health.values())

    def ready(self) -> bool:
        return self.ready_from(self.health())

    def _persist_manifest(self, served: ServedModel,
                          archive_path: Optional[str] = None) -> Optional[str]:
        """The one manifest-persistence implementation behind
        :meth:`save_manifest`, eviction and the graceful undeploy/shutdown
        refresh. Stamps the measured device bytes and page-in cost, so a cold
        registration of this archive knows its cost without restoring it."""
        from deeplearning4j_tpu_torch.serving.manifest import manifest_path
        target = archive_path or served.archive_path
        recorded = served.batcher.warmup_manifest()
        if target is None or recorded is None:
            return None
        recorded.device_bytes = int(served.device_bytes or 0)
        with self._lock:
            res = self._residency.get(served.name)
            if res is not None and res.page_in_s > 0:
                recorded.page_in_s = round(res.page_in_s, 4)
        path = manifest_path(target)
        try:
            recorded.save(path)
        except OSError:
            logger.warning("could not persist warmup manifest for %r to %s",
                           served.name, path, exc_info=True)
            return None
        risk = paging.recompile_risk(target)
        with self._lock:
            res = self._residency.get(served.name)
            if res is not None:
                res.risk = risk
        return path

    def undeploy(self, name: str, drain: bool = True) -> None:
        """Remove ``name`` entirely — resident or cold (unlike
        :meth:`evict`, which keeps the cold entry servable)."""
        with self._lock:
            served = self._models.pop(name, None)
            res = self._residency.pop(name, None)
        if served is None:
            if res is not None:
                return  # cold entry: nothing loaded, nothing to drain
            raise KeyError(f"no model registered under {name!r}")
        served._draining = True
        served.batcher.shutdown(drain=drain)
        if drain:
            # AFTER the drain: a queued oversized request may mint a bucket
            # while draining, and the manifest must record it
            self._persist_manifest(served)
        from deeplearning4j_tpu_torch.runtime import profiler
        profiler.detach_quant_metrics(name)

    def shutdown(self, drain: bool = True) -> None:
        """Stop every batcher and join its threads."""
        with self._lock:
            served = list(self._models.values())
            self._models.clear()
            self._residency.clear()
            self._reserved.clear()
            self._reserved_maps.clear()
        from deeplearning4j_tpu_torch.runtime import profiler
        for s in served:
            s._draining = True
            s.batcher.shutdown(drain=drain)
            if drain:
                self._persist_manifest(s)
            profiler.detach_quant_metrics(s.name)
