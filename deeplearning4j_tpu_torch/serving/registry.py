"""Named/versioned model registry with hot-swap, warmup, and failure
containment.

Counterpart of ``deeplearning4j_tpu/serving/registry.py``'s core. Models are
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
process served. Manifests are refreshed at graceful undeploy/shutdown to
capture traffic-minted buckets. Warmup wall time is
``serving_warmup_seconds`` in the metrics.

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

HBM-budgeted paging (``hbm_budget_bytes``, ``register_cold``, ``acquire``,
``page_in``, ``evict``, ``residency_snapshot``) and quantized deploys
(``deploy_quantized``) are not ported yet: they raise
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.runtime import chaos, journal
from deeplearning4j_tpu_torch.serving.admission import ServingError
from deeplearning4j_tpu_torch.serving.batcher import ArrayOrDict, ContinuousBatcher
from deeplearning4j_tpu_torch.serving.resilience import (
    CircuitBreaker,
    CircuitOpen,
    CircuitState,
    HealthState,
    RetryPolicy,
)

logger = logging.getLogger(__name__)

#: the only residency this half of the port has: every entry is loaded
RESIDENT = "resident"


def _not_ported(what: str):
    raise NotImplementedError(
        f"ModelRegistry.{what}: HBM-budgeted paging and quantized serving are "
        f"not ported yet")


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
        self.device_bytes = 0  # the replicas' parameter and state copies
        self._draining = False
        self._started = False  # flipped by the registry after the swap
        self._pins = 0         # in-flight requests holding this entry
        self._pin_lock = threading.Lock()  # guards: _pins
        self.batcher.metrics.attach_breaker(self.breaker)

    # ------------------------------------------------------------- pinning
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
            "residency": RESIDENT,
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


class ModelRegistry:
    """Thread-safe registry of served models."""

    def __init__(self, hbm_budget_bytes: Optional[int] = None):
        if hbm_budget_bytes is not None:
            _not_ported("__init__(hbm_budget_bytes=...)")
        self._lock = threading.Lock()  # guards: _models
        self._models: Dict[str, ServedModel] = {}

    # ----------------------------------------------------------- register
    def register(self, name: str, model, version: Optional[int] = None,
                 warmup_example: Optional[ArrayOrDict] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 retry: Optional[RetryPolicy] = None,
                 manifest=None, **batcher_kw) -> ServedModel:
        """Serve ``model`` under ``name``. Re-registering an existing name
        hot-swaps (version auto-bumps unless given); the new batcher is
        warmed before it takes traffic and the old one drains — queued
        requests are served AND every dispatched batch reads back against
        the old version before its pipeline stops. A failure during the
        replacement's build/warmup leaves the old entry serving (rollback).
        ``batcher_kw`` forwards to :class:`ContinuousBatcher`
        (``max_batch_size``, ``batch_timeout_ms``, ``queue_limit``,
        ``buckets``, ``admission``, ``replicas``, ``pipeline_depth``,
        ``devices``).

        ``manifest`` takes a :class:`~.manifest.WarmupManifest` to REPLAY:
        the batcher is built with the recorded buckets/replicas and warmed
        from the recorded input signature. A hot-swap with no explicit
        ``manifest``/``warmup_example`` inherits the replaced entry's
        manifest, so the replacement pre-warms the full live bucket set.
        Explicit ``batcher_kw`` always wins over manifest-recorded values.
        Warmup wall time is recorded as ``serving_warmup_seconds``."""
        chaos.inject("serving.registry.register")
        if getattr(model, "_params", 1) is None:
            model._ensure_init()
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
        # Build + warm OUTSIDE the lock and BEFORE the swap: if this raises
        # nothing has been swapped — the previous version keeps serving.
        t0 = time.monotonic()
        try:
            batcher = ContinuousBatcher(model, warmup_example=warmup_example, **batcher_kw)
        except BaseException:
            logger.warning("register(%r): replacement build/warmup failed; previous "
                           "version (if any) keeps serving", name)
            raise
        served = ServedModel(name, 0, model, batcher, breaker=breaker, retry=retry)
        served.metrics.set_warmup_seconds(time.monotonic() - t0)
        served.device_bytes = batcher._pool.state_bytes()
        with self._lock:
            prev = self._models.get(name)
            if version is None:
                version = prev.version + 1 if prev else 1
            served.version = int(version)
            self._models[name] = served
            served._started = True  # STARTING -> READY at the swap point
        if prev is not None:
            journal.emit("registry.hot_swap", model=name, old_version=prev.version,
                         new_version=served.version, device_bytes=served.device_bytes)
            prev._draining = True
            try:
                prev.batcher.shutdown(drain=True)
            except Exception:
                logger.exception("register(%r): drain of replaced v%d failed (new "
                                 "version is serving)", name, prev.version)
        return served

    def load(self, name: str, path: str, load_updater: bool = False,
             replay_manifest: bool = True, save_manifest: bool = True,
             resident: bool = True, device=None, **kw) -> ServedModel:
        """Register from a ``ModelSerializer`` archive (MultiLayerNetwork or
        ComputationGraph — the archive metadata dispatches the type),
        restored on ``device`` (``cuda`` unless the caller or the
        environment asks for the CPU).

        When a warmup manifest exists next to the archive
        (``<path>.warmup.json``, written by either package) it is replayed —
        recorded buckets/replicas, warmup from the recorded input signature
        — so the model reaches READY without capturing on live traffic.
        After warmup the up-to-date manifest is written back (best effort).
        ``replay_manifest=False`` forces the cold path; ``save_manifest=False``
        skips the write-back. ``resident=False`` (cold registration) is not
        ported yet."""
        if not resident:
            _not_ported("load(resident=False)")
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        from deeplearning4j_tpu_torch.serving.manifest import WarmupManifest
        model = ModelSerializer.restore_model(path, device=device, load_updater=load_updater)
        manifest = kw.pop("manifest", None)
        if manifest is None and replay_manifest:
            manifest = WarmupManifest.load_for_archive(path)
        served = self.register(name, model, manifest=manifest, **kw)
        served.archive_path = path if save_manifest else None
        if save_manifest:
            self.save_manifest(name)
        return served

    def save_manifest(self, name: str, archive_path: Optional[str] = None) -> Optional[str]:
        """Persist ``name``'s CURRENT warmup manifest next to its archive (or
        ``archive_path``), capturing buckets minted under live traffic since
        load. Called automatically at load, graceful undeploy, and shutdown.
        Best effort. Returns the manifest path, or ``None`` when there is
        nothing to record or nowhere to put it."""
        return self._persist_manifest(self.get(name), archive_path)

    def register_zoo(self, name: str, zoo_model, device=None, **kw) -> ServedModel:
        """Register a zoo entry: either an already-constructed ``ZooModel``
        instance or a zoo class name string looked up in
        ``deeplearning4j_tpu_torch.zoo``."""
        if isinstance(zoo_model, str):
            import deeplearning4j_tpu_torch.zoo as zoo
            zoo_model = getattr(zoo, zoo_model)()
        return self.register(name, zoo_model.init(device=device), **kw)

    # ------------------------------------------------- not ported (paging)
    @property
    def hbm_budget_bytes(self):
        _not_ported("hbm_budget_bytes")

    def register_cold(self, name: str, path: str, version: Optional[int] = None,
                      **load_kwargs):
        _not_ported("register_cold")

    def acquire(self, name: str, timeout_ms: Optional[float] = None):
        _not_ported("acquire")

    def page_in(self, name: str, timeout_ms: Optional[float] = None):
        _not_ported("page_in")

    def evict(self, name: str):
        _not_ported("evict")

    def deploy_quantized(self, name: str, path: str, eval_inputs, eval_labels=None,
                         golden=None, gate=None, **kw):
        _not_ported("deploy_quantized")

    def residency_snapshot(self):
        _not_ported("residency_snapshot")

    # ------------------------------------------------------------ routing
    def get(self, name: str) -> ServedModel:
        with self._lock:
            served = self._models.get(name)
            have = sorted(self._models)
        if served is None:
            raise KeyError(f"no model registered under {name!r}; have {have}")
        return served

    def pinned(self, name: str) -> ServedModel:
        """``name``'s entry, pinned for one request (the caller unpins)."""
        with self._lock:
            served = self._models.get(name)
            if served is not None:
                served.pin()
                return served
            have = sorted(self._models)
        raise KeyError(f"no model registered under {name!r}; have {have}")

    def predict(self, name: str, x: ArrayOrDict, timeout_ms: Optional[float] = None):
        """Route one request through ``name``'s served model (breaker +
        retry + batcher). Raises ``KeyError`` for unknown names,
        ``Overloaded``/``DeadlineExceeded`` under pressure, ``CircuitOpen``
        while the breaker sheds — never hangs on a registered model."""
        served = self.pinned(name)
        try:
            return served.predict(x, timeout_ms=timeout_ms)
        finally:
            served.unpin()

    # ---------------------------------------------------------- lifecycle
    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def resident_names(self) -> List[str]:
        return self.names()

    def describe(self) -> List[Dict[str, Any]]:
        with self._lock:
            served = list(self._models.values())
        return [s.describe() for s in served]

    def health(self) -> Dict[str, str]:
        """Per-model health map for a readiness probe."""
        with self._lock:
            served = list(self._models.values())
        return {s.name: s.health.value for s in served}

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
        :meth:`save_manifest` and the graceful undeploy/shutdown refresh.
        Stamps the measured device bytes."""
        from deeplearning4j_tpu_torch.serving.manifest import manifest_path
        target = archive_path or served.archive_path
        recorded = served.batcher.warmup_manifest()
        if target is None or recorded is None:
            return None
        recorded.device_bytes = int(served.device_bytes or 0)
        path = manifest_path(target)
        try:
            recorded.save(path)
        except OSError:
            logger.warning("could not persist warmup manifest for %r to %s",
                           served.name, path, exc_info=True)
            return None
        return path

    def undeploy(self, name: str, drain: bool = True) -> None:
        """Remove ``name`` entirely, draining its batcher."""
        with self._lock:
            served = self._models.pop(name, None)
        if served is None:
            raise KeyError(f"no model registered under {name!r}")
        served._draining = True
        served.batcher.shutdown(drain=drain)
        if drain:
            # AFTER the drain: a queued oversized request may mint a bucket
            # while draining, and the manifest must record it
            self._persist_manifest(served)

    def shutdown(self, drain: bool = True) -> None:
        """Stop every batcher and join its threads."""
        with self._lock:
            served = list(self._models.values())
            self._models.clear()
        for s in served:
            s._draining = True
            s.batcher.shutdown(drain=drain)
            if drain:
                self._persist_manifest(s)
