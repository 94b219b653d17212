"""Model serving on the card (counterpart of ``deeplearning4j_tpu.serving``).

- :class:`ModelRegistry` (``registry.py``) — named/versioned models from
  live nets, ``ModelSerializer`` archives or the zoo; hot-swap with
  pre-warmed replacements and graceful drain; breakers, retries, health.
- :class:`ContinuousBatcher` (``batcher.py``) — coalesces concurrent
  requests into power-of-two row buckets captured as CUDA graphs at warm-up,
  a pipelined in-flight window, deadlines at coalesce and dispatch,
  admission, and the fixed-bucket session-step path.
- :class:`ReplicaPool` (``replica.py``) — N parameter copies of one model,
  least-loaded routing, one stream and one captured graph per bucket each.
- :class:`AdmissionController` (``admission.py``) — deadlines, queue limits,
  load shedding with ``Retry-After``.
- :class:`CircuitBreaker` / :class:`RetryPolicy` / :class:`HealthState`
  (``resilience.py``).
- :class:`WarmupManifest` (``manifest.py``) — the replayable record of
  every warmed (bucket, replica, dtype) pair, in the JAX package's format.
- :class:`SessionStore` (``sessions.py``) — server-side ``rnnTimeStep``
  state with CRC-framed spills.
- :class:`ServingMetrics` / :class:`LatencyHistogram` (``metrics.py``).
- ``paging.py`` — the pager's policy (traffic EWMA, retention weight, the
  budget), behind the registry's ``hbm_budget_bytes``, ``acquire``,
  ``page_in``, ``evict`` and ``residency_snapshot``.
- ``capacity.py`` — the device-byte ledger and the capacity payload
  (:func:`model_capacity`, :func:`registry_capacity`).
- ``quantize.py`` — offline int8 archives (:func:`quantize_archive`),
  :class:`DtypePolicy`, :class:`QuantizedModel` and the
  :class:`AccuracyGate` ``deploy_quantized`` runs.
- ``delivery.py`` — the golden-set gate (:class:`GoldenGate`,
  :class:`GoldenSet`) and the staged rollout (:class:`ShadowComparator`,
  :class:`DeliveryConfig`, :class:`DeliveryController`) with the
  feedback flywheel's :class:`FeedbackLog`.

The host side, first half (the HTTP worker and the router tier):

- :class:`ModelServer` (``server.py``) — serves a registry over HTTP: JSON
  and binary predict, residency, replicas, the session tier with its
  Server-Sent-Events stream, health, ``/metrics``, capacity, traces, the
  black box's debug endpoints and feedback; with a :class:`Scheduler`
  attached, ``/v1/scheduler`` and the ``scheduler_*`` families.
- ``wire.py`` — the binary frame codec (byte for byte the JAX package's),
  the shared-memory hop, :class:`~.wire.KeepAliveHTTPServer` and
  :class:`~.wire.ConnectionPool`.
- :class:`FleetRouter` / :class:`StaticFleet` / :class:`RouterMetrics`
  (``router.py``) — rendezvous ranking, probes, hedging, failover,
  breakers, rolling and gated deploys over any fleet object.
- :class:`SLOMonitor` / :class:`SLOTarget` (``slo.py``) — attainment and
  burn rates.
- :class:`AnomalyWatchdog` / :class:`BurnRule` / :class:`RateRule`
  (``blackbox.py``) — the watchdog and the incident bundles.

The host side, second half (the process tier):

- :class:`FleetSupervisor` / :class:`WorkerSpec` (``fleet.py``) — worker
  processes (``python -m deeplearning4j_tpu_torch.serving.fleet``) on
  ``cuda`` unless a spec asks for the CPU, with a heartbeat and exit-code
  watchdog, budgeted restarts, rolling relaunches and leak-guarded pids.
- ``control_plane.py`` — :class:`FleetConfig` (the shared versioned
  config file and its exactly-once action ledger), :class:`LeaseElection`,
  :class:`RouterSupervisor` over router processes that never touch the
  card, and :class:`MultiRouterClient`.
- :class:`SLOAutoscaler` / :class:`AutoscalerConfig` (``autoscale.py``) —
  burn-rate driven replica, placement and worker levers, the decision log
  in the journal, lease-elected leader and followers.
- :class:`Scheduler` / :class:`JobStore` / :class:`SchedulerConfig`
  (``scheduler.py``) — preemptible background jobs (fine-tune, eval,
  score, sweep, flywheel) in the gaps serving leaves.

Exports resolve lazily (PEP 562), as in the JAX package.
"""

import importlib

_EXPORTS = {
    "AdmissionController": "admission",
    "AutoscalerConfig": "autoscale",
    "SLOAutoscaler": "autoscale",
    "forecast_rate": "autoscale",
    "FleetConfig": "control_plane",
    "LeaseElection": "control_plane",
    "MultiRouterClient": "control_plane",
    "RouterSpec": "control_plane",
    "RouterSupervisor": "control_plane",
    "FleetSupervisor": "fleet",
    "WorkerSpec": "fleet",
    "JobStore": "scheduler",
    "Scheduler": "scheduler",
    "SchedulerConfig": "scheduler",
    "AnomalyWatchdog": "blackbox",
    "BurnRule": "blackbox",
    "RateRule": "blackbox",
    "SLOMonitor": "slo",
    "SLOTarget": "slo",
    "ModelServer": "server",
    "FleetRouter": "router",
    "RouterMetrics": "router",
    "StaticFleet": "router",
    "DeliveryConfig": "delivery",
    "DeliveryController": "delivery",
    "FeedbackLog": "delivery",
    "ShadowComparator": "delivery",
    "DeadlineExceeded": "admission",
    "HBMBudgetExceeded": "admission",
    "Overloaded": "admission",
    "PagingInProgress": "admission",
    "ServingError": "admission",
    "ServingShutdown": "admission",
    "page_in_retry_after_ms": "admission",
    "ContinuousBatcher": "batcher",
    "default_buckets": "batcher",
    "model_capacity": "capacity",
    "registry_capacity": "capacity",
    "LatencyHistogram": "metrics",
    "ServingMetrics": "metrics",
    "ModelRegistry": "registry",
    "ServedModel": "registry",
    "WarmupManifest": "manifest",
    "manifest_path": "manifest",
    "Session": "sessions",
    "SessionLost": "sessions",
    "SessionStepConflict": "sessions",
    "SessionStore": "sessions",
    "Replica": "replica",
    "ReplicaPool": "replica",
    "GateFailed": "delivery",
    "GateRefused": "delivery",
    "GoldenGate": "delivery",
    "GoldenSet": "delivery",
    "AccuracyGate": "quantize",
    "AccuracyGateFailed": "quantize",
    "CalibrationError": "quantize",
    "DtypePolicy": "quantize",
    "QuantizedModel": "quantize",
    "quantize_archive": "quantize",
    "quantize_requests": "quantize",
    "CircuitBreaker": "resilience",
    "CircuitOpen": "resilience",
    "CircuitState": "resilience",
    "HealthState": "resilience",
    "RetryPolicy": "resilience",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    mod = importlib.import_module(f"{__name__}.{submodule}")
    return getattr(mod, name)


def __dir__():
    return __all__
