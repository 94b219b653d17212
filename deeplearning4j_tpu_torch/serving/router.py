"""Fleet router: the fault-domain boundary in front of N ``ModelServer``
workers (the reference's multi-JVM serving / parameter-server routing tier,
``docs/fleet_serving.md``). Counterpart of
``deeplearning4j_tpu/serving/router.py``: the same ranking, headers, paths,
JSON keys and metric families, so it fronts port workers and JAX workers
alike, over JSON or the binary wire.

One ``ModelServer`` process as the whole fleet means any worker crash,
stall, or deploy is a full outage. :class:`FleetRouter` is the same
stdlib ``ThreadingHTTPServer`` idiom as ``serving/server.py``, one level
up — it owns no models, only a **health view** of the workers behind it:

- **Health**: an active prober polls every worker's ``/readyz``; passive
  signals (connection failures, 5xx, shed responses) feed a per-worker
  :class:`~deeplearning4j_tpu_torch.serving.resilience.CircuitBreaker` — a
  byzantine worker (one that keeps erroring) is isolated without taking
  the fleet down, and re-admitted through the breaker's half-open probe.
- **Consistent routing**: workers are ranked per model by rendezvous
  (highest-random-weight) hashing, so one model's traffic concentrates on
  one healthy worker (warm caches, stable batching) and spreads only when
  health changes — no routing table to rebalance.
- **Hedging**: a request still unanswered after a p99-derived delay is
  *hedged* against the next-ranked worker; the first completed response
  wins bit-identically, the loser's completion is discarded and counted
  (``router_hedges_discarded_total``) — duplicate side effects are
  suppressed by the shared ``X-Request-Id``, and the hedge carries the
  REMAINING deadline (``X-Deadline-Ms``), never a fresh one.
- **Failover**: a worker dying mid-request (connection reset, SIGKILL
  under the chaos drill) fails the *attempt*, not the request — the
  router retries the untried next-ranked worker within the original
  deadline. A request is never silently dropped: it ends served, or with
  an explicit 503/504.
- **Load signals**: a worker's 503 ``Overloaded`` carries its
  ``Retry-After-Ms`` drain estimate; the router routes around that
  worker until the window passes instead of hammering it
  (``router_shed_skips_total`` counts the avoided forwards).
- **Zero-downtime rolling deploys**: :meth:`FleetRouter.rolling_deploy`
  drains one worker (stop new routing, wait in-flight), has the fleet
  relaunch it on the new archive (any object with ``restart_worker``;
  warmup-manifest prewarmed), re-admits it only after ``/readyz``, then
  moves to the next — client traffic sees a mix of old and new versions
  and zero errors, and readmitted workers capture nothing on live
  traffic.

Chaos points: ``serving.router.forward`` fires before every forward
attempt, ``serving.router.hedge`` as a hedge launches (catalogue in
``runtime/chaos.py``; drills in ``tests/test_torch_serving_router.py``).

The router runs no model and touches no device: it is host code and can
front workers from any process (a gated deploy's cold candidate is the one
exception: it loads into a :class:`~.registry.ModelRegistry` on the
environment's device, ``cuda`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import struct
import threading
import time
import uuid
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from deeplearning4j_tpu_torch.runtime import chaos, journal, trace
from deeplearning4j_tpu_torch.serving import wire
from deeplearning4j_tpu_torch.serving.metrics import LatencyHistogram
from deeplearning4j_tpu_torch.serving.resilience import CircuitBreaker, CircuitState
from deeplearning4j_tpu_torch.serving.slo import SLOMonitor

logger = logging.getLogger(__name__)

#: statuses that END a request at the client (retrying cannot change them:
#: 400/404 are the client's problem, 504 means the shared deadline — which
#: every attempt inherits via X-Deadline-Ms — has truly expired).
_TERMINAL = frozenset({200, 400, 404, 504})

#: headers the router must NOT copy from a worker response onto its own:
#: the router's HTTP layer emits its own framing (Content-Length) and
#: identity (Date, Server), and hop-by-hop headers never cross a proxy —
#: re-sending the worker's copy would emit duplicates that strict clients
#: and intermediaries reject as a protocol error.
_HOP_BY_HOP = frozenset({"content-length", "date", "server", "connection",
                         "transfer-encoding", "keep-alive"})


class StaticFleet:
    """The simplest thing a :class:`FleetRouter` can front: a fixed
    ``{worker_id: "host:port"}`` map (in-process workers, tests). A
    fleet that can relaunch workers adds ``restart_worker`` (and, for a
    gated deploy, ``worker_ids``/``worker_archive``)."""

    def __init__(self, endpoints: Dict[str, str]):
        self._endpoints = dict(endpoints)

    def endpoints(self) -> Dict[str, str]:
        return dict(self._endpoints)


class RouterMetrics:
    """Router-level counters/gauges (thread-safe), rendered on the
    router's ``/metrics`` and surfaced through
    ``runtime.profiler.router_stats()``."""

    def __init__(self):
        # guards: requests_total, responses_total, errors_total, forwards_total, hedges_total, hedge_wins_total, hedges_discarded_total, failovers_total, shed_skips_total, deploys_total, session_requests_total, session_migrations_total, shadow_mirrors_total, shadow_diverged_total, canary_requests_total, rollbacks_total, wire_requests_total, wire_downgrades_total, shm_hops_total, shm_fallbacks_total, request_latency, worker_requests
        self._lock = threading.Lock()
        self.requests_total = 0
        self.session_requests_total = 0    # session-tier requests routed
        self.session_migrations_total = 0  # session repins (failover/drain)
        self.responses_total = 0        # 2xx returned to clients
        self.errors_total = 0           # non-2xx returned to clients
        self.forwards_total = 0         # attempts launched (incl. hedges)
        self.hedges_total = 0           # hedge attempts launched
        self.hedge_wins_total = 0       # winner was the hedge attempt
        self.hedges_discarded_total = 0  # duplicate completions suppressed
        self.failovers_total = 0        # failed attempts retried elsewhere
        self.shed_skips_total = 0       # workers skipped inside Retry-After
        self.deploys_total = 0
        self.shadow_mirrors_total = 0   # requests mirrored to a candidate
        self.shadow_diverged_total = 0  # mirrors that disagreed/corrupted
        self.canary_requests_total = 0  # requests pinned to a canary
        self.rollbacks_total = 0        # gated deploys auto-rolled back
        self.wire_requests_total = 0    # binary-framed client requests
        self.wire_downgrades_total = 0  # 415s that flipped a worker to JSON
        self.shm_hops_total = 0         # forwards whose payload rode shm
        self.shm_fallbacks_total = 0    # shm hops resent inline
        self.request_latency = LatencyHistogram()
        self.worker_requests: Dict[str, int] = {}

    def record(self, counter: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + n)

    def record_response(self, status: int, latency_s: float) -> None:
        with self._lock:
            if 200 <= status < 300:
                self.responses_total += 1
                self.request_latency.observe(latency_s)
            else:
                self.errors_total += 1

    def record_forward(self, worker_id: str) -> None:
        with self._lock:
            self.forwards_total += 1
            self.worker_requests[worker_id] = \
                self.worker_requests.get(worker_id, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "errors_total": self.errors_total,
                "forwards_total": self.forwards_total,
                "hedges_total": self.hedges_total,
                "hedge_wins_total": self.hedge_wins_total,
                "hedges_discarded_total": self.hedges_discarded_total,
                "failovers_total": self.failovers_total,
                "shed_skips_total": self.shed_skips_total,
                "deploys_total": self.deploys_total,
                "session_requests_total": self.session_requests_total,
                "session_migrations_total": self.session_migrations_total,
                "shadow_mirrors_total": self.shadow_mirrors_total,
                "shadow_diverged_total": self.shadow_diverged_total,
                "canary_requests_total": self.canary_requests_total,
                "rollbacks_total": self.rollbacks_total,
                "wire_requests_total": self.wire_requests_total,
                "wire_downgrades_total": self.wire_downgrades_total,
                "shm_hops_total": self.shm_hops_total,
                "shm_fallbacks_total": self.shm_fallbacks_total,
                "latency_p50_s": self.request_latency.percentile(50),
                "latency_p99_s": self.request_latency.percentile(99),
                "worker_requests": dict(self.worker_requests),
            }

    def render_prometheus(self, workers: Dict[str, "WorkerView"]) -> str:
        s = self.snapshot()
        lines = [
            "# TYPE router_requests_total counter",
            f"router_requests_total {s['requests_total']}",
            f"router_responses_total {s['responses_total']}",
            f"router_errors_total {s['errors_total']}",
            f"router_forwards_total {s['forwards_total']}",
            f"router_hedges_total {s['hedges_total']}",
            f"router_hedge_wins_total {s['hedge_wins_total']}",
            f"router_hedges_discarded_total {s['hedges_discarded_total']}",
            f"router_failovers_total {s['failovers_total']}",
            f"router_shed_skips_total {s['shed_skips_total']}",
            f"router_deploys_total {s['deploys_total']}",
            f"router_session_requests_total {s['session_requests_total']}",
            f"router_session_migrations_total "
            f"{s['session_migrations_total']}",
            f"router_shadow_mirrors_total {s['shadow_mirrors_total']}",
            f"router_shadow_diverged_total {s['shadow_diverged_total']}",
            f"router_canary_requests_total {s['canary_requests_total']}",
            f"router_rollbacks_total {s['rollbacks_total']}",
            f"router_wire_requests_total {s['wire_requests_total']}",
            f"router_wire_downgrades_total {s['wire_downgrades_total']}",
            f"router_shm_hops_total {s['shm_hops_total']}",
            f"router_shm_fallbacks_total {s['shm_fallbacks_total']}",
            f'router_latency_seconds{{quantile="0.5"}} '
            f"{s['latency_p50_s']}",
            f'router_latency_seconds{{quantile="0.99"}} '
            f"{s['latency_p99_s']}",
        ]
        for wid, n in sorted(s["worker_requests"].items()):
            lines.append(f'router_worker_requests_total{{worker="{wid}"}} '
                         f"{n}")
        now = time.monotonic()
        for wid, view in sorted(workers.items()):
            lines.append(f'router_worker_healthy{{worker="{wid}"}} '
                         f"{int(view.admittable(now))}")
            lines.append(f'router_worker_inflight{{worker="{wid}"}} '
                         f"{view.inflight}")
        return "\n".join(lines) + "\n"


class WorkerView:
    """The router's per-worker health view: one address, an active-probe
    readiness bit, a passive-signal breaker, a shed window from the
    worker's own ``Retry-After`` hints, and the in-flight count drains
    wait on."""

    def __init__(self, worker_id: str, address: str,
                 breaker: Optional[CircuitBreaker] = None):
        self.worker_id = worker_id
        self.address = address
        self.breaker = breaker or CircuitBreaker(
            failure_threshold=3, window_s=30.0, reset_timeout_s=2.0)
        # breaker transitions land in the event journal under this scope
        #: the watchdog's breaker-flap rule counts them
        self.breaker.journal_scope = f"worker:{worker_id}"
        #: flips True after the one-shot /v1/metricsz warm-start scrape
        #:: a fresh view adopts the worker's OWN breaker
        #: verdict instead of re-learning a failure streak from traffic
        self.breaker_warmed = False
        self.ready = False
        self.draining = False
        #: a gated deploy's CANDIDATE: excluded from normal
        #: admission — it receives only the traffic the active
        #: DeliveryController assigns it (shadow mirrors, canary picks)
        self.candidate = False
        self.shed_until = 0.0           # monotonic end of the shed window
        #: negotiated transport: None = untried, True = the
        #: worker accepted a binary frame, False = it answered 415 and
        #: every later forward transcodes to JSON.  A restarted worker
        #: gets a fresh view, so it re-negotiates.
        self.wire_ok: Optional[bool] = None
        self.inflight = 0
        self.requests_total = 0
        self.failures_total = 0
        self.latency = LatencyHistogram()
        # guards: inflight, requests_total, failures_total, latency
        self._lock = threading.Lock()

    def admittable(self, now: Optional[float] = None) -> bool:
        """May new requests be routed here right now? (Half-open breaker
        probes are consumed at attempt time, not here.)"""
        now = time.monotonic() if now is None else now
        return (self.ready and not self.draining and not self.candidate
                and now >= self.shed_until
                and self.breaker.state is not CircuitState.OPEN)

    def shedding(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return now < self.shed_until

    def begin(self) -> None:
        with self._lock:
            self.inflight += 1
            self.requests_total += 1

    def done(self, ok: bool, latency_s: Optional[float] = None) -> None:
        with self._lock:
            self.inflight -= 1
            if not ok:
                self.failures_total += 1
            elif latency_s is not None:
                self.latency.observe(latency_s)

    def snapshot(self) -> Dict[str, Any]:
        now = time.monotonic()
        # counters read under the lock so a scrape sees one consistent
        # view (inflight can never exceed requests_total in a snapshot)
        with self._lock:
            inflight = self.inflight
            requests_total = self.requests_total
            failures_total = self.failures_total
        return {"address": self.address, "ready": self.ready,
                "draining": self.draining, "candidate": self.candidate,
                "admittable": self.admittable(now),
                "shedding_ms": max(0.0, (self.shed_until - now) * 1000.0),
                "inflight": inflight,
                "requests_total": requests_total,
                "failures_total": failures_total,
                "breaker": self.breaker.snapshot()}


class _BreakerDeclined(Exception):
    """The worker's half-open breaker had no probe slot left at forward
    time — a retryable skip, not a worker fault."""


class _Attempt:
    """One forward attempt's outcome."""

    __slots__ = ("view", "hedged", "status", "headers", "data", "error",
                 "span")

    def __init__(self, view: WorkerView, hedged: bool):
        self.view = view
        self.hedged = hedged
        self.status: Optional[int] = None
        self.headers: Dict[str, str] = {}
        self.data: bytes = b""
        self.error: Optional[BaseException] = None
        self.span = trace.NOOP  # the attempt's router.attempt span

    @property
    def terminal(self) -> bool:
        return self.status in _TERMINAL

    @property
    def retryable(self) -> bool:
        """A failed attempt another worker might still serve: connection
        faults, 5xx, and shed (503) responses."""
        return not self.terminal


def _crc(data: bytes) -> str:
    return f"{zlib.crc32(data) & 0xffffffff:08x}"


class _Race:
    """Exactly-one-winner coordination for a primary attempt and its
    hedge. The first TERMINAL completion claims the request (its response
    goes to the client bit-for-bit); any completion after that is a
    duplicate — discarded and counted, the side-effect suppression the
    shared request id exists for."""

    def __init__(self, metrics: RouterMetrics):
        self._metrics = metrics
        self._cv = threading.Condition()  # guards: winner, launched, finished, failures
        self.winner: Optional[_Attempt] = None
        self.launched = 0
        self.finished = 0
        self.failures: List[_Attempt] = []

    def register_launch(self) -> None:
        with self._cv:
            self.launched += 1

    def complete(self, attempt: _Attempt) -> None:
        with self._cv:
            self.finished += 1
            if attempt.terminal:
                if self.winner is None:
                    self.winner = attempt
                    if attempt.span.recording:
                        # the winner's bit-identity: a body checksum any
                        # late duplicate can be compared against
                        attempt.span.set("winner", True)
                        attempt.span.set("body_crc32", _crc(attempt.data))
                    if attempt.hedged:
                        self._metrics.record("hedge_wins_total")
                else:
                    self._metrics.record("hedges_discarded_total")
                    if attempt.span.recording:
                        attempt.span.set("discarded", True)
                        attempt.span.set("body_crc32", _crc(attempt.data))
            else:
                if self.winner is not None and self.launched > 1:
                    # the loser of a hedge race that ended in failure is
                    # still a duplicate completion to account for
                    self._metrics.record("hedges_discarded_total")
                    if attempt.span.recording:
                        attempt.span.set("discarded", True)
                self.failures.append(attempt)
            self._cv.notify_all()

    def wait(self, timeout: Optional[float]) -> bool:
        """Wait until a winner exists or every launched attempt finished.
        Returns True when settled."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self.winner is None and self.finished < self.launched:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True


class FleetRouter:
    """HTTP front end over a worker fleet.

    ``fleet`` is anything with ``endpoints() -> {worker_id: "host:port"}``
    (:class:`StaticFleet`, or a supervisor of worker processes; rolling
    deploys additionally need its ``restart_worker``).

    Hedging: a request unanswered after ``hedge_delay_s()`` — the
    measured p99 forward latency times ``hedge_factor``, clamped to
    ``[hedge_min_ms, hedge_max_ms]``, or ``hedge_initial_ms`` until
    ``hedge_warm_count`` responses have been observed — is duplicated to
    the next-ranked worker. ``hedge_enabled=False`` disables it.
    """

    def __init__(self, fleet, default_timeout_ms: Optional[float] = None,
                 hedge_enabled: bool = True, hedge_factor: float = 1.0,
                 hedge_min_ms: float = 10.0, hedge_max_ms: float = 1000.0,
                 hedge_initial_ms: float = 75.0, hedge_warm_count: int = 32,
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 1.0,
                 connect_timeout_s: float = 2.0,
                 no_deadline_timeout_s: float = 60.0,
                 residency_refresh_s: float = 1.0,
                 slo: Optional[SLOMonitor] = None,
                 router_id: str = "router",
                 shm_enabled: Optional[bool] = None,
                 shm_min_bytes: int = wire.SHM_MIN_BYTES):
        self._fleet = fleet
        #: identity in a replicated router tier: the key this
        #: router registers under in the shared config's router roster,
        #: and what peers report it as
        self.router_id = str(router_id)
        #: shared FleetConfig (attach_config): peer discovery + the
        #: idempotency ledger config-versioned levers claim through
        self._config = None
        self._peer_view: Dict[str, Dict[str, Any]] = {}
        self.default_timeout_ms = default_timeout_ms
        self.hedge_enabled = bool(hedge_enabled)
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_ms = float(hedge_min_ms)
        self.hedge_max_ms = float(hedge_max_ms)
        self.hedge_initial_ms = float(hedge_initial_ms)
        self.hedge_warm_count = int(hedge_warm_count)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.no_deadline_timeout_s = float(no_deadline_timeout_s)
        # keep-alive connection pool: EVERY router HTTP —
        # forwards, probes, scrapes, sessions, shadows — reuses sockets
        # instead of paying TCP setup per hop; invalidated per endpoint
        # on connection faults, breaker opens, and worker restarts
        self.pool = wire.ConnectionPool()
        # colocated shared-memory fast path: large binary
        # payloads to 127.0.0.1 workers ride a shm segment instead of
        # the loopback socket; DL4J_TPU_NO_SHM (or shm_enabled=False)
        # forces the socket path
        if shm_enabled is None:
            shm_enabled = not os.environ.get("DL4J_TPU_NO_SHM")
        self.shm_enabled = bool(shm_enabled)
        self.shm_min_bytes = int(shm_min_bytes)
        self.metrics = RouterMetrics()
        # fleet-wide SLO attainment + burn rates: the router
        # sees every client request whichever worker serves it, so ITS
        # monitor is the per-model fleet-wide signal the SLOAutoscaler
        # consumes (rendered on /metrics next to the worker aggregation;
        # injectable so drills can run short burn windows)
        self.slo = slo or SLOMonitor()
        # the attached SLOAutoscaler, serving /v1/autoscaler
        self.autoscaler = None
        # the attached AnomalyWatchdog: ticked by the probe
        # loop, rendered on /metrics, snapshotted into the debug bundle
        self.watchdog = None
        # placement view: {worker_id: {"models": {name: state},
        # "headroom_bytes": int|None}} refreshed by the probe loop from
        # the workers' /v1/capacity residency sections — what makes
        # ranked_workers() route cold-model traffic to the worker that
        # has the model RESIDENT (or the most eviction-free headroom)
        self.residency_refresh_s = float(residency_refresh_s)
        self._residency_view: Dict[str, Dict[str, Any]] = {}
        self._last_residency_refresh = 0.0
        self._views: Dict[str, WorkerView] = {}
        self._views_lock = threading.Lock()  # guards: _views
        # session affinity: {f"{model}/{sid}": worker_id}.
        # Local cache of the pins published through the shared config —
        # another router (or this one after a restart) adopts a pin from
        # cfg["sessions"] instead of re-deriving it, so a session never
        # ping-pongs between workers across router failover.
        self._session_pins: Dict[str, str] = {}
        self._pins_lock = threading.Lock()  # guards: _session_pins
        # gated delivery: the active per-deploy controller the
        # request path consults (shadow mirrors, canary picks), plus the
        # last finished drill's report for /v1/delivery
        self._delivery = None
        self._last_delivery_report: Optional[Dict[str, Any]] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._prober: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.port: Optional[int] = None
        self._sync_views()

    # ------------------------------------------------------------ fleet view
    def _sync_views(self) -> None:
        """Reconcile worker views with the fleet's current endpoints: new
        workers appear STARTING (not ready until probed), a restarted
        worker (same id, new address) gets a fresh breaker and must
        re-prove readiness, removed workers disappear."""
        endpoints = self._fleet.endpoints()
        with self._views_lock:
            for wid, addr in endpoints.items():
                view = self._views.get(wid)
                if view is None:
                    self._views[wid] = WorkerView(wid, addr)
                elif view.address != addr:
                    fresh = WorkerView(wid, addr)
                    fresh.draining = view.draining
                    fresh.candidate = view.candidate
                    self._views[wid] = fresh
                    # pooled keep-alives to the old address are dead
                    # weight at best, a stranger at worst
                    self.pool.invalidate(view.address)
            for wid in list(self._views):
                if wid not in endpoints:
                    self.pool.invalidate(self._views[wid].address)
                    del self._views[wid]

    def workers(self) -> Dict[str, WorkerView]:
        with self._views_lock:
            return dict(self._views)

    def ranked_workers(self, model: str) -> List[WorkerView]:
        """Every worker view, ranked for ``model``: rendezvous
        (highest-random-weight) hashing — deterministic, so one model's
        traffic concentrates on the same healthy worker across requests
        (and across router restarts) — refined by PLACEMENT when the
        fleet pages models: workers with the model RESIDENT
        rank first (rendezvous order among them), then cold workers by
        eviction-free headroom (budget minus resident bytes; an
        unbudgeted worker counts as infinite — loading there evicts
        nothing). Fleets whose residency view never mentions ``model``
        keep pure rendezvous order, so non-paging deployments are
        untouched."""
        def score(wid: str) -> int:
            h = hashlib.blake2b(f"{model}|{wid}".encode(), digest_size=8)
            return int.from_bytes(h.digest(), "big")
        views = self.workers()
        order = sorted(views, key=score, reverse=True)
        rv = getattr(self, "_residency_view", None)
        if rv and any(model in (rv.get(w) or {}).get("models", {})
                      for w in order):
            def placement(wid: str):
                info = rv.get(wid) or {}
                models = info.get("models", {})
                if models.get(model) == "resident":
                    return (0, 0.0)
                if model not in models:
                    # this worker does not KNOW the model (or reported no
                    # residency at all): it would 404 — terminal, no
                    # failover — so it must rank LAST, never outrank a
                    # cold-registered worker
                    return (2, 0.0)
                h = info.get("headroom_bytes")
                return (1, -(float("inf") if h is None else float(h)))
            order = sorted(order, key=placement)  # stable: rendezvous ties
        return [views[wid] for wid in order]

    def _refresh_residency(self) -> None:
        """Refresh the placement view from every ready worker's
        ``/v1/capacity`` residency section (throttled to
        ``residency_refresh_s`` by the probe loop; stale entries for
        vanished workers drop out). Workers without a residency section
        (stubs, older payloads) simply stay out of the view — ranking
        falls back to pure rendezvous."""
        view: Dict[str, Dict[str, Any]] = {}
        try:
            for wid, payload in self._scrape_workers("/v1/capacity").items():
                res = payload.get("residency")
                if not isinstance(res, dict):
                    continue
                models = {str(m): d.get("state")
                          for m, d in (res.get("models") or {}).items()
                          if isinstance(d, dict)}
                budget = res.get("hbm_budget_bytes")
                headroom = (None if budget is None else
                            int(budget) - int(res.get("resident_bytes", 0)))
                view[wid] = {"models": models, "headroom_bytes": headroom}
        except Exception:
            logger.exception("residency refresh failed; keeping last view")
            return
        self._residency_view = view

    def hedge_delay_s(self) -> float:
        """The p99-derived hedge trigger (see class docstring)."""
        hist = self.metrics.request_latency
        if hist.count < self.hedge_warm_count:
            ms = self.hedge_initial_ms
        else:
            ms = hist.percentile(99) * 1000.0 * self.hedge_factor
        return min(self.hedge_max_ms, max(self.hedge_min_ms, ms)) / 1000.0

    # ------------------------------------------------------------- probing
    def _probe_worker(self, view: WorkerView) -> bool:
        status, _, _ = self._http(view.address, "GET", "/readyz",
                                  timeout=self.probe_timeout_s)
        return status == 200

    def _probe_cycle(self) -> None:
        self._sync_views()
        for view in self.workers().values():
            was_ready = view.ready
            try:
                view.ready = self._probe_worker(view)
            except Exception:
                view.ready = False
            if view.ready != was_ready:
                # readiness TRANSITIONS are journal events:
                # kill -> unready and restart -> readmit are the
                # bookends of the incident drill's timeline. Each gets
                # its own flagged span so the event is trace-linked even
                # though no request context exists on the probe thread.
                sp = (trace.server_span("router.worker_transition")
                      if trace.enabled() else trace.NOOP)
                with sp:
                    if sp.recording:
                        sp.flag("fleet")
                        sp.set("worker", view.worker_id)
                        sp.set("ready", view.ready)
                    if view.ready:
                        journal.emit("router.worker_ready",
                                     worker=view.worker_id,
                                     address=view.address)
                    else:
                        journal.emit("router.worker_unready",
                                     worker=view.worker_id,
                                     address=view.address)
            if view.ready and not view.breaker_warmed:
                self._warm_start_breaker(view)
        wd = self.watchdog
        if wd is not None:
            wd.maybe_tick()
        now = time.monotonic()
        if now - self._last_residency_refresh >= self.residency_refresh_s:
            self._last_residency_refresh = now
            self._refresh_residency()
            self._refresh_peers()

    def _warm_start_breaker(self, view: WorkerView) -> None:
        """Warm-start a fresh :class:`WorkerView`'s passive breaker from
        the worker's own ``/v1/metricsz`` breaker states: a
        freshly (re)started router builds every breaker CLOSED, so
        without this it would happily route traffic into a worker its
        peers had already isolated — re-learning the failure streak at
        the clients' expense. One scrape decides: any model breaker the
        worker itself reports OPEN/HALF_OPEN pre-opens the router's
        passive breaker; re-admission then runs through the breaker's
        normal half-open probe, exactly as if this router had observed
        the failures first-hand."""
        try:
            status, _, data = self._http(view.address, "GET",
                                         "/v1/metricsz",
                                         timeout=self.probe_timeout_s)
        except Exception:
            return  # unreachable: the prober already handles that
        view.breaker_warmed = True
        if status != 200:
            return  # a stub without metricsz: nothing to adopt
        try:
            payload = json.loads(data.decode())
            states = {str((m.get("breaker") or {}).get("state"))
                      for m in (payload.get("models") or {}).values()
                      if isinstance(m, dict)}
        except Exception:
            return  # malformed payload: warm with no verdict to adopt
        if states & {"OPEN", "HALF_OPEN"}:
            view.breaker.warm_open()
            logger.warning(
                "worker %s reports open breaker(s) %s; warm-starting its "
                "passive breaker OPEN", view.worker_id,
                sorted(states & {"OPEN", "HALF_OPEN"}))

    # ----------------------------------------------------- config + peering
    def attach_config(self, config) -> None:
        """Attach the shared fleet config (any object with the JAX
        package's ``FleetConfig`` surface): enables peer discovery
        (``/v1/peers``, the ``/readyz`` peering section) and makes
        :meth:`rolling_deploy` idempotent + config-versioned through the
        applied-action ledger, so two live routers can never double-apply
        one deploy."""
        self._config = config

    def peers(self) -> Dict[str, str]:
        """Peer routers from the shared config's roster (everyone but
        us); empty without an attached config."""
        if self._config is None:
            return {}
        try:
            routers = self._config.routers()
        except Exception:
            return {}
        return {rid: addr for rid, addr in sorted(routers.items())
                if rid != self.router_id}

    def _refresh_peers(self) -> None:
        """Router-to-router ``/readyz`` peering: probe each peer on the
        residency-refresh cadence so any live router can answer "which of
        my peers is up" — the observability a supervisor or client needs
        to see a dead router from the survivors. Probes run CONCURRENTLY
        through the same fan-out helper as the worker scrapes: one hung
        peer (exactly what peering exists to surface) must not stall the
        probe loop that feeds the data path's own worker health."""
        peers = self.peers()
        view: Dict[str, Dict[str, Any]] = {
            rid: {"address": addr, "ready": False}
            for rid, addr in peers.items()}

        class _Peer:
            def __init__(self, rid, addr):
                self.worker_id = rid
                self.address = addr

        def probe(p):
            status, _, _ = self._http(p.address, "GET", "/readyz",
                                      timeout=self.probe_timeout_s)
            return status == 200

        results = self._fanout(
            probe, [_Peer(r, a) for r, a in peers.items()],
            self.probe_timeout_s)
        for rid, ok in results.items():
            view[rid]["ready"] = bool(ok)
        self._peer_view = view

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval_s):
            try:
                self._probe_cycle()
            except Exception:
                logger.exception("router probe cycle failed")

    # --------------------------------------------------------------- http
    def _http(self, address: str, method: str, path: str,
              body: Optional[bytes] = None,
              headers: Optional[Dict[str, str]] = None,
              timeout: Optional[float] = None
              ) -> Tuple[int, Dict[str, str], bytes]:
        # pooled keep-alive: a stale idle connection is
        # retried once on a fresh one inside the pool; a FRESH
        # connection's failure propagates exactly as the old
        # one-connection-per-request path did, so breaker evidence is
        # unchanged
        return self.pool.request(
            address, method, path, body=body, headers=headers,
            timeout=self.connect_timeout_s if timeout is None else timeout)

    # ------------------------------------------------------------ routing
    @staticmethod
    def _shed_window_ms(headers: Dict[str, str], body: bytes) -> float:
        h = {k.lower(): v for k, v in headers.items()}
        if "retry-after-ms" in h:
            try:
                return float(h["retry-after-ms"])
            except ValueError:
                pass
        if "retry-after" in h:
            try:
                return float(h["retry-after"]) * 1000.0
            except ValueError:
                pass
        try:
            ms = json.loads(body.decode()).get("retry_after_ms")
            return float(ms) if ms is not None else 0.0
        except Exception:
            return 0.0

    def _classify(self, attempt: _Attempt) -> None:
        """Feed an attempt's outcome into the worker's health view."""
        view = attempt.view
        if isinstance(attempt.error, _BreakerDeclined):
            return  # nothing was sent; neither fault nor success
        if attempt.error is not None:
            # connection-level fault: the worker is likely gone — fail
            # fast for subsequent requests; the prober re-admits it.
            # The readiness flip is journaled HERE (not only in the
            # probe loop): the data path usually sees a dead worker
            # first, and the probe's transition detector would then
            # find ready already False and record nothing.
            if view.ready:
                journal.emit("router.worker_unready",
                             worker=view.worker_id, address=view.address,
                             reason="connect_fault")
            view.ready = False
            view.breaker.record_failure()
            # any pooled keep-alive to this address shares whatever
            # killed this one — drop them all
            self.pool.invalidate(view.address)
            return
        if attempt.status == 503:
            # a load/health signal, not a worker fault: honor the shed
            # hint (Overloaded) or wait for the probe (circuit_open)
            window_ms = self._shed_window_ms(attempt.headers, attempt.data)
            if window_ms > 0:
                view.shed_until = max(view.shed_until,
                                      time.monotonic() + window_ms / 1000.0)
                journal.emit("router.shed_window", worker=view.worker_id,
                             window_ms=round(window_ms, 1))
            view.breaker.record_discard()
            return
        if attempt.status is not None and attempt.status >= 500:
            view.breaker.record_failure()
            if view.breaker.state is CircuitState.OPEN:
                # breaker open = stop talking to this worker; parked
                # keep-alives would outlive the verdict otherwise
                self.pool.invalidate(view.address)
            return
        view.breaker.record_success()

    @staticmethod
    def _error_reason(data: bytes) -> Optional[str]:
        try:
            return json.loads(data.decode()).get("reason")
        except Exception:
            return None

    def _send_attempt(self, view: WorkerView, name: str, body: bytes,
                      headers: Dict[str, str], timeout: Optional[float],
                      is_wire: bool) -> Tuple[int, Dict[str, str], bytes]:
        """One POST to one worker, choosing the transport: the colocated
        shared-memory fast path for large binary payloads (transparent
        inline resend on any shm trouble), else the pooled socket."""
        path = f"/v1/models/{name}/predict"
        if (is_wire and self.shm_enabled
                and view.address.startswith("127.0.0.1:")
                and len(body) >= self.shm_min_bytes):
            seg = None
            try:
                shm_body, seg = wire.frame_to_shm(
                    body, min_bytes=self.shm_min_bytes)
            except Exception:
                seg = None  # can't stage the segment: socket path
            if seg is not None:
                try:
                    status, h, data = self._http(
                        view.address, "POST", path, body=shm_body,
                        headers=headers, timeout=timeout)
                finally:
                    wire.release_shm(seg)
                if (status == 503 and
                        self._error_reason(data) == "wire_protocol_error"):
                    # the worker could not attach/validate the segment
                    # (or chaos rotted the re-framed bytes): resend the
                    # original, already-validated frame inline — the
                    # fast path must never cost an answer
                    self.metrics.record("shm_fallbacks_total")
                    return self._http(view.address, "POST", path,
                                      body=body, headers=headers,
                                      timeout=timeout)
                self.metrics.record("shm_hops_total")
                return status, h, data
        return self._http(view.address, "POST", path, body=body,
                          headers=headers, timeout=timeout)

    def _forward(self, race: _Race, view: WorkerView, name: str,
                 body: bytes, rid: str, deadline: Optional[float],
                 hedged: bool, span=trace.NOOP,
                 ctype: str = "application/json") -> None:
        """One attempt against one worker (runs on its own thread). When
        tracing, ``span`` is the attempt's ``router.attempt`` child span
        of the request's root — created by the CALLER before this thread
        launches, so the root can never finalize its trace while an
        attempt span is still unborn. Its span id rides
        ``X-Parent-Span-Id`` to the worker, whose ``worker.predict`` span
        parents to it, which is what lets the router-side aggregation
        merge the two processes' spans into one tree."""
        attempt = _Attempt(view, hedged)
        sp = span
        attempt.span = sp
        view.begin()
        t0 = time.monotonic()
        with sp:
            if sp.recording:
                sp.set("worker", view.worker_id)
                sp.set("hedged", hedged)
            try:
                chaos.inject("serving.router.forward")
                # consume the breaker slot only for attempts actually sent —
                # a half-open probe slot must never leak to a worker that was
                # merely *ranked* (that would wedge the breaker half-open)
                if not view.breaker.allow():
                    raise _BreakerDeclined(view.worker_id)
                remaining = None if deadline is None else deadline - t0
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("deadline expired before forward")
                send_body, send_ctype = body, ctype
                if ctype == wire.CONTENT_TYPE and view.wire_ok is False:
                    # cached negotiation verdict: this worker speaks
                    # JSON only — transcode the (already-validated)
                    # frame; dtype is pinned in the body so the answer
                    # stays bit-identical to the binary path
                    send_body, _tmo = wire.frame_to_json_body(body)
                    send_ctype = "application/json"
                headers = {"Content-Type": send_ctype,
                           "X-Request-Id": rid}
                if sp.recording:
                    headers["X-Trace-Id"] = sp.trace_id
                    headers["X-Parent-Span-Id"] = sp.span_id
                    if hedged:
                        # tail sampling decides per PROCESS: the worker
                        # can't see the router's hedge verdict, so the
                        # hedge attempt carries the flag and the worker's
                        # half of the trace self-keeps
                        headers["X-Trace-Flags"] = "hedged"
                if remaining is not None:
                    headers["X-Deadline-Ms"] = f"{remaining * 1000.0:.1f}"
                self.metrics.record_forward(view.worker_id)
                # a deadline-free request's socket timeout must cover a SLOW
                # predict, not just the connect — 2s here would misread a
                # healthy-but-busy worker as dead and cascade into 503s
                send_timeout = (self.no_deadline_timeout_s
                                if remaining is None else remaining + 0.25)
                status, resp_headers, data = self._send_attempt(
                    view, name, send_body, headers, send_timeout,
                    is_wire=send_ctype == wire.CONTENT_TYPE)
                if status == 415 and send_ctype == wire.CONTENT_TYPE:
                    # mid-stream downgrade: the worker declined binary
                    # RIGHT NOW (force-JSON restart, older build) —
                    # remember the verdict, transcode, and retry the
                    # SAME worker once within this attempt's budget
                    view.wire_ok = False
                    self.metrics.record("wire_downgrades_total")
                    journal.emit("router.wire_downgrade",
                                 worker=view.worker_id)
                    send_body, _tmo = wire.frame_to_json_body(body)
                    headers["Content-Type"] = "application/json"
                    status, resp_headers, data = self._http(
                        view.address, "POST",
                        f"/v1/models/{name}/predict", body=send_body,
                        headers=headers, timeout=send_timeout)
                elif status == 200 and send_ctype == wire.CONTENT_TYPE:
                    view.wire_ok = True
                attempt.status, attempt.headers, attempt.data = \
                    status, resp_headers, data
            except BaseException as e:
                attempt.error = e
            latency = time.monotonic() - t0
            self._classify(attempt)
            view.done(ok=attempt.status == 200,
                      latency_s=latency if attempt.status == 200 else None)
            if sp.recording:
                if attempt.error is not None:
                    sp.set("error", type(attempt.error).__name__)
                    if not isinstance(attempt.error, _BreakerDeclined):
                        sp.flag("fault")  # a failed attempt keeps the trace
                elif attempt.status is not None:
                    sp.set("status", attempt.status)
            # completion INSIDE the span scope: the race marks the winner
            # (bit-identity crc) or a discarded duplicate on this span
            # before it closes
            race.complete(attempt)

    def _eligible(self, ranked: List[WorkerView], tried: set,
                  now: float, span=trace.NOOP) -> List[WorkerView]:
        out = []
        for view in ranked:
            if view.worker_id in tried:
                continue
            if view.shedding(now):
                self.metrics.record("shed_skips_total")
                if span.recording:
                    span.event("shed_skip", worker=view.worker_id,
                               remaining_ms=round(
                                   (view.shed_until - now) * 1e3, 1))
                continue
            if view.admittable(now):
                out.append(view)
        return out

    def _launch(self, race: _Race, view: WorkerView, name: str, body: bytes,
                rid: str, deadline: Optional[float], hedged: bool,
                parent_span=trace.NOOP,
                ctype: str = "application/json") -> None:
        race.register_launch()
        # the attempt span is created HERE, on the handler thread, so the
        # request's trace counts it open before this thread even starts —
        # a root finishing first can then never split the trace in two
        sp = (parent_span.child("router.attempt") if parent_span.recording
              else trace.NOOP)
        threading.Thread(
            target=self._forward,
            args=(race, view, name, body, rid, deadline, hedged, sp, ctype),
            daemon=True, name=f"router-forward-{view.worker_id}").start()

    def _route_predict(self, name: str, raw: bytes, inbound_headers,
                       ctype: str = "application/json"
                       ) -> Tuple[int, Dict[str, str], bytes]:
        """The routing engine: ranked candidates -> hedged race ->
        failover loop until a terminal response or the deadline."""
        self.metrics.record("requests_total")
        t_start = time.monotonic()
        ctype = (ctype or "application/json").split(";")[0].strip()
        if ctype == wire.CONTENT_TYPE:
            # binary client: one full decode validates the
            # frame AT THE BOUNDARY (CRC over meta+payload — the router
            # never forwards rot) and yields timeout_ms without the JSON
            # path's full-body parse
            self.metrics.record("wire_requests_total")
            try:
                fr = wire.decode_frame(raw, expect_kind=wire.KIND_REQUEST)
                timeout_ms = fr.meta.get("timeout_ms",
                                         self.default_timeout_ms)
                fr.close()
            except wire.WireProtocolError as e:
                self.metrics.record_response(503, 0.0)
                return 503, {"Content-Type": "application/json"}, \
                    json.dumps({"error": "bad wire frame",
                                "reason": "wire_protocol_error",
                                "detail": str(e)}).encode()
        else:
            try:
                body = json.loads(raw.decode() or "{}")
                timeout_ms = body.get("timeout_ms", self.default_timeout_ms)
            except Exception:
                timeout_ms = self.default_timeout_ms
        inbound = {k: v for k, v in (inbound_headers or {}).items()}
        hdr_deadline = inbound.get("X-Deadline-Ms")
        if hdr_deadline is not None:
            try:
                hd = float(hdr_deadline)
                timeout_ms = hd if timeout_ms is None else min(timeout_ms, hd)
            except ValueError:
                pass
        deadline = (None if timeout_ms is None
                    else t_start + float(timeout_ms) / 1000.0)
        rid = inbound.get("X-Request-Id") or uuid.uuid4().hex
        ranked = self.ranked_workers(name)
        # gated delivery: the candidate worker never competes
        # for normal admission — it is pulled out of the ranking and
        # receives exactly the traffic the controller assigns it
        dc = self._delivery
        cand_view = None
        if dc is not None and dc.matches(name):
            cand_view = next((v for v in ranked
                              if v.worker_id == dc.candidate_worker), None)
            ranked = [v for v in ranked
                      if v.worker_id != dc.candidate_worker]
        tried: set = set()
        # the request's root span: attempt spans are its
        # children; the tail-sampling decision for the router's part of
        # the trace fires once the root AND every late child (a hedge
        # loser completing after the winner) have finished
        rsp = (trace.server_span("router.request",
                                 trace_id=inbound.get("X-Trace-Id"),
                                 parent_id=inbound.get("X-Parent-Span-Id"))
               if trace.enabled() else trace.NOOP)

        def finish(status: int, headers: Dict[str, str], data: bytes):
            latency_s = time.monotonic() - t_start
            self.metrics.record_response(status, latency_s)
            # a client-sent name must not grow fleet SLO state until it
            # has actually SERVED once (create only on 200) — otherwise
            # junk names during an outage could permanently occupy the
            # monitor's max_models slots and lock real models out of the
            # autoscaler signal; once tracked, failures count in full
            if status != 404:
                self.slo.record(name, ok=status == 200, latency_s=latency_s,
                                create=status == 200)
            headers = {k: v for k, v in headers.items()
                       if k.lower() not in _HOP_BY_HOP}
            headers["X-Request-Id"] = rid
            if rsp.recording:
                rsp.set("status", status)
                if status == 503:
                    rsp.flag("shed")
                elif status == 504:
                    rsp.flag("deadline")
                headers["X-Trace-Id"] = rsp.trace_id
            return status, headers, data

        def reply_json(status: int, obj: Dict[str, Any],
                       extra: Optional[Dict[str, str]] = None):
            return finish(status, {"Content-Type": "application/json",
                                   **(extra or {})},
                          json.dumps(obj).encode())

        with rsp:
            if rsp.recording:
                rsp.set("model", name)
                rsp.set("request_id", rid)
            if (cand_view is not None and cand_view.ready
                    and dc.take_canary()):
                # canary pick: one synchronous, NEVER-hedged
                # attempt against the candidate. A 200 serves the client
                # and feeds the canary's own SLO window; any failure is
                # absorbed — the request falls through to the incumbent
                # loop below, so the drill stays client-invisible.
                self.metrics.record("canary_requests_total")
                t_c = time.monotonic()
                race = _Race(self.metrics)
                race.register_launch()
                self._forward(race, cand_view, name, raw, rid, deadline,
                              hedged=False,
                              span=(rsp.child("router.attempt")
                                    if rsp.recording else trace.NOOP),
                              ctype=ctype)
                latency_c = time.monotonic() - t_c
                win = race.winner
                if win is not None and win.status == 200:
                    dc.observe_canary(ok=True, latency_s=latency_c)
                    if rsp.recording:
                        rsp.event("canary", worker=cand_view.worker_id)
                    return finish(win.status, win.headers, win.data)
                dc.observe_canary(ok=False, latency_s=latency_c)
                if rsp.recording:
                    rsp.event("canary_absorbed",
                              worker=cand_view.worker_id,
                              status=None if win is None else win.status)
            while True:
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    return reply_json(504, {
                        "error": "deadline exceeded",
                        "detail": f"request {rid} expired after "
                                  f"{(now - t_start) * 1000:.0f} ms spanning "
                                  f"{len(tried)} worker attempt(s)"})
                candidates = self._eligible(ranked, tried, now, span=rsp)
                if not candidates:
                    # a worker that shed THIS request is in `tried` but its
                    # shed window is still the actionable signal to surface
                    shed = [v for v in ranked if v.shedding(now)]
                    if shed:
                        wait_ms = min((v.shed_until - now) * 1000.0
                                      for v in shed)
                        return reply_json(503, {
                            "error": "overloaded", "reason": "overloaded",
                            "retry_after_ms": round(wait_ms, 1),
                            "detail": "every eligible worker is shedding"},
                            extra={"Retry-After-Ms": f"{wait_ms:.0f}"})
                    return reply_json(503, {
                        "error": "unavailable",
                        "reason": "no_healthy_workers",
                        "detail": f"no healthy worker for model {name!r} "
                                  f"({len(tried)} tried, "
                                  f"{len(ranked)} known)"})
                primary = candidates[0]
                hedge_view = candidates[1] if len(candidates) > 1 else None
                hedge_possible = self.hedge_enabled and hedge_view is not None
                race = _Race(self.metrics)
                if hedge_possible:
                    self._launch(race, primary, name, raw, rid, deadline,
                                 hedged=False, parent_span=rsp, ctype=ctype)
                else:
                    # no hedge can fire: run the attempt on the handler
                    # thread itself instead of paying a thread spawn per
                    # request just to block waiting on it
                    race.register_launch()
                    self._forward(race, primary, name, raw, rid, deadline,
                                  hedged=False,
                                  span=(rsp.child("router.attempt")
                                        if rsp.recording else trace.NOOP),
                                  ctype=ctype)
                tried.add(primary.worker_id)
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if hedge_possible:
                    delay = self.hedge_delay_s()
                    if remaining is not None:
                        delay = min(delay, max(0.0, remaining))
                    settled = race.wait(delay)
                    if not settled and race.winner is None:
                        chaos.inject("serving.router.hedge")
                        self.metrics.record("hedges_total")
                        journal.emit("router.hedge", model=name,
                                     request_id=rid,
                                     worker=hedge_view.worker_id,
                                     primary=primary.worker_id,
                                     delay_ms=round(delay * 1e3, 2))
                        if rsp.recording:
                            rsp.flag("hedged")
                            rsp.event("hedge",
                                      worker=hedge_view.worker_id,
                                      delay_ms=round(delay * 1e3, 2))
                        self._launch(race, hedge_view, name, raw, rid,
                                     deadline, hedged=True, parent_span=rsp,
                                     ctype=ctype)
                        tried.add(hedge_view.worker_id)
                race.wait(None if deadline is None
                          else max(0.0, deadline - time.monotonic()))
                if race.winner is not None:
                    win = race.winner
                    if (cand_view is not None and win.status == 200
                            and cand_view.ready and dc.take_shadow()):
                        # shadow mirror: an async duplicate to
                        # the candidate, compared off-path — it is never
                        # returned, never hedged, and never feeds the
                        # incumbents' breakers
                        self._launch_shadow(dc, cand_view, name, raw, rid,
                                            win.data,
                                            time.monotonic() - t_start,
                                            ctype=ctype)
                    return finish(win.status, win.headers, win.data)
                if race.finished < race.launched:
                    # deadline hit with attempts still in flight: their late
                    # completions are counted as discarded duplicates
                    return reply_json(504, {
                        "error": "deadline exceeded",
                        "detail": f"request {rid} expired with "
                                  f"{race.launched - race.finished} "
                                  f"attempt(s) still in flight"})
                # every launched attempt failed retryably -> fail over
                self.metrics.record("failovers_total", len(race.failures))
                journal.emit("router.failover", model=name, request_id=rid,
                             failed_attempts=len(race.failures),
                             workers=[a.view.worker_id
                                      for a in race.failures])
                if rsp.recording:
                    rsp.event("failover", failed_attempts=len(race.failures))

    # ------------------------------------------------------ gated delivery
    def _launch_shadow(self, dc, view: WorkerView, name: str, body: bytes,
                       rid: str, incumbent_body: bytes,
                       incumbent_latency_s: float,
                       ctype: str = "application/json") -> None:
        """Mirror one already-served request to the candidate on a
        detached thread. The comparison (top-1 agreement + latency
        delta) folds into the controller's :class:`ShadowComparator`;
        the response bytes ride through the ``serving.delivery.shadow``
        byte point CRC-framed, so injected wire rot is detected — a
        corrupt comparison counts against promotion, never silently
        passes."""
        self.metrics.record("shadow_mirrors_total")

        def run():
            t0 = time.monotonic()
            status, data, corrupt = 0, b"", False
            incumbent = incumbent_body
            try:
                chaos.inject("serving.delivery.shadow")
                status, resp_headers, data = self._http(
                    view.address, "POST", f"/v1/models/{name}/predict",
                    body=body,
                    headers={"Content-Type": ctype,
                             "X-Request-Id": rid, "X-Shadow": "1"},
                    timeout=self.no_deadline_timeout_s)
                if ctype == wire.CONTENT_TYPE:
                    # the comparator speaks JSON: decode binary
                    # responses to the JSON shape so shadow verdicts
                    # are protocol-invariant (a decode failure is a
                    # candidate protocol error, held against promotion)
                    incumbent = json.dumps(
                        wire.response_to_jsonable(incumbent_body)).encode()
                    if status == 200 and wire.CONTENT_TYPE in (
                            resp_headers.get("Content-Type", "")):
                        data = json.dumps(
                            wire.response_to_jsonable(data)).encode()
                framed = struct.pack("<I", zlib.crc32(data)) + data
                out = chaos.transform_bytes("serving.delivery.shadow",
                                            framed)
                if out is not framed:
                    if len(out) < 4:
                        corrupt = True
                    else:
                        (crc,) = struct.unpack("<I", out[:4])
                        data = out[4:]
                        corrupt = zlib.crc32(data) != crc
            except Exception:
                status = 0  # a connection fault is a candidate error
            diverged = dc.observe_shadow(
                incumbent, status, data, incumbent_latency_s,
                time.monotonic() - t0, corrupt=corrupt)
            if diverged:
                self.metrics.record("shadow_diverged_total")

        threading.Thread(
            target=run, daemon=True,
            name=f"router-forward-shadow-{view.worker_id}").start()

    # --------------------------------------------------------- session tier
    def _publish_pin(self, key: str, wid: str) -> None:
        with self._pins_lock:
            self._session_pins[key] = wid
        if self._config is not None:
            try:
                def fn(cfg):
                    pins = cfg.setdefault("sessions", {})
                    if pins.get(key) == wid:
                        return False  # no-op: don't burn a config version
                    pins[key] = wid
                self._config.mutate(fn)
            except Exception:
                logger.exception("session pin publication failed for %s",
                                 key)

    def _drop_pin(self, key: str) -> None:
        with self._pins_lock:
            self._session_pins.pop(key, None)
        if self._config is not None:
            try:
                def fn(cfg):
                    pins = cfg.setdefault("sessions", {})
                    if key not in pins:
                        return False
                    del pins[key]
                self._config.mutate(fn)
            except Exception:
                logger.exception("session pin removal failed for %s", key)

    def _pinned_worker(self, key: str) -> Optional[str]:
        with self._pins_lock:
            wid = self._session_pins.get(key)
        if wid is None and self._config is not None:
            try:
                wid = (self._config.snapshot().get("sessions")
                       or {}).get(key)
            except Exception:
                wid = None
            if wid is not None:
                with self._pins_lock:  # adopt the published pin
                    self._session_pins[key] = wid
        return wid

    def _session_target(self, name: str, sid: str):
        """The worker this session's traffic goes to: its pin while that
        worker is admittable, else a REPIN — session-key rendezvous over
        the admittable workers (deterministic, so two routers repin the
        same orphan identically), published through the shared config and
        journaled as ``session.migrate``. The repinned worker rehydrates
        the carry from the shared spill dir on the next step; nothing is
        dropped. Returns ``(view, migrated_from)``."""
        key = f"{name}/{sid}"
        wid = self._pinned_worker(key)
        now = time.monotonic()
        views = self.workers()
        view = views.get(wid) if wid is not None else None
        if view is not None and view.admittable(now):
            return view, None
        for cand in self.ranked_workers(key):
            if not cand.admittable(now):
                continue
            self._publish_pin(key, cand.worker_id)
            if wid is not None and cand.worker_id != wid:
                self.metrics.record("session_migrations_total")
                journal.emit("session.migrate", model=name, session=sid,
                             from_worker=wid, to_worker=cand.worker_id,
                             by=self.router_id)
            return cand, (wid if wid != cand.worker_id else None)
        return None, None

    def _route_session(self, method: str, path: str, name: str, sid: str,
                       op: str, raw: bytes, inbound_headers
                       ) -> Tuple[int, Dict[str, str], bytes]:
        """Session-tier routing: one pinned attempt at a time,
        NEVER hedged — a duplicated step would advance the carry twice
        and corrupt the stream; retries are safe only because the worker
        dedups by step index, and only after the previous attempt has
        FAILED, never concurrently with it. Connection-level faults fail
        over by repinning (the new worker rehydrates from the shared
        spill dir); everything else is relayed verbatim."""
        self.metrics.record("session_requests_total")
        t_start = time.monotonic()
        inbound = {k: v for k, v in (inbound_headers or {}).items()}
        timeout_ms = self.default_timeout_ms
        try:
            body = json.loads(raw.decode() or "{}")
            timeout_ms = body.get("timeout_ms", timeout_ms)
        except Exception:
            body = None
        hdr_deadline = inbound.get("X-Deadline-Ms")
        if hdr_deadline is not None:
            try:
                hd = float(hdr_deadline)
                timeout_ms = hd if timeout_ms is None else min(timeout_ms,
                                                               hd)
            except ValueError:
                pass
        deadline = (None if timeout_ms is None
                    else t_start + float(timeout_ms) / 1000.0)
        rid = inbound.get("X-Request-Id") or uuid.uuid4().hex
        if op == "create":
            # the router mints the session id so the pin exists BEFORE
            # the create reaches any worker — a crash between the two
            # leaves an unpinned create, never a pinned orphan the
            # client does not know about
            if not isinstance(body, dict):
                return (400, {"Content-Type": "application/json"},
                        json.dumps({"error": "malformed request body"})
                        .encode())
            sid = str(body.get("session_id") or uuid.uuid4().hex[:16])
            body["session_id"] = sid
            raw = json.dumps(body).encode()

        def finish(status, headers, data):
            self.metrics.record_response(status, time.monotonic() - t_start)
            headers = {k: v for k, v in headers.items()
                       if k.lower() not in _HOP_BY_HOP}
            headers["X-Request-Id"] = rid
            return status, headers, data

        tried: set = set()
        while True:
            now = time.monotonic()
            if deadline is not None and now >= deadline:
                return finish(504, {"Content-Type": "application/json"},
                              json.dumps({
                                  "error": "deadline exceeded",
                                  "detail": f"session request {rid} expired "
                                            f"after {len(tried)} "
                                            f"attempt(s)"}).encode())
            view, _ = self._session_target(name, sid)
            if view is None or view.worker_id in tried:
                return finish(503, {"Content-Type": "application/json"},
                              json.dumps({
                                  "error": "unavailable",
                                  "reason": "no_healthy_workers",
                                  "detail": f"no admittable worker for "
                                            f"session {sid!r} "
                                            f"({len(tried)} tried)"})
                              .encode())
            headers = {"Content-Type": "application/json",
                       "X-Request-Id": rid}
            remaining = None if deadline is None else deadline - now
            if remaining is not None:
                headers["X-Deadline-Ms"] = f"{remaining * 1000.0:.1f}"
            view.begin()
            t0 = time.monotonic()
            try:
                chaos.inject("serving.router.forward")
                status, resp_headers, data = self._http(
                    view.address, method, path, body=raw, headers=headers,
                    timeout=(self.no_deadline_timeout_s
                             if remaining is None else remaining + 0.25))
            except BaseException:
                # connection fault: the pinned worker is likely gone —
                # repin and retry (safe: the step never reached the
                # carry, or its effect is deduped by the step index)
                view.done(ok=False)
                if view.ready:
                    journal.emit("router.worker_unready",
                                 worker=view.worker_id,
                                 address=view.address,
                                 reason="connect_fault")
                view.ready = False
                view.breaker.record_failure()
                tried.add(view.worker_id)
                continue
            ok = 200 <= status < 300
            view.done(ok=ok, latency_s=(time.monotonic() - t0) if ok
                      else None)
            if ok:
                view.breaker.record_success()
            elif status >= 500 and status != 503:
                view.breaker.record_failure()
            if op == "close" and status in (200, 404):
                self._drop_pin(f"{name}/{sid}")
            return finish(status, dict(resp_headers), data)

    # ------------------------------------------------------------ lifecycle
    def drain(self, worker_id: str, timeout_s: float = 30.0) -> None:
        """Stop routing new requests to ``worker_id`` and wait for its
        in-flight requests (including hedge losers) to finish."""
        view = self.workers().get(worker_id)
        if view is None:
            raise KeyError(f"unknown worker {worker_id!r}")
        view.draining = True
        deadline = time.monotonic() + timeout_s
        while view.inflight > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        if view.inflight > 0:
            raise TimeoutError(
                f"drain of {worker_id!r} timed out with "
                f"{view.inflight} request(s) still in flight")

    def readmit(self, worker_id: str) -> None:
        view = self.workers().get(worker_id)
        if view is not None:
            view.draining = False

    def await_ready(self, worker_id: str, timeout_s: float = 120.0) -> float:
        """Poll ``worker_id``'s ``/readyz`` directly (no probe-cycle
        latency) until 200; returns the wait. The worker stays DRAINING
        in the router until :meth:`readmit`."""
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        while time.monotonic() < deadline:
            self._sync_views()
            view = self.workers().get(worker_id)
            if view is not None:
                try:
                    if self._probe_worker(view):
                        view.ready = True
                        return time.monotonic() - t0
                except Exception:
                    pass
            time.sleep(0.05)
        raise TimeoutError(f"worker {worker_id!r} not ready after "
                           f"{timeout_s:.0f}s")

    def rolling_deploy(self, archive: str, version: Optional[int] = None,
                       drain_timeout_s: float = 30.0,
                       ready_timeout_s: float = 120.0,
                       strategy: str = "all",
                       model: Optional[str] = None,
                       golden_set=None, delivery_config=None,
                       gate=None) -> Dict[str, Any]:
        """Zero-downtime deploy of ``archive`` across the fleet, one
        worker at a time: drain -> supervisor relaunch on the new archive
        (manifest-prewarmed) -> ``/readyz`` -> readmit. Requires a
        supervisor-backed fleet (``restart_worker``). Returns a per-worker
        report (ready wait, restarts).

        ``strategy`` picks the drill: ``"all"`` is the classic
        every-worker roll above; ``"gated"`` is the staged-promotion
        pipeline — golden-set gate (cold, before any swap), one candidate
        worker shadowing then canarying live traffic under its own SLO
        window, fleet-wide roll only on a promote verdict, automatic
        drain-back to the incumbent archive on any breach
        (:meth:`_gated_deploy`; ``model`` is required, ``golden_set`` /
        ``delivery_config`` / ``gate`` override the archive's sidecar
        and the stock knobs).

        With a shared config attached the deploy is
        IDEMPOTENT and config-versioned: the (archive, version) action is
        claimed in the applied-action ledger before any worker is
        touched, so the same deploy issued against two live routers runs
        exactly once — the loser returns a ``skipped`` report naming who
        applied it — and the completed deploy state is recorded in the
        config for every router (and every restarted router) to see."""
        if not hasattr(self._fleet, "restart_worker"):
            raise TypeError(
                "rolling_deploy needs a fleet that can relaunch workers "
                "(restart_worker); a StaticFleet cannot")
        if strategy == "gated":
            return self._gated_deploy(
                archive, version=version, model=model,
                golden_set=golden_set, delivery_config=delivery_config,
                gate=gate, drain_timeout_s=drain_timeout_s,
                ready_timeout_s=ready_timeout_s)
        if strategy != "all":
            raise ValueError(f"unknown deploy strategy {strategy!r} "
                             f"(expected 'all' or 'gated')")
        # the FULL path keys the claim: two different artifacts that
        # happen to share a filename must be two different actions
        action_id = (f"rolling_deploy:{os.path.abspath(archive)}"
                     f":v{version}")
        if self._config is not None:
            if not self._config.try_claim(
                    action_id, {"router": self.router_id,
                                "archive": archive, "version": version}):
                applied = self._config.applied(action_id)
                logger.info("rolling deploy %s already applied by %s; "
                            "skipping", action_id,
                            (applied or {}).get("router"))
                journal.emit("control.deploy_stage", stage="skipped",
                             archive=archive, version=version,
                             applied_by=(applied or {}).get("router"))
                return {"archive": archive, "version": version,
                        "skipped": True, "action_id": action_id,
                        "applied_by": applied}
            journal.emit("control.deploy_stage", stage="claimed",
                         archive=archive, version=version,
                         router=self.router_id)
        try:
            prewarm = getattr(self._fleet, "prewarm_manifest", None)
            if prewarm is not None:
                prewarm(archive)
            report: Dict[str, Any] = {"archive": archive, "workers": {}}
            # deploy over the SUPERVISOR's full roster, not just the live
            # views — a worker that is down mid-crash-relaunch right now
            # must still be moved to the new archive, or it comes back on
            # the old
            worker_ids = (sorted(self._fleet.worker_ids())
                          if hasattr(self._fleet, "worker_ids")
                          else sorted(self.workers()))
            for wid in worker_ids:
                # drain -> session fence (resident carries are
                # pushed to their spill files BEFORE the kill, so sessions
                # migrate instead of losing steps) -> relaunch -> readmit
                self._roll_worker(wid, archive, version,
                                  drain_timeout_s, ready_timeout_s, report)
        except BaseException:
            # a failed deploy must RELEASE its claim, or its own retry
            # (from any router) is skipped forever as "already applied"
            # while the fleet still runs the old archive
            if self._config is not None:
                try:
                    self._config.release_claim(action_id)
                except Exception:
                    logger.exception("claim rollback failed for %s",
                                     action_id)
            raise
        self.metrics.record("deploys_total")
        journal.emit("control.deploy_stage", stage="completed",
                     archive=archive, version=version,
                     workers=sorted(report["workers"]))
        if self._config is not None:
            try:
                def fn(cfg):
                    cfg["deploy"] = {"archive": archive, "version": version,
                                     "strategy": "all",
                                     "router": self.router_id,
                                     "action_id": action_id,
                                     "completed_at": time.time()}
                self._config.mutate(fn)
            except Exception:
                logger.exception("deploy-state publication failed")
        return report

    def _roll_worker(self, wid: str, archive: str, version,
                     drain_timeout_s: float, ready_timeout_s: float,
                     report: Dict[str, Any]) -> None:
        """One worker's classic roll step (drain -> session fence ->
        relaunch on ``archive`` -> ready -> readmit), shared by both
        deploy strategies."""
        if wid in self.workers():
            self.drain(wid, timeout_s=drain_timeout_s)
            view = self.workers().get(wid)
            if view is not None:
                try:
                    self._http(view.address, "POST", "/v1/sessions/drain",
                               body=b"{}",
                               headers={"Content-Type": "application/json"},
                               timeout=drain_timeout_s)
                except Exception:
                    logger.info("session spill fence skipped for %s "
                                "(unreachable)", wid)
            journal.emit("control.deploy_stage", stage="drained",
                         worker=wid, archive=archive)
        try:
            self._fleet.restart_worker(wid, archive=archive,
                                       version=version)
            ready_s = self.await_ready(wid, timeout_s=ready_timeout_s)
        finally:
            self.readmit(wid)
        journal.emit("control.deploy_stage", stage="readmitted",
                     worker=wid, archive=archive,
                     ready_s=round(ready_s, 3))
        report["workers"][wid] = {"ready_s": round(ready_s, 3)}

    def _gated_deploy(self, archive: str, version=None,
                      model: Optional[str] = None, golden_set=None,
                      delivery_config=None, gate=None,
                      drain_timeout_s: float = 30.0,
                      ready_timeout_s: float = 120.0) -> Dict[str, Any]:
        """The ``strategy="gated"`` pipeline (``docs/fleet_serving.md``): golden-set gate (candidate loaded
        COLD through a real batcher, golden side answered by the live
        incumbents through this router — before any worker is touched),
        then one candidate worker earning traffic through shadow and
        ramped canary stages under its own SLO window, then either a
        fleet-wide roll (promote) or an automatic drain-back to the
        incumbent archive (rollback — returned as a ``rolled_back``
        report, not raised: a rollback is the pipeline WORKING). Gate
        failure raises; the incumbent never stops serving either way."""
        from deeplearning4j_tpu_torch.serving import delivery as dmod
        import numpy as np
        if model is None:
            raise TypeError("gated deploy needs the model name the "
                            "archive serves (model=...)")
        if not hasattr(self._fleet, "worker_archive"):
            raise TypeError(
                "gated deploy needs a fleet exposing worker_archive() — "
                "rollback must know the incumbent artifact to restore")
        action_id = f"gated_deploy:{os.path.abspath(archive)}:v{version}"
        if self._config is not None:
            if not self._config.try_claim(
                    action_id, {"router": self.router_id,
                                "archive": archive, "version": version,
                                "strategy": "gated"}):
                applied = self._config.applied(action_id)
                logger.info("gated deploy %s already applied by %s; "
                            "skipping", action_id,
                            (applied or {}).get("router"))
                journal.emit("control.deploy_stage", stage="skipped",
                             archive=archive, version=version,
                             applied_by=(applied or {}).get("router"))
                return {"archive": archive, "version": version,
                        "skipped": True, "action_id": action_id,
                        "applied_by": applied}
            journal.emit("control.deploy_stage", stage="claimed",
                         archive=archive, version=version,
                         router=self.router_id, strategy="gated")
        dc = None
        try:
            # ---- stage 1: golden-set gate, before any swap -------------
            try:
                gs = golden_set or dmod.GoldenSet.for_archive(archive)
                if gs is None:
                    raise dmod.GateRefused(
                        f"gated deploy of {archive!r} has no golden set: "
                        f"declare one per-archive "
                        f"({dmod.GoldenSet.sidecar(archive)!r}) or pass "
                        f"golden_set= — an ungated swap is refused")
            except dmod.GateFailed as e:
                # a sidecar that cannot be trusted is a verdict too
                journal.emit("delivery.gate", model=model, archive=archive,
                             version=version, verdict="refused",
                             report=getattr(e, "report", {}))
                raise
            g = gs.gate(default=gate)

            def golden_fn(x):
                raw = json.dumps(
                    {"inputs": np.asarray(x).tolist()}).encode()
                status, _, data = self._route_predict(model, raw, {})
                if status != 200:
                    raise dmod.GateRefused(
                        f"golden side unavailable (incumbent fleet "
                        f"answered {status}) — the gate cannot run; "
                        f"deploy refused")
                return np.asarray(json.loads(data.decode())["outputs"])

            from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
            cold = ModelRegistry()
            try:
                served = cold.load(model, archive, save_manifest=False)
                report_g = g.check(
                    None, None, gs.inputs, labels=gs.labels,
                    golden_fn=golden_fn,
                    candidate_fn=lambda x: np.asarray(served.predict(x)))
            except dmod.GateFailed as e:
                journal.emit(
                    "delivery.gate", model=model, archive=archive,
                    version=version,
                    verdict=("refused" if isinstance(e, dmod.GateRefused)
                             else "fail"),
                    report=getattr(e, "report", {}))
                raise
            finally:
                try:
                    cold.shutdown()
                except Exception:
                    pass
            journal.emit("delivery.gate", model=model, archive=archive,
                         version=version, verdict="pass", report=report_g)

            # ---- stage 2+3: one candidate worker, shadow then canary ---
            prewarm = getattr(self._fleet, "prewarm_manifest", None)
            if prewarm is not None:
                prewarm(archive)
            report: Dict[str, Any] = {"archive": archive,
                                      "version": version,
                                      "strategy": "gated",
                                      "action_id": action_id,
                                      "workers": {}}
            worker_ids = sorted(self._fleet.worker_ids())
            cand_wid = worker_ids[0]
            incumbent_archive = self._fleet.worker_archive(cand_wid)
            dc = dmod.DeliveryController(
                model, archive, version, cand_wid,
                config=delivery_config, gate_report=report_g)
            # flag BEFORE the roll: _sync_views carries the flag across
            # the restart's address change and _roll_worker's readmit
            # then cannot hand the unproven candidate full traffic
            cv = self.workers().get(cand_wid)
            if cv is not None:
                cv.candidate = True
            self._roll_worker(cand_wid, archive, version,
                              drain_timeout_s, ready_timeout_s, report)
            cand_view = self.workers().get(cand_wid)
            if cand_view is not None:
                cand_view.candidate = True
            dc.transition("shadow")
            self._delivery = dc
            while not dc.decided:
                dc.tick()
                time.sleep(0.005)

            if dc.stage == "promote_ready":
                # ---- promote: candidate joins, the rest roll ----------
                self._delivery = None
                if cand_view is not None:
                    cand_view.candidate = False
                for wid in worker_ids[1:]:
                    self._roll_worker(wid, archive, version,
                                      drain_timeout_s, ready_timeout_s,
                                      report)
                dc.finish_promoted()
                self.metrics.record("deploys_total")
                journal.emit("control.deploy_stage", stage="completed",
                             archive=archive, version=version,
                             strategy="gated",
                             workers=sorted(report["workers"]))
                if self._config is not None:
                    try:
                        def fn(cfg):
                            cfg["deploy"] = {
                                "archive": archive, "version": version,
                                "strategy": "gated",
                                "router": self.router_id,
                                "action_id": action_id,
                                "completed_at": time.time()}
                        self._config.mutate(fn)
                    except Exception:
                        logger.exception("deploy-state publication failed")
                report["verdict"] = "promoted"
                report["delivery"] = dc.snapshot()
                return report

            # ---- rollback: drain the canary back to the incumbent -----
            # (a successful DEFENSE, reported not raised: the claim is
            # released so a fixed candidate can retry the same action)
            self._delivery = None
            self._roll_worker(cand_wid, incumbent_archive, None,
                              drain_timeout_s, ready_timeout_s, report)
            cand_view = self.workers().get(cand_wid)
            if cand_view is not None:
                cand_view.candidate = False
            dc.finish_rolled_back()
            self.metrics.record("rollbacks_total")
            if self._config is not None:
                try:
                    self._config.release_claim(action_id)
                except Exception:
                    logger.exception("claim rollback failed for %s",
                                     action_id)
            report["verdict"] = "rolled_back"
            report["cause"] = dc.rollback_cause
            report["delivery"] = dc.snapshot()
            return report
        except BaseException:
            self._delivery = None
            for v in self.workers().values():
                v.candidate = False
            if self._config is not None:
                try:
                    self._config.release_claim(action_id)
                except Exception:
                    logger.exception("claim rollback failed for %s",
                                     action_id)
            raise
        finally:
            if dc is not None:
                self._last_delivery_report = dc.snapshot()

    # ------------------------------------------- fleet scrape + trace merge
    def _fanout(self, fn, views, timeout_s: float,
                name: str = "trace-collector"):
        """Run ``fn(view)`` against every view concurrently (one short-
        lived thread per worker, joined before return — the conftest
        thread-leak guard watches the ``trace-collector`` prefix).
        Returns ``{worker_id: result}`` for the calls that returned
        non-None without raising."""
        results: Dict[str, Any] = {}
        lock = threading.Lock()  # guards: (results dict merge)

        def run(v):
            try:
                r = fn(v)
            except Exception:
                return  # an unreachable worker just drops out of the merge
            if r is not None:
                with lock:
                    results[v.worker_id] = r

        threads = [threading.Thread(target=run, args=(v,), daemon=True,
                                    name=f"{name}-{v.worker_id}")
                   for v in views]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout_s + 1.0)
        return results

    def _scrape_workers(self, path: str = "/v1/metricsz"
                        ) -> Dict[str, Dict[str, Any]]:
        """Every ready worker's JSON payload at ``path`` (``/v1/metricsz``
        counters + raw-bucket histograms, or the ``/v1/capacity``
        ledger), fetched in parallel."""
        views = [v for v in self.workers().values() if v.ready]

        def fetch(v):
            status, _, data = self._http(v.address, "GET", path,
                                         timeout=self.probe_timeout_s)
            return json.loads(data.decode()) if status == 200 else None

        return self._fanout(fetch, views, self.probe_timeout_s)

    def attach_autoscaler(self, autoscaler) -> None:
        """Register the autoscaler driving this router (any object with a
        ``snapshot()``, as the JAX package's ``SLOAutoscaler``) so
        ``/v1/autoscaler`` serves its decision log."""
        self.autoscaler = autoscaler

    def attach_watchdog(self, watchdog) -> None:
        """Register an :class:`~deeplearning4j_tpu_torch.serving.blackbox
        .AnomalyWatchdog`: the probe loop ticks it on the
        control cadence, its incident gauges render on ``/metrics``, and
        its state rides into ``/v1/debug/bundle``."""
        self.watchdog = watchdog

    def fleet_journal(self, since: Optional[float] = None,
                      limit: Optional[int] = None,
                      types=None):
        """The fleet's merged event timeline: this router's
        journal plus every ready worker's ``/v1/journal``, merged
        wall-anchor-first (``journal.merge_events`` — a restarted
        worker's seq reset cannot reorder the view) and bounded exactly
        like ``/v1/traces``. Filters are forwarded to the workers so the
        fan-out fetch stays bounded, then re-applied after the merge.
        Returns ``(events, truncated)``."""
        params = []
        if since is not None:
            params.append(f"since={float(since)}")
        if limit is not None:
            params.append(f"limit={int(limit)}")
        if types:
            params.append("type=" + ",".join(sorted(types)))
        path = "/v1/journal" + ("?" + "&".join(params) if params else "")
        streams = [journal.events(since=since, limit=limit, types=types)]
        worker_truncated = False
        for payload in self._scrape_workers(path).values():
            streams.append(payload.get("events") or [])
            worker_truncated = worker_truncated or \
                bool(payload.get("truncated"))
        merged = journal.merge_events(streams)
        bounded, truncated = journal.bound_events(
            merged, since=since, limit=limit, types=types)
        return bounded, truncated or worker_truncated

    def fleet_capacity(self) -> Dict[str, Any]:
        """Fleet-wide capacity aggregation: every
        ready worker's ``/v1/capacity`` ledger, aggregated the same way
        ``/v1/metricsz`` is — bytes/counters SUMMED per model,
        utilization carried as summed (busy_s, window_s) pairs divided
        once at the edge, dispatch histograms bucket-MERGED (percentiles
        of the merged histogram, never averaged percentiles). The
        per-worker payloads ride along under ``workers`` so the
        autoscaler's capacity guard can check the one worker it would
        scale."""
        scraped = self._scrape_workers("/v1/capacity")
        models: Dict[str, Dict[str, Any]] = {}
        hists: Dict[str, LatencyHistogram] = {}
        budget = in_use = None
        hbm_budget = resident_bytes = None
        placement: Dict[str, Dict[str, List[str]]] = {}
        paging_totals = {"page_ins_total": 0, "evictions_total": 0,
                         "page_in_queue_waits_total": 0,
                         "page_in_rejections_total": 0,
                         "page_in_failures_total": 0,
                         "resident_hits_total": 0, "cold_hits_total": 0}
        sessions_agg: Optional[Dict[str, Any]] = None
        util_agg = {"busy_s": 0.0, "harvested_busy_s": 0.0,
                    "device_window_s": 0.0, "replicas": 0}
        for wid, payload in sorted(scraped.items()):
            # idle-signal aggregation: the raw
            # summable busy/window terms are summed across workers and
            # the fractions derived ONCE at the edge, never averaged
            wu = payload.get("utilization")
            if isinstance(wu, dict):
                try:
                    inc_util = {
                        "busy_s": float(wu.get("busy_s", 0.0)),
                        "harvested_busy_s":
                            float(wu.get("harvested_busy_s", 0.0)),
                        "device_window_s":
                            float(wu.get("device_window_s", 0.0)),
                        "replicas": int(wu.get("replicas", 0))}
                except (TypeError, ValueError):
                    pass  # malformed utilization: skip, never the scrape
                else:
                    for k, v in inc_util.items():
                        util_agg[k] += v
            # session aggregation: residency/counters SUMMED;
            # spilled_files taken as the MAX because the spill dir is
            # shared fleet-wide — every worker counts the same files
            ses = payload.get("sessions")
            if isinstance(ses, dict):
                try:
                    inc_tracked = int(ses.get("tracked", 0))
                    inc_resident = int(ses.get("resident", 0))
                    inc_bytes = int(ses.get("resident_bytes", 0))
                    inc_spilled = int(ses.get("spilled_files", 0))
                    inc_counters = {
                        k: int(v)
                        for k, v in sorted((ses.get("counters")
                                            or {}).items())}
                except (TypeError, ValueError):
                    pass  # malformed sessions block: skip, never the scrape
                else:
                    if sessions_agg is None:
                        sessions_agg = {"tracked": 0, "resident": 0,
                                        "resident_bytes": 0,
                                        "spilled_files": 0, "counters": {}}
                    sessions_agg["tracked"] += inc_tracked
                    sessions_agg["resident"] += inc_resident
                    sessions_agg["resident_bytes"] += inc_bytes
                    sessions_agg["spilled_files"] = max(
                        sessions_agg["spilled_files"], inc_spilled)
                    for k, v in inc_counters.items():
                        sessions_agg["counters"][k] = (
                            sessions_agg["counters"].get(k, 0) + v)
            # residency aggregation: budgets/resident bytes
            # summed, per-model worker placement lists, paging counters
            res = payload.get("residency")
            if isinstance(res, dict):
                try:
                    if res.get("hbm_budget_bytes") is not None:
                        hbm_budget = ((hbm_budget or 0)
                                      + int(res["hbm_budget_bytes"]))
                    resident_bytes = ((resident_bytes or 0)
                                      + int(res.get("resident_bytes", 0)))
                    for m, d in sorted((res.get("models") or {}).items()):
                        slot = placement.setdefault(
                            m, {"resident_workers": [], "cold_workers": []})
                        key = ("resident_workers"
                               if d.get("state") == "resident"
                               else "cold_workers")
                        slot[key].append(wid)
                    pg = res.get("paging") or {}
                    for k in paging_totals:
                        paging_totals[k] += int(pg.get(k, 0))
                except (TypeError, ValueError):
                    pass  # malformed residency: skip it, never the scrape
            proc = payload.get("process") or {}
            if proc.get("device_budget_bytes") is not None:
                budget = (budget or 0) + int(proc["device_budget_bytes"])
            if proc.get("device_in_use_bytes") is not None:
                in_use = (in_use or 0) + int(proc["device_in_use_bytes"])
            for model, c in sorted((payload.get("models") or {}).items()):
                # parse the WHOLE entry first, apply increments only
                # after: a malformed field must skip the entry entirely,
                # not leave its bytes counted with zero busy time (which
                # would skew busy_fraction low — the very signal the
                # autoscaler's guard reads)
                try:
                    inc = {
                        "param_bytes": int(c["param_bytes"]),
                        "device_bytes_total": int(c["device_bytes_total"]),
                        "replicas": int(c["replicas"]),
                        "workers": 1,
                        "busy_s": float(c["utilization"]["busy_s"]),
                        "window_s": float(c["utilization"]["window_s"]),
                        "queue_depth": int(c["queue"]["depth"]),
                        "queue_headroom_requests":
                            int(c["queue"]["headroom_requests"]),
                        "aot_executables": int(c["aot_executables"]),
                    }
                    # drain-rate flatten: each
                    # worker's measured admission-queue drain estimate
                    # becomes a fleet-summed requests/s capacity figure
                    # the autoscaler's forecast blends with the
                    # utilization-implied serveable rate. Optional field
                    # (older payloads / no drain sample yet): missing or
                    # non-positive contributes 0, never skips the entry.
                    dm = c["queue"].get("drain_ms_per_request")
                    try:
                        inc["drain_rate_rps"] = (
                            1000.0 / float(dm)
                            if dm is not None and float(dm) > 0 else 0.0)
                    except (TypeError, ValueError):
                        inc["drain_rate_rps"] = 0.0
                    wire = c.get("dispatch_latency")
                    h = LatencyHistogram.from_wire(wire) if wire else None
                    if h is not None:
                        # merge checks bucket-bounds compatibility BEFORE
                        # mutating, so a raise here leaves hists untouched
                        if model in hists:
                            hists[model].merge(h)
                        else:
                            hists[model] = h
                except (KeyError, TypeError, ValueError):
                    continue  # malformed worker entry: skip, never break
                a = models.setdefault(model, {
                    "param_bytes": 0, "device_bytes_total": 0,
                    "replicas": 0, "workers": 0, "busy_s": 0.0,
                    "window_s": 0.0, "queue_depth": 0,
                    "queue_headroom_requests": 0, "aot_executables": 0,
                    "drain_rate_rps": 0.0})
                for k, v in inc.items():
                    a[k] += v
        for model, a in models.items():
            a["busy_fraction"] = round(
                a["busy_s"] / a["window_s"], 6) if a["window_s"] else 0.0
            a["drain_rate_rps"] = round(a["drain_rate_rps"], 4)
            h = hists.get(model)
            if h is not None:
                a["dispatch_p50_s"] = h.percentile(50)
                a["dispatch_p99_s"] = h.percentile(99)
                a["dispatch_count"] = h.count
        dw = util_agg["device_window_s"]
        util_agg["serving_busy_fraction"] = round(
            util_agg["busy_s"] / dw, 6) if dw > 0 else 0.0
        util_agg["device_idle_fraction"] = round(max(
            0.0, 1.0 - (util_agg["busy_s"] + util_agg["harvested_busy_s"])
            / dw), 6) if dw > 0 else 1.0
        util_agg["busy_s"] = round(util_agg["busy_s"], 6)
        util_agg["harvested_busy_s"] = round(
            util_agg["harvested_busy_s"], 6)
        util_agg["device_window_s"] = round(dw, 3)
        out = {
            "workers": scraped,
            "models": models,
            "process": {"device_budget_bytes": budget,
                        "device_in_use_bytes": in_use},
            "utilization": util_agg,
        }
        if placement or hbm_budget is not None:
            out["residency"] = {
                "hbm_budget_bytes": hbm_budget,
                "resident_bytes": resident_bytes or 0,
                "models": placement,
                "paging": paging_totals,
            }
        if sessions_agg is not None:
            out["sessions"] = sessions_agg
        return out

    def render_fleet_capacity(self) -> str:
        """``fleet_capacity_*`` gauges for the router's ``/metrics``."""
        agg = self.fleet_capacity()
        lines = ["# TYPE fleet_capacity_param_bytes gauge"]
        for model, a in sorted(agg["models"].items()):
            lbl = f'{{model="{model}"}}'
            lines.append(f"fleet_capacity_param_bytes{lbl} "
                         f"{a['param_bytes']}")
            lines.append(f"fleet_capacity_device_bytes{lbl} "
                         f"{a['device_bytes_total']}")
            lines.append(f"fleet_capacity_replicas{lbl} {a['replicas']}")
            lines.append(f"fleet_capacity_workers{lbl} {a['workers']}")
            lines.append(f"fleet_capacity_utilization_busy_fraction{lbl} "
                         f"{a['busy_fraction']}")
            lines.append(f"fleet_capacity_queue_headroom_requests{lbl} "
                         f"{a['queue_headroom_requests']}")
            lines.append(f"fleet_capacity_drain_rate_rps{lbl} "
                         f"{a['drain_rate_rps']}")
            if "dispatch_p99_s" in a:
                lines.append(
                    f'fleet_capacity_dispatch_seconds{{model="{model}",'
                    f'quantile="0.99"}} {a["dispatch_p99_s"]}')
        util = agg.get("utilization") or {}
        if util:
            lines.append(f"fleet_capacity_device_busy_s "
                         f"{util['busy_s']}")
            lines.append(f"fleet_capacity_harvested_busy_s "
                         f"{util['harvested_busy_s']}")
            lines.append(f"fleet_capacity_device_window_s "
                         f"{util['device_window_s']}")
            lines.append(f"fleet_capacity_serving_busy_fraction "
                         f"{util['serving_busy_fraction']}")
            lines.append(f"fleet_capacity_device_idle_fraction "
                         f"{util['device_idle_fraction']}")
        proc = agg["process"]
        if proc.get("device_budget_bytes") is not None:
            lines.append(f"fleet_capacity_device_budget_bytes "
                         f"{proc['device_budget_bytes']}")
        res = agg.get("residency")
        if res:
            if res.get("hbm_budget_bytes") is not None:
                lines.append(f"fleet_capacity_hbm_budget_bytes "
                             f"{res['hbm_budget_bytes']}")
            lines.append(f"fleet_capacity_resident_bytes "
                         f"{res.get('resident_bytes', 0)}")
            for m, slot in sorted((res.get("models") or {}).items()):
                lines.append(
                    f'fleet_capacity_resident_workers{{model="{m}"}} '
                    f"{len(slot.get('resident_workers', []))}")
            pg = res.get("paging") or {}
            for counter in ("page_ins_total", "evictions_total",
                            "page_in_queue_waits_total",
                            "page_in_failures_total"):
                if counter in pg:
                    lines.append(f"fleet_capacity_{counter} {pg[counter]}")
        ses = agg.get("sessions")
        if ses:
            lines.append(f"fleet_capacity_sessions_tracked "
                         f"{ses.get('tracked', 0)}")
            lines.append(f"fleet_capacity_sessions_resident "
                         f"{ses.get('resident', 0)}")
            lines.append(f"fleet_capacity_sessions_resident_bytes "
                         f"{ses.get('resident_bytes', 0)}")
            lines.append(f"fleet_capacity_sessions_spilled_files "
                         f"{ses.get('spilled_files', 0)}")
            cs = ses.get("counters") or {}
            for counter in ("steps_total", "rehydrates_total",
                            "migrations_total", "lost_total"):
                if counter in cs:
                    lines.append(f"fleet_capacity_sessions_{counter} "
                                 f"{cs[counter]}")
        return "\n".join(lines) + "\n"

    def render_fleet_metrics(self) -> str:
        """Fleet-wide ``/metrics`` section: worker counters
        summed and latency histograms MERGED across the fleet (bucket
        merge — percentiles of the merged histogram, never averaged
        percentiles), per-worker series kept under a ``worker=`` label,
        plus the router's fleet-wide SLO attainment and burn rates. One
        scrape of the router sees the whole fleet."""
        scraped = self._scrape_workers()
        agg_counters: Dict[tuple, float] = {}
        agg_hists: Dict[str, LatencyHistogram] = {}
        per_worker = []
        for wid, payload in sorted(scraped.items()):
            for model, snap in sorted((payload.get("models") or {}).items()):
                for cname, v in sorted((snap.get("counters") or {}).items()):
                    if not isinstance(v, (int, float)):
                        continue  # malformed counter: skip, never break
                    per_worker.append(
                        f'fleet_serving_{cname}{{model="{model}",'
                        f'worker="{wid}"}} {v}')
                    key = (model, cname)
                    agg_counters[key] = agg_counters.get(key, 0) + v
                hist_wire = (snap.get("histograms")
                             or {}).get("request_latency")
                if not hist_wire:
                    continue
                try:
                    h = LatencyHistogram.from_wire(hist_wire)
                    if model in agg_hists:
                        agg_hists[model].merge(h)
                    else:
                        agg_hists[model] = h
                except (KeyError, ValueError, TypeError):
                    pass  # malformed snapshot: skip, never break the scrape
        lines = ["# TYPE fleet_serving_requests_total counter",
                 f"fleet_workers_scraped {len(scraped)}"]
        for (model, cname), v in sorted(agg_counters.items()):
            lines.append(f'fleet_serving_{cname}{{model="{model}"}} {v}')
        for model, h in sorted(agg_hists.items()):
            lines.append(f'fleet_serving_latency_count{{model="{model}"}} '
                         f"{h.count}")
            for q in (50, 99):
                lines.append(
                    f'fleet_serving_latency_seconds{{model="{model}",'
                    f'quantile="0.{q}"}} {h.percentile(q)}')
        lines.extend(per_worker)
        slo_text = self.slo.render_prometheus()
        if slo_text:
            lines.append(slo_text.rstrip("\n"))
        try:
            lines.append(self.render_fleet_capacity().rstrip("\n"))
        except Exception:
            pass  # capacity must never be able to break a scrape
        return "\n".join(lines) + "\n"

    def _render_pool_metrics(self) -> str:
        """Keep-alive pool gauges for the router's ``/metrics``
       : how much TCP setup the pool is actually saving."""
        s = self.pool.snapshot()
        return "\n".join([
            f"router_pool_idle_connections {s['idle_connections']}",
            f"router_pool_created_total {s['created_total']}",
            f"router_pool_reused_total {s['reused_total']}",
            f"router_pool_discarded_total {s['discarded_total']}",
            f"router_pool_invalidated_total {s['invalidated_total']}",
        ]) + "\n"

    def _render_blackbox_metrics(self) -> str:
        """The ``journal_*`` + ``incident_*`` section of the router's
        ``/metrics``."""
        parts = [journal.render_prometheus().rstrip("\n")]
        wd = self.watchdog
        if wd is not None:
            try:
                parts.append(wd.render_prometheus().rstrip("\n"))
            except Exception:
                pass  # the black box must never break a scrape
        return "\n".join(parts) + "\n"

    def aggregate_traces(self, trace_id: Optional[str] = None,
                         limit: Optional[int] = None,
                         since: Optional[float] = None
                         ) -> List[Dict[str, Any]]:
        """The flight recorder's read side — see
        :meth:`aggregate_traces_bounded`; this convenience returns the
        (bounded) records alone."""
        return self.aggregate_traces_bounded(trace_id, limit, since)[0]

    def aggregate_traces_bounded(self, trace_id: Optional[str] = None,
                                 limit: Optional[int] = None,
                                 since: Optional[float] = None):
        """The flight recorder's read side: merge this router's kept
        traces with every ready worker's ``/v1/traces`` into one record
        per trace id — router attempt spans and the worker spans they
        parented (predict, batcher stages) come back as ONE tree
        (``trace.span_tree``). ``limit``/``since`` bound the result
        — forwarded to the workers too, so the fan-out fetch
        itself stays bounded, then re-applied (with the hard
        response-size cap) after the merge. Returns
        ``(records, truncated)``."""
        records = list(trace.collector().traces())
        views = [v for v in self.workers().values() if v.ready]
        params = []
        if trace_id is not None:
            params.append(f"trace_id={trace_id}")
        if limit is not None:
            params.append(f"limit={int(limit)}")
        if since is not None:
            params.append(f"since={float(since)}")
        path = "/v1/traces" + ("?" + "&".join(params) if params else "")

        def fetch(v):
            status, _, data = self._http(v.address, "GET", path,
                                         timeout=self.probe_timeout_s)
            if status != 200:
                return None
            payload = json.loads(data.decode())
            return payload.get("traces", []), bool(payload.get("truncated"))

        worker_truncated = False
        for recs, trunc in self._fanout(fetch, views,
                                        self.probe_timeout_s).values():
            records.extend(recs or [])
            # a worker that already cut its response means the merged
            # view is incomplete even if the router-side bound trims
            # nothing further — the flag must survive the hop
            worker_truncated = worker_truncated or trunc
        merged = trace.merge_traces(records)
        if trace_id is not None:
            merged = [m for m in merged if m.get("trace_id") == trace_id]
        bounded, truncated = trace.bound_traces(merged, limit=limit,
                                                since=since)
        return bounded, truncated or worker_truncated

    # --------------------------------------------------------- GET handlers
    def _handle_get(self, path: str):
        if path.startswith("/v1/traces"):
            q = parse_qs(urlsplit(path).query)
            try:
                limit = (int(q["limit"][0]) if "limit" in q else None)
                since = (float(q["since"][0]) if "since" in q else None)
            except ValueError as e:
                return 400, {"error": f"bad limit/since query param: {e}"}
            merged, truncated = self.aggregate_traces_bounded(
                q.get("trace_id", [None])[0], limit=limit, since=since)
            if q.get("format", [None])[0] == "chrome":
                return 200, trace.to_chrome_trace(merged)
            return 200, {"traces": merged, "truncated": truncated}
        if path.startswith("/v1/journal"):
            # the black box's fleet read side: this router's
            # ring merged with every ready worker's, ordered and bounded
            q = parse_qs(urlsplit(path).query)
            try:
                limit = (int(q["limit"][0]) if "limit" in q else None)
                since = (float(q["since"][0]) if "since" in q else None)
            except ValueError as e:
                return 400, {"error": f"bad limit/since query param: {e}"}
            types = None
            if "type" in q:
                types = {t for v in q["type"] for t in v.split(",") if t}
            events, truncated = self.fleet_journal(since=since, limit=limit,
                                                   types=types)
            return 200, {"router_id": self.router_id, "events": events,
                         "truncated": truncated,
                         "counters": journal.counters()}
        if path == "/v1/debug/stacks":
            from deeplearning4j_tpu_torch.serving import blackbox
            return 200, {"router_id": self.router_id,
                         "stacks": blackbox.stack_sample()}
        if path == "/v1/slo":
            # structured twin of the /metrics slo_* section — the signal
            # the autoscaler consumes, fleet-wide by construction
            return 200, {"windows_s": list(self.slo.windows_s),
                         "slo": self.slo.report()}
        if path == "/v1/delivery":
            # the gated-delivery drill's live view: the active
            # controller's stage/stats, else the last finished verdict
            dc = self._delivery
            if dc is not None:
                return 200, {"active": True, "delivery": dc.snapshot()}
            if self._last_delivery_report is not None:
                return 200, {"active": False,
                             "delivery": self._last_delivery_report}
            return 404, {"error": "no gated delivery has run here"}
        if path == "/v1/capacity":
            # fleet-wide capacity aggregation (sums + merged histograms)
            return 200, self.fleet_capacity()
        if path == "/v1/autoscaler":
            # the decision log: why the fleet grew/shrank, with the
            # triggering burn snapshots and the headroom consulted
            if self.autoscaler is None:
                return 404, {"error": "no autoscaler attached"}
            return 200, self.autoscaler.report()
        if path == "/healthz":
            return 200, {"status": "ok",
                         "workers": {wid: v.admittable()
                                     for wid, v in self.workers().items()}}
        if path == "/readyz":
            now = time.monotonic()
            admittable = {wid: v.admittable(now)
                          for wid, v in self.workers().items()}
            ready = any(admittable.values())
            out = {"ready": ready, "router_id": self.router_id,
                   "workers": admittable}
            if self._peer_view:
                # router-to-router peering: which peers this
                # router last saw ready — readiness itself stays a
                # function of OUR workers only
                out["peers"] = {rid: p["ready"]
                                for rid, p in self._peer_view.items()}
            return (200 if ready else 503), out
        if path == "/v1/peers":
            # the peering view in full: peer addresses +
            # last-probed readiness, and the shared-config health this
            # router routes from
            out = {"router_id": self.router_id,
                   "peers": dict(self._peer_view)}
            if self._config is not None:
                try:
                    out["config"] = self._config.counters()
                except Exception:
                    pass
            return 200, out
        if path == "/fleet":
            out = {
                "router_id": self.router_id,
                "workers": {wid: v.snapshot()
                            for wid, v in self.workers().items()},
                "hedge_delay_ms": round(self.hedge_delay_s() * 1000.0, 3),
                "metrics": self.metrics.snapshot()}
            if self._config is not None:
                try:
                    out["config"] = self._config.counters()
                except Exception:
                    pass
            return 200, out
        if path == "/v1/models" or path.startswith("/v1/models/"):
            # proxy the listing from the first admittable worker
            now = time.monotonic()
            for view in self.ranked_workers("__listing__"):
                if not view.admittable(now):
                    continue
                try:
                    status, _, data = self._http(
                        view.address, "GET", path,
                        timeout=self.probe_timeout_s)
                    return status, json.loads(data.decode())
                except Exception:
                    continue
            return 503, {"error": "unavailable",
                         "reason": "no_healthy_workers"}
        return 404, {"error": f"unknown path {path!r}"}

    # ------------------------------------------------------------ plumbing
    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        router = self
        self._stop.clear()
        self._probe_cycle()  # workers registered+probed before first request

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: clients with connection
            # pools (clients of the router) reuse this socket;
            # every _send sets Content-Length, which 1.1 requires
            protocol_version = "HTTP/1.1"
            timeout = 20.0
            # headers and body go out in separate writes; without
            # NODELAY, Nagle + delayed ACK stalls each response ~40ms
            disable_nagle_algorithm = True

            def _send(self, code: int, headers: Dict[str, str],
                      body: bytes):
                self.send_response(code)
                for k, v in headers.items():
                    self.send_header(k, str(v))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    text = (router.metrics.render_prometheus(
                                router.workers())
                            + router._render_pool_metrics()
                            + router.render_fleet_metrics()
                            + router._render_blackbox_metrics()).encode()
                    self._send(200, {"Content-Type":
                                     "text/plain; version=0.0.4"}, text)
                    return
                if self.path.startswith("/v1/debug/bundle"):
                    # one curl away from a postmortem: the
                    # fleet incident bundle, as a binary tar.gz
                    from deeplearning4j_tpu_torch.serving import blackbox
                    try:
                        data = blackbox.fleet_bundle(router)
                    except Exception as e:
                        self._send(500,
                                   {"Content-Type": "application/json"},
                                   json.dumps({"error": repr(e)}).encode())
                        return
                    self._send(200, {
                        "Content-Type": "application/gzip",
                        "Content-Disposition": 'attachment; filename='
                                               '"debug-bundle.tar.gz"'},
                        data)
                    return
                code, obj = router._handle_get(self.path)
                self._send(code, {"Content-Type": "application/json"},
                           json.dumps(obj).encode())

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if (self.path.startswith("/v1/models/")
                        and self.path.endswith("/predict")):
                    name = self.path[len("/v1/models/"):-len("/predict")]
                    code, headers, data = router._route_predict(
                        name, raw, self.headers,
                        ctype=self.headers.get("Content-Type"))
                elif (self.path.startswith("/v1/models/")
                        and "/sessions" in self.path):
                    # session tier: pinned, never hedged
                    name, _, tail = (self.path[len("/v1/models/"):]
                                     .partition("/sessions"))
                    parts = tail.strip("/").split("/") if tail.strip("/") \
                        else []
                    if not parts:
                        op, sid = "create", ""
                    elif len(parts) == 2 and parts[1] in ("step", "stream"):
                        op, sid = parts[1], parts[0]
                    else:
                        self._send(404, {"Content-Type": "application/json"},
                                   json.dumps({"error": f"unknown path "
                                               f"{self.path!r}"}).encode())
                        return
                    code, headers, data = router._route_session(
                        "POST", self.path, name, sid, op, raw, self.headers)
                elif self.path == "/v1/feedback":
                    # the flywheel's label intake: joined
                    # against the access log wherever it lives — the
                    # router accepts labels even when workers wrote the
                    # log, as long as they share the log file
                    from deeplearning4j_tpu_torch.serving import delivery
                    code, obj = delivery.handle_feedback(raw)
                    headers = {"Content-Type": "application/json"}
                    data = json.dumps(obj).encode()
                else:
                    code, headers, data = 404, {
                        "Content-Type": "application/json"}, json.dumps(
                        {"error": f"unknown path {self.path!r}"}).encode()
                self._send(code, headers, data)

            def do_DELETE(self):
                if (self.path.startswith("/v1/models/")
                        and "/sessions/" in self.path):
                    name, _, sid = (self.path[len("/v1/models/"):]
                                    .partition("/sessions/"))
                    code, headers, data = router._route_session(
                        "DELETE", self.path, name, sid.strip("/"), "close",
                        b"", self.headers)
                else:
                    code, headers, data = 404, {
                        "Content-Type": "application/json"}, json.dumps(
                        {"error": f"unknown path {self.path!r}"}).encode()
                self._send(code, headers, data)

            def log_message(self, *a):
                pass

        # KeepAliveHTTPServer: stop() must sever parked keep-alive
        # connections, or pooled clients keep talking to a dead router
        self._httpd = wire.KeepAliveHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="FleetRouter")
        self._thread.start()
        self._prober = threading.Thread(target=self._probe_loop,
                                        daemon=True,
                                        name="FleetRouter-probe")
        self._prober.start()
        from deeplearning4j_tpu_torch.runtime import profiler
        profiler.attach_router(self.metrics)
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()  # release the listener fd promptly
            self._httpd = None
        if self._prober:
            self._prober.join(timeout=5.0)
            self._prober = None
        # parked keep-alives hold worker-side handler threads open;
        # closing the pool releases both ends promptly
        self.pool.close()
