"""SLO-feedback autoscaler: the telemetry loop closed (counterpart of
``deeplearning4j_tpu/serving/autoscale.py``, with the same policy, decision
log, journal events and levers).

The router's :class:`~deeplearning4j_tpu_torch.serving.slo.SLOMonitor`
computes per-model multi-window burn rates fleet-wide; ``serving/capacity.py``
accounts what a scaling decision would spend (on the card: the ledger of
device bytes by mesh position).
:class:`SLOAutoscaler` is the control loop that makes both pay their way:
a thread at the router that, each tick, reads the burn rates and the
capacity headroom and drives two levers —

- **replica resize**: ``POST /v1/models/<name>/replicas`` against the
  worker currently ranked #1 for the model (the one its traffic
  concentrates on under rendezvous routing) — the worker grows/shrinks
  its :class:`~deeplearning4j_tpu_torch.serving.replica.ReplicaPool` at
  runtime, each new replica warmed from the live
  :class:`~deeplearning4j_tpu_torch.serving.manifest.WarmupManifest` (its
  graphs captured) BEFORE it takes traffic;
- **fleet resize**: :meth:`FleetSupervisor.add_worker` /
  :meth:`~deeplearning4j_tpu_torch.serving.fleet.FleetSupervisor.remove_worker`
  with a cloned :class:`WorkerSpec` — the router's existing ``/readyz``
  prober readmits the newcomer, nothing new to integrate.

Control policy (``docs/observability.md`` has the runbook):

- **Multi-window burn**: scale-up requires the FAST window's burn rate
  over ``up_burn`` (trigger) AND the SLOW window's over ``confirm_burn``
  (confirm) — a one-second blip cannot trigger, a sustained breach
  cannot hide. The burn signal is ``max(availability_burn,
  latency_burn)``.
- **Hysteresis + cooldown**: scale-down requires BOTH windows under
  ``down_burn`` (strictly below the trigger band) and fires only after
  ``down_cooldown_s`` since the last action; scale-ups are themselves
  rate-limited by ``up_cooldown_s``. The gap between ``up_burn`` and
  ``down_burn`` plus the cooldowns make flapping impossible: there is no
  burn trajectory that alternates actions faster than the cooldowns.
- **Capacity guard**: before any scale-up the aggregated capacity
  accounting is consulted — a new replica costs the model's measured
  ``param_bytes + model_state_bytes`` on the target worker, and the
  guard refuses to scale past the memory budget
  (``memory_budget_bytes``, else the worker's measured device budget
  where the backend reports one). The refusal is itself a logged,
  explained decision.
- **Unwind discipline**: the autoscaler only scales down what IT scaled
  up (a per-model action stack), so a hand-provisioned baseline is never
  eroded below ``min_replicas``/the launch fleet.
- **Out of HBM != out of compute**: a capacity-guard refusal
  means the worker is memory-bound — more replicas there cannot help.
  The controller first REBALANCES PLACEMENT: page the model in on a
  worker with eviction-free headroom (``POST /v1/models/<m>/residency``;
  the router's placement-aware ranking then shifts the traffic), and
  only spawns a worker — new HBM — when no placed worker has room. The
  decision log's ``capacity.bound`` field (``"hbm"`` vs ``"compute"``)
  records which wall was hit.

Every decision — acted, refused by the guard, or deferred by a cooldown —
is an explained, traced event: a bounded log records the triggering
burn-rate snapshot (both windows), the capacity headroom consulted, the
action and its outcome, and the active trace id (decision spans carry the
``autoscale`` flag so tail sampling always keeps them). ``GET
/v1/autoscaler`` on the router serves the log, so "why did the fleet grow
at 14:32" is answerable after the fact.
"""

from __future__ import annotations

import dataclasses
import http.client
import itertools
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.runtime import journal, trace

logger = logging.getLogger(__name__)

__all__ = ["AutoscalerConfig", "SLOAutoscaler", "forecast_rate"]

#: per-process controller counter: each SLOAutoscaler's journal events
#: carry a unique controller id so two controllers in one process (unit
#: tests, drills) read back exactly their own decisions
_CONTROLLER_IDS = itertools.count(1)


@dataclasses.dataclass
class AutoscalerConfig:
    """Control-policy knobs (defaults are the production shape; drills
    and tests shrink the windows/cooldowns via the injectable clock)."""

    tick_s: float = 1.0
    #: burn-rate windows (must be members of the monitor's ``windows_s``)
    fast_window_s: int = 60
    slow_window_s: int = 300
    #: fast window triggers at this burn rate...
    up_burn: float = 2.0
    #: ...and the slow window must confirm at this one
    confirm_burn: float = 1.0
    #: both windows must sit under this (strictly below the trigger band:
    #: the hysteresis gap) before a scale-down is considered
    down_burn: float = 0.5
    up_cooldown_s: float = 30.0
    down_cooldown_s: float = 120.0
    #: a fast window with fewer requests than this cannot trigger (burn
    #: over 3 requests is noise, not an outage)
    min_requests: int = 8
    min_replicas: int = 1
    max_replicas: int = 8
    #: fleet lever: ``None`` disables worker scaling entirely
    max_workers: Optional[int] = None
    #: capacity guard budget; ``None`` falls back to the target worker's
    #: measured device budget (backends that report one), else unbounded
    memory_budget_bytes: Optional[int] = None
    #: when a scale-up is refused for MEMORY (out of HBM, not compute),
    #: first try to rebalance placement: page the model in on
    #: a worker with eviction-free headroom instead of spawning a worker
    rebalance_enabled: bool = True
    #: decision-log ring size
    log_capacity: int = 256
    #: socket budget for the replica lever (warmup compiles take seconds)
    lever_timeout_s: float = 120.0
    # ---- predictive scaling: act BEFORE the burn-rate breach
    #: master switch for the pre-breach signals below
    predictive: bool = True
    #: look-ahead horizon of the SLO-ring traffic forecast
    forecast_horizon_s: float = 15.0
    #: per-second history the trend is fitted over (clamped to the SLO
    #: monitor's ring horizon)
    forecast_window_s: int = 30
    #: forecast demand must exceed the estimated serveable rate by this
    #: factor before a pre-scale fires
    forecast_margin: float = 1.2
    #: admission-queue pressure (depth / limit) that predicts a breach —
    #: the queue is already measured for the ``Retry-After`` drain hints
    queue_pressure: float = 0.5
    #: scheduled pre-scaling windows: ``{"model": name-or-"*",
    #: "start_ts", "end_ts"}`` (unix seconds) — capacity ahead of a
    #: KNOWN traffic event, no signal required
    schedules: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def forecast_rate(counts: List[float], horizon_s: float
                  ) -> "tuple[float, float, float]":
    """Least-squares linear trend over per-second request counts ->
    ``(predicted_rate_at_now+horizon, slope_per_s, rate_now)``.
    ``rate_now`` is the mean of the newest quarter of the window, so one
    noisy second does not define "now"; fewer than 4 samples fit no
    trend (slope 0). Pure function — the forecast unit tests drive it
    with hand-built ramps."""
    n = len(counts)
    if n == 0:
        return 0.0, 0.0, 0.0
    tail = max(1, n // 4)
    rate_now = sum(counts[-tail:]) / tail
    if n < 4:
        return rate_now, 0.0, rate_now
    mean_x = (n - 1) / 2.0
    mean_y = sum(counts) / n
    sxx = sum((i - mean_x) ** 2 for i in range(n))
    sxy = sum((i - mean_x) * (counts[i] - mean_y) for i in range(n))
    slope = sxy / sxx if sxx else 0.0
    pred = mean_y + slope * ((n - 1) + float(horizon_s) - mean_x)
    return max(0.0, pred), slope, rate_now


class _ModelState:
    """Per-model controller state."""

    __slots__ = ("actions", "last_action_ts", "suppressed")

    def __init__(self):
        self.actions: List[tuple] = []   # stack of ("replica"|"worker", wid)
        self.last_action_ts = float("-inf")
        self.suppressed: Optional[str] = None  # dedup key for skip logging

    @property
    def level(self) -> int:
        return len(self.actions)


class SLOAutoscaler:
    """Closed-loop controller over a
    :class:`~deeplearning4j_tpu_torch.serving.router.FleetRouter`'s burn-rate
    and capacity telemetry.

    ``router`` supplies the SLO monitor (fleet-wide by construction),
    the worker ranking, and the capacity aggregation; ``fleet`` (a
    :class:`~deeplearning4j_tpu_torch.serving.fleet.FleetSupervisor`) enables
    the worker lever when given. ``replica_lever`` / ``worker_lever``
    are injectable for unit tests — production uses the HTTP scale
    endpoint and the supervisor.

    :meth:`start` runs :meth:`tick` on a daemon control thread named
    ``slo-autoscaler`` (covered by a test's thread-leak guard);
    :meth:`tick` is public so drills can step the loop deterministically.
    """

    def __init__(self, router, fleet=None,
                 config: Optional[AutoscalerConfig] = None,
                 models: Optional[List[str]] = None,
                 capacity_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 replica_lever: Optional[Callable] = None,
                 worker_lever: Optional[Callable] = None,
                 residency_lever: Optional[Callable] = None,
                 election=None,
                 now_fn: Callable[[], float] = time.monotonic):
        self.router = router
        self.fleet = fleet
        #: lease election: with one attached, this controller
        #: only ACTS while it holds the lease — otherwise every decision
        #: is shadow-computed and logged with role="follower". None keeps
        #: the single-controller behaviour (always leader).
        self.election = election
        if election is not None and election.on_transition is None:
            election.on_transition = self._record_election
        self.config = config or AutoscalerConfig()
        cfg = self.config
        # coerce the window knobs: SLOMonitor.report keys windows as
        # f"{int(w)}s", so a float 60.0 here would pass the membership
        # check below (60.0 == 60) yet miss every lookup ("60.0s") and
        # silently disable the controller
        cfg.fast_window_s = int(cfg.fast_window_s)
        cfg.slow_window_s = int(cfg.slow_window_s)
        windows = getattr(router.slo, "windows_s", ())
        for w in (cfg.fast_window_s, cfg.slow_window_s):
            if w not in windows:
                raise ValueError(
                    f"autoscaler window {w}s is not one of the SLO "
                    f"monitor's windows {windows} — the burn rates it "
                    f"would read do not exist")
        if cfg.fast_window_s >= cfg.slow_window_s:
            raise ValueError(
                f"fast window ({cfg.fast_window_s}s) must be shorter than "
                f"the slow confirm window ({cfg.slow_window_s}s)")
        if cfg.down_burn >= min(cfg.up_burn, cfg.confirm_burn):
            raise ValueError(
                f"down_burn ({cfg.down_burn}) must sit strictly below the "
                f"trigger band (up {cfg.up_burn} / confirm "
                f"{cfg.confirm_burn}) — no hysteresis gap means flapping")
        self._models_filter = set(models) if models else None
        self._capacity_fn = (capacity_fn if capacity_fn is not None
                             else getattr(router, "fleet_capacity",
                                          lambda: {}))
        self._replica_lever = replica_lever or self._http_scale_replicas
        self._worker_lever = worker_lever
        self._residency_lever = residency_lever or self._http_page_in
        self._now = now_fn
        self._states: Dict[str, _ModelState] = {}
        self._lock = threading.Lock()  # guards: _states
        # decision records live in the EVENT JOURNAL: _log
        # emits one `autoscale.decision` event per entry and report()
        # reads them back — one source, no double bookkeeping. The
        # controller id scopes the read-back to THIS controller.
        self._cid = (f"{getattr(router, 'router_id', 'router')}"
                     f"#{next(_CONTROLLER_IDS)}")
        if not journal.enabled():
            # the decision log LIVES in the journal now: with it disabled
            # every decision still acts but /v1/autoscaler shows nothing
            logger.warning(
                "event journal disabled (DL4J_TPU_JOURNAL=0): autoscaler "
                "decisions will act but /v1/autoscaler's decision log "
                "will be empty")
        self.ticks = 0
        self._tick_capacity: Optional[Dict[str, Any]] = None
        self._worker_seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- levers
    def _http_scale_replicas(self, view, model: str, delta: int, span):
        """Production replica lever: the worker's scale endpoint, driven
        with a RELATIVE ``delta`` — the worker applies it to its own live
        replica count under its resize lock, so a stale (or missing)
        capacity scrape can never turn a scale-up into an absolute
        scale-down. The decision span's ids ride the headers so the
        worker-side ``worker.scale_replicas`` span joins the decision's
        trace."""
        host, port = view.address.rsplit(":", 1)
        conn = http.client.HTTPConnection(
            host, int(port), timeout=self.config.lever_timeout_s)
        headers = {"Content-Type": "application/json"}
        if span.recording:
            headers["X-Trace-Id"] = span.trace_id
            headers["X-Parent-Span-Id"] = span.span_id
        try:
            # the floor rides the request: the worker clamps the delta
            # target against its LIVE count, so min_replicas holds even
            # when the capacity scrape is stale
            conn.request("POST", f"/v1/models/{model}/replicas",
                         json.dumps({"delta": int(delta),
                                     "floor": int(self.config.min_replicas)}
                                    ).encode(), headers)
            resp = conn.getresponse()
            data = resp.read()
            try:
                body = json.loads(data.decode())
            except Exception:
                body = {"raw": data.decode(errors="replace")[:200]}
            return resp.status == 200, body
        finally:
            conn.close()

    def _http_page_in(self, view, model: str, span) -> tuple:
        """Placement-rebalance lever: page ``model`` in on
        ``view`` via the worker's residency endpoint — the worker with
        eviction-free headroom becomes a RESIDENT home for the model, and
        the router's placement-aware ranking shifts its traffic there
        before any worker is spawned."""
        host, port = view.address.rsplit(":", 1)
        conn = http.client.HTTPConnection(
            host, int(port), timeout=self.config.lever_timeout_s)
        headers = {"Content-Type": "application/json"}
        if span.recording:
            headers["X-Trace-Id"] = span.trace_id
            headers["X-Parent-Span-Id"] = span.span_id
        try:
            conn.request("POST", f"/v1/models/{model}/residency",
                         json.dumps({"state": "resident"}).encode(), headers)
            resp = conn.getresponse()
            data = resp.read()
            try:
                body = json.loads(data.decode())
            except Exception:
                body = {"raw": data.decode(errors="replace")[:200]}
            return resp.status == 200, body
        finally:
            conn.close()

    def _spawn_worker(self, base_view, span) -> tuple:
        """Production worker lever (scale-up): clone the busiest worker's
        spec under a fresh id and spawn it; the router's prober readmits
        it through ``/readyz``."""
        self._worker_seq += 1
        new_id = f"{base_view.worker_id}-as{self._worker_seq}"
        spec = self.fleet.clone_spec(base_view.worker_id, new_id)
        self.fleet.add_worker(spec)
        return True, {"worker_id": new_id}

    # --------------------------------------------------------- leadership
    def _role(self) -> str:
        """``"leader"`` when this controller may act (no election wired,
        or the lease is ours); ``"follower"`` otherwise. A lock-free read
        — safe on the tick path even while a chaos drill hangs the
        leader's heartbeat."""
        if self.election is None:
            return "leader"
        return "leader" if self.election.is_leader() else "follower"

    def _record_election(self, event: Dict[str, Any]) -> None:
        """Fold a lease transition into the decision log:
        every election — acquired, takeover, lost, released — is an
        explained ``/v1/autoscaler`` entry next to the decisions it
        gates. The entry is an ``autoscale.election`` JOURNAL event
        — the black box and the ``/v1/autoscaler`` view read
        the same record."""
        entry = {
            "ts": event.get("ts", time.time()),
            "tick": self.ticks,
            "model": None,
            "action": f"election_{event.get('role')}",
            "ok": True,
            "role": event.get("role"),
            "worker": None,
            "level": None,
            "burn": None,
            "capacity": None,
            "trace_id": None,
            "detail": {k: event.get(k)
                       for k in ("holder", "seq", "reason", "id")},
        }
        journal.emit("autoscale.election", controller=self._cid,
                     entry=entry)
        logger.info("autoscaler election: %s -> %s (%s)",
                    event.get("id"), event.get("role"),
                    event.get("reason"))

    # ---------------------------------------------------------- burn math
    @staticmethod
    def _burn(window: Dict[str, Any]) -> float:
        return max(float(window.get("availability_burn_rate", 0.0)),
                   float(window.get("latency_burn_rate", 0.0)))

    def _capacity(self) -> Dict[str, Any]:
        """The tick's capacity snapshot, scraped lazily (only ticks that
        reach a decision pay for it) and at most once per tick."""
        if self._tick_capacity is None:
            try:
                self._tick_capacity = self._capacity_fn()
            except Exception:
                logger.exception("autoscaler capacity scrape failed")
                self._tick_capacity = {}
        return self._tick_capacity

    def _guard(self, model: str, view) -> tuple:
        """Capacity guard: can the target worker afford one more replica
        of ``model``? Returns ``(ok, headroom_record)`` — the record is
        logged with the decision either way, so every decision shows the
        headroom it consulted."""
        cfg = self.config
        cap = self._capacity()
        worker = (cap.get("workers") or {}).get(
            view.worker_id if view is not None else None, {})
        entry = (worker.get("models") or {}).get(model, {})
        needed = int(entry.get("param_bytes", 0)) + \
            int(entry.get("model_state_bytes", 0))
        in_use = int((worker.get("totals") or {}).get("device_bytes", 0))
        budget = cfg.memory_budget_bytes
        if budget is None:
            budget = (worker.get("process") or {}).get("device_budget_bytes")
        headroom = None if budget is None else int(budget) - in_use
        record = {
            "budget_bytes": budget,
            "device_bytes_in_use": in_use,
            "headroom_bytes": headroom,
            "replica_cost_bytes": needed,
            "replicas": entry.get("replicas"),
            "utilization": entry.get("utilization"),
            "queue": entry.get("queue"),
        }
        ok = headroom is None or headroom >= needed
        # classify the binding constraint: a guard refusal is
        # "out of HBM" — the fix is placement (evict/page elsewhere) or a
        # NEW worker's memory, never more replicas on this one; an
        # approved scale-up is "out of compute" (burn with memory to
        # spare). The decision log carries it so "why did the fleet grow"
        # distinguishes the two resource walls.
        record["bound"] = "compute" if ok else "hbm"
        return ok, record

    # ------------------------------------------------------------ the loop
    def tick(self) -> List[Dict[str, Any]]:
        """One control iteration over every tracked model; returns the
        decisions logged this tick (empty on a quiet tick)."""
        self.ticks += 1
        self._tick_capacity = None
        if self.election is not None:
            # one election step per tick (plus the election's own
            # heartbeat thread): a controller that just lost its lease
            # must learn so BEFORE deciding, not a heartbeat later
            self.election.ensure()
        try:
            report = self.router.slo.report(
                models=(sorted(self._models_filter)
                        if self._models_filter else None))
        except Exception:
            logger.exception("autoscaler SLO read failed")
            return []
        out = []
        for model in sorted(report):
            d = self._decide(model, report[model])
            if d is not None:
                out.append(d)
        return out

    def _decide(self, model: str, rep: Dict[str, Any]
                ) -> Optional[Dict[str, Any]]:
        cfg = self.config
        fast = rep.get("windows", {}).get(f"{cfg.fast_window_s}s")
        slow = rep.get("windows", {}).get(f"{cfg.slow_window_s}s")
        if fast is None or slow is None:
            return None
        burn_fast, burn_slow = self._burn(fast), self._burn(slow)
        with self._lock:  # report() iterates _states under the same lock
            st = self._states.setdefault(model, _ModelState())
        now = self._now()
        burn = {"fast_window_s": cfg.fast_window_s, "fast": fast,
                "slow_window_s": cfg.slow_window_s, "slow": slow,
                "burn_fast": burn_fast, "burn_slow": burn_slow}
        breach = (int(fast.get("requests", 0)) >= cfg.min_requests
                  and burn_fast >= cfg.up_burn
                  and burn_slow >= cfg.confirm_burn)
        recovered = (burn_fast <= cfg.down_burn
                     and burn_slow <= cfg.down_burn)
        if breach:
            if now - st.last_action_ts < cfg.up_cooldown_s:
                return self._log_suppressed(model, st, "up_cooldown", burn)
            return self._act(model, st, burn, direction=+1)
        if cfg.predictive:
            # pre-breach signals: queue pressure, traffic
            # forecast, scheduled windows. Checked BEFORE the recovery
            # branch — a 10x ramp can still read "recovered" on burn
            # alone, and scaling DOWN into a ramp is the one wrong move.
            sig = self._predictive_signal(model, fast)
            if sig is not None:
                if now - st.last_action_ts < cfg.up_cooldown_s:
                    return self._log_suppressed(model, st, "up_cooldown",
                                                burn)
                burn = {**burn, "predictive": sig}
                return self._act(model, st, burn, direction=+1,
                                 predictive=sig)
        if recovered and st.level > 0:
            if now - st.last_action_ts < cfg.down_cooldown_s:
                return self._log_suppressed(model, st, "down_cooldown", burn)
            return self._act(model, st, burn, direction=-1)
        st.suppressed = None
        return None

    def _predictive_signal(self, model: str, fast: Dict[str, Any]
                           ) -> Optional[Dict[str, Any]]:
        """The pre-breach scale-up signal, or ``None``:

        - **schedule** — a configured pre-scaling window covers now
          (checked first: planned capacity needs no live traffic at all);
        - **queue** — admission-queue pressure ``depth/limit`` at or over
          ``queue_pressure`` (the same queue the ``Retry-After`` drain
          hints are computed from): requests are already waiting, the
          latency burn just has not caught up yet;
        - **forecast** — the short-horizon linear trend over the SLO
          ring's per-second request counts exceeds the estimated
          serveable rate by ``forecast_margin``: the 10x step is scaled
          for BEFORE the burn-rate breach it would otherwise become.

        The forecast comparison is a *blend*, not
        two independent triggers: the serveable rate averages the
        utilization-implied estimate (current rate / busy fraction)
        with the fleet's admission-queue drain-rate capacity
        (``drain_rate_rps`` — summed ``1000 / drain_ms_per_request``
        across workers), and the predicted demand folds the standing
        queue backlog in as ``depth / horizon`` — a ramp arriving on
        top of an already-backed-up queue trips the signal earlier than
        either series would alone. When only one serveable estimate is
        available (near-idle fleet, or no drain sample yet) the blend
        degrades to that one; with neither there is no honest capacity
        estimate and no forecast signal."""
        cfg = self.config
        now_wall = time.time()
        for sched in (cfg.schedules or []):
            try:
                if sched.get("model") not in (model, "*", None):
                    continue
                if (float(sched["start_ts"]) <= now_wall
                        <= float(sched["end_ts"])):
                    return {"signal": "schedule",
                            "start_ts": float(sched["start_ts"]),
                            "end_ts": float(sched["end_ts"])}
            except (TypeError, KeyError, ValueError):
                continue  # malformed schedule entry: skip, never crash
        if int(fast.get("requests", 0)) < cfg.min_requests:
            return None  # too little traffic to predict from
        # the fleet-aggregated capacity schema (FleetRouter
        # .fleet_capacity): flattened queue_depth / queue_headroom /
        # busy_fraction summed across workers
        entry = (self._capacity().get("models") or {}).get(model) or {}
        try:
            depth = int(entry.get("queue_depth", 0))
            headroom = int(entry.get("queue_headroom_requests", 0))
        except (TypeError, ValueError):
            depth = headroom = 0
        limit = depth + headroom
        if limit > 0 and depth / limit >= cfg.queue_pressure:
            return {"signal": "queue", "queue_depth": depth,
                    "queue_limit": limit}
        recent = getattr(self.router.slo, "recent_counts", None)
        if recent is None:
            return None
        counts = recent(model, cfg.forecast_window_s)
        pred, slope, rate_now = forecast_rate(counts,
                                              cfg.forecast_horizon_s)
        if slope <= 0 or rate_now <= 0:
            return None
        try:
            busy = float(entry.get("busy_fraction", 0.0))
        except (TypeError, ValueError):
            busy = 0.0
        try:
            drain_rps = float(entry.get("drain_rate_rps", 0.0))
        except (TypeError, ValueError):
            drain_rps = 0.0
        util_serveable = (rate_now / min(1.0, max(busy, 1e-6))
                          if busy > 0.01 else None)
        if util_serveable is None and drain_rps <= 0:
            return None  # near-idle, no drain sample: nothing honest
        if util_serveable is not None and drain_rps > 0:
            serveable = (util_serveable + drain_rps) / 2.0
        elif util_serveable is not None:
            serveable = util_serveable
        else:
            serveable = drain_rps
        # the standing backlog must ALSO clear within the horizon: fold
        # it into demand so ramp-onto-backlog trips earlier than the
        # traffic trend alone would
        horizon = max(cfg.forecast_horizon_s, 1e-6)
        backlog_rate = depth / horizon if depth > 0 else 0.0
        demand = pred + backlog_rate
        if demand > serveable * cfg.forecast_margin:
            out = {"signal": "forecast",
                   "rate_now": round(rate_now, 3),
                   "predicted_rate": round(pred, 3),
                   "serveable_rate": round(serveable, 3),
                   "slope_per_s": round(slope, 4),
                   "horizon_s": cfg.forecast_horizon_s}
            if backlog_rate > 0:
                out["backlog_rate"] = round(backlog_rate, 3)
                out["predicted_demand"] = round(demand, 3)
            if drain_rps > 0:
                out["drain_rate_rps"] = round(drain_rps, 3)
            return out
        return None

    # ----------------------------------------------------------- decisions
    def _target_view(self, model: str):
        now = time.monotonic()
        for view in self.router.ranked_workers(model):
            if view.admittable(now):
                return view
        return None

    def _act(self, model: str, st: _ModelState, burn: Dict[str, Any],
             direction: int, predictive: Optional[Dict[str, Any]] = None
             ) -> Optional[Dict[str, Any]]:
        cfg = self.config
        # the decision span: flagged so tail sampling ALWAYS keeps it —
        # an autoscaling event is never a "healthy trace to drop"
        sp = (trace.server_span("autoscaler.decision")
              if trace.enabled() else trace.NOOP)
        with sp:
            if sp.recording:
                sp.flag("autoscale")
                sp.set("model", model)
                sp.set("direction", direction)
                if predictive is not None:
                    sp.set("predictive", predictive.get("signal"))
            if self._role() == "follower":
                # shadow decision: computed like the leader's,
                # logged with role="follower", levers NEVER touched — the
                # exactly-once guarantee two live routers depend on
                return self._log(
                    model, st,
                    ("follower_scale_up" if direction > 0
                     else "follower_scale_down"),
                    burn, None, span=sp, ok=False, role="follower",
                    detail="shadow decision: not the lease holder",
                    dedup=True)
            view = self._target_view(model)
            if view is None:
                return self._log_suppressed(model, st, "no_healthy_worker",
                                            burn, span=sp)
            ok_guard, headroom = self._guard(model, view)
            if direction > 0:
                return self._scale_up(model, st, burn, view, ok_guard,
                                      headroom, sp, predictive=predictive)
            return self._scale_down(model, st, burn, view, headroom, sp)

    def _fenced(self, model, st, burn, headroom, sp):
        """Last-instant lease re-check before a lever fires: a leader
        that lost its lease mid-decision must NOT act (the new leader may
        already be acting on the same signal). ``election.verify()``
        reads the lease FILE directly — lock-free, so it stays truthful
        even while the election's own heartbeat thread is hung inside a
        step (the ``serving.autoscale.lease`` chaos drill), which is
        exactly when the cached role lies. An arbitrary scheduler pause
        between this check and the lever remains possible (full fencing
        would need the seq token validated at the worker); the check
        closes every observable lost-lease window. Returns the
        suppression entry when fencing triggers, else ``None``."""
        if self.election is not None and not self.election.verify():
            return self._log(model, st, "suppressed_lost_lease", burn,
                             headroom, span=sp, ok=False, role="follower",
                             detail="lease lost between decision and "
                                    "lever; deferring to the new leader")
        return None

    def _scale_up(self, model, st, burn, view, ok_guard, headroom, sp,
                  predictive=None):
        cfg = self.config
        if headroom.get("replicas") is None:
            # no capacity entry for the target worker (scrape timed out
            # or the worker just joined): a controller must not act
            # blind — defer, explained, until the ledger is back
            return self._log(model, st, "suppressed_no_capacity", burn,
                             headroom, span=sp, ok=False,
                             detail=f"no capacity data for worker "
                                    f"{view.worker_id!r} this tick",
                             dedup=True)
        if not ok_guard:
            # OUT OF HBM, not out of compute: more replicas on
            # this worker cannot help. Rebalance placement first — page
            # the model in on a worker with eviction-free headroom, so
            # the router's placement ranking moves the traffic — and only
            # spawn a worker (new HBM) when no such worker exists.
            if cfg.rebalance_enabled:
                target = self._rebalance_target(model, view)
                if target is not None:
                    fenced = self._fenced(model, st, burn, headroom, sp)
                    if fenced is not None:
                        return fenced
                    try:
                        ok, detail = self._residency_lever(target, model, sp)
                    except Exception as e:
                        ok, detail = False, {"error": repr(e)}
                    if ok:
                        st.last_action_ts = self._now()
                        st.suppressed = None
                    return self._log(model, st, "rebalance_page_in", burn,
                                     headroom, span=sp, ok=ok,
                                     worker=target.worker_id, detail=detail)
            entry = self._worker_entry(model, st, burn, view, headroom, sp,
                                       reason="out of HBM on every placed "
                                              "worker")
            if entry is not None:
                return entry
            return self._log(model, st, "suppressed_capacity_guard",
                             burn, headroom, span=sp, ok=False,
                             detail="scale-up refused: out of HBM (replica "
                                    "cost exceeds memory headroom) and no "
                                    "rebalance target or worker headroom",
                             dedup=True)
        replicas = int(headroom["replicas"])
        if replicas < cfg.max_replicas:
            fenced = self._fenced(model, st, burn, headroom, sp)
            if fenced is not None:
                return fenced
            try:
                ok, detail = self._replica_lever(view, model, +1, sp)
            except Exception as e:
                ok, detail = False, {"error": repr(e)}
            if ok:
                st.actions.append(("replica", view.worker_id))
                st.last_action_ts = self._now()
                st.suppressed = None
            return self._log(model, st, "scale_up_replica", burn, headroom,
                             span=sp, ok=ok, worker=view.worker_id,
                             detail=detail, predictive=predictive)
        entry = self._worker_entry(model, st, burn, view, headroom, sp,
                                   reason="replicas at max")
        if entry is not None:
            return entry
        return self._log(model, st, "suppressed_at_max", burn, headroom,
                         span=sp, ok=False,
                         detail=f"replicas={replicas} at max_replicas="
                                f"{cfg.max_replicas} and no worker "
                                f"headroom", dedup=True)

    def _worker_entry(self, model, st, burn, view, headroom, sp, reason):
        """The fleet lever (spawn a cloned worker), shared by the
        compute-bound (replicas at max) and HBM-bound (no rebalance
        target) paths; ``None`` when the lever is unavailable."""
        cfg = self.config
        if not (self.fleet is not None and cfg.max_workers is not None
                and len(self.router.workers()) < cfg.max_workers):
            return None
        fenced = self._fenced(model, st, burn, headroom, sp)
        if fenced is not None:
            return fenced
        lever = self._worker_lever or self._spawn_worker
        try:
            ok, detail = lever(view, sp)
        except Exception as e:
            ok, detail = False, {"error": repr(e)}
        if ok:
            st.actions.append(("worker", detail.get("worker_id")))
            st.last_action_ts = self._now()
            st.suppressed = None
        if isinstance(detail, dict):
            detail = {**detail, "reason": reason}
        return self._log(model, st, "scale_up_worker", burn, headroom,
                         span=sp, ok=ok, worker=view.worker_id,
                         detail=detail)

    def _rebalance_target(self, model, view):
        """The best placement-rebalance target: an admittable worker
        (other than ``view``) that knows ``model`` COLD and has the most
        eviction-free headroom covering the model's bytes. ``None`` when
        no worker qualifies — or when the model is already RESIDENT
        elsewhere (routing, not this controller, should shift the
        traffic)."""
        cap = self._capacity()
        live = self.router.workers()
        now = time.monotonic()
        best = None
        best_headroom = None
        for wid, payload in sorted((cap.get("workers") or {}).items()):
            if wid == view.worker_id:
                continue
            w = live.get(wid)
            if w is None or not w.admittable(now):
                continue
            res = payload.get("residency")
            if not isinstance(res, dict):
                continue
            entry = (res.get("models") or {}).get(model)
            if not isinstance(entry, dict):
                continue
            if entry.get("state") == "resident":
                return None  # already placed elsewhere; routing handles it
            budget = res.get("hbm_budget_bytes")
            headroom = (float("inf") if budget is None else
                        int(budget) - int(res.get("resident_bytes", 0)))
            if headroom < int(entry.get("bytes", 0)):
                continue  # paging in here would evict someone else
            if best_headroom is None or headroom > best_headroom:
                best, best_headroom = w, headroom
        return best

    def _scale_down(self, model, st, burn, view, headroom, sp):
        fenced = self._fenced(model, st, burn, headroom, sp)
        if fenced is not None:
            return fenced
        kind, wid = st.actions[-1]
        if kind == "worker":
            try:
                self.fleet.remove_worker(wid)
                ok, detail = True, {"worker_id": wid}
            except Exception as e:
                ok, detail = False, {"error": repr(e)}
            if ok:
                st.actions.pop()
                st.last_action_ts = self._now()
                st.suppressed = None
            return self._log(model, st, "scale_down_worker", burn, headroom,
                             span=sp, ok=ok, worker=wid, detail=detail)
        # replica unwind: prefer the worker we scaled, fall back to the
        # current target if it has since been replaced. The lever is a
        # RELATIVE -1 applied to the worker's live count (floored at 1
        # by the endpoint itself), so a stale scrape cannot collapse a
        # multi-replica worker to the floor in one step.
        target = self.router.workers().get(wid) or view
        try:
            ok, detail = self._replica_lever(target, model, -1, sp)
        except Exception as e:
            ok, detail = False, {"error": repr(e)}
        if ok:
            st.actions.pop()
            st.last_action_ts = self._now()
            st.suppressed = None
        return self._log(model, st, "scale_down_replica", burn, headroom,
                         span=sp, ok=ok, worker=target.worker_id,
                         detail=detail)

    # ------------------------------------------------------------- logging
    def _log_suppressed(self, model, st, reason, burn, span=trace.NOOP):
        """A deferred decision is logged ONCE per streak (the first tick
        it would have acted), not once per tick — the log explains, it
        does not spam."""
        if st.suppressed == reason:
            return None
        st.suppressed = reason
        return self._log(model, st, f"suppressed_{reason}", burn, None,
                         span=span, ok=False,
                         detail=f"deferred by {reason}")

    def _log(self, model, st, action, burn, headroom, span=trace.NOOP,
             ok=True, worker=None, detail=None, dedup=False, role=None,
             predictive=None):
        if dedup:
            if st.suppressed == action:
                return None
            st.suppressed = action
        entry = {
            "ts": time.time(),
            "tick": self.ticks,
            "model": model,
            "action": action,
            "ok": bool(ok),
            "role": role or self._role(),
            "worker": worker,
            "level": st.level,
            "burn": burn,
            "capacity": headroom,
            "trace_id": span.trace_id,
            "detail": detail,
        }
        if predictive is not None:
            entry["predictive"] = predictive
        if span.recording:
            span.set("action", action)
            span.set("ok", bool(ok))
            span.event("decision", action=action, ok=bool(ok))
        # the decision IS a journal event: /v1/autoscaler and
        # the black box read the same record — no double bookkeeping
        journal.emit("autoscale.decision", _trace_id=span.trace_id,
                     controller=self._cid, entry=entry)
        logger.info("autoscaler: %s %s (ok=%s) burn_fast=%.2f "
                    "burn_slow=%.2f level=%d", action, model, ok,
                    burn["burn_fast"], burn["burn_slow"], st.level)
        return entry

    def decision_log(self) -> List[Dict[str, Any]]:
        """THIS controller's decision + election entries, oldest first,
        read back from the event journal (the journal is the
        single source; the deque it replaced is gone). Bounded by the
        configured ``log_capacity`` — and by the journal ring itself: a
        flood of OTHER event types can overwrite old decisions (the
        tradeoff of one shared black box; ``report()`` surfaces the
        ring's ``overwritten_total`` so a shortened log is explainable,
        and ``journal.enable(capacity=...)`` sizes the ring for long
        incidents)."""
        entries = [
            e["attrs"]["entry"]
            for e in journal.events(
                types=("autoscale.decision", "autoscale.election"))
            if e.get("attrs", {}).get("controller") == self._cid
            and isinstance(e.get("attrs", {}).get("entry"), dict)]
        cap = int(self.config.log_capacity)
        return entries[max(0, len(entries) - cap):]

    def report(self) -> Dict[str, Any]:
        """The ``/v1/autoscaler`` payload: config, controller state, and
        the bounded decision log (oldest first, journal-backed)."""
        now = self._now()
        decisions = self.decision_log()
        with self._lock:
            # the states snapshot under the lock: the control thread
            # setdefault()s new models mid-tick, and a dict resize
            # during an unlocked iteration would 500 the scrape
            states = {m: (s.level, s.last_action_ts)
                      for m, s in sorted(self._states.items())}
        out = {
            "config": self.config.to_dict(),
            "ticks": self.ticks,
            "running": self._thread is not None,
            # the log's provenance: journal-backed, with the
            # ring counters that explain a shortened history
            "decision_log_source": ("journal" if journal.enabled()
                                    else "journal_disabled"),
            "journal": journal.counters(),
            "role": self._role(),
            "models": {m: {"level": level,
                           "last_action_age_s": (
                               None if last_ts == float("-inf")
                               else round(now - last_ts, 3))}
                       for m, (level, last_ts) in states.items()},
            "decisions": decisions,
        }
        if self.election is not None:
            # the election record: who holds the lease, how
            # fresh its heartbeat is, and every transition this
            # controller observed
            try:
                out["election"] = self.election.snapshot()
            except Exception:
                out["election"] = {"error": "election snapshot failed"}
        return out

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "SLOAutoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="slo-autoscaler")
        self._thread.start()
        attach = getattr(self.router, "attach_autoscaler", None)
        if attach is not None:
            attach(self)
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.config.tick_s):
            try:
                self.tick()
            except Exception:
                logger.exception("autoscaler tick failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(10.0,
                                          self.config.lever_timeout_s))
            self._thread = None

    def __enter__(self) -> "SLOAutoscaler":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()
