"""Anomaly watchdog + one-command incident bundles over the event
journal (``docs/observability.md`` "Black box"; counterpart of
``deeplearning4j_tpu/serving/blackbox.py``: the bundle's entry names are
the JAX package's, so an incident bundle reads the same whichever package
wrote it).

Two consumers of :mod:`deeplearning4j_tpu_torch.runtime.journal`:

- :class:`AnomalyWatchdog` — journal-rate + SLO-ring rules evaluated on
  the router's control cadence (the probe loop calls
  :meth:`AnomalyWatchdog.maybe_tick`; drills call :meth:`tick`
  directly). A firing rule opens an ``incident.open`` journal event
  carrying the rule name, the triggering count and the evidence seqs;
  once the rule stays quiet for ``clear_after_s`` the incident closes
  with an ``incident.close`` event and its duration. The default rule
  set names the fleet's known failure smells: **breaker-flap** (breakers
  tripping repeatedly), **restart-storm** (the supervisor relaunching
  over and over), **page-in-thrash** (the pager evicting and reloading
  in a loop — the budget is too tight for the traffic), **election
  churn** (the autoscaler lease changing hands repeatedly), plus an
  SLO-ring **fast-burn** rule over the router's fleet-wide monitor.
  Clocks are injectable so every rule unit-tests without sleeping.

- :func:`fleet_bundle` / :func:`local_bundle` — ``GET /v1/debug/bundle``:
  ONE tar.gz that makes any drill or outage a self-contained postmortem:
  the fleet-merged journal window, the kept traces, the Prometheus
  ``/metrics`` text, the ``/v1/capacity`` and ``/v1/slo`` payloads, the
  autoscaler decision log, the shared-config version, a
  ``sys._current_frames`` stack sample per process (the router fetches
  each worker's via ``/v1/debug/stacks``), the newest crash-report
  files, and a manifest listing exactly what made it in (a fetch that
  failed is named in the manifest, never silently absent).

Like the router, this module is host code: it touches no device.
"""

from __future__ import annotations

import glob
import io
import json
import os
import sys
import tarfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.runtime import journal, trace

__all__ = ["RateRule", "BurnRule", "AnomalyWatchdog", "default_rules",
           "stack_sample", "build_bundle", "local_bundle", "fleet_bundle",
           "crash_report_paths"]


# ------------------------------------------------------------------- rules
class RateRule:
    """Journal-rate rule: fires when at least ``threshold`` events of the
    given types landed within the trailing ``window_s`` (wall-anchored,
    so merged multi-process windows evaluate correctly)."""

    def __init__(self, name: str, event_types, threshold: int,
                 window_s: float, description: str = ""):
        self.name = str(name)
        self.event_types = frozenset(event_types)
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.description = description

    def evaluate(self, events: List[Dict[str, Any]], now_wall: float
                 ) -> Optional[Dict[str, Any]]:
        cutoff = now_wall - self.window_s
        hits = [e for e in events
                if e.get("type") in self.event_types
                and (e.get("ts") or 0.0) >= cutoff]
        if len(hits) < self.threshold:
            return None
        return {"count": len(hits), "threshold": self.threshold,
                "window_s": self.window_s,
                "evidence_seqs": [e.get("seq") for e in hits[-16:]],
                "evidence_trace_ids": sorted(
                    {e.get("trace_id") for e in hits
                     if e.get("trace_id")})[:16]}

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": "journal_rate",
                "event_types": sorted(self.event_types),
                "threshold": self.threshold, "window_s": self.window_s,
                "description": self.description}


class BurnRule:
    """SLO-ring rule: fires when any model's fast-window burn rate (the
    max of availability/latency burn, the autoscaler's signal) is at or
    over ``burn`` with at least ``min_requests`` in the window.
    ``monitor`` is an :class:`~deeplearning4j_tpu_torch.serving.slo.SLOMonitor`
    (the router's fleet-wide one)."""

    def __init__(self, monitor, name: str = "slo_fast_burn",
                 window_s: int = 60, burn: float = 2.0,
                 min_requests: int = 8, description: str = ""):
        self.monitor = monitor
        self.name = str(name)
        self.window_s = int(window_s)
        self.burn = float(burn)
        self.min_requests = int(min_requests)
        self.description = description

    def evaluate(self, events, now_wall) -> Optional[Dict[str, Any]]:
        try:
            report = self.monitor.report()
        except Exception:
            return None  # a failing read must not flap an incident
        burning = {}
        for model, rep in sorted(report.items()):
            w = (rep.get("windows") or {}).get(f"{self.window_s}s")
            if not w or int(w.get("requests", 0)) < self.min_requests:
                continue
            b = max(float(w.get("availability_burn_rate", 0.0)),
                    float(w.get("latency_burn_rate", 0.0)))
            if b >= self.burn:
                burning[model] = round(b, 3)
        if not burning:
            return None
        return {"burning_models": burning, "burn_threshold": self.burn,
                "window_s": self.window_s}

    def describe(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": "slo_burn",
                "window_s": self.window_s, "burn": self.burn,
                "min_requests": self.min_requests,
                "description": self.description}


def default_rules(monitor=None) -> List[Any]:
    """The stock rule set (thresholds sized for production cadences;
    drills shrink them)."""
    rules: List[Any] = [
        RateRule("breaker_flap", {"breaker.open"}, threshold=3,
                 window_s=60.0,
                 description="breakers tripping repeatedly: a worker or "
                             "model is oscillating between dead and "
                             "half-open instead of recovering"),
        RateRule("restart_storm",
                 {"fleet.worker_restart", "fleet.worker_kill"},
                 threshold=3, window_s=120.0,
                 description="the supervisor is relaunching workers in a "
                             "loop: crash loop or heartbeat starvation"),
        RateRule("page_in_thrash", {"registry.page_in", "registry.evict"},
                 threshold=6, window_s=60.0,
                 description="the pager is evicting and reloading in a "
                             "cycle: the HBM budget is too tight for the "
                             "working set"),
        RateRule("election_churn", {"autoscale.election"}, threshold=3,
                 window_s=120.0,
                 description="the autoscaler lease keeps changing hands: "
                             "leader heartbeats are starving or fencing "
                             "is racing"),
    ]
    if monitor is not None:
        rules.append(BurnRule(monitor,
                              description="fast-window burn at page-now "
                                          "levels on at least one model"))
    return rules


# ---------------------------------------------------------------- watchdog
class AnomalyWatchdog:
    """Evaluate rules over the journal on the control cadence; open and
    close ``incident`` journal events.

    ``events_fn`` supplies the event window (default: this process's
    journal — the router process sees breaker/hedge/failover/decision/
    restart events when the supervisor is co-resident, which is the
    drill topology); ``wall_fn``/``mono_fn`` are injectable clocks so
    rule units run without sleeping. ``tick()`` is the drill seam;
    ``maybe_tick()`` rate-limits to ``interval_s`` for the router's
    probe loop."""

    def __init__(self, rules: Optional[List[Any]] = None,
                 events_fn: Optional[Callable[[], List[Dict[str, Any]]]]
                 = None,
                 clear_after_s: float = 30.0, interval_s: float = 0.5,
                 wall_fn: Callable[[], float] = time.time,
                 mono_fn: Callable[[], float] = time.monotonic):
        self.rules = list(rules) if rules is not None else default_rules()
        self._events_fn = events_fn or (lambda: journal.events())
        self.clear_after_s = float(clear_after_s)
        self.interval_s = float(interval_s)
        self._wall = wall_fn
        self._mono = mono_fn
        # guards: _open, incidents_total, ticks, _last_tick
        self._lock = threading.Lock()
        self._open: Dict[str, Dict[str, Any]] = {}
        self.incidents_total = 0
        self.ticks = 0
        self._last_tick = float("-inf")

    def maybe_tick(self) -> None:
        """Tick if at least ``interval_s`` passed since the last one —
        the router probe loop's cheap call."""
        now = self._mono()
        with self._lock:
            if now - self._last_tick < self.interval_s:
                return
            self._last_tick = now
        self.tick()

    def tick(self) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the incident events (open/close)
        emitted this tick."""
        now = self._wall()
        try:
            events = [e for e in self._events_fn()
                      if not str(e.get("type", "")).startswith("incident.")]
        except Exception:
            events = []  # a failing read must not crash the control loop
        emitted: List[Dict[str, Any]] = []
        with self._lock:
            self.ticks += 1
            for rule in self.rules:
                firing = rule.evaluate(events, now)
                state = self._open.get(rule.name)
                if firing is not None:
                    if state is None:
                        self.incidents_total += 1
                        rec = journal.emit("incident.open", rule=rule.name,
                                           **firing)
                        self._open[rule.name] = {
                            "opened_ts": now, "last_firing_ts": now,
                            "open_seq": (rec or {}).get("seq"),
                            "evidence": firing}
                        if rec is not None:
                            emitted.append(rec)
                    else:
                        state["last_firing_ts"] = now
                        state["evidence"] = firing
                elif state is not None and \
                        now - state["last_firing_ts"] >= self.clear_after_s:
                    rec = journal.emit(
                        "incident.close", rule=rule.name,
                        duration_s=round(now - state["opened_ts"], 3),
                        open_seq=state.get("open_seq"))
                    del self._open[rule.name]
                    if rec is not None:
                        emitted.append(rec)
        return emitted

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"rules": [r.describe() for r in self.rules],
                    "open": {k: dict(v) for k, v in self._open.items()},
                    "incidents_total": self.incidents_total,
                    "ticks": self.ticks,
                    "clear_after_s": self.clear_after_s}

    def render_prometheus(self) -> str:
        with self._lock:
            open_rules = set(self._open)
            total = self.incidents_total
        lines = [f"incident_opens_total {total}"]
        for rule in self.rules:
            lines.append(f'incident_open{{rule="{rule.name}"}} '
                         f"{int(rule.name in open_rules)}")
        return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ bundle
def stack_sample() -> Dict[str, List[str]]:
    """``sys._current_frames`` rendered per thread — the "where is every
    thread right now" page of the black box."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        out[f"{names.get(tid, 'unknown')}@{tid}"] = \
            traceback.format_stack(frame)
    return out


def crash_report_paths(n: int = 5,
                       directory: Optional[str] = None) -> List[str]:
    """The newest ``n`` CrashReportingUtil dump files (mtime order,
    newest first) from ``directory`` (default: the configured
    ``crash_dump_dir``, else cwd)."""
    if directory is None:
        from deeplearning4j_tpu_torch.runtime.crash_reporting import \
            CrashReportingUtil
        directory = CrashReportingUtil.crash_dump_dir or os.getcwd()
    paths = glob.glob(os.path.join(directory,
                                   "dl4j-tpu-memory-crash-dump-*.txt"))

    def mtime(p):
        # a dump deleted between glob and stat (tmp reaper racing the
        # bundle pull) must not 500 the whole bundle
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0.0
    paths.sort(key=mtime, reverse=True)
    return paths[:max(0, int(n))]


def build_bundle(entries: Dict[str, bytes]) -> bytes:
    """Tar.gz the named entries in-memory (sorted, deterministic
    member order)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for name, data in sorted(entries.items()):
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            info.mtime = int(time.time())
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _jsonb(obj: Any) -> bytes:
    return json.dumps(obj, indent=1, sort_keys=True,
                      default=str).encode()


def _collect(entries: Dict[str, bytes], errors: Dict[str, str],
             name: str, fn: Callable[[], bytes]) -> None:
    """One bundle section, best-effort: a failing fetch lands in the
    manifest's ``errors`` map instead of silently missing."""
    try:
        entries[name] = fn()
    except Exception as e:
        errors[name] = repr(e)


def _finish(entries: Dict[str, bytes], errors: Dict[str, str],
            meta: Dict[str, Any]) -> bytes:
    meta = dict(meta)
    meta["created_at"] = time.time()
    meta["incarnation"] = journal.incarnation()
    meta["errors"] = errors
    meta["contents"] = sorted(list(entries) + ["manifest.json"])
    entries["manifest.json"] = _jsonb(meta)
    return build_bundle(entries)


def _crash_report_entries(entries: Dict[str, bytes],
                          errors: Dict[str, str], n: int = 5) -> None:
    for path in crash_report_paths(n):
        def read(p=path):
            with open(p, "rb") as f:
                return f.read()
        _collect(entries, errors,
                 f"crash_reports/{os.path.basename(path)}", read)


def local_bundle(server) -> bytes:
    """One process's bundle (the worker's ``/v1/debug/bundle``):
    journal, kept traces, metrics text, capacity, SLO, stacks, crash
    reports."""
    entries: Dict[str, bytes] = {}
    errors: Dict[str, str] = {}
    evs, truncated = journal.bound_events(journal.events())
    entries["journal.json"] = _jsonb({"events": evs,
                                      "truncated": truncated,
                                      "counters": journal.counters()})
    _collect(entries, errors, "traces.json",
             lambda: _jsonb(trace.collector().traces()))
    _collect(entries, errors, "metrics.txt",
             lambda: server._render_metrics().encode())
    def cap():
        from deeplearning4j_tpu_torch.serving import capacity
        return _jsonb(capacity.registry_capacity(server.registry))
    _collect(entries, errors, "capacity.json", cap)
    _collect(entries, errors, "slo.json", lambda: _jsonb(server.slo.report()))
    _collect(entries, errors, f"stacks/{trace.process_tag()}.json",
             lambda: _jsonb(stack_sample()))
    _crash_report_entries(entries, errors)
    return _finish(entries, errors,
                   {"kind": "worker", "worker": server.worker_id})


def fleet_bundle(router) -> bytes:
    """The fleet bundle (the router's ``/v1/debug/bundle``): the merged
    journal window, merged traces, fleet-aggregated metrics/capacity/SLO,
    the autoscaler log, the shared-config version, a stack sample for
    the router AND every ready worker (scraped via ``/v1/debug/stacks``),
    the watchdog state, and the newest crash reports — one curl away
    from a self-contained postmortem."""
    entries: Dict[str, bytes] = {}
    errors: Dict[str, str] = {}

    def merged_journal():
        evs, truncated = router.fleet_journal()
        return _jsonb({"events": evs, "truncated": truncated,
                       "counters": journal.counters()})
    _collect(entries, errors, "journal.json", merged_journal)

    def traces():
        recs, truncated = router.aggregate_traces_bounded()
        return _jsonb({"traces": recs, "truncated": truncated})
    _collect(entries, errors, "traces.json", traces)
    _collect(entries, errors, "metrics.txt",
             lambda: (router.metrics.render_prometheus(router.workers())
                      + router.render_fleet_metrics()
                      + router._render_blackbox_metrics()).encode())
    _collect(entries, errors, "capacity.json",
             lambda: _jsonb(router.fleet_capacity()))
    _collect(entries, errors, "slo.json",
             lambda: _jsonb(router.slo.report()))
    if router.autoscaler is not None:
        _collect(entries, errors, "autoscaler.json",
                 lambda: _jsonb(router.autoscaler.report()))
    if getattr(router, "watchdog", None) is not None:
        _collect(entries, errors, "watchdog.json",
                 lambda: _jsonb(router.watchdog.snapshot()))
    # the router's own stacks under a router-prefixed name: the process
    # tag can legitimately equal a worker id (an in-process ModelServer
    # set it earlier), and the per-worker scrape below must not be able
    # to collide with (and silently replace) this process's sample
    _collect(entries, errors,
             f"stacks/router-{router.router_id}.json",
             lambda: _jsonb(stack_sample()))

    def worker_stacks():
        return router._scrape_workers("/v1/debug/stacks")
    try:
        for wid, payload in sorted(worker_stacks().items()):
            entries[f"stacks/{wid}.json"] = _jsonb(
                payload.get("stacks", payload))
    except Exception as e:
        errors["stacks/workers"] = repr(e)

    meta: Dict[str, Any] = {"kind": "fleet", "router": router.router_id}
    if router._config is not None:
        try:
            meta["config"] = router._config.counters()
        except Exception as e:
            errors["config"] = repr(e)
    _crash_report_entries(entries, errors)
    return _finish(entries, errors, meta)
