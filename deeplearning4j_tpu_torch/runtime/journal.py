"""Unified fleet event journal: the black box.

The port's own copy of ``deeplearning4j_tpu/runtime/journal.py`` (pure
Python), kept so that the port imports nothing of the JAX package.

The reference DL4J pairs its ``StatsListener`` -> UI-server telemetry
with ``CrashReportingUtil`` — when something dies, a single artifact
tells the whole story. Our stack had the *telemetry* (traces, SLO burn
rates, capacity) but the *operational record* was scattered: autoscaler
decisions in one deque, lease elections in another, breaker state only
as a gauge, fleet restarts only in the supervisor's logger, chaos stamps
only on spans, crash reports as loose files. Reconstructing "what
happened during that SIGKILL drill" meant correlating five endpoints by
hand.

This module is the single ordered record those sources now write to: a
bounded, lock-free, causally-ordered **event journal** — the same ring
discipline as :class:`~deeplearning4j_tpu_torch.runtime.trace.TraceCollector`
— of typed events, one per control-plane state change:

- every event carries a **monotonic per-process ``seq``** (dense — a gap
  in a scraped window means the ring overwrote history, never that an
  event was silently lost in flight), a **wall-clock anchor** ``ts``
  that orders events across processes (same-host skew is microseconds),
  a per-process-incarnation id (a restarted worker's seq reset cannot
  alias its predecessor's events), and the **active trace id** when one
  exists — the journal and the flight recorder cross-link, so a
  breaker-open event names the exact request tree that opened it;
- event *types* are a closed registry (:data:`EVENT_TYPES`), enforced by
  ``analysis/lint.py`` with the same four-way diff as chaos points: an
  emit site whose type is unregistered, a registered type never emitted,
  undocumented in ``docs/observability.md``, or exercised by no
  test/bench drill is each a lint finding;
- **emit is lock-free and cheap**: one ``itertools.count`` draw (atomic
  under the GIL), one dict build, one slot store. Nothing on the serving
  request hot path emits per-request — journal events fire on control
  seams (breaker transitions, page-ins, restarts, deploys, decisions),
  so ``bench.py --blackbox`` bounds the journal-on serving cost < 1%;
- reads are bounded: :func:`bound_events` (shared by the worker and
  router ``/v1/journal`` handlers) applies ``since``/``limit``/``types``
  filters plus a hard serialized-size cap, exactly like
  ``trace.bound_traces``.

The router merges its own ring with every ready worker's
(``GET /v1/journal`` fleet view) via :func:`merge_events`: wall-anchor
first, seq as the within-process tiebreak — so a worker restart (seq
resets to 0, new incarnation) cannot reorder the merged view, and one
scrape yields the fleet's full ordered timeline. ``serving/blackbox.py``
builds the anomaly watchdog and the one-``curl`` incident bundle on top.

The journal is ON by default (a black box that must be switched on
before the crash records nothing); ``DL4J_TPU_JOURNAL=0`` or
:func:`disable` restores a no-op fast path (one global load + ``is
None`` test), which is the off arm of the bench A/B.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import time
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.runtime import trace

__all__ = [
    "EVENT_TYPES", "EventJournal", "emit", "events", "counters",
    "enable", "disable", "enabled", "journal", "incarnation",
    "merge_events", "bound_events", "render_prometheus",
    "JOURNAL_RESPONSE_BYTE_CAP",
]

# Central journal-event-type registry: every event type
# emitted anywhere in the package, name -> one-line description. The
# analysis lint diffs this registry against (a) the ``journal.emit``
# call sites in code, (b) the ``docs/observability.md`` event-schema
# rows, and (c) the test/bench corpus — the same four-way parity as
# ``chaos.REGISTERED_POINTS``, so code, registry, docs and drills can
# never drift apart.
EVENT_TYPES: Dict[str, str] = {
    "breaker.open": "circuit breaker tripped OPEN (scope: model:* or worker:*)",
    "breaker.half_open": "breaker reset timeout elapsed; probing",
    "breaker.close": "half-open probe succeeded; breaker CLOSED",
    "router.hedge": "router launched a hedge against a second worker",
    "router.failover": "every launched attempt failed; retrying elsewhere",
    "router.shed_window": "router honoring a worker's Retry-After shed hint",
    "router.worker_ready": "router probe readmitted a worker (not-ready -> ready)",
    "router.worker_unready": "router probe lost a worker (ready -> not-ready)",
    "router.wire_downgrade": "worker answered 415 to a binary frame; router pinned JSON for it",
    "autoscale.decision": "one SLOAutoscaler decision (acted/refused/deferred)",
    "autoscale.election": "lease transition (acquired/takeover/lost/released)",
    "control.config_apply": "a FleetConfig mutation committed (new version)",
    "control.deploy_stage": "rolling-deploy stage (claim/drain/restart/readmit/done)",
    "fleet.worker_spawn": "supervisor spawned a worker process",
    "fleet.worker_restart": "supervisor relaunched a worker (crash or intentional)",
    "fleet.worker_retire": "supervisor retired a worker from the fleet",
    "fleet.worker_kill": "SIGKILL issued to a worker (the chaos drill's hammer)",
    "registry.hot_swap": "a model hot-swapped to a new version",
    "registry.page_in": "a cold model rehydrated under the HBM budget",
    "registry.evict": "a resident model paged out to COLD",
    "registry.residency_lever": "explicit residency lever (POST .../residency)",
    "train.checkpoint": "a checkpoint archive written (atomic + manifested)",
    "train.resume": "a restarted trainer restored from a checkpoint",
    "train.restart": "supervised trainer counted a restart against its budget",
    "delivery.gate": "a candidate's golden-set gate verdict (pass/fail/refused)",
    "delivery.stage": "gated-delivery stage transition (shadow/canary/ramp/verdict)",
    "delivery.shadow_stats": "shadow stage closed: mirror comparison stats + verdict",
    "delivery.rollback": "gated delivery auto-rolled back to the incumbent (cause)",
    "delivery.promote": "gated delivery promoted the candidate fleet-wide",
    "chaos.action": "a chaos policy acted (fault/latency/corruption injected)",
    "crash.report": "CrashReportingUtil wrote (or failed to write) a dump",
    "incident.open": "anomaly watchdog opened an incident (rule + evidence)",
    "incident.close": "anomaly watchdog closed an incident (quiet again)",
    "session.create": "streaming session opened (zero carry, spill written)",
    "session.step_miss": "session step found no resident carry; rehydrating",
    "session.spill": "session carry pushed cold to its CRC-framed spill file",
    "session.rehydrate": "session carry read back from spill (CRC-verified)",
    "session.migrate": "session moved workers (rehydrated a foreign spill)",
    "session.evict": "session memory copy dropped (idle TTL or byte budget)",
    "session.close": "streaming session closed; spill file deleted",
    "scheduler.submit": "background job submitted to the shared job store",
    "scheduler.claim": "scheduler claim attempt on a job (won or lost the ledger race)",
    "scheduler.start": "claimed job started running on a worker's spare capacity",
    "scheduler.preempt": "traffic preempted a running job (checkpointed mid-run)",
    "scheduler.resume": "preempted job resumed from its checkpoint (exact batch-skip)",
    "scheduler.complete": "background job ran to completion (result recorded)",
    "scheduler.fail": "background job raised; failure recorded in the job store",
    "scheduler.cancel": "background job cancelled before completion",
}

#: per-process-incarnation id: a restarted worker starts a fresh seq
#: stream under a fresh incarnation, so merged views can never alias two
#: lifetimes of the same worker id into one stream
_INCARNATION = f"{random.getrandbits(48):012x}"


def incarnation() -> str:
    return _INCARNATION


class EventJournal:
    """Bounded lock-free ring of journal events.

    ``record`` assigns the event its dense per-process ``seq`` from an
    ``itertools.count`` (atomic under the GIL) and stores it in
    ``seq % capacity`` — a single slot store, no lock, old events
    overwritten. Readers snapshot the slots and sort by seq (the read
    path is not hot).
    """

    def __init__(self, capacity: int = 1024):
        self.capacity = max(1, int(capacity))
        self._slots: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._n = itertools.count()

    def record(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        seq = next(self._n)
        rec["seq"] = seq
        self._slots[seq % self.capacity] = rec
        return rec

    def events(self, since: Optional[float] = None,
               limit: Optional[int] = None,
               types: Optional[Iterable[str]] = None
               ) -> List[Dict[str, Any]]:
        """Live events oldest-first, optionally filtered: ``since`` is a
        wall-clock lower bound, ``types`` an allow-set, ``limit`` keeps
        the newest N of what remains."""
        recs = [r for r in list(self._slots) if r is not None]
        recs.sort(key=lambda r: r["seq"])
        if types is not None:
            tset = set(types)
            recs = [r for r in recs if r["type"] in tset]
        if since is not None:
            recs = [r for r in recs if r["ts"] >= float(since)]
        if limit is not None and int(limit) >= 0:
            recs = recs[max(0, len(recs) - int(limit)):]
        return recs

    def counters(self) -> Dict[str, int]:
        """``events_total`` is derived from the newest live seq (seqs are
        dense, so newest+1 == emitted) — no separate counter to race."""
        live = [r["seq"] for r in list(self._slots) if r is not None]
        total = (max(live) + 1) if live else 0
        return {"events_total": total,
                "capacity": self.capacity,
                "live": len(live),
                "overwritten_total": max(0, total - self.capacity)}

    def clear(self) -> None:
        self._slots = [None] * self.capacity


def _env_enabled(environ) -> bool:
    return environ.get("DL4J_TPU_JOURNAL", "").strip().lower() not in (
        "0", "false", "off", "no")


_JOURNAL: Optional[EventJournal] = (
    EventJournal() if _env_enabled(os.environ) else None)


def enable(capacity: Optional[int] = None) -> EventJournal:
    """(Re)install the process journal; ``capacity`` replaces the ring
    with a fresh one of that size."""
    global _JOURNAL
    if capacity is not None or _JOURNAL is None:
        _JOURNAL = EventJournal(capacity or 1024)
    return _JOURNAL


def disable() -> None:
    """No-op fast path: subsequent ``emit`` calls do nothing (the off
    arm of ``bench.py --blackbox``'s A/B)."""
    global _JOURNAL
    _JOURNAL = None


def enabled() -> bool:
    return _JOURNAL is not None


def journal() -> Optional[EventJournal]:
    return _JOURNAL


def emit(etype: str, _trace_id: Optional[str] = None,
         **attrs: Any) -> Optional[Dict[str, Any]]:
    """Record one typed event. THE emit entry point: with the journal
    disabled this is one global load and an ``is None`` test. The active
    trace id (when any) is captured automatically so the journal and the
    flight recorder cross-link; ``_trace_id`` overrides it. Returns the
    stored record (or ``None`` when disabled). Never raises — the black
    box must not be able to fail the system it records."""
    j = _JOURNAL
    if j is None:
        return None
    try:
        tid = _trace_id if _trace_id is not None else trace.current_trace_id()
        return j.record({"ts": time.time(), "type": str(etype),
                         "process": trace.process_tag(),
                         "incarnation": _INCARNATION,
                         "trace_id": tid, "attrs": attrs})
    except Exception:
        return None


def events(since: Optional[float] = None, limit: Optional[int] = None,
           types: Optional[Iterable[str]] = None) -> List[Dict[str, Any]]:
    """This process's live events (empty when disabled)."""
    j = _JOURNAL
    return [] if j is None else j.events(since=since, limit=limit,
                                         types=types)


def counters() -> Dict[str, int]:
    j = _JOURNAL
    if j is None:
        return {"events_total": 0, "capacity": 0, "live": 0,
                "overwritten_total": 0}
    return j.counters()


# ------------------------------------------------------------ merge + bound
def merge_events(streams: Iterable[Iterable[Dict[str, Any]]]
                 ) -> List[Dict[str, Any]]:
    """Merge per-process event streams into one fleet timeline,
    de-duplicated by ``(incarnation, seq)`` and ordered by **wall anchor
    first, seq second** — the wall clock orders across processes; the
    dense seq breaks same-tick ties within a process. Seq is NOT the
    primary key on purpose: a restarted worker's seq resets to 0 under a
    fresh incarnation, and seq-first ordering would teleport its new
    events before its old ones (the satellite regression test)."""
    seen: Set[Tuple[str, int]] = set()
    out: List[Dict[str, Any]] = []
    for stream in streams:
        for rec in stream or ():
            key = (rec.get("incarnation", "?"), int(rec.get("seq", -1)))
            if key in seen:
                continue
            seen.add(key)
            out.append(rec)
    out.sort(key=lambda r: (r.get("ts") or 0.0, r.get("seq") or 0,
                            r.get("incarnation") or ""))
    return out


#: hard cap on one ``/v1/journal`` response body — a scrape of a full
#: ring must never produce an unbounded HTTP body (the trace.bound_traces
#: contract, applied to events)
JOURNAL_RESPONSE_BYTE_CAP = 2 * 1024 * 1024


def bound_events(records: Iterable[Dict[str, Any]],
                 since: Optional[float] = None,
                 limit: Optional[int] = None,
                 types: Optional[Iterable[str]] = None,
                 max_bytes: Optional[int] = None):
    """The ``/v1/journal`` handlers' shared read bound: ``since`` /
    ``types`` filter, ``limit`` keeps the newest N, and the serialized
    size of what remains is capped (default
    :data:`JOURNAL_RESPONSE_BYTE_CAP`) by dropping oldest-first — the
    newest event always survives. Returns
    ``(events_oldest_first, truncated)``."""
    recs = sorted(records, key=lambda r: (r.get("ts") or 0.0,
                                          r.get("seq") or 0))
    if types is not None:
        tset = set(types)
        recs = [r for r in recs if r.get("type") in tset]
    if since is not None:
        recs = [r for r in recs if (r.get("ts") or 0.0) >= float(since)]
    truncated = False
    if limit is not None and int(limit) >= 0 and len(recs) > int(limit):
        truncated = True
        recs = recs[len(recs) - int(limit):]
    cap = JOURNAL_RESPONSE_BYTE_CAP if max_bytes is None else int(max_bytes)
    total, kept = 0, []
    for r in reversed(recs):               # newest first
        size = len(json.dumps(r, default=str).encode())
        if kept and total + size > cap:
            truncated = True
            break
        kept.append(r)
        total += size
    kept.reverse()
    return kept, truncated


def render_prometheus() -> str:
    """The ``journal_*`` gauges for ``/metrics`` (both tiers)."""
    c = counters()
    return "\n".join([
        f"journal_enabled {int(enabled())}",
        f"journal_events_total {c['events_total']}",
        f"journal_ring_capacity {c['capacity']}",
        f"journal_overwritten_total {c['overwritten_total']}",
    ]) + "\n"
