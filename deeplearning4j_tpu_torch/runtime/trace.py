"""End-to-end distributed tracing: the flight recorder for the fleet and
the trainer.

The port's own copy of ``deeplearning4j_tpu/runtime/trace.py`` (pure
Python), kept so that the port imports nothing of the JAX package.

The stack spans processes — ``FleetRouter`` -> supervised ``ModelServer``
workers -> batcher pipeline -> ``ReplicaPool``, and ``DistributedTrainer``
ranks — but until this module every observability surface was per-process
and per-subsystem (``/metrics`` histograms, profiler sections,
``ExchangeStats``). Nothing correlated ONE request (or one training step)
across those boundaries. This is the Dapper-shaped answer, and the analog
of the reference DL4J's ``StatsListener`` -> UI-server pipeline
(``docs/parity.md``): every unit of work is a :class:`Span` in a trace
tree, propagated

- **in-process** via a ``contextvars`` context (``span()`` parents to the
  caller's active span) and explicitly across the batcher's worker
  threads (a request's span rides its ``_Request``; batch stage spans
  parent to the first traced request of the batch), and
- **cross-process** via the ``X-Trace-Id`` / ``X-Parent-Span-Id`` HTTP
  headers, piggybacking the fleet tier's existing ``X-Request-Id`` /
  ``X-Deadline-Ms`` plumbing — the router's attempt span id becomes the
  worker's root span parent, so router-side aggregation
  (``FleetRouter /v1/traces``) can merge worker spans into one tree.

Design constraints (the serving hot path calls into this unconditionally):

- **Disabled = no-op fast path, zero allocations.** With tracing off (the
  default; ``enable()`` never called, or rate 0 via ``DL4J_TPU_TRACE``),
  ``span(name)`` is one module-global load, an ``is None`` test, and the
  return of a shared singleton no-op span — nothing allocates, nothing
  locks, and ``current_span()`` is ``None`` (``bench.py
  --trace-overhead`` asserts this path is allocation-free and
  bit-identical).
- **Tail-based sampling.** While enabled, every request is *recorded*;
  the keep/drop decision happens when the trace completes (root span and
  every late child — e.g. a hedge loser — finished): a trace that was
  flagged (``shed``, ``fault``, ``hedged``, ``deadline``, ``chaos``,
  ``slow``) is ALWAYS kept; a healthy trace is kept with probability
  ``rate`` (so ``enable(rate=0.0)`` keeps exactly the interesting
  traces). This is what makes a post-hoc fault-drill investigation
  possible without paying for healthy traffic.
- **Bounded memory.** Kept traces land in a fixed-capacity lock-free
  ring buffer (:class:`TraceCollector`) — one slot store per trace, old
  traces overwritten, no growth under sustained load.
- **Monotonic timing.** Span durations come from ``time.monotonic()``;
  a wall-clock anchor per span start orders spans across processes
  (same-host skew is microseconds — the fleet topology this serves).

Export: :func:`to_chrome_trace` renders trace records as Chrome
trace-event JSON (``chrome://tracing`` / Perfetto's legacy loader —
``ph: "X"`` complete events per span, ``ph: "i"`` instants per chaos
stamp); :func:`merge_traces` merges multi-process records by trace id
(span-id deduplicated); :func:`span_tree` rebuilds the parent/child tree.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import random
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "Span", "TraceCollector", "TraceConfig", "enable", "disable", "enabled",
    "span", "server_span", "current_span", "current_trace_id", "collector",
    "flag_current", "annotate_current", "stamp_chaos", "stage_event",
    "merge_traces", "span_tree", "to_chrome_trace", "set_process_tag",
    "process_tag",
    "access_log_enabled", "emit_access_log", "bound_traces",
    "TRACES_RESPONSE_BYTE_CAP", "NOOP",
]

_CURRENT: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("dl4j_tpu_trace_span", default=None)

_ids = itertools.count(1)
# per-process random base: ids are collision-free within a process by the
# counter and across processes by the base; formatting one small counter
# is several times cheaper than drawing fresh random bits per span (this
# runs on the serving hot path for every recorded span)
_ID_BASE = f"{random.getrandbits(48):012x}"


def _new_id() -> str:
    """Process-unique span/trace id (no uuid machinery on the recording
    path)."""
    return _ID_BASE + format(next(_ids), "08x")


# ---------------------------------------------------------------- collector
class TraceCollector:
    """Bounded lock-free ring buffer of kept trace records.

    ``record`` is a single slot store (the index comes from an
    ``itertools.count``, atomic under the GIL) — no lock on the keep path;
    a full ring overwrites the oldest trace. Readers snapshot the slots.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        # each slot holds (insertion seq, record) or None
        self._slots: List[Optional[tuple]] = [None] * self.capacity
        self._n = itertools.count()
        # kept/dropped are per-TRACE (not per-span) counters; a plain
        # `+= 1` from concurrent finalizing threads loses updates, so
        # they take a (rarely contended) lock — the slot store itself
        # stays lock-free via the atomic counter
        self._count_lock = threading.Lock()  # guards: kept, dropped
        self.kept = 0        # traces stored (monotonic; ring may overwrite)
        self.dropped = 0     # completed traces the sampler discarded

    def record(self, rec: Dict[str, Any]) -> None:
        n = next(self._n)
        self._slots[n % self.capacity] = (n, rec)
        with self._count_lock:
            self.kept += 1

    def record_dropped(self) -> None:
        with self._count_lock:
            self.dropped += 1

    def traces(self) -> List[Dict[str, Any]]:
        """Recent kept traces, oldest first (at most ``capacity``). Slots
        carry their insertion sequence so order survives ring wraparound
        (the read path is not hot; sorting <= capacity entries is fine)."""
        entries = [e for e in list(self._slots) if e is not None]
        entries.sort(key=lambda e: e[0])
        return [rec for _, rec in entries]

    def find(self, trace_id: str) -> Optional[Dict[str, Any]]:
        for rec in reversed(self.traces()):
            if rec.get("trace_id") == trace_id:
                return rec
        return None

    def clear(self) -> None:
        self._slots = [None] * self.capacity


# ------------------------------------------------------------------- config
class TraceConfig:
    """Sampling policy: ``rate`` is the probability of keeping a HEALTHY
    completed trace; flagged traces (shed/fault/hedged/deadline/chaos/slow)
    are always kept. ``latency_threshold_ms`` flags any trace whose root
    span exceeds it (``slow``). ``seed`` makes the probabilistic decision
    replayable in tests."""

    __slots__ = ("rate", "latency_threshold_ms", "_rng", "_rng_lock")

    def __init__(self, rate: float = 0.0,
                 latency_threshold_ms: Optional[float] = None,
                 seed: Optional[int] = None):
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.latency_threshold_ms = (None if latency_threshold_ms is None
                                     else float(latency_threshold_ms))
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()  # guards: _rng

    def keep(self, flagged: bool) -> bool:
        if flagged:
            return True
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        with self._rng_lock:
            return self._rng.random() < self.rate


_CONFIG: Optional[TraceConfig] = None
_COLLECTOR = TraceCollector()
_PROCESS_TAG = f"pid-{os.getpid()}"


def set_process_tag(tag: str) -> None:
    """Name this process in exported traces (``ModelServer`` sets its
    ``worker_id``; defaults to ``pid-<n>``)."""
    global _PROCESS_TAG
    _PROCESS_TAG = str(tag)


def process_tag() -> str:
    """This process's tag — shared with the event journal
    (``runtime/journal.py``) so journal events and trace spans name the
    same process the same way."""
    return _PROCESS_TAG


def enable(rate: float = 0.0, latency_threshold_ms: Optional[float] = None,
           capacity: Optional[int] = None,
           seed: Optional[int] = None) -> TraceConfig:
    """Turn tracing on with the given tail-sampling policy. ``capacity``
    (when given) replaces the process collector with a fresh ring of that
    size. Returns the installed config."""
    global _CONFIG, _COLLECTOR
    if capacity is not None:
        _COLLECTOR = TraceCollector(capacity)
    _CONFIG = TraceConfig(rate, latency_threshold_ms, seed)
    return _CONFIG


def disable() -> None:
    """Back to the no-op fast path (in-flight traces finish un-kept)."""
    global _CONFIG
    _CONFIG = None


def enabled() -> bool:
    return _CONFIG is not None


def collector() -> TraceCollector:
    return _COLLECTOR


# -------------------------------------------------------------- trace state
class _TraceState:
    """Per-trace accumulation shared by every span of one trace in one
    process: the span buffer, the flag set, and the open-span count that
    defers the tail-sampling decision until the LAST span (e.g. a hedge
    loser completing after the root) has finished."""

    __slots__ = ("trace_id", "spans", "flags", "open", "root_done", "lock")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.spans: List[Dict[str, Any]] = []
        self.flags: set = set()
        self.open = 0
        self.root_done = False
        self.lock = threading.Lock()  # guards: open, root_done

    def span_started(self) -> None:
        with self.lock:
            self.open += 1

    def span_finished(self, span: "Span") -> None:
        """Buffer the finished Span OBJECT — serialization to dicts is
        deferred to :meth:`_finalize` and paid only for KEPT traces (at a
        sampling rate of r, 1-r of the traffic skips it entirely)."""
        with self.lock:
            self.spans.append(span)
            self.open -= 1
            if span._is_root:
                self.root_done = True
            done = self.root_done and self.open == 0
        if done:
            self._finalize()

    def _finalize(self) -> None:
        cfg = _CONFIG
        spans, self.spans = self.spans, []  # break the span<->state cycle
        if cfg is None:
            return  # tracing was disabled mid-trace: drop silently
        if cfg.keep(bool(self.flags)):
            _COLLECTOR.record({
                "trace_id": self.trace_id,
                "process": _PROCESS_TAG,
                "flags": sorted(self.flags),
                "spans": [s.to_dict() for s in spans],
            })
        else:
            _COLLECTOR.record_dropped()


# --------------------------------------------------------------------- span
class Span:
    """One timed unit of work. Use as a context manager; annotate with
    :meth:`set`, stamp point events with :meth:`event`, and mark the whole
    trace interesting with :meth:`flag`. ``child()`` creates an
    explicitly-parented span for work handed to another thread (the
    batcher's stage threads)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_ts",
                 "_t0", "duration_s", "annotations", "events", "thread",
                 "_state", "_token", "_is_root", "_done")

    recording = True

    def __init__(self, name: str, state: _TraceState,
                 parent_id: Optional[str], is_root: bool):
        self.name = name
        self.trace_id = state.trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start_ts = time.time()
        self._t0 = time.monotonic()
        self.duration_s: Optional[float] = None
        self.annotations: Dict[str, Any] = {}
        self.events: Optional[List[Dict[str, Any]]] = None  # lazy: rare
        self.thread = threading.current_thread().name
        self._state = state
        self._token = None
        self._is_root = is_root
        self._done = False
        state.span_started()

    # ------------------------------------------------------------ recording
    def set(self, key: str, value: Any) -> "Span":
        self.annotations[key] = value
        return self

    def event(self, name: str, **attrs: Any) -> "Span":
        if self.events is None:
            self.events = []
        self.events.append({"name": name, "ts": time.time(),
                            "offset_ms": round(
                                (time.monotonic() - self._t0) * 1e3, 3),
                            **attrs})
        return self

    def flag(self, reason: str) -> "Span":
        """Mark the whole trace as always-keep (tail sampling)."""
        with self._state.lock:
            self._state.flags.add(str(reason))
        return self

    def child(self, name: str) -> "Span":
        """A child span of THIS span (explicit parentage — safe from any
        thread, independent of the calling thread's context)."""
        return Span(name, self._state, self.span_id, is_root=False)

    # ------------------------------------------------------------- lifecycle
    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        if exc is not None and not self._done:
            self.set("error", type(exc).__name__)
            self.flag("fault")
        self.finish()

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        self.duration_s = time.monotonic() - self._t0
        cfg = _CONFIG
        if (self._is_root and cfg is not None
                and cfg.latency_threshold_ms is not None
                and self.duration_s * 1e3 > cfg.latency_threshold_ms):
            self.flag("slow")
        self._state.span_finished(self)

    def to_dict(self) -> Dict[str, Any]:
        """Serialize (called once, at keep-time, for kept traces only —
        the span is finished and immutable, so no defensive copies)."""
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_ts": self.start_ts,
                "duration_s": self.duration_s, "thread": self.thread,
                "process": _PROCESS_TAG,
                "annotations": self.annotations,
                "events": self.events or []}


class _NoopSpan:
    """The shared do-nothing span returned while tracing is disabled —
    every method is a constant-return no-op, ``with`` works, nothing
    allocates. There is exactly ONE instance (:data:`NOOP`)."""

    __slots__ = ()
    recording = False
    trace_id = None
    span_id = None
    annotations: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []

    def set(self, key, value):
        return self

    def event(self, name, **attrs):
        return self

    def flag(self, reason):
        return self

    def child(self, name):
        return self

    def finish(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


NOOP = _NoopSpan()


# ------------------------------------------------------------- entry points
def span(name: str) -> Any:
    """A span parented to the calling context's active span (or a new
    trace root when there is none). THE hot-path entry point: with tracing
    disabled this is one global load + ``is None`` + singleton return —
    zero allocations."""
    if _CONFIG is None:
        return NOOP
    cur = _CURRENT.get()
    if cur is not None and cur.recording:
        return Span(name, cur._state, cur.span_id, is_root=False)
    return Span(name, _TraceState(_new_id()), None, is_root=True)


def server_span(name: str, trace_id: Optional[str] = None,
                parent_id: Optional[str] = None) -> Any:
    """A request-root span continuing a REMOTE trace: ``trace_id`` /
    ``parent_id`` come off the ``X-Trace-Id`` / ``X-Parent-Span-Id``
    headers (absent -> a fresh trace). This span is the local root — its
    completion (plus any late children) triggers the tail-sampling
    decision for this process's part of the trace."""
    if _CONFIG is None:
        return NOOP
    state = _TraceState(str(trace_id) if trace_id else _new_id())
    return Span(name, state, str(parent_id) if parent_id else None,
                is_root=True)


def current_span() -> Optional[Span]:
    if _CONFIG is None:
        return None
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    sp = current_span()
    return sp.trace_id if sp is not None else None


def flag_current(reason: str) -> None:
    sp = current_span()
    if sp is not None:
        sp.flag(reason)


def annotate_current(key: str, value: Any) -> None:
    sp = current_span()
    if sp is not None:
        sp.set(key, value)


def stamp_chaos(point: str, action: str) -> None:
    """Stamp a chaos-injection decision onto the active span (called by
    :mod:`deeplearning4j_tpu_torch.runtime.chaos` for every policy action) and
    flag the trace ``chaos`` — every fault drill is traceable after the
    fact, and tail sampling always keeps it."""
    sp = current_span()
    if sp is not None:
        sp.event("chaos", point=point, action=action)
        sp.flag("chaos")


def stage_event(stage: str, seconds: float) -> None:
    """Stamp a named stage duration (encode/exchange/decode/apply,
    data_wait/dispatch/step) onto the active span — the bridge from the
    existing ``ExchangeStats`` / ``TrainingProfiler`` hooks into the
    trace tree."""
    if _CONFIG is None:
        return
    sp = _CURRENT.get()
    if sp is not None:
        sp.event("stage", stage=stage, seconds=round(float(seconds), 6))


# ------------------------------------------------------- merge / tree / export
def merge_traces(records: Iterable[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """Merge per-process trace records by trace id into one record per
    trace (spans concatenated, de-duplicated by span id; flags unioned;
    contributing processes listed). The router's ``/v1/traces``
    aggregation is this function over its own collector plus every
    worker's."""
    by_id: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        tid = rec.get("trace_id")
        if tid is None:
            continue
        m = by_id.get(tid)
        if m is None:
            m = by_id[tid] = {"trace_id": tid, "flags": set(),
                              "processes": [], "spans": [], "_seen": set()}
        m["flags"].update(rec.get("flags", ()))
        proc = rec.get("process")
        if proc and proc not in m["processes"]:
            m["processes"].append(proc)
        for s in rec.get("spans", ()):
            sid = s.get("span_id")
            if sid in m["_seen"]:
                continue
            m["_seen"].add(sid)
            m["spans"].append(s)
    out = []
    for m in by_id.values():
        m.pop("_seen")
        m["flags"] = sorted(m["flags"])
        m["spans"].sort(key=lambda s: s.get("start_ts") or 0.0)
        out.append(m)
    out.sort(key=lambda m: min((s.get("start_ts") or 0.0
                                for s in m["spans"]), default=0.0))
    return out


def span_tree(record: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Rebuild the span tree of one (merged) trace record: returns the
    root spans, each with a ``children`` list, children sorted by start
    time. A span whose parent is not in the record (a remote parent whose
    process was not scraped) becomes a root."""
    spans = [dict(s) for s in record.get("spans", ())]
    by_id = {s["span_id"]: s for s in spans}
    roots = []
    for s in spans:
        s.setdefault("children", [])
    for s in spans:
        parent = by_id.get(s.get("parent_id"))
        if parent is None:
            roots.append(s)
        else:
            parent["children"].append(s)
    for s in spans:
        s["children"].sort(key=lambda c: c.get("start_ts") or 0.0)
    roots.sort(key=lambda s: s.get("start_ts") or 0.0)
    return roots


def to_chrome_trace(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Render trace records as Chrome trace-event JSON (the format
    Perfetto's legacy importer and ``chrome://tracing`` load): one
    ``ph: "X"`` complete event per span (``ts``/``dur`` in microseconds,
    wall-clock anchored), one ``ph: "i"`` instant per span event (chaos
    stamps, stage marks), ``pid`` = originating process tag, ``tid`` =
    recording thread."""
    events: List[Dict[str, Any]] = []
    for rec in records:
        for s in rec.get("spans", ()):
            ts_us = (s.get("start_ts") or 0.0) * 1e6
            events.append({
                "name": s["name"], "ph": "X",
                "ts": ts_us, "dur": (s.get("duration_s") or 0.0) * 1e6,
                "pid": s.get("process", rec.get("process", "?")),
                "tid": s.get("thread", "?"),
                "args": {"trace_id": rec.get("trace_id"),
                         "span_id": s.get("span_id"),
                         "parent_id": s.get("parent_id"),
                         **(s.get("annotations") or {})},
            })
            for ev in s.get("events", ()):
                attrs = {k: v for k, v in ev.items()
                         if k not in ("name", "ts", "offset_ms")}
                events.append({
                    "name": f"{s['name']}:{ev['name']}", "ph": "i", "s": "t",
                    "ts": (ev.get("ts") or 0.0) * 1e6,
                    "pid": s.get("process", rec.get("process", "?")),
                    "tid": s.get("thread", "?"),
                    "args": attrs,
                })
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ------------------------------------------------------------ read bounding
#: hard cap on one ``/v1/traces`` response body (serialized record bytes):
#: a scrape of a full ring must never produce an unbounded HTTP body — a
#: 256-slot ring of deep fleet traces can reach tens of MB.
TRACES_RESPONSE_BYTE_CAP = 4 * 1024 * 1024


def _record_newest_ts(rec: Dict[str, Any]) -> float:
    return max((s.get("start_ts") or 0.0 for s in rec.get("spans", ())),
               default=0.0)


def bound_traces(records: Iterable[Dict[str, Any]],
                 limit: Optional[int] = None,
                 since: Optional[float] = None,
                 max_bytes: Optional[int] = None):
    """Bound a trace-record read (the ``/v1/traces`` handlers' shared
    selection): ``since`` keeps records whose newest span started at or
    after the given wall-clock time, ``limit`` keeps the newest N, and
    the serialized size of what remains is capped at ``max_bytes``
    (default :data:`TRACES_RESPONSE_BYTE_CAP`) by dropping oldest-first —
    the newest record is always returned even if it alone exceeds the
    cap, so a scrape can never come back empty-but-truncated. Returns
    ``(records_oldest_first, truncated)``. Records are (re)ordered by
    their newest span's start time first, so "newest N" means newest in
    TIME even when the input interleaves several processes' records
    (the router's merge orders by *earliest* span — an overlapping
    long-lived trace would otherwise outrank a genuinely newer one)."""
    recs = sorted(records, key=_record_newest_ts)
    if since is not None:
        recs = [r for r in recs if _record_newest_ts(r) >= float(since)]
    truncated = False
    if limit is not None and limit >= 0 and len(recs) > int(limit):
        truncated = True
        recs = recs[len(recs) - int(limit):]
    cap = TRACES_RESPONSE_BYTE_CAP if max_bytes is None else int(max_bytes)
    total, kept = 0, []
    for r in reversed(recs):               # newest first
        size = len(json.dumps(r, default=str).encode())
        if kept and total + size > cap:
            truncated = True
            break
        kept.append(r)
        total += size
        if total > cap:                    # single over-cap record: keep it
            truncated = truncated or len(kept) < len(recs)
            break
    kept.reverse()
    return kept, truncated


# --------------------------------------------------------------- access log
#: spellings that DISABLE the access log — aligned with the journal's
#: ``DL4J_TPU_JOURNAL`` parsing, so "off"/"no" can never be mistaken
#: for a file literally named ./off
_ACCESS_LOG_OFF = ("", "0", "false", "off", "no")
#: bare truthy spellings that mean "enabled, to stderr" (the original
#: behaviour); anything else is a file path
_ACCESS_LOG_STDERR = ("1", "true", "on", "yes")


def access_log_enabled() -> bool:
    """The ``DL4J_TPU_ACCESS_LOG`` env knob (off by default): one
    structured JSON line per terminal request outcome — to stderr for
    the bare truthy spellings, to a FILE when the value is a path."""
    return os.environ.get("DL4J_TPU_ACCESS_LOG",
                          "").strip().lower() not in _ACCESS_LOG_OFF


def _access_log_path() -> Optional[str]:
    """The access-log destination file, or ``None`` for stderr (the
    original behaviour for bare truthy spellings of the knob)."""
    v = os.environ.get("DL4J_TPU_ACCESS_LOG", "")
    if v.strip().lower() in _ACCESS_LOG_OFF + _ACCESS_LOG_STDERR:
        return None
    return v


def _access_log_max_bytes() -> int:
    """``DL4J_TPU_ACCESS_LOG_MAX_BYTES``: size-based rotation threshold
    for the file form (0 / unset / unparsable = no rotation)."""
    try:
        return max(0, int(os.environ.get(
            "DL4J_TPU_ACCESS_LOG_MAX_BYTES", "0")))
    except ValueError:
        return 0


# serializes the size check + rename + append so concurrent request
# threads cannot double-rotate or interleave partial lines
_ACCESS_LOG_LOCK = threading.Lock()  # guards: (access-log rotate+append)


def emit_access_log(record: Dict[str, Any]) -> None:
    """Write one JSON access-log line (no-op unless
    :func:`access_log_enabled`). When ``DL4J_TPU_ACCESS_LOG`` is a file
    path, lines append there with size-based rotation: once
    the file would exceed ``DL4J_TPU_ACCESS_LOG_MAX_BYTES`` it is
    atomically renamed to ``<path>.1`` (keep-1 rollover — a soak can
    never grow the log unbounded) and a fresh file starts. Never raises
    — logging must not be able to fail a request."""
    if not access_log_enabled():
        return
    try:
        line = json.dumps({"log": "dl4j_tpu_access", **record},
                          default=str) + "\n"
        path = _access_log_path()
        if path is None:
            sys.stderr.write(line)
            sys.stderr.flush()
            return
        max_bytes = _access_log_max_bytes()
        with _ACCESS_LOG_LOCK:
            if max_bytes:
                try:
                    size = os.path.getsize(path)
                except OSError:
                    size = 0
                if size and size + len(line.encode()) > max_bytes:
                    os.replace(path, path + ".1")  # atomic keep-1 rollover
            with open(path, "a") as f:
                f.write(line)
    except Exception:
        pass


# env bootstrap: DL4J_TPU_TRACE=<rate> enables tracing at import (fleet
# worker subprocesses inherit the parent's env, so one knob traces the
# whole fleet; 0/absent keeps the no-op fast path; bare truthy spellings
# mean rate 1.0, matching the DL4J_TPU_ACCESS_LOG knob's convention).
# DL4J_TPU_TRACE_SLOW_MS=<ms> sets the worker-side slow threshold — and
# by itself enables tracing at rate 0, the shape that closes the earlier
# documented per-process tail-sampling gap: a slow-but-healthy hedge
# LOSER has nothing local to flag, so the straggling worker's half of
# the trace self-keeps by flagging itself `slow` even at rate 0.
def _env_config(environ) -> Optional[tuple]:
    """Parse the two env knobs into ``(rate, latency_threshold_ms)``, or
    ``None`` when tracing should stay on the no-op fast path. Pure so
    the precedence rules are unit-testable without re-importing."""
    rate_s = environ.get("DL4J_TPU_TRACE", "").strip().lower()
    slow_s = environ.get("DL4J_TPU_TRACE_SLOW_MS", "").strip()
    slow_ms: Optional[float] = None
    if slow_s:
        try:
            slow_ms = float(slow_s)
        except ValueError:
            slow_ms = None
        if slow_ms is not None and slow_ms <= 0:
            slow_ms = None
    rate: Optional[float] = None
    if rate_s not in ("", "0", "0.0", "false", "off", "no"):
        try:
            rate = 1.0 if rate_s in ("true", "on", "yes") else float(rate_s)
        except ValueError:
            rate = None
        if rate is not None and not 0.0 <= rate <= 1.0:
            rate = None
    if rate is None and slow_ms is None:
        return None
    return (rate if rate is not None else 0.0, slow_ms)


_env_cfg = _env_config(os.environ)
if _env_cfg is not None:
    enable(rate=_env_cfg[0], latency_threshold_ms=_env_cfg[1])
del _env_cfg
