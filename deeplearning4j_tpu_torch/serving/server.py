"""Stdlib-HTTP model server: a :class:`ModelServer` serves a port
:class:`~.registry.ModelRegistry` over HTTP (counterpart of
``deeplearning4j_tpu/serving/server.py``, with the same paths, status codes,
headers, JSON keys and ``/metrics`` families, so a JAX client, router or
worker talks to it unchanged). The HTTP tier adds no device of its own: a
worker serves on whatever device its registry's models sit on. Endpoints:

- ``GET  /v1/models``                  — registry listing + per-model metrics
- ``GET  /v1/models/<name>``           — one model's description
- ``POST /v1/models/<name>/predict``   — inference, JSON or a binary frame
  (``Content-Type: application/x-dl4j-wire``, :mod:`.wire`); pages a COLD
  model in first — the request waits, and a deadline that cannot cover the
  wait gets 503 ``paging_in`` with an honest ``Retry-After`` from the
  measured page-in cost
- ``POST /v1/models/<name>/replicas``  — resize the replica pool
  (``{"replicas": n}`` or ``{"delta": d}``)
- ``POST /v1/models/<name>/residency`` — explicit paging lever:
  ``{"state": "resident"|"cold"}`` pages in / evicts (409 while pinned)
- Session tier (requires ``session_dir``): ``POST
  /v1/models/<name>/sessions`` opens a stream (server-side
  ``rnnTimeStep`` carry), ``POST /v1/models/<name>/sessions/<id>/step``
  advances it one chunk (``{"inputs": ..., "step": k}`` — the step index
  makes failover retries exactly-once; 410 ``session_lost`` when the
  spilled carry is damaged, 409 ``step_conflict`` on a position
  mismatch), ``POST /v1/models/<name>/sessions/<id>/stream`` runs many
  steps over one connection with Server-Sent-Events framing, ``DELETE
  /v1/models/<name>/sessions/<id>`` closes, and ``POST
  /v1/sessions/drain`` is the rolling-deploy migration fence (spill all
  resident carries to the shared spill dir)
- ``GET  /healthz``                    — liveness (the process serves HTTP)
- ``GET  /readyz``                     — readiness (every model READY; a
  DEGRADED breaker-open model or an empty registry returns 503 so an
  orchestrator routes traffic elsewhere)
- ``GET  /metrics``                    — Prometheus text format, incl. the
  pipeline gauges: ``serving_inflight_depth`` (dispatched batches awaiting
  readback), ``serving_replica_batches_total`` per replica, and the
  ``serving_dispatch_to_completion_seconds`` histogram
- ``GET  /v1/metricsz``, ``/v1/slo``, ``/v1/capacity``, ``/v1/traces``,
  ``/v1/journal``, ``/v1/debug/stacks``, ``GET /v1/debug/bundle`` and
  ``POST /v1/feedback`` — the machine-readable twins the router
  aggregates fleet-wide, and the black box
- ``GET  /v1/scheduler`` — the attached background scheduler's harvest
  counters, admission config and the shared job store's records (404
  ``no scheduler attached`` without one; see :attr:`ModelServer.scheduler`)

Predict request body::

    {"inputs": [[...], ...]}                       # single-input model
    {"inputs": {"in_a": [[...]], "in_b": [[...]]}} # multi-input graph
    {"inputs": ..., "timeout_ms": 50}              # per-request deadline
    {"inputs": [[...]], "dtype": "int8"}           # wire dtype

The optional ``dtype`` field (a numpy dtype name, or a per-input-name map
for graphs) pins the parsed arrays' dtype — JSON integers otherwise parse
as int64 and JSON floats as float64. The batcher pads float64 rows as
float32 and integer rows in their own dtype, so a request replays the graph
warmed for that dtype: declare the warm-up example's dtype (``"int64"``
for ids drawn by numpy's ``integers``, ``"int8"`` for a quantized model's
policy, ``"float32"`` for features). Clients serving a quantized model send
rows through :func:`~.quantize.quantize_requests` and declare ``"dtype":
"int8"``.

Admission-control semantics map onto status codes: ``503`` for
``Overloaded`` (queue full — shed, retry elsewhere) and for
``CircuitOpen`` (breaker shedding a failing model, ``reason`` field
disambiguates), ``504`` for ``DeadlineExceeded``, ``404`` unknown model,
``400`` malformed body. Every response is explicit; nothing queues
unboundedly behind the socket. No handler answers a kernel's or a graph
capture's failure from another path: it is a ``500``.

Fleet-tier contract (``docs/fleet_serving.md``) — the headers a
:class:`~.router.FleetRouter` in front of this worker relies on:

- ``X-Deadline-Ms`` (request): the caller's REMAINING deadline budget.
  Honored as an upper bound on the body's ``timeout_ms``, so a hedged or
  failed-over retry arriving late in a request's life never gets a fresh
  full deadline.
- ``Retry-After`` / ``Retry-After-Ms`` (503 ``Overloaded`` response): the
  shedding worker's queue-depth-derived drain estimate
  (:meth:`~.admission.AdmissionController.retry_after_ms`) — the router
  routes around this worker until the window passes instead of hammering
  it.
- ``X-Request-Id`` (both ways): echoed verbatim so duplicate hedge
  completions are attributable; ``X-Worker-Id`` / ``X-Model-Version``
  (response) identify who actually served.

``chaos.inject("serving.worker.predict")`` fires at the top of every
predict so a drill can slow or fail an individual worker.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

import numpy as np

from deeplearning4j_tpu_torch.runtime import chaos, journal, trace
from deeplearning4j_tpu_torch.serving import wire
from deeplearning4j_tpu_torch.serving.admission import (
    DeadlineExceeded,
    Overloaded,
    PagingInProgress,
    ServingError,
)
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.serving.resilience import CircuitOpen
from deeplearning4j_tpu_torch.serving.sessions import (SessionLost,
                                                 SessionStepConflict)
from deeplearning4j_tpu_torch.serving.slo import SLOMonitor


def _to_jsonable(out):
    if isinstance(out, (list, tuple)):
        return [np.asarray(o).tolist() for o in out]
    return np.asarray(out).tolist()


class ModelServer:
    """``ModelServer(registry).start(port)`` — serve a registry over HTTP.

    ``worker_id`` names this process in a fleet (stamped on responses as
    ``X-Worker-Id`` so the router's hedge/failover accounting and the
    bit-identity drills can attribute every answer)."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 worker_id: Optional[str] = None,
                 slo: Optional[SLOMonitor] = None,
                 session_dir: Optional[str] = None,
                 session_kw: Optional[dict] = None,
                 wire_enabled: Optional[bool] = None):
        self.registry = registry or ModelRegistry()
        self.worker_id = worker_id
        # binary wire protocol: on by default; the
        # DL4J_TPU_FORCE_JSON runbook knob (or wire_enabled=False) makes
        # this worker answer 415 to binary frames so every sender
        # transcodes to JSON — the negotiated compatibility fallback
        if wire_enabled is None:
            wire_enabled = not os.environ.get("DL4J_TPU_FORCE_JSON")
        self.wire_enabled = bool(wire_enabled)
        # per-worker SLO attainment + burn rates; the router
        # keeps its own fleet-wide monitor over the same outcomes
        self.slo = slo or SLOMonitor()
        # session tier: enabled by pointing the worker at the
        # fleet's SHARED spill directory — sharing it is what makes a
        # session survive failover and rolling deploys (migration =
        # rehydrate the spill on the newly pinned worker)
        self.sessions = None
        if session_dir is not None:
            from deeplearning4j_tpu_torch.serving.sessions import SessionStore
            self.sessions = SessionStore(self.registry, session_dir,
                                         worker_id=worker_id or "",
                                         **(session_kw or {}))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._capacity_provider = None  # our profiler attachment (stop)
        # background-job scheduler: attach one to surface GET /v1/scheduler
        # and the scheduler_* /metrics section; the owner starts/stops it
        # (the server only reads snapshots)
        self.scheduler = None
        self.port: Optional[int] = None

    # ------------------------------------------------------------ handlers
    @staticmethod
    def _effective_timeout_ms(body_timeout_ms, header_deadline_ms):
        """The request's deadline budget: the body's ``timeout_ms`` capped
        by the forwarded ``X-Deadline-Ms`` remaining budget — a retry that
        arrives with 40 ms left gets 40 ms, never a fresh full window."""
        values = [float(v) for v in (body_timeout_ms, header_deadline_ms)
                  if v is not None]
        return min(values) if values else None

    def _handle_predict(self, name: str, raw: bytes, headers=None,
                        wire_proto: bool = False):
        """Returns ``(status, body, extra_headers)`` — ``body`` is a
        jsonable dict, or an encoded wire frame (bytes) for a binary
        request's 200 (errors stay JSON on both protocols so a damaged
        frame can never masquerade as a tensor).

        Tracing: when enabled, the whole predict runs inside a
        ``worker.predict`` span continuing the caller's trace off the
        ``X-Trace-Id`` / ``X-Parent-Span-Id`` headers (the router's
        attempt span id), so the router's ``/v1/traces`` aggregation can
        merge this worker's spans — including the batcher stage spans the
        request's span parents — into one tree. Terminal outcomes feed
        the worker's :class:`SLOMonitor` and, behind the
        ``DL4J_TPU_ACCESS_LOG`` knob, one structured JSON log line."""
        h = headers or {}
        if trace.enabled():
            sp = trace.server_span("worker.predict",
                                   trace_id=h.get("X-Trace-Id"),
                                   parent_id=h.get("X-Parent-Span-Id"))
            # a caller that already knows this trace is interesting (the
            # router's hedge attempt) says so — tail sampling is decided
            # per process, so the hint is what keeps THIS process's half
            flags = h.get("X-Trace-Flags")
            if flags and sp.recording:
                for f in str(flags).split(","):
                    if f.strip():
                        sp.flag(f.strip())
        else:
            sp = trace.NOOP
        t0 = time.monotonic()
        with sp:
            if sp.recording:
                sp.set("model", name)
                if self.worker_id is not None:
                    sp.set("worker", self.worker_id)
            status, obj, hdrs = self._predict_inner(name, raw, h,
                                                    wire_proto=wire_proto)
            latency_s = time.monotonic() - t0
            if sp.recording:
                sp.set("status", status)
                if status == 503:
                    sp.flag("shed")
                elif status == 504:
                    sp.flag("deadline")
                elif status >= 500:
                    sp.flag("fault")
                hdrs["X-Trace-Id"] = sp.trace_id
        if status != 404:
            # 404 = the model name does not exist here; recording it
            # would let arbitrary client-sent names grow SLO state
            self.slo.record(name, ok=status == 200, latency_s=latency_s)
        if trace.access_log_enabled():  # don't build the record otherwise
            trace.emit_access_log({
                "trace_id": sp.trace_id,
                "request_id": h.get("X-Request-Id"),
                "worker": self.worker_id,
                "model": name,
                "bucket": sp.annotations.get("bucket"),
                "dtype": sp.annotations.get("dtype"),
                "outcome": status,
                "latency_ms": round(latency_s * 1e3, 3),
            })
        return status, obj, hdrs

    def _predict_inner(self, name: str, raw: bytes, headers,
                       wire_proto: bool = False):
        chaos.inject("serving.worker.predict")
        if wire_proto:
            return self._predict_wire(name, raw, headers)
        hdrs = {}
        try:
            body = json.loads(raw.decode() or "{}")
            inputs = body["inputs"]
            timeout_ms = self._effective_timeout_ms(
                body.get("timeout_ms"),
                (headers or {}).get("X-Deadline-Ms"))
            dtype = body.get("dtype")
            if dtype is not None:
                trace.annotate_current(
                    "dtype", dtype if isinstance(dtype, str) else dict(dtype))

            def _dt(name):
                if dtype is None:
                    return None
                if isinstance(dtype, dict):
                    if name not in dtype:
                        return None
                    dt = np.dtype(dtype[name])
                else:
                    dt = np.dtype(dtype)
                if dt.kind not in "biuf":
                    # object/str/datetime dtypes would defeat the
                    # ragged-row guard below (np.asarray(..., object)
                    # accepts ragged input) and fail inside the model,
                    # feeding the circuit breaker instead of returning 400
                    raise ValueError(f"unsupported request dtype {dt!s}")
                return dt
            if isinstance(inputs, dict):
                x = {k: np.asarray(v, dtype=_dt(k))
                     for k, v in inputs.items()}
            else:
                x = np.asarray(inputs, dtype=_dt(None))  # ragged rows -> 400
        except Exception as e:
            return 400, {"error": f"malformed request body: {e}"}, hdrs
        status, obj, hdrs, out = self._serve(name, x, timeout_ms, hdrs)
        if status == 200:
            obj = dict(obj, outputs=_to_jsonable(out))
        return status, obj, hdrs

    def _predict_wire(self, name: str, raw: bytes, headers):
        """The binary-frame twin of the JSON parse path.  A frame that
        fails validation is an EXPLICIT protocol error: 503 with reason
        ``wire_protocol_error`` (retryable at the router — 400 would be
        terminal), never a silently wrong tensor."""
        hdrs = {}
        try:
            x, body_timeout_ms, fields, fr = wire.decode_predict_request(raw)
        except wire.WireProtocolError as e:
            trace.flag_current("fault")
            return 503, {"error": "bad wire frame",
                         "reason": "wire_protocol_error",
                         "detail": str(e)}, hdrs
        try:
            # frame fields carry the control headers 1:1; an ACTUAL HTTP
            # header wins (the router stamps the per-attempt shrunken
            # X-Deadline-Ms on the hop itself)
            eff = wire.fields_to_headers(fields)
            eff.update({str(k): v for k, v in dict(headers or {}).items()})
            timeout_ms = self._effective_timeout_ms(
                body_timeout_ms, eff.get("X-Deadline-Ms"))
            status, obj, hdrs, out = self._serve(name, x, timeout_ms, hdrs)
        finally:
            x = None  # drop tensor views so a shm-backed frame can close
            fr.close()
        if status == 200:
            frame = wire.encode_predict_response(
                name, obj.get("version"), out,
                fields=wire.headers_to_fields(
                    dict(hdrs, **({"X-Worker-Id": self.worker_id}
                                  if self.worker_id is not None else {}))))
            return 200, frame, hdrs
        return status, obj, hdrs

    def _serve(self, name, x, timeout_ms, hdrs):
        """acquire -> predict -> classify, shared by both protocols.
        Returns ``(status, obj, hdrs, out)`` where ``out`` is the raw
        model output on 200 (the caller marshals it per protocol)."""
        # resolve the model OUTSIDE the submit try: a KeyError raised by a
        # multi-input forward (wrong input name) must not read as 404.
        # acquire() also PAGES IN a cold model — the request
        # waits in the page-in queue instead of failing — and pins the
        # entry so eviction can never unload it mid-request.
        acquire = getattr(self.registry, "acquire", None)
        # the deadline is spent ONCE: time the request waits on a page-in
        # is deducted from the budget the batcher sees afterwards
        deadline = (None if timeout_ms is None
                    else time.monotonic() + float(timeout_ms) / 1000.0)
        try:
            if acquire is not None:
                served = acquire(name, timeout_ms=timeout_ms)
            else:  # duck-typed stub registry (tests): resident-only lookup
                served = self.registry.get(name)
        except KeyError:
            return 404, {"error": f"model {name!r} not found",
                         "models": self.registry.names()}, hdrs, None
        except PagingInProgress as e:
            # the deadline provably cannot cover the page-in: an HONEST
            # Retry-After from the measured page-in cost, not a generic 503
            retry_ms = e.retry_after_ms
            if retry_ms is not None:
                hdrs["Retry-After"] = str(int(math.ceil(retry_ms / 1000.0)))
                hdrs["Retry-After-Ms"] = f"{retry_ms:.0f}"
            trace.flag_current("shed")
            return 503, {"error": "paging in", "reason": "paging_in",
                         "retry_after_ms": retry_ms,
                         "detail": str(e)}, hdrs, None
        except ServingError as e:
            # e.g. HBMBudgetExceeded mid-page-in: transient, retryable
            return 503, {"error": "unavailable", "reason": "paging_failed",
                         "detail": str(e)}, hdrs, None
        except Exception as e:
            # a corrupt archive mid-page-in must not read as model fault 500
            return 503, {"error": "unavailable", "reason": "paging_failed",
                         "detail": repr(e)}, hdrs, None
        if deadline is not None:
            timeout_ms = max(0.0, (deadline - time.monotonic()) * 1000.0)
        try:
            out = served.predict(x, timeout_ms=timeout_ms)
        except CircuitOpen as e:
            return 503, {"error": "unavailable", "reason": "circuit_open",
                         "detail": str(e)}, hdrs, None
        except Overloaded as e:
            retry_ms = getattr(e, "retry_after_ms", None)
            if retry_ms is not None:
                # standard header is integer seconds; the -Ms twin keeps
                # sub-second hints honest for the router
                hdrs["Retry-After"] = str(int(math.ceil(retry_ms / 1000.0)))
                hdrs["Retry-After-Ms"] = f"{retry_ms:.0f}"
            return 503, {"error": "overloaded", "reason": "overloaded",
                         "retry_after_ms": retry_ms,
                         "detail": str(e)}, hdrs, None
        except DeadlineExceeded as e:
            return (504, {"error": "deadline exceeded", "detail": str(e)},
                    hdrs, None)
        except Exception as e:
            return 500, {"error": repr(e)}, hdrs, None
        finally:
            unpin = getattr(served, "unpin", None)
            if unpin is not None:  # stubs have no pin ledger
                unpin()
        hdrs["X-Model-Version"] = str(served.version)
        return (200, {"model": name, "version": served.version}, hdrs, out)

    def _handle_get(self, path: str):
        if path.startswith("/v1/journal"):
            # this process's slice of the black box: the
            # router merges it fleet-wide; same bounded-read contract
            # as /v1/traces
            q = parse_qs(urlsplit(path).query)
            try:
                limit = (int(q["limit"][0]) if "limit" in q else None)
                since = (float(q["since"][0]) if "since" in q else None)
            except ValueError as e:
                return 400, {"error": f"bad limit/since query param: {e}"}
            types = None
            if "type" in q:
                types = {t for v in q["type"] for t in v.split(",") if t}
            events, truncated = journal.bound_events(
                journal.events(), since=since, limit=limit, types=types)
            return 200, {"worker": self.worker_id, "events": events,
                         "truncated": truncated,
                         "counters": journal.counters()}
        if path == "/v1/debug/stacks":
            # per-process stack sample: what the router's fleet bundle
            # scrapes so the postmortem shows where EVERY process was
            from deeplearning4j_tpu_torch.serving import blackbox
            return 200, {"worker": self.worker_id,
                         "stacks": blackbox.stack_sample()}
        if path.startswith("/v1/traces"):
            # this process's kept traces (tail-sampled flight recorder);
            # ?trace_id= filters, ?format=chrome renders Perfetto-loadable
            # trace-event JSON (docs/observability.md).
            # Responses are BOUNDED: ?limit=N keeps the newest
            # N, ?since=<unix ts> filters by span start, and a hard
            # serialized-size cap applies regardless — a scrape of a full
            # ring can never produce an unbounded HTTP body.
            q = parse_qs(urlsplit(path).query)
            recs = trace.collector().traces()
            tid = q.get("trace_id", [None])[0]
            if tid:
                recs = [r for r in recs if r.get("trace_id") == tid]
            try:
                limit = (int(q["limit"][0]) if "limit" in q else None)
                since = (float(q["since"][0]) if "since" in q else None)
            except ValueError as e:
                return 400, {"error": f"bad limit/since query param: {e}"}
            recs, truncated = trace.bound_traces(recs, limit=limit,
                                                 since=since)
            if q.get("format", [None])[0] == "chrome":
                return 200, trace.to_chrome_trace(recs)
            return 200, {"traces": recs,
                         "truncated": truncated,
                         "kept": trace.collector().kept,
                         "dropped": trace.collector().dropped,
                         "worker": self.worker_id}
        if path == "/v1/slo":
            # machine-readable twin of the /metrics slo_* section: the
            # SLOMonitor report dict — what the autoscaler drill and
            # external dashboards consume instead of parsing Prometheus
            # text
            return 200, {"worker": self.worker_id,
                         "windows_s": list(self.slo.windows_s),
                         "slo": self.slo.report()}
        if path == "/v1/capacity":
            # per-model resource accounting: parameter
            # /device bytes by dtype, replica utilization, queue headroom,
            # compile footprint — the ledger the autoscaler's capacity
            # guard consults (aggregated fleet-wide by the router)
            from deeplearning4j_tpu_torch.serving import capacity
            payload = {"worker": self.worker_id,
                       **capacity.registry_capacity(self.registry)}
            if self.sessions is not None:
                # session-tier residency: counts/bytes +
                # rehydrate percentiles, fleet-aggregated by the router
                payload["sessions"] = self.sessions.snapshot()
            return 200, payload
        if path == "/v1/scheduler":
            # background-job scheduler: harvest counters, admission config
            # and the shared job store's records — the machine-readable
            # twin of the scheduler_* /metrics section
            if self.scheduler is None:
                return 404, {"error": "no scheduler attached"}
            return 200, {"worker": self.worker_id,
                         "scheduler": self.scheduler.harvest_snapshot(),
                         "jobs": self.scheduler.store.jobs()}
        if path == "/v1/metricsz":
            # machine-readable twin of /metrics: summable counters + raw
            # bucket histograms so the router can aggregate fleet-wide
            models = {}
            for name in self.registry.names():
                try:
                    models[name] = \
                        self.registry.get(name).metrics.wire_snapshot()
                except KeyError:
                    pass  # undeployed between listing and snapshot
            return 200, {"worker": self.worker_id, "models": models}
        if path == "/healthz":
            # liveness only: the process is up and serving HTTP; "wire"
            # advertises whether binary frames are accepted
            return 200, {"status": "ok", "models": self.registry.names(),
                         "wire": self.wire_enabled}
        if path == "/readyz":
            # one snapshot for both fields so they can never disagree
            health = self.registry.health()
            ready = self.registry.ready_from(health)
            return (200 if ready else 503), {"ready": ready,
                                             "models": health}
        if path == "/v1/models":
            return 200, {"models": self.registry.describe()}
        if path.startswith("/v1/models/"):
            name = path[len("/v1/models/"):].strip("/")
            try:
                return 200, self.registry.get(name).describe()
            except KeyError:
                # a COLD model is registered, not gone: serve
                # its catalogue description instead of a false 404
                for d in self.registry.describe():
                    if d.get("name") == name:
                        return 200, d
                return 404, {"error": f"model {name!r} not found"}
        return 404, {"error": f"unknown path {path!r}"}

    def _handle_scale(self, name: str, raw: bytes, headers=None):
        """``POST /v1/models/<name>/replicas`` — runtime ReplicaPool
        resize (the autoscaler's replica lever; also a manual
        operator action). Body ``{"replicas": n}`` (absolute) or
        ``{"delta": d}`` (relative to the LIVE count — what the
        autoscaler sends, so a stale capacity scrape can never turn a
        scale-up into an absolute scale-down; delta targets clamp to the
        one-replica floor instead of erroring). Grows via
        :meth:`ContinuousBatcher.add_replica` (each new replica warmed
        from the live warmup manifest BEFORE routing — zero on-traffic
        compiles) or shrinks via :meth:`remove_replica`; concurrent
        resizes serialize on the batcher's resize lock (two racing
        target-chasing loops would otherwise overshoot and thrash,
        paying warmup compiles for replicas immediately removed). Joins
        the caller's trace off the standard headers so the scaling
        decision and its execution are ONE tree."""
        h = headers or {}
        sp = (trace.server_span("worker.scale_replicas",
                                trace_id=h.get("X-Trace-Id"),
                                parent_id=h.get("X-Parent-Span-Id"))
              if trace.enabled() else trace.NOOP)
        with sp:
            if sp.recording:
                sp.flag("autoscale")
                sp.set("model", name)
            try:
                body = json.loads(raw.decode() or "{}")
                if ("replicas" in body) == ("delta" in body):
                    raise ValueError(
                        "body must carry exactly one of 'replicas' "
                        "(absolute) or 'delta' (relative)")
                delta = int(body["delta"]) if "delta" in body else None
                n = int(body["replicas"]) if "replicas" in body else None
                if n is not None and not 1 <= n <= 64:
                    raise ValueError(f"replicas must be in [1, 64], got {n}")
                # optional floor for delta requests (the autoscaler sends
                # its min_replicas): downward deltas clamp against it
                floor = int(body.get("floor", 1))
                if not 1 <= floor <= 64:
                    raise ValueError(f"floor must be in [1, 64], got {floor}")
                if floor != 1 and delta is None:
                    raise ValueError("'floor' is only valid with 'delta'")
            except Exception as e:
                return 400, {"error": f"malformed scale request: {e}"}, {}
            try:
                served = self.registry.get(name)
            except KeyError:
                if name in self.registry.names():
                    # registered but COLD: a resize has no pool to act on
                    return 409, {"error": f"model {name!r} is cold; page "
                                          f"it in before resizing"}, {}
                return 404, {"error": f"model {name!r} not found"}, {}
            batcher = served.batcher
            with batcher.resize_lock:
                before = batcher.replica_count
                if delta is not None:
                    n = min(64, max(floor, before + delta))
                try:
                    while batcher.replica_count < n:
                        batcher.add_replica()
                    while batcher.replica_count > n:
                        batcher.remove_replica()
                except Exception as e:
                    return 500, {"error": repr(e),
                                 "replicas": batcher.replica_count}, {}
            if sp.recording:
                sp.set("replicas_before", before)
                sp.set("replicas_after", batcher.replica_count)
            refresh = getattr(self.registry, "refresh_device_bytes", None)
            if refresh is not None:
                # the resize minted/dropped parameter copies: the device
                # ledger must see the new footprint (and page others out
                # if it overshot the budget)
                refresh(name)
            try:
                # persist the resized warm set so a restart pre-warms it
                self.registry.save_manifest(name)
            except Exception:
                pass  # best effort, same as graceful-shutdown refresh
            return 200, {"model": name, "replicas": batcher.replica_count,
                         "replicas_before": before,
                         "compile_count": batcher.compile_count(),
                         "warmed_pairs": len(batcher._warmed_pairs)}, {}

    def _handle_residency(self, name: str, raw: bytes, headers=None):
        """``POST /v1/models/<name>/residency`` — explicit paging lever
       : body ``{"state": "resident"}`` pages a cold model in
        (manifest-prewarmed, single-flight with any request-triggered
        page-in underway), ``{"state": "cold"}`` evicts (refused with 409
        while in-flight requests pin the model — eviction is never
        unsafe, only deferred). Drives the autoscaler's placement
        rebalancing and operator runbooks; joins the caller's trace so a
        rebalance decision and its page-in are one tree."""
        h = headers or {}
        sp = (trace.server_span("worker.residency",
                                trace_id=h.get("X-Trace-Id"),
                                parent_id=h.get("X-Parent-Span-Id"))
              if trace.enabled() else trace.NOOP)
        with sp:
            if sp.recording:
                sp.flag("page_in")
                sp.set("model", name)
            try:
                body = json.loads(raw.decode() or "{}")
                state = body["state"]
                if state not in ("resident", "cold"):
                    raise ValueError(f"state must be 'resident' or 'cold', "
                                     f"got {state!r}")
            except Exception as e:
                return 400, {"error": f"malformed residency request: "
                                      f"{e}"}, {}
            if sp.recording:
                sp.set("target_state", state)
            # the explicit lever is a journal event either way:
            # an autoscaler rebalance and an operator runbook leave the
            # same black-box record
            journal.emit("registry.residency_lever", model=name,
                         target_state=state)
            if state == "resident":
                try:
                    served = self.registry.page_in(name)
                except KeyError:
                    return 404, {"error": f"no archive-backed model "
                                          f"{name!r}"}, {}
                except Exception as e:
                    return 500, {"error": repr(e)}, {}
                return 200, {"model": name, "state": "resident",
                             "version": served.version,
                             "device_bytes": served.device_bytes}, {}
            if name not in self.registry.names():
                return 404, {"error": f"model {name!r} not found"}, {}
            if self.registry.evict(name):
                return 200, {"model": name, "state": "cold"}, {}
            # idempotence: asking for a state the model is already in is
            # a no-op 200, not a 409 (retried runbooks must not alert)
            if name not in self.registry.resident_names():
                return 200, {"model": name, "state": "cold",
                             "already": True}, {}
            return 409, {"error": f"cannot evict {name!r}: pinned by "
                                  f"in-flight requests or not "
                                  f"archive-backed"}, {}

    # ------------------------------------------------------ session tier
    def _session_store_or_503(self):
        if self.sessions is None:
            return None, (503, {"error": "sessions disabled",
                                "reason": "sessions_disabled",
                                "detail": "this worker was started without "
                                          "a session spill directory"}, {})
        return self.sessions, None

    def _handle_session_create(self, name: str, raw: bytes, headers=None):
        """``POST /v1/models/<name>/sessions`` — open a stream. Body
        ``{"session_id"?: str, "timeout_ms"?: ms}``; the router normally
        generates the id so it can pin before forwarding."""
        store, err = self._session_store_or_503()
        if err is not None:
            return err
        h = headers or {}
        try:
            body = json.loads(raw.decode() or "{}")
            timeout_ms = self._effective_timeout_ms(
                body.get("timeout_ms"), h.get("X-Deadline-Ms"))
        except Exception as e:
            return 400, {"error": f"malformed request body: {e}"}, {}
        try:
            sess = store.create(name, body.get("session_id"),
                                timeout_ms=timeout_ms)
        except KeyError:
            return 404, {"error": f"model {name!r} not found"}, {}
        except ValueError as e:
            # duplicate id, invalid id, or a model without the session
            # path warmed — a client error either way
            return 409, {"error": str(e)}, {}
        except ServingError as e:
            return 503, {"error": "unavailable", "detail": str(e)}, {}
        except Exception as e:
            return 500, {"error": repr(e)}, {}
        return 200, {"model": name, "session": sess.session_id,
                     "step": sess.step, "worker": self.worker_id}, {}

    def _session_step_inner(self, name, sid, body, timeout_ms, hdrs):
        """Shared by the unary step endpoint and the SSE stream: returns
        ``(status, json_obj)`` for ONE step of session ``sid``."""
        store = self.sessions
        try:
            dtype = body.get("dtype")
            x = np.asarray(body["inputs"],
                           dtype=None if dtype is None else np.dtype(dtype))
        except Exception as e:
            return 400, {"error": f"malformed request body: {e}"}
        t0 = time.monotonic()
        try:
            out, step, replayed = store.step(
                name, sid, x, timeout_ms=timeout_ms,
                client_step=body.get("step"))
        except KeyError:
            return 404, {"error": f"unknown session {sid!r} for model "
                                  f"{name!r}"}
        except SessionLost as e:
            # 410 Gone: the stream is unrecoverable — carry was damaged
            # on disk; the client must open a new session
            return 410, {"error": "session lost", "reason": "session_lost",
                         "detail": str(e)}
        except SessionStepConflict as e:
            return 409, {"error": "step conflict", "reason": "step_conflict",
                         "detail": str(e)}
        except Overloaded as e:
            retry_ms = getattr(e, "retry_after_ms", None)
            if retry_ms is not None:
                hdrs["Retry-After"] = str(int(math.ceil(retry_ms / 1000.0)))
                hdrs["Retry-After-Ms"] = f"{retry_ms:.0f}"
            return 503, {"error": "overloaded", "reason": "overloaded",
                         "retry_after_ms": retry_ms, "detail": str(e)}
        except DeadlineExceeded as e:
            return 504, {"error": "deadline exceeded", "detail": str(e)}
        except ServingError as e:
            return 503, {"error": "unavailable", "detail": str(e)}
        except Exception as e:
            return 500, {"error": repr(e)}
        self.slo.record(name, ok=True, latency_s=time.monotonic() - t0)
        return 200, {"model": name, "session": sid, "step": step,
                     "replayed": replayed, "outputs": _to_jsonable(out)}

    def _handle_session_step(self, name: str, sid: str, raw: bytes,
                             headers=None):
        """``POST /v1/models/<name>/sessions/<id>/step`` — advance the
        stream one input chunk. Body ``{"inputs": [[...]], "step"?: k,
        "timeout_ms"?: ms, "dtype"?: name}``; ``step`` (the client's
        0-based index for THIS call) makes failover retries exactly-once —
        a replay of the last acked step returns its persisted output
        without advancing the carry."""
        store, err = self._session_store_or_503()
        if err is not None:
            return err
        h = headers or {}
        hdrs = {}
        try:
            body = json.loads(raw.decode() or "{}")
            timeout_ms = self._effective_timeout_ms(
                body.get("timeout_ms"), h.get("X-Deadline-Ms"))
        except Exception as e:
            return 400, {"error": f"malformed request body: {e}"}, hdrs
        status, obj = self._session_step_inner(name, sid, body, timeout_ms,
                                               hdrs)
        if status == 200:
            hdrs["X-Session-Step"] = str(obj["step"])
        return status, obj, hdrs

    def _handle_session_stream(self, name: str, sid: str, raw: bytes,
                               handler) -> None:
        """``POST /v1/models/<name>/sessions/<id>/stream`` — multi-step
        generation over ONE connection, Server-Sent-Events framing. Body
        ``{"inputs": [chunk, ...], "step"?: k0, "timeout_ms"?: ms}``:
        each chunk is one step input; one ``data:`` event per step, then
        ``event: end`` (or ``event: error`` carrying the same JSON the
        unary endpoint would have returned). The response is
        close-delimited (no Content-Length); a writer thread decouples
        device stepping from a slow client socket and is ALWAYS joined
        before the handler returns."""
        import queue as _queue
        h = handler.headers
        try:
            body = json.loads(raw.decode() or "{}")
            chunks = body["inputs"]
            if not isinstance(chunks, list) or not chunks:
                raise ValueError("'inputs' must be a non-empty list of "
                                 "per-step input chunks")
            timeout_ms = self._effective_timeout_ms(
                body.get("timeout_ms"), h.get("X-Deadline-Ms"))
        except Exception as e:
            payload = json.dumps(
                {"error": f"malformed request body: {e}"}).encode()
            handler._send(400, payload, "application/json")
            return
        store, err = self._session_store_or_503()
        if err is not None:
            handler._send(err[0], json.dumps(err[1]).encode(),
                          "application/json")
            return
        handler.send_response(200)
        handler.send_header("Content-Type", "text/event-stream")
        handler.send_header("Cache-Control", "no-store")
        handler.send_header("Connection", "close")
        if self.worker_id is not None:
            handler.send_header("X-Worker-Id", self.worker_id)
        handler.end_headers()
        q: "_queue.Queue" = _queue.Queue()

        def _writer():
            while True:
                frame = q.get()
                if frame is None:
                    return
                try:
                    handler.wfile.write(frame)
                    handler.wfile.flush()
                except OSError:
                    # client went away; keep draining so the stepper
                    # never blocks on an unbounded queue put
                    pass

        wt = threading.Thread(target=_writer, daemon=True,
                              name=f"stream-writer-{sid}")
        wt.start()
        deadline = (None if timeout_ms is None
                    else time.monotonic() + timeout_ms / 1000.0)
        step0 = body.get("step")
        try:
            for i, chunk in enumerate(chunks):
                remaining_ms = (None if deadline is None
                                else max(0.0, (deadline - time.monotonic())
                                         * 1000.0))
                step_body = {"inputs": chunk, "dtype": body.get("dtype")}
                if step0 is not None:
                    step_body["step"] = int(step0) + i
                status, obj = self._session_step_inner(
                    name, sid, step_body, remaining_ms, {})
                if status != 200:
                    obj["status"] = status
                    q.put(b"event: error\ndata: "
                          + json.dumps(obj).encode() + b"\n\n")
                    return
                q.put(b"data: " + json.dumps(obj).encode() + b"\n\n")
            q.put(b"event: end\ndata: "
                  + json.dumps({"steps": len(chunks)}).encode() + b"\n\n")
        finally:
            q.put(None)
            wt.join()

    def _handle_session_close(self, name: str, sid: str):
        """``DELETE /v1/models/<name>/sessions/<id>`` — end the stream
        and delete its spill file."""
        store, err = self._session_store_or_503()
        if err is not None:
            return err
        try:
            store.close(name, sid)
        except KeyError:
            return 404, {"error": f"unknown session {sid!r} for model "
                                  f"{name!r}"}, {}
        except Exception as e:
            return 500, {"error": repr(e)}, {}
        return 200, {"model": name, "session": sid, "closed": True}, {}

    def _handle_sessions_drain(self, raw: bytes = b""):
        """``POST /v1/sessions/drain`` — the rolling-deploy migration
        fence: push every resident session cold so its state is on the
        shared spill dir before this worker restarts. Steps arriving
        after the drain simply rehydrate (here or on the repinned
        worker); nothing is dropped."""
        store, err = self._session_store_or_503()
        if err is not None:
            return err
        try:
            n = store.spill_all(reason="drain")
        except Exception as e:
            return 500, {"error": repr(e)}, {}
        return 200, {"worker": self.worker_id, "spilled": n}, {}

    def _render_sessions(self) -> str:
        """``/metrics`` session-tier section."""
        snap = self.sessions.snapshot()
        c = snap["counters"]
        reh = snap["rehydrate"]
        return "\n".join([
            f"serving_sessions_tracked {snap['tracked']}",
            f"serving_sessions_resident {snap['resident']}",
            f"serving_sessions_resident_bytes {snap['resident_bytes']}",
            f"serving_sessions_spilled_files {snap['spilled_files']}",
            f"serving_session_steps_total {c['steps_total']}",
            f"serving_session_replays_total {c['replays_total']}",
            f"serving_session_rehydrates_total {c['rehydrates_total']}",
            f"serving_session_migrations_total {c['migrations_total']}",
            f"serving_session_evictions_total {c['evictions_total']}",
            f"serving_session_lost_total {c['lost_total']}",
            "serving_session_rehydrate_seconds{quantile=\"0.5\"} "
            + f"{reh['p50_s']}",
            "serving_session_rehydrate_seconds{quantile=\"0.99\"} "
            + f"{reh['p99_s']}",
        ])

    def _render_metrics(self) -> str:
        parts = ["# TYPE serving_latency_seconds summary",
                 "# TYPE serving_dispatch_to_completion_seconds summary",
                 "# TYPE serving_inflight_depth gauge",
                 "# TYPE serving_warmup_seconds gauge",
                 "# TYPE serving_replica_batches_total counter"]
        for name in self.registry.names():
            try:
                parts.append(self.registry.get(name).metrics
                             .render_prometheus(name))
            except KeyError:
                pass  # undeployed between listing and render
        parts.append(self._render_compile_cache())
        slo_text = self.slo.render_prometheus()
        if slo_text:
            parts.append(slo_text.rstrip("\n"))
        try:
            # the capacity ledger's /metrics view: same numbers
            # /v1/capacity serves machine-readably
            from deeplearning4j_tpu_torch.serving import capacity
            parts.append(capacity.render_prometheus(
                capacity.registry_capacity(self.registry)).rstrip("\n"))
        except Exception:
            pass  # capacity must never be able to break a scrape
        if self.sessions is not None:
            parts.append(self._render_sessions())
        if self.scheduler is not None:
            # the harvest ledger's /metrics view
            from deeplearning4j_tpu_torch.serving import scheduler as _sched
            try:
                parts.append(_sched.render_prometheus(
                    self.scheduler.harvest_snapshot()).rstrip("\n"))
            except Exception:
                pass  # the scheduler must never break a scrape
        # binary transport frame/error counters
        parts.append("\n".join(wire.render_prometheus()))
        # the black box's ring health: journal_* gauges
        parts.append(journal.render_prometheus().rstrip("\n"))
        # the flywheel's label-join counters
        from deeplearning4j_tpu_torch.serving import delivery
        fb = delivery.feedback_counters()
        parts.append(
            f"serving_feedback_joined_total {fb['joined_total']}\n"
            f"serving_feedback_orphaned_total {fb['orphaned_total']}")
        return "\n".join(parts) + "\n"

    @staticmethod
    def _render_compile_cache() -> str:
        """Process-global kernel build cache and captured-graph counters
        (cold-start observability) — unlabelled: one process, one cache,
        shared by every served model. The families are the JAX worker's:
        ``aot_dispatch_executables_total`` counts graph captures,
        ``aot_dispatch_fallbacks_total`` refused captures; nothing is
        retrieved from a persistent executable cache here, so
        ``compile_cache_retrieval_seconds_total`` stays 0."""
        from deeplearning4j_tpu_torch.runtime.compile_cache import stats
        s = stats()
        return "\n".join([
            f"compile_cache_enabled {int(bool(s['enabled']))}",
            f"compile_cache_hits_total {s['hits']}",
            f"compile_cache_misses_total {s['misses']}",
            f"compile_cache_corrupt_entries_total {s['corrupt_entries']}",
            f"compile_cache_compile_seconds_total {s['compile_seconds']}",
            f"compile_cache_retrieval_seconds_total {s.get('retrieval_seconds', 0.0)}",
            f"aot_dispatch_executables_total {s['aot_compiles']}",
            f"aot_dispatch_fallbacks_total {s['aot_fallbacks']}",
        ])

    # ------------------------------------------------------------ plumbing
    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        srv = self
        if self.worker_id is not None:
            trace.set_process_tag(self.worker_id)
        # profiling tooling reads this registry's capacity ledger without
        # holding a registry reference (newest server wins,
        # mirroring profiler.attach_router)
        from deeplearning4j_tpu_torch.runtime import profiler

        def _capacity_provider():
            from deeplearning4j_tpu_torch.serving import capacity
            return capacity.registry_capacity(srv.registry)
        self._capacity_provider = _capacity_provider
        profiler.attach_capacity(_capacity_provider)

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: the router's and client's
            # connection pools reuse this socket across requests instead
            # of paying TCP setup per hop (the 1.0 default closes every
            # time).  Every _send sets Content-Length, which 1.1
            # requires; ``timeout`` bounds how long an idle keep-alive
            # connection may pin its handler thread.
            protocol_version = "HTTP/1.1"
            timeout = 20.0
            # headers and body go out in separate writes; without
            # NODELAY, Nagle + delayed ACK stalls each response ~40ms
            disable_nagle_algorithm = True

            def _send(self, code: int, body: bytes, ctype: str,
                      extra=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if srv.worker_id is not None:
                    self.send_header("X-Worker-Id", srv.worker_id)
                rid = self.headers.get("X-Request-Id")
                if rid:
                    self.send_header("X-Request-Id", rid)
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, srv._render_metrics().encode(),
                               "text/plain; version=0.0.4")
                    return
                if self.path.startswith("/v1/debug/bundle"):
                    # the worker's local incident bundle; the
                    # router's twin merges the whole fleet
                    from deeplearning4j_tpu_torch.serving import blackbox
                    try:
                        data = blackbox.local_bundle(srv)
                    except Exception as e:
                        self._send(500, json.dumps(
                            {"error": repr(e)}).encode(),
                            "application/json")
                        return
                    self._send(200, data, "application/gzip")
                    return
                code, obj = srv._handle_get(self.path)
                self._send(code, json.dumps(obj).encode(), "application/json")

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                if (self.path.startswith("/v1/models/")
                        and self.path.endswith("/predict")):
                    name = self.path[len("/v1/models/"):-len("/predict")]
                    ctype = (self.headers.get("Content-Type") or
                             "").split(";")[0].strip()
                    if ctype == wire.CONTENT_TYPE and not srv.wire_enabled:
                        # negotiation: 415 tells the sender to transcode
                        # to JSON and downgrade this endpoint
                        code, obj, extra = 415, {
                            "error": "binary wire protocol disabled",
                            "reason": "wire_disabled"}, {}
                    else:
                        code, obj, extra = srv._handle_predict(
                            name, raw, headers=self.headers,
                            wire_proto=ctype == wire.CONTENT_TYPE)
                elif (self.path.startswith("/v1/models/")
                        and self.path.endswith("/replicas")):
                    name = self.path[len("/v1/models/"):-len("/replicas")]
                    code, obj, extra = srv._handle_scale(
                        name, raw, headers=self.headers)
                elif (self.path.startswith("/v1/models/")
                        and self.path.endswith("/residency")):
                    name = self.path[len("/v1/models/"):-len("/residency")]
                    code, obj, extra = srv._handle_residency(
                        name, raw, headers=self.headers)
                elif (self.path.startswith("/v1/models/")
                        and "/sessions" in self.path):
                    name, _, tail = (self.path[len("/v1/models/"):]
                                     .partition("/sessions"))
                    tail = tail.strip("/")
                    if not tail:
                        code, obj, extra = srv._handle_session_create(
                            name, raw, headers=self.headers)
                    else:
                        parts = tail.split("/")
                        if len(parts) == 2 and parts[1] == "step":
                            code, obj, extra = srv._handle_session_step(
                                name, parts[0], raw, headers=self.headers)
                        elif len(parts) == 2 and parts[1] == "stream":
                            # SSE: the handler writes the (close-
                            # delimited) response itself
                            srv._handle_session_stream(
                                name, parts[0], raw, self)
                            return
                        else:
                            code, obj, extra = (
                                404, {"error": f"unknown path "
                                               f"{self.path!r}"}, {})
                elif self.path == "/v1/sessions/drain":
                    code, obj, extra = srv._handle_sessions_drain(raw)
                elif self.path == "/v1/feedback":
                    # label intake: a client grades an answer
                    # by trace id; the label joins the access log into
                    # the append-only labeled-example file
                    from deeplearning4j_tpu_torch.serving import delivery
                    code, obj = delivery.handle_feedback(raw)
                    extra = {}
                else:
                    code, obj, extra = (404,
                                        {"error": f"unknown path "
                                                  f"{self.path!r}"}, {})
                if isinstance(obj, bytes):  # a 200 wire frame
                    self._send(code, obj, wire.CONTENT_TYPE, extra=extra)
                else:
                    self._send(code, json.dumps(obj).encode(),
                               "application/json", extra=extra)

            def do_DELETE(self):
                if (self.path.startswith("/v1/models/")
                        and "/sessions/" in self.path):
                    name, _, sid = (self.path[len("/v1/models/"):]
                                    .partition("/sessions/"))
                    code, obj, extra = srv._handle_session_close(
                        name, sid.strip("/"))
                else:
                    code, obj, extra = (404,
                                        {"error": f"unknown path "
                                                  f"{self.path!r}"}, {})
                self._send(code, json.dumps(obj).encode(),
                           "application/json", extra=extra)

            def log_message(self, *a):
                pass

        # KeepAliveHTTPServer: stop() must sever parked keep-alive
        # connections, or pooled routers keep talking to a dead worker
        self._httpd = wire.KeepAliveHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="ModelServer")
        self._thread.start()
        return self.port

    def stop(self, shutdown_registry: bool = False) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()  # release the listener fd promptly
            self._httpd = None
        if self.sessions is not None:
            # spill-at-exit: a graceful stop leaves every stream
            # resumable from the shared spill dir
            self.sessions.shutdown(spill=True)
        if self._capacity_provider is not None:
            # detach only OUR provider — a newer server's stays attached
            from deeplearning4j_tpu_torch.runtime import profiler
            profiler.detach_capacity(self._capacity_provider)
            self._capacity_provider = None
        if shutdown_registry:
            self.registry.shutdown()
