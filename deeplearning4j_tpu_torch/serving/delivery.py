"""The golden-set gate of gated delivery.

Counterpart of ``deeplearning4j_tpu/serving/delivery.py``'s gate half
(``:61-268``): :class:`GoldenGate`, the one deploy bar (the quantized
deploy's :class:`~.quantize.AccuracyGate` is a subclass), and
:class:`GoldenSet`, the declared evaluation set, persisted as a CRC-framed
``<archive>.golden`` sidecar in the JAX package's bytes. A sidecar that
fails its CRC is :class:`GateRefused`: a damaged bar refuses the deploy and
never passes it (chaos point ``serving.delivery.gate``).

The delivery half (``:270-787`` there) drives the fleet router's staged
rollouts: :class:`ShadowComparator` (the shadow stage's ledger: mirrored
responses compared for top-1 disagreement and latency delta, never returned
to clients and never fed to worker breakers), :class:`DeliveryConfig`,
:class:`DeliveryController` (the per-deploy state machine ``gate -> shadow
-> canary (ramped) -> promoted | rolled_back``, whose per-version
:class:`~.slo.SLOMonitor` window triggers the rollback) and
:class:`FeedbackLog` (``POST /v1/feedback``: client labels joined against
the structured access log by trace id). Journal event types:
``delivery.gate``, ``delivery.stage``, ``delivery.shadow_stats``,
``delivery.rollback``, ``delivery.promote``.
"""

from __future__ import annotations

import json
import os
import random
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.runtime import chaos, journal
from deeplearning4j_tpu_torch.serving.slo import SLOMonitor, SLOTarget

__all__ = ["GATE_POINT", "SHADOW_POINT", "DeliveryConfig", "DeliveryController",
           "FeedbackLog", "GateFailed", "GateRefused", "GoldenGate", "GoldenSet",
           "ShadowComparator", "feedback_counters", "handle_feedback",
           "iter_feedback_examples"]

#: the golden-set gate's chaos point (call at every gate evaluation; byte
#: point over the CRC-framed golden-set sidecar)
GATE_POINT = "serving.delivery.gate"
#: the shadow mirror's chaos point (the delivery half fires it)
SHADOW_POINT = "serving.delivery.shadow"


class GateFailed(RuntimeError):
    """The candidate failed its golden-set gate; the incumbent keeps
    serving. ``report`` carries the measured deltas."""

    def __init__(self, msg: str, report: Optional[Dict[str, Any]] = None):
        super().__init__(msg)
        self.report = report or {}


class GateRefused(GateFailed):
    """The gate could not be trusted (corrupt or truncated golden set,
    unreadable sidecar): the deploy is refused exactly like a failed
    gate."""


def _probs(out) -> np.ndarray:
    """A model's (first) output as numpy, bfloat16 widened to float32."""
    from deeplearning4j_tpu_torch.serving.replica import _numpy
    if isinstance(out, (list, tuple)):
        out = out[0]
    return _numpy(out)


class GoldenSet:
    """The declared evaluation set a candidate must clear: inputs, optional
    labels (default: the golden model's own top-1, the **top-1 agreement**
    metric), and an optional ``max_delta``/``metric`` overriding the gate's
    bar. Persisted per archive as ``<archive>.golden``: a 4-byte
    little-endian CRC32 header and the JSON payload."""

    def __init__(self, inputs, labels=None, max_delta: Optional[float] = None,
                 metric: Optional[str] = None):
        self.inputs = np.asarray(inputs)
        self.labels = None if labels is None else np.asarray(labels)
        self.max_delta = None if max_delta is None else float(max_delta)
        self.metric = metric

    def gate(self, default: Optional["GoldenGate"] = None) -> "GoldenGate":
        """The gate this set declares: the sidecar's ``max_delta``/``metric``
        when present, else ``default`` (or the stock bar)."""
        base = default or GoldenGate()
        return GoldenGate(
            max_delta=self.max_delta if self.max_delta is not None else base.max_delta,
            metric=self.metric if self.metric is not None else base.metric)

    @staticmethod
    def sidecar(archive_path: str) -> str:
        return archive_path + ".golden"

    def save(self, path: str) -> str:
        payload = json.dumps({
            "inputs": self.inputs.tolist(),
            "labels": None if self.labels is None else self.labels.tolist(),
            "max_delta": self.max_delta,
            "metric": self.metric,
        }).encode()
        framed = struct.pack("<I", zlib.crc32(payload)) + payload
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(framed)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "GoldenSet":
        try:
            with open(path, "rb") as f:
                framed = f.read()
        except OSError as e:
            raise GateRefused(f"golden set {path!r} unreadable ({e}) — deploy refused")
        if len(framed) < 4:
            raise GateRefused(f"golden set {path!r} truncated below its CRC header — "
                              f"deploy refused")
        payload = chaos.transform_bytes(GATE_POINT, framed[4:])
        (crc,) = struct.unpack("<I", framed[:4])
        if zlib.crc32(payload) != crc:
            raise GateRefused(
                f"golden set {path!r} failed its CRC check (corrupt or truncated golden "
                f"set) — deploy refused, candidate never serves")
        try:
            obj = json.loads(payload.decode())
            return cls(obj["inputs"], labels=obj.get("labels"),
                       max_delta=obj.get("max_delta"), metric=obj.get("metric"))
        except Exception as e:
            raise GateRefused(f"golden set {path!r} unparsable after a clean CRC "
                              f"({e!r}) — deploy refused")

    @classmethod
    def for_archive(cls, archive_path: str) -> Optional["GoldenSet"]:
        """The archive's declared golden set, or ``None`` without a sidecar.
        A sidecar that exists but cannot be trusted is :class:`GateRefused`,
        never ``None``."""
        path = cls.sidecar(archive_path)
        if not os.path.exists(path):
            return None
        return cls.load(path)


class GoldenGate:
    """The deploy bar: the candidate's accuracy on the golden set may trail
    the golden model's by at most ``max_delta``. Without labels they
    default to the golden's own top-1 (**top-1 agreement**). A candidate
    with a ``dtype_policy`` sees its inputs through the policy's request
    quantization. ``golden_fn``/``candidate_fn`` override how each side
    produces probabilities (the registry routes both through their serving
    paths)."""

    #: subclasses re-point this at their own chaos point
    chaos_point = GATE_POINT
    #: the exception class a failed bar raises
    failure_exc = GateFailed

    def __init__(self, max_delta: float = 0.02, metric: str = "top1_agreement"):
        self.max_delta = float(max_delta)
        self.metric = metric

    @classmethod
    def from_policy(cls, policy) -> "GoldenGate":
        g = getattr(policy, "gate", None) or {}
        return cls(max_delta=float(g.get("max_delta", 0.02)),
                   metric=str(g.get("metric", "top1_agreement")))

    @staticmethod
    def _run(model, x):
        """One side's probabilities through ``model.output`` (graph models
        fed by input name)."""
        graph_inputs = list(getattr(getattr(model, "conf", None), "inputs", []) or [])
        if graph_inputs:
            if not isinstance(x, dict):
                x = {graph_inputs[0]: x}
            return _probs(model.output(*[x[n] for n in graph_inputs]))
        return _probs(model.output(x))

    def check(self, golden, candidate, inputs, labels=None,
              golden_fn: Optional[Callable[[Any], Any]] = None,
              candidate_fn: Optional[Callable[[Any], Any]] = None) -> Dict[str, Any]:
        """Evaluate both sides and enforce the bar: the report on success,
        :attr:`failure_exc` carrying it on failure."""
        from deeplearning4j_tpu_torch.evaluation import Evaluation
        chaos.inject(self.chaos_point)
        golden_probs = _probs(golden_fn(inputs) if golden_fn is not None
                                else self._run(golden, inputs))
        if labels is None:
            labels = golden_probs.argmax(-1)
        labels = np.asarray(labels)
        policy = getattr(candidate, "dtype_policy", None)
        c_inputs = inputs
        if policy is not None and candidate_fn is None:
            from deeplearning4j_tpu_torch.serving.quantize import quantize_requests
            c_inputs = quantize_requests(inputs, policy)
        cand_probs = _probs(candidate_fn(c_inputs) if candidate_fn is not None
                              else self._run(candidate, c_inputs))
        ev_g, ev_c = Evaluation(), Evaluation()
        ev_g.eval(labels, golden_probs)
        ev_c.eval(labels, cand_probs)
        delta = ev_g.accuracy() - ev_c.accuracy()
        report = {"metric": self.metric,
                  "golden_accuracy": round(ev_g.accuracy(), 6),
                  "candidate_accuracy": round(ev_c.accuracy(), 6),
                  # the quantized deploy's report key, kept as the JAX package keeps it
                  "quantized_accuracy": round(ev_c.accuracy(), 6),
                  "accuracy_delta": round(float(delta), 6),
                  "max_delta": self.max_delta,
                  "n_examples": int(ev_g.total),
                  "passed": bool(delta <= self.max_delta)}
        if not report["passed"]:
            raise self.failure_exc(
                f"candidate failed its golden-set gate: delta {delta:.4f} > max_delta "
                f"{self.max_delta} (golden {report['golden_accuracy']}, candidate "
                f"{report['candidate_accuracy']} over {report['n_examples']} examples)",
                report)
        return report


def _top1(obj) -> Optional[np.ndarray]:
    """Top-1 predictions out of a decoded ``outputs`` payload, or
    ``None`` when the payload has no argmax-able shape."""
    try:
        arr = np.asarray(obj, dtype=np.float64)
    except Exception:
        return None
    if arr.ndim < 1 or arr.size == 0:
        return None
    return arr.argmax(-1)


class ShadowComparator:
    """The shadow stage's ledger: every mirrored response is compared to
    the incumbent's for top-1 disagreement and latency delta. Mirrors
    are observational only — a candidate error or disagreement here
    refuses promotion; it can never touch a client response or a worker
    breaker."""

    def __init__(self, max_disagreement: float = 0.0,
                 min_samples: int = 16):
        self.max_disagreement = float(max_disagreement)
        self.min_samples = int(min_samples)
        # guards: mirrored_total, compared_total, disagreed_total, candidate_errors_total, corrupt_total, incumbent_latency_s, candidate_latency_s
        self._lock = threading.Lock()
        self.mirrored_total = 0
        self.compared_total = 0
        self.disagreed_total = 0
        self.candidate_errors_total = 0
        self.corrupt_total = 0
        self.incumbent_latency_s = 0.0
        self.candidate_latency_s = 0.0

    def observe(self, incumbent_body: bytes, candidate_status: int,
                candidate_body: bytes, incumbent_latency_s: float,
                candidate_latency_s: float, corrupt: bool = False) -> bool:
        """Fold one mirror's outcome in; returns True when the pair
        DISAGREED (or could not be compared)."""
        disagreed = False
        if corrupt:
            pass  # counted below; a corrupt comparison refuses promotion
        elif candidate_status != 200:
            pass
        else:
            try:
                inc = json.loads(incumbent_body.decode())["outputs"]
                cand = json.loads(candidate_body.decode())["outputs"]
            except Exception:
                corrupt = True
            else:
                t_inc, t_cand = _top1(inc), _top1(cand)
                disagreed = (t_inc is None or t_cand is None
                             or t_inc.shape != t_cand.shape
                             or not np.array_equal(t_inc, t_cand))
        with self._lock:
            self.mirrored_total += 1
            if corrupt:
                self.corrupt_total += 1
            elif candidate_status != 200:
                self.candidate_errors_total += 1
            else:
                self.compared_total += 1
                self.incumbent_latency_s += float(incumbent_latency_s)
                self.candidate_latency_s += float(candidate_latency_s)
                if disagreed:
                    self.disagreed_total += 1
        return disagreed or corrupt

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            compared = self.compared_total
            return {
                "mirrored_total": self.mirrored_total,
                "compared_total": compared,
                "disagreed_total": self.disagreed_total,
                "candidate_errors_total": self.candidate_errors_total,
                "corrupt_total": self.corrupt_total,
                "disagreement_rate": round(
                    self.disagreed_total / compared, 6) if compared else 0.0,
                "latency_delta_ms": round(
                    (self.candidate_latency_s - self.incumbent_latency_s)
                    / compared * 1e3, 3) if compared else 0.0,
            }

    def verdict(self) -> Optional[str]:
        """``None`` while evidence is still accruing, ``"pass"`` once
        ``min_samples`` clean comparisons agree, else the refusal
        cause. Corruption and candidate errors refuse IMMEDIATELY — a
        comparison that cannot be trusted must never be averaged away."""
        s = self.snapshot()
        if s["corrupt_total"] > 0:
            return "shadow_corrupt"
        if s["candidate_errors_total"] > 0:
            return "shadow_candidate_errors"
        if s["compared_total"] < self.min_samples:
            return None
        if s["disagreement_rate"] > self.max_disagreement:
            return "shadow_divergence"
        return "pass"


# ===================================================== delivery control
class DeliveryConfig:
    """Knobs for one gated delivery. ``canary_fractions`` is the ramp
    schedule — each step must see ``canary_min_requests`` candidate
    responses with both burn rates under the limits before the next
    step (the last step's pass is the promotion verdict). ``now_fn``
    and ``seed`` are injectable so drills replay deterministically."""

    def __init__(self, shadow_fraction: float = 0.5,
                 shadow_min_samples: int = 16,
                 shadow_max_disagreement: float = 0.0,
                 canary_fractions: Sequence[float] = (0.1, 0.3),
                 canary_min_requests: int = 16,
                 canary_target: Optional[SLOTarget] = None,
                 max_availability_burn: float = 1.0,
                 max_latency_burn: float = 1.0,
                 canary_window_s: int = 60,
                 stage_timeout_s: float = 120.0,
                 seed: int = 0,
                 now_fn: Callable[[], float] = time.monotonic):
        if not 0.0 <= shadow_fraction <= 1.0:
            raise ValueError(f"bad shadow_fraction {shadow_fraction!r}")
        fractions = tuple(float(f) for f in canary_fractions)
        if not fractions or any(not 0.0 < f <= 1.0 for f in fractions):
            raise ValueError(f"bad canary_fractions {canary_fractions!r}")
        self.shadow_fraction = float(shadow_fraction)
        self.shadow_min_samples = int(shadow_min_samples)
        self.shadow_max_disagreement = float(shadow_max_disagreement)
        self.canary_fractions = fractions
        self.canary_min_requests = int(canary_min_requests)
        self.canary_target = canary_target or SLOTarget(
            availability=0.99, latency_ms=250.0, latency_target=0.9)
        self.max_availability_burn = float(max_availability_burn)
        self.max_latency_burn = float(max_latency_burn)
        self.canary_window_s = int(canary_window_s)
        self.stage_timeout_s = float(stage_timeout_s)
        self.seed = int(seed)
        self.now_fn = now_fn


#: stages a controller moves through (terminal: promoted / rolled_back /
#: gate_failed)
STAGES = ("gate", "shadow", "canary", "promote_ready", "rollback_pending",
          "promoted", "rolled_back", "gate_failed")


class DeliveryController:
    """One gated deploy's state machine. The router consults
    :meth:`take_shadow` / :meth:`take_canary` per request, feeds
    :meth:`observe_shadow` / :meth:`observe_canary` per outcome, and the
    deploy driver calls :meth:`tick` until a terminal verdict. Every
    transition is a typed ``delivery.stage`` journal event, so the full
    gate -> shadow -> canary -> verdict history reconstructs from one
    ``/v1/debug/bundle``."""

    def __init__(self, model: str, archive: str, version,
                 candidate_worker: str, config: Optional[DeliveryConfig]
                 = None, gate_report: Optional[Dict[str, Any]] = None):
        self.model = str(model)
        self.archive = archive
        self.version = version
        self.candidate_worker = str(candidate_worker)
        self.config = config or DeliveryConfig()
        self.gate_report = gate_report or {}
        self.shadow = ShadowComparator(
            max_disagreement=self.config.shadow_max_disagreement,
            min_samples=self.config.shadow_min_samples)
        # the candidate's own per-version SLO window — the rollback
        # trigger, fed ONLY by canary outcomes (never by shadow mirrors)
        self.canary_slo = SLOMonitor(
            target=self.config.canary_target,
            windows_s=(self.config.canary_window_s,),
            now_fn=self.config.now_fn)
        self._rng = random.Random(self.config.seed)
        # guards: stage, ramp_index, canary_requests, canary_failures, client_errors, rollback_cause, history
        self._lock = threading.Lock()
        self.stage = "gate"
        self.ramp_index = 0
        self.canary_requests = 0     # candidate responses at current step
        self.canary_failures = 0     # candidate failures (client-invisible)
        self.client_errors = 0       # must stay 0 across the whole drill
        self.rollback_cause: Optional[str] = None
        self.history: List[Dict[str, Any]] = []
        self._stage_started = self.config.now_fn()
        self._record("gate")

    # ----------------------------------------------------------- stages
    # holds: _lock
    def _record(self, stage: str, **attrs) -> None:
        entry = {"stage": stage, "at": round(self.config.now_fn(), 3),
                 **attrs}
        self.history.append(entry)
        journal.emit("delivery.stage", model=self.model,
                     archive=self.archive, version=self.version,
                     candidate=self.candidate_worker, stage=stage, **attrs)

    def transition(self, stage: str, **attrs) -> None:
        with self._lock:
            if stage == self.stage:
                return
            attrs.setdefault("from_stage", self.stage)
            self.stage = stage
            self._stage_started = self.config.now_fn()
            self._record(stage, **attrs)

    @property
    def decided(self) -> bool:
        return self.stage in ("promote_ready",  # unguarded-ok: racy read
                              "rollback_pending", "promoted",
                              "rolled_back", "gate_failed")

    def canary_fraction(self) -> float:
        idx = min(self.ramp_index,  # unguarded-ok: racy read, bounds-safe
                  len(self.config.canary_fractions) - 1)
        return self.config.canary_fractions[idx]

    # ---------------------------------------------------- request hooks
    def matches(self, model: str) -> bool:
        return str(model) == self.model

    def take_shadow(self) -> bool:
        if self.stage != "shadow":  # unguarded-ok: stale read self-heals
            return False
        with self._lock:
            return self._rng.random() < self.config.shadow_fraction

    def take_canary(self) -> bool:
        if self.stage != "canary":  # unguarded-ok: stale read self-heals
            return False
        with self._lock:
            return self._rng.random() < self.canary_fraction()

    def observe_shadow(self, incumbent_body: bytes, candidate_status: int,
                       candidate_body: bytes, incumbent_latency_s: float,
                       candidate_latency_s: float,
                       corrupt: bool = False) -> bool:
        return self.shadow.observe(incumbent_body, candidate_status,
                                   candidate_body, incumbent_latency_s,
                                   candidate_latency_s, corrupt=corrupt)

    def observe_canary(self, ok: bool, latency_s: float) -> None:
        self.canary_slo.record(self.model, ok=ok, latency_s=latency_s)
        with self._lock:
            self.canary_requests += 1
            if not ok:
                self.canary_failures += 1

    def client_error(self) -> None:
        """A client-visible non-2xx attributable to the delivery drill —
        the zero-error contract's counter (must stay 0)."""
        with self._lock:
            self.client_errors += 1

    # ------------------------------------------------------- evaluation
    def _canary_burns(self) -> Tuple[int, float, float]:
        rep = self.canary_slo.report(models=[self.model]).get(self.model)
        if rep is None:
            return 0, 0.0, 0.0
        w = rep["windows"][f"{self.config.canary_window_s}s"]
        return (int(w["requests"]), float(w["availability_burn_rate"]),
                float(w["latency_burn_rate"]))

    def tick(self) -> Optional[str]:
        """Advance the state machine from accrued evidence. Returns the
        new stage when a transition fired, else ``None``. Safe to call
        from the deploy driver's wait loop at any cadence."""
        stage = self.stage  # unguarded-ok: the driver is the only ticker
        if stage not in ("shadow", "canary"):
            return None
        timed_out = (self.config.now_fn() - self._stage_started
                     > self.config.stage_timeout_s)
        if stage == "shadow":
            v = self.shadow.verdict()
            if v == "pass":
                journal.emit("delivery.shadow_stats", model=self.model,
                             archive=self.archive, verdict="pass",
                             **self.shadow.snapshot())
                self.transition("canary",
                                fraction=self.canary_fraction())
                return "canary"
            if v is not None or timed_out:
                cause = v or "shadow_timeout"
                journal.emit("delivery.shadow_stats", model=self.model,
                             archive=self.archive, verdict=cause,
                             **self.shadow.snapshot())
                return self._decide_rollback(cause)
            return None
        # canary: any breach rolls back; a full healthy step ramps
        n, avail_burn, lat_burn = self._canary_burns()
        min_evidence = max(4, self.config.canary_min_requests // 4)
        if n >= min_evidence:
            if avail_burn > self.config.max_availability_burn:
                return self._decide_rollback(
                    "slo_availability_burn",
                    availability_burn=avail_burn, requests=n)
            if lat_burn > self.config.max_latency_burn:
                return self._decide_rollback(
                    "slo_latency_burn", latency_burn=lat_burn, requests=n)
        with self._lock:
            step_done = self.canary_requests >= self.config.canary_min_requests
        if step_done:
            with self._lock:
                last = (self.ramp_index
                        >= len(self.config.canary_fractions) - 1)
                if not last:
                    self.ramp_index += 1
                    self.canary_requests = 0
                    fraction = self.canary_fraction()
            if last:
                self.transition("promote_ready",
                                availability_burn=avail_burn,
                                latency_burn=lat_burn)
                return "promote_ready"
            self._record("canary_ramp", fraction=fraction)
            return None
        if timed_out:
            return self._decide_rollback("canary_timeout", requests=n)
        return None

    def _decide_rollback(self, cause: str, **attrs) -> str:
        with self._lock:
            self.rollback_cause = cause
        self.transition("rollback_pending", cause=cause, **attrs)
        return "rollback_pending"

    # ---------------------------------------------------------- verdicts
    def finish_promoted(self) -> None:
        self.transition("promoted")
        journal.emit("delivery.promote", model=self.model,
                     archive=self.archive, version=self.version,
                     candidate=self.candidate_worker,
                     shadow=self.shadow.snapshot(),
                     client_errors=self.client_errors)  # unguarded-ok

    def finish_rolled_back(self, cause: Optional[str] = None) -> None:
        cause = (cause or self.rollback_cause  # unguarded-ok: settled
                 or "unknown")
        self.transition("rolled_back", cause=cause)
        journal.emit("delivery.rollback", model=self.model,
                     archive=self.archive, version=self.version,
                     candidate=self.candidate_worker, cause=cause,
                     shadow=self.shadow.snapshot(),
                     client_errors=self.client_errors)  # unguarded-ok

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "model": self.model,
                "archive": self.archive,
                "version": self.version,
                "candidate_worker": self.candidate_worker,
                "stage": self.stage,
                "ramp_index": self.ramp_index,
                "canary_fraction": self.canary_fraction(),
                "canary_requests": self.canary_requests,
                "canary_failures": self.canary_failures,
                "client_errors": self.client_errors,
                "rollback_cause": self.rollback_cause,
                "gate_report": dict(self.gate_report),
                "shadow": self.shadow.snapshot(),
                "history": [dict(h) for h in self.history],
            }


# ======================================================= feedback (flywheel)
#: process-wide feedback counters (rendered as
#: ``serving_feedback_joined_total`` / ``serving_feedback_orphaned_total``)
_FEEDBACK_LOCK = threading.Lock()  # guards: (feedback counters + appends)
_FEEDBACK_COUNTS = {"joined_total": 0, "orphaned_total": 0}


def feedback_counters() -> Dict[str, int]:
    with _FEEDBACK_LOCK:
        return dict(_FEEDBACK_COUNTS)


class FeedbackLog:
    """``POST /v1/feedback``'s backing store — the data flywheel's feed:
    a client labels an answer it got
    (``{trace_id, label | score}``), the label is JOINED against the
    structured access log (``DL4J_TPU_ACCESS_LOG=<path>``) by
    trace id, and the joined record appends to an append-only
    labeled-example file (``DL4J_TPU_FEEDBACK_FILE``, default
    ``<access_log>.labeled.jsonl``) — model/worker/outcome/latency
    context and the label in one line, usable as training feed.

    A label whose trace id has no access-log line (rotated away, logging
    off, or never served here) is an ORPHAN: counted, not written —
    a labeled-example file must never contain label-only rows.

    The file rotates like the access log: once an
    append would push it past ``DL4J_TPU_FEEDBACK_FILE_MAX_BYTES`` it is
    atomically renamed to ``<path>.1`` (keep-1 rollover) and a fresh
    file starts — a long-running flywheel can never grow the labeled
    feed unbounded, and readers (:func:`iter_feedback_examples`, which
    feeds the scheduler's flywheel job) consult the ``.1`` file too."""

    @staticmethod
    def max_bytes() -> int:
        """``DL4J_TPU_FEEDBACK_FILE_MAX_BYTES``: size-based rotation
        threshold (0 / unset / unparsable = no rotation), mirroring
        ``DL4J_TPU_ACCESS_LOG_MAX_BYTES``."""
        try:
            return max(0, int(os.environ.get(
                "DL4J_TPU_FEEDBACK_FILE_MAX_BYTES", "0")))
        except ValueError:
            return 0

    def __init__(self, access_log_path: Optional[str] = None,
                 out_path: Optional[str] = None):
        if access_log_path is None:
            from deeplearning4j_tpu_torch.runtime import trace
            access_log_path = trace._access_log_path()
        self.access_log_path = access_log_path
        self.out_path = out_path or os.environ.get(
            "DL4J_TPU_FEEDBACK_FILE") or (
                f"{access_log_path}.labeled.jsonl" if access_log_path
                else None)

    def _lookup(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The access-log record for ``trace_id`` (newest wins), scanning
        the live file then its keep-1 rollover."""
        if not self.access_log_path:
            return None
        found = None
        for path in (self.access_log_path, self.access_log_path + ".1"):
            try:
                with open(path) as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        if rec.get("trace_id") == trace_id:
                            found = rec
                if found is not None:
                    return found
            except OSError:
                continue
        return None

    def record(self, trace_id: str, label=None, score=None, inputs=None
               ) -> Optional[Dict[str, Any]]:
        """Join one label against the access log; returns the appended
        labeled example, or ``None`` for an orphan. ``inputs`` (the
        request features, re-sent by the labelling client) rides along
        when given — that is what turns a labeled line into a training
        example the flywheel fine-tune can actually fit on."""
        rec = self._lookup(str(trace_id))
        if rec is None or self.out_path is None:
            with _FEEDBACK_LOCK:
                _FEEDBACK_COUNTS["orphaned_total"] += 1
            return None
        example = {k: v for k, v in rec.items() if k != "log"}
        example["label"] = label
        example["score"] = score
        if inputs is not None:
            example["inputs"] = inputs
        example["feedback"] = True
        line = json.dumps(example, default=str) + "\n"
        max_bytes = self.max_bytes()
        with _FEEDBACK_LOCK:
            if max_bytes:
                try:
                    size = os.path.getsize(self.out_path)
                except OSError:
                    size = 0
                if size and size + len(line.encode()) > max_bytes:
                    # atomic keep-1 rollover, same shape as the access log
                    os.replace(self.out_path, self.out_path + ".1")
            with open(self.out_path, "a") as f:
                f.write(line)
            _FEEDBACK_COUNTS["joined_total"] += 1
        return example


def iter_feedback_examples(path: str):
    """Yield labeled examples from a feedback file INCLUDING its keep-1
    rollover (``<path>.1`` first, so lines come out oldest-first across
    the rotation boundary). Malformed lines are skipped, missing files
    are empty — the flywheel's feed must read cleanly mid-rotation."""
    for p in (path + ".1", path):
        try:
            with open(p) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("feedback"):
                        yield rec
        except OSError:
            continue


def handle_feedback(raw: bytes) -> Tuple[int, Dict[str, Any]]:
    """The shared ``POST /v1/feedback`` handler (server AND router mount
    it): 200 with the joined example, 202 for an accepted-but-orphaned
    label, 400 for a malformed body."""
    try:
        body = json.loads(raw.decode() or "{}")
    except ValueError as e:
        return 400, {"error": f"malformed feedback body: {e}"}
    trace_id = body.get("trace_id")
    label, score = body.get("label"), body.get("score")
    if not trace_id:
        return 400, {"error": "feedback requires a trace_id"}
    if label is None and score is None:
        return 400, {"error": "feedback requires a label or a score"}
    example = FeedbackLog().record(trace_id, label=label, score=score,
                                   inputs=body.get("inputs"))
    if example is None:
        return 202, {"joined": False, "trace_id": trace_id,
                     "detail": "no access-log line for this trace id "
                               "(logging off, rotated away, or served "
                               "elsewhere) — label not recorded"}
    return 200, {"joined": True, "example": example}
