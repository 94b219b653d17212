"""Failure handling for the serving subsystem: circuit breaking, retries,
health states.

The port's own copy of ``deeplearning4j_tpu/serving/resilience.py`` (pure
Python, on the port's ``runtime/journal.py``). Admission control handles
load; this module handles *failures*: a model that starts throwing must not take every request down
with it, a transient fault must not surface to the client when one cheap
retry would absorb it, and orchestration needs an honest readiness signal.

- :class:`CircuitBreaker` — per-model three-state breaker. CLOSED counts
  consecutive-within-window failures; at ``failure_threshold`` it OPENs
  (requests shed instantly with :class:`CircuitOpen`, no compute wasted on
  a known-bad model). After ``reset_timeout_s`` it goes HALF_OPEN and
  admits up to ``half_open_probes`` probe requests: a probe success closes
  the breaker, a probe failure re-opens it and restarts the timer.
- :class:`RetryPolicy` — bounded retries with exponential backoff and
  **full jitter** (delay ~ U[0, min(cap, base * 2^attempt)]), the
  decorrelated schedule that avoids retry stampedes. Seedable so tests
  and chaos drills replay exactly.
- :class:`HealthState` — the per-model lifecycle surfaced on ``/readyz``:
  STARTING (build/warmup in progress), READY, DEGRADED (breaker not
  closed), DRAINING (undeploy/shutdown in progress).

Admission rejections (``Overloaded`` / ``DeadlineExceeded`` /
``ServingShutdown``) are *load* signals, not model faults: they never trip
the breaker and are never retried here.
"""

from __future__ import annotations

import enum
import random
import threading
import time
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch.runtime import journal
from deeplearning4j_tpu_torch.serving.admission import ServingError


class CircuitOpen(ServingError):
    """Request shed because the model's circuit breaker is open."""


class CircuitState(enum.Enum):
    CLOSED = 0
    HALF_OPEN = 1
    OPEN = 2


class HealthState(enum.Enum):
    STARTING = "starting"
    READY = "ready"
    DEGRADED = "degraded"
    DRAINING = "draining"


class CircuitBreaker:
    """Three-state breaker (thread-safe).

    ``failure_threshold`` failures within ``window_s`` (a success clears
    the count — i.e. consecutive-within-window semantics) open the
    circuit. ``clock`` is injectable so tests drive transitions without
    sleeping.

    Every state TRANSITION emits a ``breaker.open`` / ``breaker.half_open``
    / ``breaker.close`` event into the fleet journal tagged
    with ``journal_scope`` — ``"model:<name>"`` for the registry's
    per-model breakers, ``"worker:<id>"`` for the router's passive
    per-worker views — so a flapping breaker is visible in the black box
    and the watchdog's breaker-flap rule has something to count. Steady
    state emits nothing (the serving hot path records successes without
    a transition).
    """

    def __init__(self, failure_threshold: int = 5, window_s: float = 30.0,
                 reset_timeout_s: float = 5.0, half_open_probes: int = 1,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.window_s = float(window_s)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = int(half_open_probes)
        self._clock = clock
        #: who this breaker protects, for journal events (set by the
        #: owner; None = emit unscoped)
        self.journal_scope: Optional[str] = None
        # guards: _state, _failures, _seen_keys, _opened_at, _probes_issued, opens_total
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._failures: List[float] = []  # timestamps within window
        self._seen_keys: Dict[str, float] = {}  # batch-failure dedup
        self._opened_at: Optional[float] = None
        self._probes_issued = 0
        self.opens_total = 0

    # ------------------------------------------------------------ internal
    def _prune(self, now: float) -> None:  # holds: _lock
        cutoff = now - self.window_s
        self._failures = [t for t in self._failures if t > cutoff]

    def _tick(self, now: float) -> None:  # holds: _lock
        """OPEN -> HALF_OPEN once the reset timeout elapses."""
        if (self._state is CircuitState.OPEN
                and now - self._opened_at >= self.reset_timeout_s):
            self._state = CircuitState.HALF_OPEN
            self._probes_issued = 0
            journal.emit("breaker.half_open", scope=self.journal_scope)

    # ------------------------------------------------------------- queries
    @property
    def state(self) -> CircuitState:
        with self._lock:
            self._tick(self._clock())
            return self._state

    def allow(self) -> bool:
        """May a request proceed right now? HALF_OPEN admits at most
        ``half_open_probes`` in-flight probes (counted here)."""
        with self._lock:
            now = self._clock()
            self._tick(now)
            if self._state is CircuitState.CLOSED:
                return True
            if self._state is CircuitState.OPEN:
                return False
            if self._probes_issued < self.half_open_probes:
                self._probes_issued += 1
                return True
            return False

    # ------------------------------------------------------------ outcomes
    def record_success(self) -> None:
        with self._lock:
            self._tick(self._clock())
            if self._state is CircuitState.HALF_OPEN:
                self._state = CircuitState.CLOSED
                journal.emit("breaker.close", scope=self.journal_scope)
            self._failures.clear()

    def record_discard(self) -> None:
        """The allowed request ended in an admission rejection (Overloaded
        / DeadlineExceeded / ServingShutdown) — neither a model success nor
        a model failure. Returns a half-open probe slot so an admission
        rejection during HALF_OPEN cannot leak the probe and wedge the
        breaker in a permanent shedding state."""
        with self._lock:
            if (self._state is CircuitState.HALF_OPEN
                    and self._probes_issued > 0):
                self._probes_issued -= 1

    def record_failure(self, key: Optional[str] = None) -> None:
        """``key`` (optional) dedups shared faults: the pipelined batcher
        stamps one key per faulted *batch*, so a single mid-flight failure
        that takes down N coalesced requests counts once toward the
        threshold, not N times — one bad batch must not read as an outage.
        Distinct batches (e.g. each retry attempt) get distinct keys and
        still count individually."""
        with self._lock:
            now = self._clock()
            self._tick(now)
            if key is not None:
                cutoff = now - self.window_s
                self._seen_keys = {k: t for k, t in self._seen_keys.items()
                                   if t > cutoff}
                if key in self._seen_keys:
                    return
                self._seen_keys[key] = now
            if self._state is CircuitState.HALF_OPEN:
                # failed probe: back to OPEN, restart the timer
                self._state = CircuitState.OPEN
                self._opened_at = now
                self.opens_total += 1
                journal.emit("breaker.open", scope=self.journal_scope,
                             reason="probe_failed",
                             opens_total=self.opens_total)
                return
            if self._state is CircuitState.OPEN:
                return
            self._failures.append(now)
            self._prune(now)
            if len(self._failures) >= self.failure_threshold:
                self._state = CircuitState.OPEN
                self._opened_at = now
                self.opens_total += 1
                journal.emit("breaker.open", scope=self.journal_scope,
                             reason="failure_threshold",
                             failures=len(self._failures),
                             opens_total=self.opens_total)
                self._failures.clear()

    def warm_open(self) -> None:
        """Adopt an externally observed OPEN verdict (a fresh
        router warm-starts its passive per-worker breaker from the
        worker's own ``/v1/metricsz`` breaker states instead of
        re-learning the failure streak from live traffic). A no-op unless
        CLOSED — an already OPEN/HALF_OPEN breaker keeps its own timer,
        so a warm-start can never reset an in-progress recovery probe."""
        with self._lock:
            now = self._clock()
            self._tick(now)
            if self._state is CircuitState.CLOSED:
                self._state = CircuitState.OPEN
                self._opened_at = now
                self.opens_total += 1
                journal.emit("breaker.open", scope=self.journal_scope,
                             reason="warm_start",
                             opens_total=self.opens_total)
                self._failures.clear()

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            self._tick(self._clock())
            return {"state": self._state.name,
                    "failures_in_window": len(self._failures),
                    "opens_total": self.opens_total}


class RetryPolicy:
    """Exponential backoff with full jitter (seedable, thread-safe enough:
    the RNG is only read under the caller's request thread; determinism is
    per-policy-instance for single-threaded drills)."""

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.02,
                 max_delay_s: float = 1.0, seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self._rng = random.Random(seed)
        self._sleep = sleep

    def delay_for(self, attempt: int) -> float:
        """Full jitter: U[0, min(max_delay, base * 2^attempt)] for the
        delay AFTER failed attempt number ``attempt`` (0-based)."""
        cap = min(self.max_delay_s, self.base_delay_s * (2 ** attempt))
        return self._rng.uniform(0.0, cap)

    def sleep_before_retry(self, attempt: int) -> float:
        d = self.delay_for(attempt)
        if d > 0:
            self._sleep(d)
        return d


NO_RETRY = RetryPolicy(max_attempts=1)
