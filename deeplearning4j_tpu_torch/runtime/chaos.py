"""Deterministic fault injection (the chaos-engineering layer).

The port's own copy of ``deeplearning4j_tpu/runtime/chaos.py`` (pure
Python): the same point names and policies.

The ROADMAP north star is production serving; that requires the system to
be provably well-behaved under *injected* failure, not just under load.
This module is the injection side: production code declares **named
injection points** (``chaos.inject("serving.batcher.forward")``,
``chaos.transform_bytes("train.checkpoint.bytes", data)``) and a test,
benchmark, or drill installs a :class:`ChaosController` that maps points to
**policies**:

- :class:`FailNth` — fail the N-th call (or every N-th) at a point.
- :class:`FailWithProbability` — fail each call with probability ``p``
  drawn from a per-policy seeded RNG, so a schedule replays exactly.
- :class:`AddLatency` — sleep a fixed delay plus seeded jitter.
- :class:`CorruptBytes` — corrupt data flowing through a byte point
  (bit-flips or truncation at seeded offsets): the torn-write /
  bit-rot simulator for checkpoint archives.
- :class:`HangUntilCancelled` — block until the controller is cancelled
  (scope exit), then raise :class:`ChaosCancelled`: the stuck-worker
  simulator a heartbeat watchdog must catch.

Design constraints:

- **No-op fast path.** With no controller installed, ``inject()`` is one
  module-global load and an ``is None`` test — nothing allocates, nothing
  locks. Serving/training hot paths may call it unconditionally.
- **Determinism.** Every policy owns a ``random.Random`` seeded from
  ``(controller seed, point pattern, policy index, class name)``; per-point
  call indices are sequential under a lock. The same seed and the same
  call sequence produce the same fault schedule, and the controller's
  ``events`` log records every decision for replay assertions.
- **Scoped.** ``with ChaosController(seed=7) as c: ...`` installs the
  controller globally for the block and restores the previous one (nesting
  allowed) on exit; exit also cancels any :class:`HangUntilCancelled`
  waiters so no thread outlives the blast radius.

Catalogue of injection points threaded through the stack (see
``docs/robustness.md``): ``serving.batcher.submit``,
``serving.batcher.forward`` (dispatch stage — fires as the batch is issued
to a replica), ``serving.batcher.complete`` (completion stage — fires
before the blocking readback, so ``AddLatency`` here simulates a slow
device and fills the pipeline's in-flight window),
``serving.batcher.warmup``, ``serving.registry.register``,
``serving.registry.page_in`` (fires as a cold model's single-flight
rehydration begins — ``AddLatency`` here simulates a slow page-in so
drills can exercise the queue-wait and honest-``Retry-After`` paths),
``train.checkpoint.write`` (call), ``train.checkpoint.bytes`` (byte
point), ``train.epoch``, ``train.iteration`` (via :class:`ChaosListener`),
``train.prefetch.fetch`` (fires once per fetched batch on the training
feed path, before coercion/transfer — in the
:class:`~deeplearning4j_tpu_torch.train.prefetch.DevicePrefetcher` worker when
prefetching, inline otherwise, so one drill schedule covers both; a fault
must fail the fit cleanly with no thread left behind, see
``tests/test_train_pipeline.py``), ``runtime.compile_cache.load`` (fires
once per persistent-compilation-cache lookup, before the entry is read —
a fault here simulates a corrupt/truncated cached executable and must
degrade to a fresh compile, never a crash or a wrong answer, see
``tests/test_compile_cache.py``), ``train.distributed.exchange`` (fires
once per distributed training step at the top of the gradient exchange —
a fault kills the worker's step, which must surface as a supervised
whole-group restart with exact checkpoint resume, never a silent
divergence) and ``train.distributed.exchange.bytes`` (byte point over a
worker's encoded-update payload AFTER its CRC header is computed, so
injected wire corruption is exactly what every receiver's CRC check
catches — see ``tests/test_distributed.py``), ``serving.worker.predict``
(fires at the top of every ``ModelServer`` predict — per-PROCESS, so a
fleet drill can slow or fail one worker without touching its peers;
``AddLatency(p=...)`` here is the straggler injector ``bench.py
--fleet`` hedges against), ``serving.router.forward`` (fires in the
fleet router before each forward attempt — primary, hedge, or failover —
a fault here is a failed attempt the router must absorb by failing over
within the deadline), ``serving.router.hedge`` (fires as a hedge is
launched against a second worker, so a drill can fault or delay exactly
the hedge path — see ``tests/test_router.py``) and ``serving.wire.frame``
(fires per binary wire-frame encode, plus a ``transform_bytes`` byte
point over the finished CRC-framed frame — injected corruption,
truncation or bit flips must surface as a counted wire protocol error
and a JSON fallback/retry, never a silently wrong tensor, see
``tests/test_wire.py``).
"""

from __future__ import annotations

import fnmatch
import logging
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.runtime import journal, trace

logger = logging.getLogger(__name__)


# Central chaos-point registry: every injection point fired
# anywhere in the package, name -> one-line description. The analysis
# lint diffs this registry against (a) the `chaos.inject`/`transform_bytes`
# call sites in code, (b) the `docs/robustness.md` catalogue rows, and
# (c) the test/bench corpus — a point missing from any leg is a finding,
# so code, registry, docs and drills can never drift apart.
REGISTERED_POINTS: Dict[str, str] = {
    "serving.batcher.submit": "every request admission into the batcher",
    "serving.batcher.forward": "dispatch stage, as a batch is issued to a replica",
    "serving.batcher.complete": "completion stage, before the blocking readback",
    "serving.batcher.warmup": "AOT bucket warmup during build/hot-swap",
    "serving.registry.register": "start of every model registration",
    "serving.registry.deploy_quantized": "top of the accuracy-gated quantized deploy",
    "serving.registry.page_in": "start of a cold model's single-flight rehydration",
    "serving.worker.predict": "top of every ModelServer predict (per process)",
    "serving.router.forward": "router, before each forward attempt",
    "serving.router.hedge": "router, as a hedge launches against a second worker",
    "serving.router.config_load": "FleetConfig reload (call + byte point)",
    "serving.autoscale.lease": "LeaseElection, before every leader heartbeat",
    "serving.quantize.calibrate": "per calibration batch (call + CRC byte point)",
    "serving.quantize.gate": "top of the deploy_quantized accuracy-gate eval",
    "serving.delivery.gate": "golden-set gate eval; also a byte point over the CRC-framed golden-set sidecar",
    "serving.delivery.shadow": "shadow mirror launch; also a byte point over the mirrored response body",
    "train.checkpoint.write": "before each checkpoint archive write",
    "train.checkpoint.bytes": "byte point over the checkpoint archive bytes",
    "train.epoch": "supervised epoch worker, before net.fit",
    "train.iteration": "every iteration via chaos.ChaosListener",
    "train.prefetch.fetch": "per fetched batch on the training feed path",
    "train.distributed.exchange": "top of each distributed gradient exchange",
    "train.distributed.exchange.bytes": "byte point over a worker's encoded update",
    "runtime.compile_cache.load": "per persistent-executable-cache lookup",
    "serving.session.step": "top of every streaming-session step",
    "serving.session.rehydrate": "session spill read-back; also a byte point over the CRC-framed spill frame",
    "serving.wire.frame": "binary wire-frame encode; also a byte point over the CRC-framed frame",
    "serving.scheduler.claim": "background scheduler, before each exactly-once job claim on the ledger",
}


class ChaosError(RuntimeError):
    """An injected failure (never raised by real production faults)."""


class ChaosCancelled(ChaosError):
    """A :class:`HangUntilCancelled` hang released by controller exit."""


class Policy:
    """Base injection policy. Subclasses override :meth:`apply` (call
    points: raise / sleep / hang) and/or :meth:`transform` (byte points)."""

    def apply(self, point: str, index: int, rng: random.Random,
              controller: "ChaosController") -> Optional[str]:
        """Act on the ``index``-th call (1-based) of ``point``. Return a
        short action tag for the event log, or None for no action."""
        return None

    def transform(self, point: str, index: int, rng: random.Random,
                  data: bytes) -> Tuple[bytes, Optional[str]]:
        """Transform bytes flowing through ``point``. Returns (data, tag);
        return the SAME object untouched for no action."""
        return data, None


class FailNth(Policy):
    """Fail the ``n``-th call at a point (1-based); with ``every=True``,
    fail every ``n``-th call."""

    def __init__(self, n: int, every: bool = False,
                 exc: Optional[BaseException] = None):
        self.n = int(n)
        self.every = every
        self.exc = exc

    def apply(self, point, index, rng, controller):
        hit = (index % self.n == 0) if self.every else (index == self.n)
        if hit:
            raise self.exc or ChaosError(
                f"injected failure at {point} (call #{index})")
        return None


class FailWithProbability(Policy):
    """Fail each call with probability ``p`` from the policy's seeded RNG
    — the same seed replays the same fault schedule call-for-call."""

    def __init__(self, p: float, exc: Optional[BaseException] = None):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.p = float(p)
        self.exc = exc

    def apply(self, point, index, rng, controller):
        if rng.random() < self.p:
            raise self.exc or ChaosError(
                f"injected probabilistic failure at {point} (call #{index})")
        return None


class AddLatency(Policy):
    """Sleep ``seconds`` plus uniform seeded jitter in [0, ``jitter``].

    ``p < 1.0`` makes it a *straggler* profile: each call sleeps with
    probability ``p`` from the policy's seeded RNG (the tail-latency
    simulator the fleet router's hedging exists for) — a given seed
    replays the same slow-call schedule exactly. ``p=1.0`` (default)
    draws nothing and slows every call, so existing schedules replay
    unchanged."""

    def __init__(self, seconds: float, jitter: float = 0.0, p: float = 1.0):
        if not 0.0 < p <= 1.0:
            raise ValueError(f"p must be in (0, 1], got {p}")
        self.seconds = float(seconds)
        self.jitter = float(jitter)
        self.p = float(p)

    def apply(self, point, index, rng, controller):
        if self.p < 1.0 and rng.random() >= self.p:
            return None
        delay = self.seconds + (rng.uniform(0.0, self.jitter)
                                if self.jitter else 0.0)
        time.sleep(delay)
        return f"latency:{delay:.4f}"


class CorruptBytes(Policy):
    """Corrupt bytes at a byte point: ``mode="flip"`` XORs ``n_bytes``
    bytes at seeded offsets (bit rot), ``mode="truncate"`` cuts the tail at
    a seeded offset (torn write). ``nth`` restricts corruption to one call
    index (e.g. only the 3rd checkpoint); None corrupts every call."""

    def __init__(self, n_bytes: int = 8, mode: str = "flip",
                 nth: Optional[int] = None):
        if mode not in ("flip", "truncate"):
            raise ValueError(f"mode must be 'flip' or 'truncate', got {mode!r}")
        self.n_bytes = int(n_bytes)
        self.mode = mode
        self.nth = nth

    def transform(self, point, index, rng, data):
        if self.nth is not None and index != self.nth:
            return data, None
        if not data:
            return data, None
        if self.mode == "truncate":
            cut = rng.randrange(0, max(1, len(data) - 1))
            return data[:cut], f"corrupt:truncate@{cut}"
        buf = bytearray(data)
        for _ in range(min(self.n_bytes, len(buf))):
            i = rng.randrange(len(buf))
            buf[i] ^= 0xFF
        return bytes(buf), f"corrupt:flip:{min(self.n_bytes, len(buf))}"


class HangUntilCancelled(Policy):
    """Block the calling thread until the controller is cancelled (scope
    exit or explicit :meth:`ChaosController.cancel`), then raise
    :class:`ChaosCancelled`. ``timeout_s`` bounds the wait as a safety net
    against a forgotten cancel (raises anyway when it expires)."""

    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = float(timeout_s)

    def apply(self, point, index, rng, controller):
        controller._cancel_event.wait(self.timeout_s)
        raise ChaosCancelled(
            f"injected hang at {point} (call #{index}) released")


class ChaosController:
    """Scoped, seeded registry of (point pattern -> policies).

    Usage::

        with ChaosController(seed=7) as c:
            c.on("serving.batcher.forward", FailWithProbability(0.2))
            c.on("train.checkpoint.write", CorruptBytes(mode="truncate"))
            ... run traffic / training ...
        # scope exit: hangs cancelled, previous controller restored

    ``events`` is the append-only decision log — one
    ``(point, call_index, policy_name, action)`` tuple per policy action —
    used to assert deterministic replay of a fault schedule.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.events: List[Tuple[str, int, str, str]] = []
        self._rules: List[Tuple[str, Policy, random.Random]] = []
        self._counts: Dict[str, int] = {}
        # _rules is append-under-lock / read-lock-free by design (list
        # iteration over a snapshot reference is safe in CPython)
        self._lock = threading.Lock()  # guards: _counts, events
        self._cancel_event = threading.Event()
        self._previous: Optional["ChaosController"] = None

    # -------------------------------------------------------------- config
    def on(self, pattern: str, *policies: Policy) -> "ChaosController":
        """Attach policies to an injection-point name or fnmatch pattern
        (``"serving.*"`` matches every serving point). Chainable."""
        if not policies:
            raise ValueError("on() needs at least one policy")
        with self._lock:
            for p in policies:
                # seed from the per-PATTERN policy position (not the global
                # rule index): a schedule replays identically even when
                # unrelated rules are registered around it
                nth = sum(1 for pat, _, _ in self._rules if pat == pattern)
                rng = random.Random(
                    f"{self.seed}:{pattern}:{nth}:{type(p).__name__}")
                self._rules.append((pattern, p, rng))
        return self

    def cancel(self) -> None:
        """Release every :class:`HangUntilCancelled` waiter."""
        self._cancel_event.set()

    # --------------------------------------------------------------- scope
    def __enter__(self) -> "ChaosController":
        global _ACTIVE
        with _INSTALL_LOCK:
            self._previous = _ACTIVE
            _ACTIVE = self
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        global _ACTIVE
        self.cancel()
        with _INSTALL_LOCK:
            _ACTIVE = self._previous
        self._previous = None

    # ------------------------------------------------------------- plumbing
    def _matching(self, name: str):
        return [(pat, pol, rng) for pat, pol, rng in self._rules
                if pat == name or fnmatch.fnmatchcase(name, pat)]

    def _next_index(self, name: str) -> int:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1
            return self._counts[name]

    def count(self, name: str) -> int:
        """How many times ``name`` has fired under this controller."""
        with self._lock:
            return self._counts.get(name, 0)

    def _record(self, name, index, policy, action) -> None:
        with self._lock:
            self.events.append((name, index, type(policy).__name__, action))
        # the black box sees every injected fault: the event
        # rides next to the breaker/failover/restart events the fault
        # causes, trace-linked via the active span like the chaos stamp
        journal.emit("chaos.action", point=name, index=index,
                     policy=type(policy).__name__, action=action)

    def fire(self, name: str) -> None:
        rules = self._matching(name)
        if not rules:
            return
        index = self._next_index(name)
        for _pat, policy, rng in rules:
            try:
                action = policy.apply(name, index, rng, self)
            except BaseException as e:
                self._record(name, index, policy, f"raise:{type(e).__name__}")
                # stamp the injected fault onto the active trace span
                #: every fault drill is traceable after the
                # fact, and tail sampling always keeps the trace
                trace.stamp_chaos(name, f"raise:{type(e).__name__}")
                logger.info("chaos: %s #%d -> %s", name, index, e)
                raise
            if action is not None:
                self._record(name, index, policy, action)
                trace.stamp_chaos(name, action)

    def transform(self, name: str, data: bytes) -> bytes:
        rules = self._matching(name)
        if not rules:
            return data
        index = self._next_index(name)
        for _pat, policy, rng in rules:
            out, action = policy.transform(name, index, rng, data)
            if action is not None:
                self._record(name, index, policy, action)
                trace.stamp_chaos(name, action)
                logger.info("chaos: %s #%d -> %s", name, index, action)
                data = out
        return data


_INSTALL_LOCK = threading.Lock()  # guards: (_ACTIVE install/restore)
_ACTIVE: Optional[ChaosController] = None


def active() -> bool:
    """True when a controller is installed (hot paths may use this to skip
    chaos-only work like re-reading a file for byte corruption)."""
    return _ACTIVE is not None


def inject(name: str) -> None:
    """Fire the injection point ``name``. No-op fast path when no
    controller is installed; otherwise applies every matching policy
    (which may raise, sleep, or hang)."""
    c = _ACTIVE
    if c is None:
        return
    c.fire(name)


def transform_bytes(name: str, data: bytes) -> bytes:
    """Pass ``data`` through the byte point ``name``. Returns ``data``
    itself (same object) when no controller or no matching corruption
    policy is installed."""
    c = _ACTIVE
    if c is None:
        return data
    return c.transform(name, data)


class ChaosListener:
    """TrainingListener shim firing ``train.iteration`` every iteration —
    attach it to a net to schedule deterministic mid-epoch faults (the
    in-process analog of losing a chip at step N)."""

    def __init__(self, point: str = "train.iteration"):
        self.point = point

    def iteration_done(self, model, iteration, epoch, score):
        inject(self.point)

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass
