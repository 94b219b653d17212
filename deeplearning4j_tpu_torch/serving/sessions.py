"""Session tier: server-side recurrent state for streaming inference.

Counterpart of ``deeplearning4j_tpu/serving/sessions.py``. The reference's
``MultiLayerNetwork.rnnTimeStep`` keeps carry state on the network between
calls. This module puts that state behind the serving layer: a
:class:`SessionStore` holds one carry tree per (model, session id), every
step advances it through the batcher's fixed-shape session graph
(:meth:`~.batcher.ContinuousBatcher.submit_step`), and the store keeps a
resident/cold discipline for session state:

- **Write-through spill.** Every acked step persists the NEW carry to a
  CRC-framed spill file (tmp + ``os.replace``; the frame is byte for byte
  the JAX package's, so either package reads the other's). Memory is only
  a CACHE: idle-TTL eviction and the host-byte budget drop the memory copy,
  nothing else.
- **Rehydrate on touch.** A step that misses memory (evicted, or the
  session was created by another store over the same spill directory)
  reads the spill file back, CRC-checked: a corrupt or truncated frame is
  an explicit :class:`SessionLost`, never a silently-wrong carry.
  Rehydration is single-flight per session — the per-session lock that
  already serializes steps is the flight; waiters bound their wait by
  their own deadline.
- **Migration.** A spill directory shared by several stores makes
  "migrate a session" "rehydrate its spill file in the other store"; a
  rehydrate of a frame written by another worker or incarnation emits
  ``session.migrate``.
- **Exactly-once steps.** A step request may carry the client's step
  index; a replay of the last applied step returns the PERSISTED last
  output without re-advancing the carry.

Every lifecycle transition emits a typed journal event —
``session.create`` / ``session.step_miss`` / ``session.spill`` /
``session.rehydrate`` / ``session.migrate`` / ``session.evict`` /
``session.close``. Leaves are numpy; the carry tree is the port's
(``{layer: (h, c)}``, leaves in :func:`~..runtime.trees.tree_leaves`
order, which is the JAX package's).

Timing: the idle-TTL clock is injectable (``clock=``) so eviction tests
never sleep; deadline math stays on ``time.monotonic``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import struct
import tempfile
import threading
import time
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.runtime import chaos, journal
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_unflatten_like
from deeplearning4j_tpu_torch.serving.admission import DeadlineExceeded, ServingError
from deeplearning4j_tpu_torch.serving.metrics import LatencyHistogram

logger = logging.getLogger(__name__)

__all__ = ["Session", "SessionLost", "SessionStore", "SessionStepConflict"]

_MAGIC = b"DL4JSES1"
_SPILL_SUFFIX = ".sess"


class SessionLost(ServingError):
    """The session's spilled carry state is unusable — corrupt frame, bad
    CRC, truncation, or a structure that no longer matches the model. The
    stream cannot be resumed; the client must create a new session.
    Raised EXPLICITLY: a damaged spill is never rehydrated into a
    silently-wrong carry."""


class SessionStepConflict(ServingError):
    """The client's step index is neither the next step nor a replay of
    the last applied one — the stream and the server disagree about
    position, and applying the input anyway would corrupt the carry."""


def _tree_bytes(tree) -> int:
    return int(sum(getattr(l, "nbytes", 0)
                   for l in tree_leaves(tree)))


def _pack_frame(header: Dict[str, Any], leaves: List[np.ndarray]) -> bytes:
    """CRC-framed spill encoding: magic, header length, JSON header (leaf
    shapes/dtypes + payload CRC32), concatenated raw leaf bytes."""
    payload = b"".join(np.ascontiguousarray(l).tobytes() for l in leaves)
    header = dict(header)
    header["leaves"] = [{"shape": list(l.shape), "dtype": l.dtype.str}
                        for l in leaves]
    header["crc"] = zlib.crc32(payload) & 0xFFFFFFFF
    hj = json.dumps(header, sort_keys=True).encode("utf-8")
    return _MAGIC + struct.pack("<II", len(hj), len(payload)) + hj + payload


def _unpack_frame(raw: bytes) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    """Decode + verify a spill frame; any damage is :class:`SessionLost`."""
    fixed = len(_MAGIC) + 8
    if len(raw) < fixed or raw[:len(_MAGIC)] != _MAGIC:
        raise SessionLost("spill frame: bad magic or truncated header")
    hlen, plen = struct.unpack("<II", raw[len(_MAGIC):fixed])
    if len(raw) != fixed + hlen + plen:
        raise SessionLost(f"spill frame: truncated "
                          f"({len(raw)} bytes, expected {fixed + hlen + plen})")
    try:
        header = json.loads(raw[fixed:fixed + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise SessionLost(f"spill frame: unreadable header ({e})") from e
    payload = raw[fixed + hlen:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != header.get("crc"):
        raise SessionLost("spill frame: payload CRC mismatch")
    leaves: List[np.ndarray] = []
    ofs = 0
    for meta in header.get("leaves", []):
        dt = np.dtype(str(meta["dtype"]))
        shape = tuple(int(s) for s in meta["shape"])
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        if ofs + n > len(payload):
            raise SessionLost("spill frame: leaf extends past payload")
        leaves.append(np.frombuffer(payload, dtype=dt, count=n // dt.itemsize,
                                    offset=ofs).reshape(shape).copy())
        ofs += n
    if ofs != len(payload):
        raise SessionLost("spill frame: trailing bytes after last leaf")
    return header, leaves


class Session:
    """One stream's server-side record. ``lock`` serializes everything
    that touches the carry — steps, rehydration, eviction — so a stream's
    steps are totally ordered and rehydration is single-flight."""

    __slots__ = ("session_id", "model_name", "state", "last_out", "step",
                 "touched", "state_bytes", "spilled_step", "lock")

    def __init__(self, model_name: str, session_id: str, touched: float):
        self.model_name = model_name
        self.session_id = session_id
        self.state = None          # carry tree (numpy leaves) or None=cold
        self.last_out: Optional[np.ndarray] = None
        self.step = 0              # steps applied to the carry
        self.touched = touched     # store clock; drives idle-TTL
        self.state_bytes = 0
        self.spilled_step = -1     # step count persisted on disk
        # guards: state, last_out, step, state_bytes, spilled_step
        self.lock = threading.Lock()


class SessionStore:
    """Per-worker store of streaming-session carry state (see module
    docstring) over a :class:`~.registry.ModelRegistry` whose entries were
    given sessions (``batcher.enable_sessions``)."""

    def __init__(self, registry, spill_dir: str, worker_id: str = "",
                 idle_ttl_s: float = 300.0,
                 byte_budget_bytes: Optional[int] = None,
                 clock=time.monotonic, evict_interval_s: float = 1.0,
                 start_evictor: bool = True):
        self._registry = registry
        self.spill_dir = spill_dir
        os.makedirs(spill_dir, exist_ok=True)
        self.worker_id = worker_id
        self.idle_ttl_s = float(idle_ttl_s)
        self.byte_budget_bytes = byte_budget_bytes
        self._clock = clock
        self._lock = threading.Lock()  # guards: _sessions, _counters
        self._sessions: Dict[Tuple[str, str], Session] = {}
        self._counters = {
            "creates_total": 0, "steps_total": 0, "replays_total": 0,
            "step_misses_total": 0, "rehydrates_total": 0,
            "migrations_total": 0, "spills_total": 0, "evictions_total": 0,
            "closes_total": 0, "lost_total": 0,
        }
        self._rehydrate_hist = LatencyHistogram()
        self._stop = threading.Event()
        self._evictor: Optional[threading.Thread] = None
        if start_evictor:
            self._evictor = threading.Thread(
                target=self._run_evictor, daemon=True,
                name="session-evictor",
                args=(float(evict_interval_s),))
            self._evictor.start()

    # ------------------------------------------------------------ lifecycle
    def create(self, model_name: str, session_id: Optional[str] = None,
               timeout_ms: Optional[float] = None) -> Session:
        """Open a stream: zero carry, spill frame written immediately (a
        brand-new session already survives a worker SIGKILL)."""
        served = self._registry.acquire(model_name, timeout_ms)
        try:
            batcher = served.batcher
            if batcher.session_bucket is None:
                raise ValueError(f"model {model_name!r} is not serving "
                                 f"sessions (no session bucket warmed)")
            sid = str(session_id) if session_id else uuid.uuid4().hex[:16]
            if "/" in sid or os.sep in sid:
                raise ValueError(f"invalid session id {sid!r}")
            key = (model_name, sid)
            sess = Session(model_name, sid, self._clock())
            sess.state = batcher.session_state_template()
            sess.state_bytes = _tree_bytes(sess.state)
            with self._lock:
                if key in self._sessions:
                    raise ValueError(f"session {sid!r} already exists "
                                     f"for model {model_name!r}")
                self._sessions[key] = sess
                self._counters["creates_total"] += 1
            with sess.lock:
                self._write_spill(sess)
            journal.emit("session.create", model=model_name, session=sid,
                         worker=self.worker_id)
            return sess
        finally:
            served.unpin()

    def step(self, model_name: str, session_id: str, x,
             timeout_ms: Optional[float] = None,
             client_step: Optional[int] = None):
        """Advance the stream by one input chunk; returns
        ``(out_row, step, replayed)``. ``client_step`` (the 0-based index
        of the step the CLIENT believes it is sending) makes retries
        exactly-once: a replay of the last applied step returns the
        persisted output without touching the carry."""
        chaos.inject("serving.session.step")
        t0 = time.monotonic()
        served = self._registry.acquire(model_name, timeout_ms)
        try:
            sess = self._lookup_or_adopt(model_name, session_id)
            remaining = (None if timeout_ms is None
                         else max(0.0, timeout_ms / 1000.0
                                  - (time.monotonic() - t0)))
            # the per-session lock IS the step serializer and the
            # rehydration single-flight: the holder rehydrates, everyone
            # else waits bounded by their own deadline
            if not sess.lock.acquire(timeout=remaining if remaining
                                     is not None else -1):
                raise DeadlineExceeded(
                    f"session {session_id!r} busy past the deadline "
                    f"(a prior step of this stream is still executing)")
            try:
                if sess.state is None:
                    with self._lock:
                        self._counters["step_misses_total"] += 1
                    journal.emit("session.step_miss", model=model_name,
                                 session=session_id, worker=self.worker_id)
                    self._rehydrate(sess, served)
                if client_step is not None:
                    if client_step == sess.step - 1 \
                            and sess.last_out is not None:
                        with self._lock:
                            self._counters["replays_total"] += 1
                        return sess.last_out, sess.step, True
                    if client_step != sess.step:
                        raise SessionStepConflict(
                            f"session {session_id!r} is at step "
                            f"{sess.step}, client sent step {client_step}")
                step_timeout = (None if timeout_ms is None
                                else max(1.0, timeout_ms
                                         - (time.monotonic() - t0) * 1000.0))
                out, new_state = served.batcher.submit_step(
                    x, sess.state, timeout_ms=step_timeout)
                sess.state = new_state
                sess.last_out = out
                sess.step += 1
                sess.state_bytes = _tree_bytes(new_state)
                sess.touched = self._clock()
                self._write_spill(sess)  # write-through: ack implies durable
                with self._lock:
                    self._counters["steps_total"] += 1
                return out, sess.step, False
            finally:
                sess.lock.release()
        finally:
            served.unpin()

    def close(self, model_name: str, session_id: str) -> None:
        """End the stream: forget the memory copy AND the spill file."""
        key = (model_name, str(session_id))
        with self._lock:
            sess = self._sessions.pop(key, None)
        path = self._spill_path(model_name, session_id)
        if sess is not None:
            with sess.lock:  # let an in-flight step finish first
                self._remove_file(path)
        else:
            if not os.path.exists(path):
                raise KeyError(session_id)
            self._remove_file(path)
        with self._lock:
            self._counters["closes_total"] += 1
        journal.emit("session.close", model=model_name,
                     session=str(session_id), worker=self.worker_id)

    # ------------------------------------------------------------- residency
    def spill_all(self, reason: str = "drain") -> int:
        """Push every resident session cold (state already durable via
        write-through; this drops the memory copies and emits the
        spill/evict events). The migration fence a rolling deploy runs
        before restarting a worker — after it, any step landing anywhere
        rehydrates current state."""
        with self._lock:
            sessions = list(self._sessions.values())
        n = 0
        for sess in sessions:
            if self._evict_one(sess, reason, block_s=2.0):
                n += 1
        return n

    def _evict_one(self, sess: Session, reason: str,
                   block_s: float = 0.0) -> bool:
        if block_s > 0:
            acquired = sess.lock.acquire(timeout=block_s)
        else:
            acquired = sess.lock.acquire(blocking=False)
        if not acquired:
            return False  # busy stream: skip, next pass gets it
        try:
            if sess.state is None:
                return False
            if sess.spilled_step != sess.step:
                self._write_spill(sess)  # write-through should prevent this
            with self._lock:
                self._counters["spills_total"] += 1
                self._counters["evictions_total"] += 1
            journal.emit("session.spill", model=sess.model_name,
                         session=sess.session_id, step=sess.step,
                         bytes=sess.state_bytes, worker=self.worker_id)
            sess.state = None
            sess.last_out = None
            journal.emit("session.evict", model=sess.model_name,
                         session=sess.session_id, reason=reason,
                         worker=self.worker_id)
            return True
        finally:
            sess.lock.release()

    def _evict_pass(self) -> None:
        now = self._clock()
        with self._lock:
            resident = [s for s in self._sessions.values()
                        if s.state is not None]
        # idle-TTL first
        for sess in resident:
            if now - sess.touched >= self.idle_ttl_s:
                self._evict_one(sess, "idle_ttl")
        if self.byte_budget_bytes is None:
            return
        with self._lock:
            resident = [s for s in self._sessions.values()
                        if s.state is not None]
        total = sum(s.state_bytes for s in resident)
        if total <= self.byte_budget_bytes:
            return
        # LRU beyond the budget: coldest-touched first
        for sess in sorted(resident, key=lambda s: s.touched):
            if total <= self.byte_budget_bytes:
                break
            freed = sess.state_bytes
            if self._evict_one(sess, "byte_budget"):
                total -= freed

    def _run_evictor(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self._evict_pass()
            except Exception:
                logger.exception("session evictor pass failed")

    def shutdown(self, spill: bool = True) -> None:
        self._stop.set()
        if self._evictor is not None:
            self._evictor.join(timeout=5.0)
        if spill:
            try:
                self.spill_all(reason="shutdown")
            except Exception:
                logger.exception("session spill-all at shutdown failed")

    # --------------------------------------------------------------- spill io
    def _spill_path(self, model_name: str, session_id: str) -> str:
        return os.path.join(self.spill_dir,
                            f"{model_name}__{session_id}{_SPILL_SUFFIX}")

    @staticmethod
    def _remove_file(path: str) -> None:
        try:
            os.remove(path)
        except FileNotFoundError:
            pass

    def _write_spill(self, sess: Session) -> None:
        """Persist the carry with the checkpoint atomics: tmp file in the
        same directory, then ``os.replace`` — a reader sees the old frame
        or the new frame, never a torn one. Called under ``sess.lock``."""
        leaves = [np.asarray(l) for l in tree_leaves(sess.state)]
        header = {"v": 1, "model": sess.model_name,
                  "session": sess.session_id, "step": sess.step,
                  "worker": self.worker_id,
                  "incarnation": journal.incarnation(),
                  "out": None}
        if sess.last_out is not None:
            out = np.ascontiguousarray(sess.last_out)
            header["out"] = {"shape": list(out.shape),
                             "dtype": out.dtype.str}
            leaves = leaves + [out]
        raw = _pack_frame(header, leaves)
        path = self._spill_path(sess.model_name, sess.session_id)
        fd, tmp = tempfile.mkstemp(dir=self.spill_dir,
                                   prefix=f".{sess.session_id}-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(raw)
            os.replace(tmp, path)
        except BaseException:
            self._remove_file(tmp)
            raise
        sess.spilled_step = sess.step

    def _lookup_or_adopt(self, model_name: str, session_id: str) -> Session:
        """Find the session in memory, or ADOPT it cold from a spill file
        another worker (or a previous incarnation of this one) wrote —
        the failover/migration entry point. Unknown everywhere is
        ``KeyError``."""
        key = (model_name, str(session_id))
        with self._lock:
            sess = self._sessions.get(key)
        if sess is not None:
            return sess
        if not os.path.exists(self._spill_path(model_name, session_id)):
            raise KeyError(session_id)
        sess = Session(model_name, str(session_id), self._clock())
        with self._lock:
            return self._sessions.setdefault(key, sess)

    def _rehydrate(self, sess: Session, served) -> None:
        """Read the spill frame back into memory (under ``sess.lock``).
        Any damage — chaos-injected or real — is :class:`SessionLost`."""
        t0 = time.monotonic()
        chaos.inject("serving.session.rehydrate")
        path = self._spill_path(sess.model_name, sess.session_id)
        try:
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except FileNotFoundError as e:
                raise SessionLost(
                    f"session {sess.session_id!r}: spill file vanished "
                    f"({path})") from e
            raw = chaos.transform_bytes("serving.session.rehydrate", raw)
            header, leaves = _unpack_frame(raw)
            out = None
            if header.get("out") is not None:
                if not leaves:
                    raise SessionLost("spill frame: output leaf missing")
                out, leaves = leaves[-1], leaves[:-1]
            template = served.batcher.session_state_template()
            tl = tree_leaves(template)
            if len(tl) != len(leaves):
                raise SessionLost(
                    f"spill frame: {len(leaves)} state leaves, model "
                    f"expects {len(tl)} — archive/state mismatch")
            for have, want in zip(leaves, tl):
                if tuple(have.shape) != tuple(np.shape(want)):
                    raise SessionLost(
                        f"spill frame: leaf shape {have.shape} != model "
                        f"carry shape {np.shape(want)}")
            sess.state = tree_unflatten_like(template, leaves)
            sess.last_out = out
            sess.step = int(header.get("step", 0))
            sess.spilled_step = sess.step
            sess.state_bytes = _tree_bytes(sess.state)
            sess.touched = self._clock()
        except SessionLost:
            # drop the record so every later step fails the same way
            # (410, not a silently-fresh stream); the file stays on disk
            # for forensics
            with self._lock:
                self._counters["lost_total"] += 1
                self._sessions.pop((sess.model_name, sess.session_id), None)
            raise
        seconds = time.monotonic() - t0
        self._rehydrate_hist.observe(seconds)
        with self._lock:
            self._counters["rehydrates_total"] += 1
        journal.emit("session.rehydrate", model=sess.model_name,
                     session=sess.session_id, step=sess.step,
                     seconds=round(seconds, 6), bytes=len(raw),
                     worker=self.worker_id)
        if header.get("worker") != self.worker_id or \
                header.get("incarnation") != journal.incarnation():
            # the frame was written by another worker (failover, rolling
            # deploy) or a previous life of this one — the stream MOVED
            with self._lock:
                self._counters["migrations_total"] += 1
            journal.emit("session.migrate", model=sess.model_name,
                         session=sess.session_id, step=sess.step,
                         from_worker=header.get("worker"),
                         to_worker=self.worker_id)

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, Any]:
        """The ``/v1/capacity`` ``sessions`` section: counts, bytes,
        rehydrate latency percentiles, lifecycle counters."""
        with self._lock:
            sessions = list(self._sessions.values())
            counters = dict(self._counters)
        resident = [s for s in sessions if s.state is not None]
        try:
            spilled_files = len(glob.glob(os.path.join(
                self.spill_dir, f"*{_SPILL_SUFFIX}")))
        except OSError:
            spilled_files = 0
        h = self._rehydrate_hist
        return {
            "tracked": len(sessions),
            "resident": len(resident),
            "resident_bytes": sum(s.state_bytes for s in resident),
            "spilled_files": spilled_files,
            "idle_ttl_s": self.idle_ttl_s,
            "byte_budget_bytes": self.byte_budget_bytes,
            "counters": counters,
            "rehydrate": {
                "count": h.count,
                "p50_s": round(h.percentile(50), 6),
                "p99_s": round(h.percentile(99), 6),
                "max_s": round(h.max, 6),
            },
        }
