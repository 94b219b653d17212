"""Replicated serving control plane (counterpart of
``deeplearning4j_tpu/serving/control_plane.py``: the same config and lease
file formats, so a JAX and a port instance can share one file).

One ``FleetRouter`` process and one in-process ``SLOAutoscaler`` would be
a single point of failure: kill that process and the fleet goes dark. This
module replicates them with three pieces that deliberately share NOTHING
but files and scrapes:

- :class:`FleetConfig` — the versioned shared fleet-config file (worker
  roster, router roster, model catalogue, deploy state, applied-action
  ledger) written with the checkpoint-atomics discipline (tmp file +
  ``os.replace`` in the target directory, the ``train/checkpoint.py`` /
  ``serving/manifest.py`` idiom) under a cross-process lock file. Readers
  degrade, never crash: a corrupt or version-regressed snapshot keeps the
  last-valid config and bumps a loud counter (chaos point
  ``serving.router.config_load``). The config IS a fleet for
  :class:`~deeplearning4j_tpu_torch.serving.router.FleetRouter` (it has
  ``endpoints()``), so N router processes front one worker roster with no
  coordinator on the serving path — per-model SLO/capacity state is
  scrape-derived and breakers/hedging p99s rebuild from traffic, so
  routers stay shared-nothing by construction.
- :class:`LeaseElection` — file-lock leader election for the autoscaler
  tier: atomic-create acquisition (``os.link``), heartbeat = lease-file
  mtime, takeover once the mtime goes stale past the lease window, a
  monotonic ``seq`` fencing token bumped on every takeover. Exactly one
  router's ``SLOAutoscaler`` acts; the others shadow-compute and log
  ``follower`` decisions; a SIGKILL'd (or hung — chaos point
  ``serving.autoscale.lease``) leader loses the lease within one window
  and the next scaling decision comes from the new leader.
- :class:`RouterSupervisor` + :func:`router_main` — the
  :class:`~deeplearning4j_tpu_torch.serving.fleet.FleetSupervisor`
  pattern one level up: N ``FleetRouter`` *processes* (``python -m
  deeplearning4j_tpu_torch.serving.control_plane <spec.json>``) with
  port-file readiness (written only after the router has probed its
  workers and registered itself in the shared config), heartbeat +
  exit-code watchdog, and budgeted restarts. Router pids register in this
  module's own leak-guard tables, polled like the fleet worker pids.
- :class:`MultiRouterClient` — the caller's side of the story:
  round-robin across the live router roster with connect-fail/5xx
  failover, so a SIGKILL'd router is invisible to callers.

A router process is host code and never touches the card: its supervisor
spawns it with no GPU visible (``CUDA_VISIBLE_DEVICES`` empty), and
:func:`router_main` sets the process's device to the CPU, so a gated
deploy's candidate that a router loads runs there.
"""

from __future__ import annotations

import copy
import dataclasses
import http.client
import itertools
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.runtime import chaos, journal
from deeplearning4j_tpu_torch.serving import wire
from deeplearning4j_tpu_torch.serving.fleet import FleetSupervisor, PidRegistry, _worker_env
from deeplearning4j_tpu_torch.serving.manifest import atomic_replace

logger = logging.getLogger(__name__)

__all__ = ["FleetConfig", "LeaseElection", "MultiRouterClient",
           "RouterSpec", "RouterSupervisor", "router_main",
           "live_router_pids", "kill_stray_routers",
           "orphaned_router_pids", "kill_orphaned_routers"]

CONFIG_FORMAT = "dl4j-fleet-config-v1"
LEASE_FORMAT = "dl4j-lease-v1"


# -------------------------------------------------------------------------
# router-pid registry: same contract (and implementation —
# fleet.PidRegistry) as serving.fleet's worker registry, but a SEPARATE
# population so a leak guard names router leaks as router leaks and
# killing strays in one tier never touches the other
_registry = PidRegistry()


def _track_router(proc: subprocess.Popen) -> None:
    _registry.track(proc)


def live_router_pids() -> List[int]:
    """PIDs of router subprocesses launched through this module that are
    still alive — polled by a test's leak guard after every test."""
    return _registry.live_pids()


def kill_stray_routers() -> List[int]:
    """Kill any still-live tracked routers (leak-guard teardown)."""
    return _registry.kill_stray()


def orphaned_router_pids() -> List[int]:
    """Live tracked router pids NOT owned by any active supervisor — a
    supervised fixture router tier is managed, not leaked."""
    return _registry.orphaned_pids()


def kill_orphaned_routers() -> List[int]:
    """Kill only the ORPHANED tracked routers (leak-guard teardown)."""
    return _registry.kill_orphaned()


# =========================================================== fleet config
def _empty_config() -> Dict[str, Any]:
    return {"format": CONFIG_FORMAT, "version": 0,
            "workers": {},            # worker_id -> "host:port"
            "routers": {},            # router_id -> "host:port"
            "models": {},             # model catalogue (name -> metadata)
            "deploy": {},             # deploy state (archive, version, ...)
            "applied_actions": {},    # action_id -> record (exactly-once)
            "schedules": [],          # pre-scaling windows (autoscaler)
            "updated_at": 0.0}


class FleetConfig:
    """The versioned shared fleet-config file N routers front a fleet
    through.

    Reads are mtime-cached and DEGRADE on failure: a corrupt, truncated,
    missing or version-regressed file keeps the last-valid in-memory
    snapshot and bumps ``load_failures_total`` — a bad config write can
    slow convergence, never take a router down (chaos point
    ``serving.router.config_load``; drill in ``tests/test_chaos.py`` /
    ``tests/test_control_plane.py``).

    Writes go through :meth:`mutate`: a cross-process lock file
    serializes read-modify-write cycles, the version bumps by exactly one
    per committed mutation, and the write itself is the checkpoint-atomic
    tmp-file + ``os.replace``. :meth:`try_claim` builds exactly-once
    action application on top (rolling deploys, autoscaler levers): the
    first claimant records the action id in the ledger, every later
    claimant sees it and skips — two live routers can never double-apply.

    A ``FleetConfig`` is also a *fleet* (``endpoints()``), so
    ``FleetRouter(FleetConfig(path))`` just works.
    """

    def __init__(self, path: str, create: bool = True,
                 lock_timeout_s: float = 10.0,
                 stale_lock_s: float = 30.0,
                 max_applied_actions: int = 256):
        self.path = str(path)
        self.lock_timeout_s = float(lock_timeout_s)
        self.stale_lock_s = float(stale_lock_s)
        self.max_applied_actions = int(max_applied_actions)
        # reload/mutate critical section; readers take the _last_valid
        # reference lock-free by design (degrade-never-crash)
        # guards: (reload/mutate critical section)
        self._lock = threading.Lock()
        self._last_valid = _empty_config()
        self._last_stat: Optional[Tuple[int, int]] = None
        self.loads_total = 0
        self.load_failures_total = 0
        if create and not os.path.exists(self.path):
            try:
                self._seed_empty()
            except OSError:
                logger.exception("could not seed fleet config %s", self.path)
        with self._lock:
            self._refresh_locked()

    def _seed_empty(self) -> None:
        """Create-if-absent of the v0 config, atomically: the file is
        linked into place only if nothing exists there — a racing
        creator that already wrote (and possibly populated) the config
        must never be stomped back to an empty v0."""
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(prefix=".fleet-config-seed-", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self._last_valid, f, indent=2, sort_keys=True)
            try:
                os.link(tmp, self.path)  # atomic create: loses to anyone
            except FileExistsError:
                pass  # someone else seeded (or populated) it first
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # --------------------------------------------------------------- reads
    def _read_disk(self) -> Dict[str, Any]:
        """Parse the on-disk config; raises on anything malformed. The
        bytes pass through the ``serving.router.config_load`` byte point
        so chaos drills can corrupt exactly what a torn write would."""
        with open(self.path, "rb") as f:
            data = f.read()
        data = chaos.transform_bytes("serving.router.config_load", data)
        cfg = json.loads(data.decode())
        fmt = cfg.get("format") if isinstance(cfg, dict) else None
        if fmt != CONFIG_FORMAT:
            raise ValueError(f"not a fleet config (format={fmt!r})")
        cfg["version"] = int(cfg["version"])
        base = _empty_config()
        base.update(cfg)
        return base

    def _refresh_locked(self) -> None:
        """Reload when the file changed; on ANY failure keep the
        last-valid snapshot (degrade + count, never crash)."""
        try:
            st = os.stat(self.path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            if self._last_stat is not None:
                # the file vanished under us: a failure mode, not a reset
                self.load_failures_total += 1
                self._last_stat = None
            return
        if sig == self._last_stat:
            return
        try:
            chaos.inject("serving.router.config_load")
            cfg = self._read_disk()
            if cfg["version"] < self._last_valid["version"]:
                raise ValueError(
                    f"stale config: version {cfg['version']} regressed "
                    f"below last-valid {self._last_valid['version']}")
        except Exception as e:
            self.load_failures_total += 1
            self._last_stat = sig  # don't re-pay the parse until it changes
            logger.warning(
                "fleet config load failed (%s: %s); keeping last-valid "
                "v%d", type(e).__name__, e, self._last_valid["version"])
            return
        self._last_valid = cfg
        self._last_stat = sig
        self.loads_total += 1

    def snapshot(self, refresh: bool = True) -> Dict[str, Any]:
        """The latest VALID config (a deep copy — mutate via
        :meth:`mutate`, never in place)."""
        with self._lock:
            if refresh:
                self._refresh_locked()
            return copy.deepcopy(self._last_valid)

    @property
    def version(self) -> int:
        return self.snapshot()["version"]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {"version": self._last_valid["version"],
                    "loads_total": self.loads_total,
                    "load_failures_total": self.load_failures_total}

    # the fleet duck-type: what FleetRouter calls every probe cycle
    def endpoints(self) -> Dict[str, str]:
        return dict(self.snapshot()["workers"])

    def routers(self) -> Dict[str, str]:
        return dict(self.snapshot()["routers"])

    def deploy_state(self) -> Optional[Dict[str, Any]]:
        """The last completed deploy's published record (archive,
        version, strategy, router, action_id) — what a restarted router
        reads to learn which artifact the fleet is supposed to run."""
        return self.snapshot().get("deploy")

    # -------------------------------------------------------------- writes
    @contextmanager
    def _flock(self):
        """Cross-process mutation lock: O_EXCL lock-file create with
        stale-lock breaking (a crashed holder's lock older than
        ``stale_lock_s`` is reclaimed)."""
        lock = self.path + ".lock"
        deadline = time.monotonic() + self.lock_timeout_s
        while True:
            try:
                fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, f"{os.getpid()}\n".encode())
                os.close(fd)
                break
            except FileExistsError:
                try:
                    st1 = os.stat(lock)
                    if time.time() - st1.st_mtime > self.stale_lock_s:
                        # break only the SAME lock instance we judged
                        # stale (inode + mtime re-checked right before
                        # the unlink): a holder releasing and a fresh
                        # waiter re-creating in the window must not have
                        # its brand-new lock stolen out from under it
                        st2 = os.stat(lock)
                        if (st2.st_ino, st2.st_mtime_ns) == \
                                (st1.st_ino, st1.st_mtime_ns):
                            os.unlink(lock)
                        continue
                except OSError:
                    continue  # holder released between stat and unlink
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"fleet-config lock {lock} held past "
                        f"{self.lock_timeout_s:.0f}s")
                time.sleep(0.005)
        try:
            yield
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    def _write_locked(self, cfg: Dict[str, Any]) -> None:
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(cfg, f, indent=2, sort_keys=True)
        atomic_replace(self.path, write, prefix=".fleet-config-")

    def mutate(self, fn) -> Dict[str, Any]:
        """Cross-process read-modify-write: under the lock file, re-read
        the LATEST config, apply ``fn(cfg)`` in place (return ``False``
        to abort without writing), bump the version by one, write
        atomically. Returns the (new or unchanged) config."""
        with self._flock():
            with self._lock:
                # FORCE a re-parse: a reader that cached a failed load
                # must not mutate from (and then re-publish) a stale
                # snapshot when the on-disk config has since healed —
                # only if the disk is truly unreadable is rewriting from
                # last-valid the right repair
                self._last_stat = None
                self._refresh_locked()
                cfg = copy.deepcopy(self._last_valid)
            if fn(cfg) is False:
                return cfg
            cfg["version"] = int(cfg["version"]) + 1
            cfg["updated_at"] = time.time()
            self._write_locked(cfg)
            with self._lock:
                self._last_valid = cfg
                try:
                    st = os.stat(self.path)
                    self._last_stat = (st.st_mtime_ns, st.st_size)
                except OSError:
                    self._last_stat = None
                self.loads_total += 1
            # every committed mutation is a journal event: the
            # black box shows WHICH config version a deploy/roster change
            # produced, next to the stages that consumed it
            journal.emit("control.config_apply", version=cfg["version"],
                         workers=len(cfg.get("workers") or {}),
                         routers=len(cfg.get("routers") or {}))
            return copy.deepcopy(cfg)

    def set_workers(self, endpoints: Dict[str, str]) -> None:
        """Publish the worker roster (the supervisor's seam)."""
        endpoints = {str(k): str(v) for k, v in endpoints.items()}

        def fn(cfg):
            if cfg["workers"] == endpoints:
                return False
            cfg["workers"] = endpoints
        self.mutate(fn)

    def set_router(self, router_id: str, address: str) -> None:
        def fn(cfg):
            if cfg["routers"].get(router_id) == address:
                return False
            cfg["routers"][str(router_id)] = str(address)
        self.mutate(fn)

    def remove_router(self, router_id: str) -> None:
        def fn(cfg):
            if router_id not in cfg["routers"]:
                return False
            del cfg["routers"][router_id]
        self.mutate(fn)

    def try_claim(self, action_id: str,
                  payload: Optional[Dict[str, Any]] = None) -> bool:
        """Exactly-once action claim: ``True`` for the FIRST caller
        (across every process sharing this config), ``False`` for every
        later one. The ledger is bounded (oldest claims age out), so an
        action id must be unique within the ledger's horizon — deploys
        and autoscaler levers key on content (archive/version,
        model/level), not on wall time."""
        out = {"claimed": True}

        def fn(cfg):
            ledger = cfg["applied_actions"]
            if action_id in ledger:
                out["claimed"] = False
                out["by"] = ledger[action_id]
                return False
            ledger[str(action_id)] = {"ts": time.time(),
                                      "pid": os.getpid(),
                                      **(payload or {})}
            if len(ledger) > self.max_applied_actions:
                for k in sorted(ledger,
                                key=lambda k: ledger[k].get("ts", 0.0))[
                        :len(ledger) - self.max_applied_actions]:
                    del ledger[k]
        self.mutate(fn)
        return out["claimed"]

    def release_claim(self, action_id: str) -> None:
        """Roll a claim back (the claimant's action FAILED partway): the
        action id leaves the ledger so a retry — from this router or any
        peer — can claim it again instead of being skipped forever as
        'already applied'."""
        def fn(cfg):
            if action_id not in cfg["applied_actions"]:
                return False
            del cfg["applied_actions"][action_id]
        self.mutate(fn)

    def applied(self, action_id: str) -> Optional[Dict[str, Any]]:
        return self.snapshot()["applied_actions"].get(action_id)


# ========================================================= lease election
class LeaseElection:
    """File-lock lease election (exactly one autoscaler acts).

    The lease is one JSON file: ``{"format", "holder", "seq",
    "acquired_at"}``. Acquisition of a FREE lease is atomic
    (``os.link`` of a prepared tmp file — creation fails if the path
    exists); while held, the holder heartbeats by touching the file's
    mtime (chaos point ``serving.autoscale.lease`` fires before each
    beat, so a drill can hang or fail exactly the heartbeat); a lease
    whose mtime is older than ``lease_s`` is STALE and any follower may
    take it over (``os.replace`` with ``seq + 1`` — the fencing token —
    then a re-read to confirm the takeover actually stuck; a lost race
    resolves into ``follower`` at the next :meth:`ensure`).

    The holder re-reads the lease BEFORE every beat: a leader whose
    heartbeat hung long enough to lose the lease observes the new holder
    and steps down instead of stomping the new leader's heartbeat.
    Every transition is recorded in :attr:`elections` (bounded) and
    reported through ``on_transition`` — the autoscaler folds them into
    its ``/v1/autoscaler`` decision log.

    :meth:`is_leader` is a lock-free read of the last settled role, so
    the autoscaler's fencing check never blocks behind a hung heartbeat.
    """

    def __init__(self, path: str, holder_id: str, lease_s: float = 2.0,
                 heartbeat_s: Optional[float] = None,
                 on_transition=None):
        self.path = str(path)
        self.holder_id = str(holder_id)
        self.lease_s = float(lease_s)
        self.heartbeat_s = (float(heartbeat_s) if heartbeat_s is not None
                            else self.lease_s / 4.0)
        self.on_transition = on_transition
        self.role = "follower"
        self.seq = 0                      # fencing token of OUR last lease
        self.elections: deque = deque(maxlen=64)
        self._lock = threading.Lock()  # guards: (ensure()/heartbeat step serialization)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --------------------------------------------------------------- state
    def _read(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.path) as f:
                rec = json.load(f)
            if rec.get("format") != LEASE_FORMAT:
                return None
            return rec
        except (OSError, ValueError):
            return None  # absent or torn: treated as up for grabs

    def _mtime(self) -> Optional[float]:
        try:
            return os.stat(self.path).st_mtime
        except OSError:
            return None

    def holder(self) -> Optional[str]:
        rec = self._read()
        return rec.get("holder") if rec else None

    def is_leader(self) -> bool:
        return self.role == "leader"

    def verify(self) -> bool:
        """Fencing check: does the lease FILE, read right now, still name
        us? Lock-free and state-free by design — it must stay truthful
        even while the heartbeat thread is hung inside an election step
        holding ``_lock`` (the one scenario where the cached role lies).
        Used by the autoscaler immediately before firing a lever."""
        if self.role != "leader":
            return False
        rec = self._read()
        return rec is not None and rec.get("holder") == self.holder_id

    def _set_role(self, role: str, rec: Optional[Dict[str, Any]],
                  reason: str) -> None:
        if role == self.role:
            return
        self.role = role
        event = {"ts": time.time(), "role": role,
                 "holder": (rec or {}).get("holder"),
                 "seq": int((rec or {}).get("seq", 0)),
                 "reason": reason, "id": self.holder_id}
        self.elections.append(event)
        logger.info("lease %s: %s -> %s (%s)", self.path, self.holder_id,
                    role, reason)
        if self.on_transition is not None:
            try:
                self.on_transition(event)
            except Exception:
                logger.exception("lease transition callback failed")

    # ------------------------------------------------------------ election
    def ensure(self) -> str:
        """One election step: beat if held, acquire if free/stale,
        observe otherwise. Non-blocking when another step (e.g. a hung
        heartbeat) is already in flight — the caller gets the last
        settled role, and a hung beat simply stops refreshing the mtime,
        which is exactly what lets a follower take over."""
        if not self._lock.acquire(blocking=False):
            return self.role
        try:
            return self._ensure_locked()
        finally:
            self._lock.release()

    def _ensure_locked(self) -> str:
        rec = self._read()
        mtime = self._mtime()
        if rec is not None and rec.get("holder") == self.holder_id:
            # we hold it: heartbeat. The chaos point sits BEFORE the
            # beat — a hang here leaves the mtime stale (takeover feed),
            # a fault skips the beat entirely.
            beat_fault = None
            try:
                chaos.inject("serving.autoscale.lease")
            except Exception as e:
                beat_fault = e
            fresh = self._read()  # post-hang/fault re-check: still ours?
            if fresh is None or fresh.get("holder") != self.holder_id:
                self._set_role("follower", fresh, "lease_lost")
                return self.role
            if beat_fault is not None:
                # a faulted beat skips the mtime touch: repeated faults
                # age the lease out and a follower takes over
                logger.warning("lease heartbeat chaos fault: %r", beat_fault)
                self._set_role("leader", fresh, "heartbeat_faulted")
                return self.role
            try:
                os.utime(self.path)
            except OSError:
                pass
            self.seq = int(rec.get("seq", 0))
            self._set_role("leader", rec, "heartbeat")
            return self.role
        stale = (rec is None or mtime is None
                 or time.time() - mtime > self.lease_s)
        if stale:
            self._try_take(rec)
        else:
            self._set_role("follower", rec, "observed_holder")
        return self.role

    def _try_take(self, prev: Optional[Dict[str, Any]]) -> None:
        # Acquisition/takeover runs under a brief O_EXCL take-lock:
        # without it two followers can BOTH os.replace a stale lease and
        # both confirm (the second replace landing between the first's
        # replace and its re-read), minting dual leaders with the SAME
        # seq token. Losing the lock just means another election is in
        # progress — stay follower and re-observe next heartbeat.
        lock = self.path + ".takelock"
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            try:
                if time.time() - os.stat(lock).st_mtime > \
                        max(self.lease_s, 5.0):
                    os.unlink(lock)  # a crashed elector's leftover
            except OSError:
                pass
            self._set_role("follower", self._read(),
                           "election_in_progress")
            return
        except OSError:
            self._set_role("follower", self._read(),
                           "election_in_progress")
            return
        try:
            # re-validate UNDER the lock: another elector may have just
            # won and heart-beaten before we got here
            cur = self._read()
            mtime = self._mtime()
            if (cur is not None and mtime is not None
                    and time.time() - mtime <= self.lease_s
                    and cur.get("holder") != self.holder_id):
                self._set_role("follower", cur, "lost_race")
                return
            rec = {"format": LEASE_FORMAT, "holder": self.holder_id,
                   "seq": int((cur or prev or {}).get("seq", 0)) + 1,
                   "acquired_at": time.time()}
            d = os.path.dirname(os.path.abspath(self.path)) or "."
            fd, tmp = tempfile.mkstemp(prefix=".lease-", dir=d)
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(rec, f)
                if cur is None and not os.path.exists(self.path):
                    try:
                        os.link(tmp, self.path)  # atomic: fails if raced
                    except (FileExistsError, OSError):
                        self._set_role("follower", self._read(),
                                       "lost_race")
                        return
                else:
                    os.replace(tmp, self.path)  # takeover, serialized
                    tmp = None
            finally:
                if tmp is not None:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
            confirm = self._read()
            if confirm is not None and \
                    confirm.get("holder") == self.holder_id:
                self.seq = int(confirm.get("seq", rec["seq"]))
                self._set_role("leader", confirm,
                               "acquired" if prev is None else "takeover")
            else:
                self._set_role("follower", confirm, "lost_race")
        finally:
            try:
                os.unlink(lock)
            except OSError:
                pass

    def release(self) -> None:
        """Give the lease up voluntarily (graceful shutdown): unlink only
        when WE hold it, so a follower's shutdown never revokes the live
        leader."""
        with self._lock:
            rec = self._read()
            if rec is not None and rec.get("holder") == self.holder_id:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
                self._set_role("follower", None, "released")

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "LeaseElection":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"lease-election-{self.holder_id}")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self.ensure()
            except Exception:
                logger.exception("lease election step failed")

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(10.0, self.lease_s * 2))
            self._thread = None
        if release:
            self.release()

    def snapshot(self) -> Dict[str, Any]:
        rec = self._read()
        return {"path": self.path, "id": self.holder_id,
                "role": self.role, "lease_s": self.lease_s,
                "holder": (rec or {}).get("holder"),
                "seq": int((rec or {}).get("seq", 0)),
                "age_s": (None if self._mtime() is None
                          else round(time.time() - self._mtime(), 3)),
                "elections": list(self.elections)}

    def __enter__(self) -> "LeaseElection":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()


# ====================================================== multi-router client
class MultiRouterClient:
    """Client-side failover across N shared-nothing routers.

    ``endpoints`` is a static ``["host:port", ...]`` list, or pass
    ``config`` (a :class:`FleetConfig`) to follow the live router roster.
    Requests ROUND-ROBIN across routers (each router's SLO monitor and
    hedging p99s learn from the share it serves) and FAIL OVER to the
    next router on: connection faults (the SIGKILL drill), router 5xx
    (500/502), and ``503 no_healthy_workers`` (a router whose probe view
    is momentarily empty — a peer with a warmer view can still serve).
    A shed 503 (``Retry-After``: every worker overloaded) and 504
    (deadline spent) are TERMINAL — every router fronts the same
    workers, so retrying elsewhere would only hammer them harder or
    double-spend an expired deadline.
    """

    def __init__(self, endpoints: Optional[List[str]] = None,
                 config: Optional[FleetConfig] = None,
                 timeout_s: float = 60.0, keepalive: bool = True,
                 protocol: str = "binary"):
        if not endpoints and config is None:
            raise ValueError("need endpoints or a FleetConfig")
        if protocol not in ("binary", "json"):
            raise ValueError(f"unknown protocol {protocol!r}")
        self._static = list(endpoints or [])
        self._config = config
        self.timeout_s = float(timeout_s)
        self._rr = itertools.count()
        #: reuse HTTP/1.1 connections across requests; ``False`` restores
        #: the one-connection-per-request behaviour (what a baseline arm
        #: measures: the TCP-setup tax)
        self.keepalive = bool(keepalive)
        #: preferred predict encoding; a 415 from a wire-disabled fleet
        #: downgrades ONCE and is cached (all routers front the same
        #: workers, so one verdict covers the client)
        self.protocol = protocol
        self._wire_ok: Optional[bool] = None
        self.pool = wire.ConnectionPool()
        # guards: requests_total, failovers_total, router_requests, wire_downgrades_total
        self._lock = threading.Lock()
        self.requests_total = 0
        self.failovers_total = 0
        self.router_requests: Dict[str, int] = {}
        self.wire_downgrades_total = 0

    def endpoints(self) -> List[str]:
        if self._config is not None:
            routers = self._config.routers()
            eps = [routers[k] for k in sorted(routers)]
            if eps:
                return eps
        return list(self._static)

    def _http(self, address: str, method: str, path: str, body, headers,
              timeout: float) -> Tuple[int, Dict[str, str], bytes]:
        if self.keepalive:
            return self.pool.request(address, method, path, body=body,
                                     headers=headers or {}, timeout=timeout)
        host, port = address.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        try:
            conn.request(method, path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    @staticmethod
    def _retryable(status: int, data: bytes) -> bool:
        if status in (500, 502):
            return True
        if status == 503:
            try:
                reason = json.loads(data.decode()).get("reason")
            except Exception:
                reason = None
            return reason == "no_healthy_workers"
        return False

    def request(self, method: str, path: str, body: Optional[bytes] = None,
                headers: Optional[Dict[str, str]] = None,
                timeout_s: Optional[float] = None
                ) -> Tuple[int, Dict[str, str], bytes]:
        """One request with router failover; raises only when EVERY
        router is unreachable (the last connection error propagates)."""
        eps = self.endpoints()
        if not eps:
            raise RuntimeError("no router endpoints known")
        with self._lock:
            self.requests_total += 1
            start = next(self._rr) % len(eps)
        order = eps[start:] + eps[:start]
        timeout = self.timeout_s if timeout_s is None else timeout_s
        last_err: Optional[BaseException] = None
        last_5xx = None
        for i, ep in enumerate(order):
            if i:
                with self._lock:
                    self.failovers_total += 1
            try:
                status, hdrs, data = self._http(ep, method, path, body,
                                                headers, timeout)
            except Exception as e:
                # a dead router (the SIGKILL drill) poisons every pooled
                # connection to it — drop them so failback reconnects
                self.pool.invalidate(ep)
                last_err = e
                continue
            with self._lock:
                self.router_requests[ep] = self.router_requests.get(ep, 0) + 1
            if self._retryable(status, data):
                last_5xx = (status, hdrs, data)
                continue
            return status, hdrs, data
        if last_5xx is not None:
            return last_5xx  # every router answered; surface the response
        raise last_err  # every router unreachable

    def predict(self, model: str, inputs, timeout_ms: Optional[float] = None,
                timeout_s: Optional[float] = None,
                protocol: Optional[str] = None
                ) -> Tuple[int, Dict[str, Any]]:
        """Predict convenience: returns ``(status, payload)``.

        ``protocol`` overrides the client default ("binary"/"json"). The
        binary path ships inputs as a CRC-framed ndarray frame and gets
        the response tensor back without JSON marshalling (``outputs`` is
        an ndarray); a 415 from a wire-disabled fleet falls back to JSON
        for this request and caches the verdict. Error responses are JSON
        on both protocols, so the payload shape is identical."""
        proto = self.protocol if protocol is None else protocol
        if proto not in ("binary", "json"):
            raise ValueError(f"unknown protocol {proto!r}")
        if proto == "binary" and self._wire_ok is not False:
            frame = wire.encode_predict_request(inputs, timeout_ms=timeout_ms)
            status, hdrs, data = self.request(
                "POST", f"/v1/models/{model}/predict", body=frame,
                headers={"Content-Type": wire.CONTENT_TYPE},
                timeout_s=timeout_s)
            if status != 415:
                if status == 200:
                    self._wire_ok = True
                    ctype = next((v for k, v in hdrs.items()
                                  if k.lower() == "content-type"), "")
                    if ctype.split(";")[0].strip() == wire.CONTENT_TYPE:
                        name, version, out, fr = \
                            wire.decode_predict_response(data)
                        try:
                            payload = {"model": name, "version": version,
                                       "outputs": np.array(out)}
                        finally:
                            out = None
                            fr.close()
                        return status, payload
                    # a JSON-only worker behind a wire-capable router:
                    # the router transcoded — parse as JSON below
                return status, self._json_payload(data)
            # 415: the fleet speaks JSON only — cache and fall through
            with self._lock:
                if self._wire_ok is not False:
                    self.wire_downgrades_total += 1
                self._wire_ok = False
        req: Dict[str, Any] = {"inputs": inputs}
        if isinstance(inputs, np.ndarray):
            req["inputs"] = inputs.tolist()
            req["dtype"] = str(inputs.dtype)
        if timeout_ms is not None:
            req["timeout_ms"] = float(timeout_ms)
        status, _, data = self.request(
            "POST", f"/v1/models/{model}/predict",
            body=json.dumps(req).encode(),
            headers={"Content-Type": "application/json"},
            timeout_s=timeout_s)
        return status, self._json_payload(data)

    @staticmethod
    def _json_payload(data: bytes) -> Dict[str, Any]:
        try:
            return json.loads(data.decode())
        except Exception:
            return {"raw": data.decode(errors="replace")[:200]}

    def close(self) -> None:
        """Drop every pooled connection (idempotent)."""
        self.pool.close()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"requests_total": self.requests_total,
                    "failovers_total": self.failovers_total,
                    "router_requests": dict(self.router_requests),
                    "wire_downgrades_total": self.wire_downgrades_total,
                    "pool": self.pool.snapshot()}


# ========================================================= router processes
@dataclasses.dataclass
class RouterSpec:
    """One router process's configuration (JSON-serializable; the spec
    file IS the router's argv). Field names mirror
    :class:`~deeplearning4j_tpu_torch.serving.fleet.WorkerSpec` where the
    supervisor machinery reads them (``worker_id`` is aliased)."""

    router_id: str
    config_path: str
    #: lease file for autoscaler leader election (default: next to the
    #: config). Only consulted when ``autoscaler`` is set.
    lease_path: Optional[str] = None
    lease_s: float = 2.0
    #: FleetRouter constructor kwargs (hedge knobs, probe intervals, ...)
    router_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: SLOMonitor windows + target for THIS router's fleet-wide monitor
    slo_windows_s: Optional[List[int]] = None
    slo_target: Optional[Dict[str, float]] = None
    #: AutoscalerConfig kwargs; ``None`` runs the router with no
    #: autoscaler at all (pure data plane)
    autoscaler: Optional[Dict[str, Any]] = None
    host: str = "local"
    heartbeat_interval_s: float = 0.5

    @property
    def worker_id(self) -> str:  # the supervisor's handle/file naming key
        return self.router_id

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class RouterSupervisor(FleetSupervisor):
    """Launch + watch + restart N router processes: the
    :class:`FleetSupervisor` pattern one level up. Port-file readiness
    (written only after the router probed its workers, registered in the
    shared config, and is serving), heartbeat + exit-code watchdog,
    budgeted restarts — all inherited; only the subprocess module and
    the leak-guard registries differ. ``kill_router`` is the chaos
    drill's SIGKILL (the watchdog relaunches within budget)."""

    _worker_module = "deeplearning4j_tpu_torch.serving.control_plane"

    @staticmethod
    def _spawn_env(spec) -> Dict[str, str]:
        """A router's env: the workers' (repository on ``PYTHONPATH``) with
        no GPU visible — a router never holds a CUDA context."""
        env = _worker_env(spec)
        env["CUDA_VISIBLE_DEVICES"] = ""
        return env

    @staticmethod
    def _track(proc: subprocess.Popen) -> None:
        _track_router(proc)

    @staticmethod
    def _active_list() -> List["RouterSupervisor"]:
        return _registry.active

    def router_ids(self) -> List[str]:
        return self.worker_ids()

    def kill_router(self, router_id: str) -> int:
        return self.kill_worker(router_id)

    def restart_router(self, router_id: str) -> int:
        return self.restart_worker(router_id)


def router_main(spec_path: str) -> int:
    """Router process entry point (``python -m
    deeplearning4j_tpu_torch.serving.control_plane <spec.json>``): build the
    config-backed :class:`FleetRouter`, optionally a lease-elected
    :class:`SLOAutoscaler`, register in the shared router roster, write
    the readiness port file, heartbeat until SIGTERM, then deregister
    and release the lease on the way out."""
    import signal

    with open(spec_path) as f:
        spec = json.load(f)

    from deeplearning4j_tpu_torch.serving.autoscale import (AutoscalerConfig,
                                                      SLOAutoscaler)
    from deeplearning4j_tpu_torch.serving.router import FleetRouter
    from deeplearning4j_tpu_torch.serving.slo import SLOMonitor, SLOTarget

    stop = threading.Event()

    def _graceful(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)

    # host code: a gated deploy's candidate this router loads runs on the
    # CPU, and nothing here may open a CUDA context
    from deeplearning4j_tpu_torch.runtime.environment import get_environment
    get_environment().set_device("cpu")
    rid = spec["router_id"]
    config = FleetConfig(spec["config_path"], create=True)
    slo_kw: Dict[str, Any] = {}
    if spec.get("slo_windows_s"):
        slo_kw["windows_s"] = tuple(int(w) for w in spec["slo_windows_s"])
    target = (SLOTarget(**spec["slo_target"])
              if spec.get("slo_target") else None)
    router = FleetRouter(config, slo=SLOMonitor(target=target, **slo_kw),
                         **(spec.get("router_kw") or {}))
    router.router_id = rid
    router.attach_config(config)
    election = auto = None
    if spec.get("autoscaler") is not None:
        lease_path = spec.get("lease_path") or (spec["config_path"]
                                                + ".autoscaler.lease")
        # lease identity is per PROCESS INCARNATION, not per router id: a
        # relaunched router finding its predecessor's holder id in the
        # lease file must NOT silently resume a dead incarnation's lease
        # (skipping the election and the fencing-seq bump) — it re-enters
        # as a follower and wins the lease properly or not at all
        election = LeaseElection(lease_path,
                                 holder_id=f"{rid}@{os.getpid()}",
                                 lease_s=float(spec.get("lease_s", 2.0)))
        auto = SLOAutoscaler(router,
                             config=AutoscalerConfig(**spec["autoscaler"]),
                             election=election)
    port = router.start(0)
    if election is not None:
        election.start()
    if auto is not None:
        auto.start()
    config.set_router(rid, f"127.0.0.1:{port}")
    # the port file is the readiness signal: written only after the
    # router has probed its workers (FleetRouter.start's first probe
    # cycle), registered itself, and is serving — atomic, like the
    # fleet workers'
    info = {"port": port, "pid": os.getpid(), "router_id": rid}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(spec["port_file"]))
    with os.fdopen(fd, "w") as f:
        json.dump(info, f)
    os.replace(tmp, spec["port_file"])

    hb = spec["heartbeat_file"]
    interval = float(spec.get("heartbeat_interval_s", 0.5))
    while not stop.wait(interval):
        with open(hb, "a"):
            os.utime(hb)
    # graceful exit: leave the roster, stop acting, release the lease so
    # a follower can take over without waiting out the window
    try:
        config.remove_router(rid)
    except Exception:
        logger.exception("router %s deregistration failed", rid)
    if auto is not None:
        auto.stop()
    if election is not None:
        election.stop(release=True)
    router.stop()
    return 0


if __name__ == "__main__":
    sys.exit(router_main(sys.argv[1]))
