"""Failure detection / auto-resume.

Counterpart of ``deeplearning4j_tpu/train/fault_tolerance.py``. The
reference's fault story is: workers heartbeat into the parameter-server
mesh (upstream ``org.nd4j.parameterserver.distributed.v2.util.MeshOrganizer``
join/leave remap) and training restarts from the last checkpoint. A lost
or faulted card kills the step, so the equivalent is supervision AROUND
the step: checkpoint periodically, detect the failure (exception or
watchdog timeout), restore the newest checkpoint into a fresh network on
the same device, and continue the epoch loop.

What the supervisor does:

- **Real supervision**: with a heartbeat timeout configured, each epoch
  runs in a worker thread while the supervisor polls the
  :class:`HeartbeatMonitor` — a *hung* step (not just a raised one) is
  detected, the stalled worker is abandoned (on real hardware the chip
  behind it is gone), and training restarts from the newest valid
  checkpoint.
- **Bounded restart budget**: ``max_restarts`` within
  ``restart_window_s`` (lifetime when None). When the budget is
  exhausted the supervisor stops retrying and escalates
  :class:`TrainingFailure` — a crash loop must page a human, not burn
  accelerator time forever.
- **Exact mid-epoch resume**: the trainer records the iteration at which
  each epoch began; after restoring a checkpoint taken mid-epoch it skips
  the already-trained leading batches of that epoch, so the resumed loss
  trajectory bit-matches an uninterrupted run (the serializer already
  restores updater state, iteration/epoch counters, and the RNG stream
  position).
- **Corruption-aware restore**: ``CheckpointListener.last_checkpoint_in``
  now verifies archives (CRC manifest + zip structure) and falls back to
  the newest *valid* checkpoint, so a crash mid-save can no longer feed a
  truncated zip to the restart.

Chaos injection point: ``train.epoch`` fires inside the epoch worker just
before ``net.fit`` (fail → supervised restart; hang → watchdog abandon).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from deeplearning4j_tpu_torch.runtime import chaos, journal
from deeplearning4j_tpu_torch.train.checkpoint import CheckpointListener

logger = logging.getLogger(__name__)


class TrainingFailure(RuntimeError):
    pass


class HeartbeatMonitor:
    """Liveness watchdog (the heartbeat half of the reference's mesh
    organizer): training calls :meth:`beat` every iteration; a supervisor
    thread — or the trainer itself between epochs — calls :meth:`check`
    and treats a stale heartbeat as a failure."""

    def __init__(self, timeout_s: float = 600.0):
        self.timeout_s = float(timeout_s)
        self._last = time.monotonic()

    def beat(self) -> None:
        self._last = time.monotonic()

    def seconds_since_beat(self) -> float:
        return time.monotonic() - self._last

    def check(self) -> None:
        if self.seconds_since_beat() > self.timeout_s:
            raise TrainingFailure(
                f"no training heartbeat for {self.seconds_since_beat():.0f}s "
                f"(timeout {self.timeout_s:.0f}s)")


class _HeartbeatListener:
    """TrainingListener shim feeding the monitor."""

    def __init__(self, monitor: HeartbeatMonitor):
        self.monitor = monitor

    def iteration_done(self, model, iteration, epoch, score):
        self.monitor.beat()

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


class _FencedIterator:
    """Iterator wrapper the supervisor can revoke: an abandoned (hung)
    epoch worker that later wakes up sees an exhausted iterator instead of
    racing the restarted epoch for batches."""

    def __init__(self, base):
        self.base = base
        self._revoked = False

    def revoke(self) -> None:
        self._revoked = True

    def reset(self) -> None:
        if not self._revoked:
            self.base.reset()

    def has_next(self) -> bool:
        return (not self._revoked) and self.base.has_next()

    def next(self):
        if self._revoked:
            raise StopIteration("iterator revoked by the supervisor")
        return self.base.next()

    def batch(self) -> int:
        return self.base.batch()

    def set_pre_processor(self, p) -> None:
        self.base.set_pre_processor(p)

    def __iter__(self):
        while self.has_next():
            yield self.next()


class _SkipBatches:
    """Iterator wrapper that discards the first ``skip`` batches after each
    reset — the mid-epoch resume mechanism: a deterministic iterator
    replays the epoch's prefix into the void so training continues at
    exactly the batch the checkpoint was taken after."""

    def __init__(self, base, skip: int):
        self.base = base
        self.skip = int(skip)

    def reset(self) -> None:
        self.base.reset()
        for _ in range(self.skip):
            if not self.base.has_next():
                break
            self.base.next()

    def has_next(self) -> bool:
        return self.base.has_next()

    def next(self):
        return self.base.next()

    def batch(self) -> int:
        return self.base.batch()

    def set_pre_processor(self, p) -> None:
        self.base.set_pre_processor(p)

    def __iter__(self):
        while self.has_next():
            yield self.next()


class FaultTolerantTrainer:
    """Checkpoint + restart supervision loop.

    ``make_net()`` must build a FRESH, initialised network (the replacement
    worker). ``fit`` runs epoch-at-a-time; on any failure — a raised
    exception, or a stale heartbeat when ``heartbeat_timeout_s`` is set —
    it reloads the newest *valid* checkpoint from ``checkpoint_dir`` into
    a fresh network and continues, within the restart budget
    (``max_restarts`` per ``restart_window_s``; lifetime when the window
    is None). An exhausted budget escalates :class:`TrainingFailure`.
    """

    def __init__(self, make_net: Callable[[], object], checkpoint_dir: str,
                 every_n_iterations: int = 50, keep_last: int = 3,
                 max_restarts: int = 3,
                 restart_window_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None):
        self.make_net = make_net
        self.checkpoint_dir = checkpoint_dir
        self.every_n_iterations = every_n_iterations
        self.keep_last = keep_last
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.restarts = 0
        self.monitor = (HeartbeatMonitor(heartbeat_timeout_s)
                        if heartbeat_timeout_s else None)
        self._restart_times: deque = deque()
        os.makedirs(checkpoint_dir, exist_ok=True)
        # epoch -> iteration at which it began; persisted next to the
        # checkpoints so a BRAND-NEW trainer over an existing directory
        # (cross-process restart) still resumes mid-epoch exactly instead
        # of replaying the epoch's leading batches
        self._epoch_start_iters = self._load_epoch_starts()

    def _epoch_starts_path(self) -> str:
        return os.path.join(self.checkpoint_dir, "trainer_state.json")

    def _load_epoch_starts(self) -> dict:
        import json
        try:
            with open(self._epoch_starts_path()) as f:
                return {int(k): int(v) for k, v in
                        json.load(f)["epoch_start_iters"].items()}
        except (OSError, ValueError, KeyError, TypeError):
            return {}

    def _save_epoch_starts(self) -> None:
        import json
        path = self._epoch_starts_path()
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"epoch_start_iters": self._epoch_start_iters}, f)
            os.replace(tmp, path)
        except OSError:
            logger.warning("could not persist trainer state to %s", path)

    def _fresh_net(self):
        base = self.make_net()  # one build: class, listeners, or the net itself
        listeners = list(getattr(base, "_listeners", []))
        ckpt = CheckpointListener.last_checkpoint_in(self.checkpoint_dir)
        if ckpt is not None:
            logger.warning("Restoring from checkpoint %s", ckpt)
            net = type(base).load(ckpt, device=getattr(base, "device", None))
            # resume on the black-box record: which archive a
            # restarted trainer actually picked up
            journal.emit("train.resume", checkpoint=ckpt)
        else:
            net = base
        listeners.append(CheckpointListener(
            self.checkpoint_dir, every_n_iterations=self.every_n_iterations,
            keep_last=self.keep_last))
        if self.monitor:
            listeners.append(_HeartbeatListener(self.monitor))
        net.set_listeners(*listeners)
        return net

    # ----------------------------------------------------------- internals
    def _run_epoch(self, net, iterator) -> Optional[BaseException]:
        """Run ONE epoch; returns None on success or the failure cause.
        With a heartbeat monitor the epoch runs in a worker thread and the
        supervisor polls for staleness — a hung worker is abandoned (its
        eventual result, if any, is ignored) and reported as a failure."""
        box = {}

        def work():
            try:
                chaos.inject("train.epoch")
                net.fit(iterator, epochs=1)
            except BaseException as e:  # noqa: BLE001 — any failure counts
                box["err"] = e

        if self.monitor is None:
            work()
            return box.get("err")
        self.monitor.beat()  # epoch start counts as liveness
        worker = threading.Thread(target=work, daemon=True,
                                  name="FaultTolerantTrainer-epoch")
        worker.start()
        poll = max(0.01, min(0.5, self.monitor.timeout_s / 4.0))
        while worker.is_alive():
            worker.join(poll)
            if not worker.is_alive():
                break
            if self.monitor.seconds_since_beat() > self.monitor.timeout_s:
                # Quarantine the stalled worker before abandoning it: if
                # it ever wakes up it must not race the restarted epoch —
                # its iterator is revoked (no more batches) and its
                # checkpoint listeners are disarmed (no stale archives
                # into the directory the new attempt checkpoints into).
                if isinstance(iterator, _FencedIterator):
                    iterator.revoke()
                for lst in getattr(net, "_listeners", []):
                    if isinstance(lst, CheckpointListener):
                        lst.armed = False
                return TrainingFailure(
                    f"no training heartbeat for "
                    f"{self.monitor.seconds_since_beat():.1f}s (timeout "
                    f"{self.monitor.timeout_s:.1f}s); abandoning the "
                    f"stalled epoch worker")
        return box.get("err")

    def _register_restart(self, cause: BaseException) -> None:
        """Count a restart against the budget; escalate when exhausted."""
        now = time.monotonic()
        self.restarts += 1
        self._restart_times.append(now)
        if self.restart_window_s is not None:
            while (self._restart_times
                   and now - self._restart_times[0] > self.restart_window_s):
                self._restart_times.popleft()
            recent = len(self._restart_times)
            budget = (f"{self.max_restarts} restarts in "
                      f"{self.restart_window_s:.0f}s")
        else:
            recent = self.restarts
            budget = f"{self.max_restarts} restarts"
        if recent > self.max_restarts:
            raise TrainingFailure(f"giving up after {budget}") from cause
        journal.emit("train.restart", cause=type(cause).__name__,
                     restarts=self.restarts)
        logger.warning("Training failed (%s); restart %d within budget %s",
                       cause, recent, budget)

    # ----------------------------------------------------------------- fit
    def fit(self, iterator, epochs: int = 1):
        """Supervised training; returns the final (possibly restarted) net.

        Epoch progress is tracked on the NET's epoch counter (restored
        from checkpoints), so a restart resumes at the checkpoint's epoch
        — and, via batch skipping, at the checkpoint's exact batch."""
        net = self._fresh_net()
        while net._epoch < epochs:
            e = net._epoch
            start_iter = self._epoch_start_iters.get(e)
            if start_iter is None:
                self._epoch_start_iters[e] = net._iteration
                self._save_epoch_starts()
                skip = 0
            else:
                # resumed mid-epoch: the checkpoint's iteration counter
                # minus the recorded epoch start = batches already trained
                skip = max(0, net._iteration - start_iter)
            it = _SkipBatches(iterator, skip) if skip else iterator
            if self.monitor is not None:
                it = _FencedIterator(it)  # revocable on watchdog abandon
            failure = self._run_epoch(net, it)
            if failure is None:
                continue  # net.fit advanced net._epoch
            self._register_restart(failure)
            net = self._fresh_net()
        return net
