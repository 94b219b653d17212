"""Checkpointing.

Counterpart of ``deeplearning4j_tpu/train/checkpoint.py``: upstream
``org.deeplearning4j.optimize.listeners.CheckpointListener`` (periodic save
every N iterations/epochs/minutes with keep-last-K retention) over the
port's ``ModelSerializer`` archives, which the JAX package reads, and
:class:`AsyncCheckpointer`, the port's counterpart of the JAX package's
``OrbaxCheckpointer``: the raw training state saved with ``torch.save`` from
a background thread, so the fit does not wait for the disk.

Crash safety: the reference's listener wrote archives in place —
a crash mid-``model.save`` left a truncated zip that a restart would
happily "restore". Here every archive is **atomic** (written to a tmp file
in the same directory, fsynced, then ``os.replace``d into place, directory
fsynced) and recorded in a per-directory CRC32 **manifest**
(``checkpoint_manifest.json``, itself written atomically).
:meth:`CheckpointListener.last_checkpoint_in` verifies candidates newest-
first — manifest CRC/size, then zip structure — and falls back to the
newest *valid* checkpoint, logging what it skipped, instead of returning
the lexically-newest path blindly. ``keep_every``-skipped checkpoints are
decided BEFORE saving: an archive destined for immediate deletion is never
written at all (the seed saved then unlinked — wasted IO and a window
where the newest file on disk was one scheduled for removal).

Chaos injection points (``runtime.chaos``): ``train.checkpoint.write``
fires before each archive write (fail/latency/hang policies);
``train.checkpoint.bytes`` is the byte point for
:class:`~deeplearning4j_tpu_torch.runtime.chaos.CorruptBytes` — the manifest CRC
is computed from the *intended* bytes, so an injected torn write or
bit-flip is exactly what restore-time verification catches.
"""

from __future__ import annotations

import json
import os
import time
import zipfile
import zlib
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.runtime import chaos, journal
from deeplearning4j_tpu_torch.train.listeners import TrainingListener, logger

MANIFEST_NAME = "checkpoint_manifest.json"


def _checkpoint_index(filename: str) -> Optional[int]:
    """``checkpoint_<idx>_<tag>.zip`` -> idx, else None (foreign files —
    including the manifest — never break directory scans)."""
    parts = filename.split("_")
    if (len(parts) >= 3 and parts[0] == "checkpoint"
            and filename.endswith(".zip") and parts[1].isdigit()):
        return int(parts[1])
    return None


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename within it survives power loss (no-op
    on platforms whose dirs can't be opened)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _crc32_file(path: str) -> Dict[str, int]:
    crc, size = 0, 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return {"crc32": crc & 0xFFFFFFFF, "size": size}


def atomic_save_model(model, path: str, save_updater: bool = True) -> Dict[str, int]:
    """Crash-safe archive write: tmp file in the same directory (same
    filesystem, so the final ``os.replace`` is atomic), fsync, replace,
    directory fsync. Returns ``{"crc32", "size"}`` of the bytes *intended*
    for disk — computed before the chaos byte point, so injected write
    corruption is detectable against the returned digest."""
    d, base = os.path.split(os.path.abspath(path))
    tmp = os.path.join(d, f".{base}.tmp")
    chaos.inject("train.checkpoint.write")
    try:
        model.save(tmp, save_updater=save_updater)
        entry = _crc32_file(tmp)
        if chaos.active():
            with open(tmp, "rb") as f:
                data = f.read()
            corrupted = chaos.transform_bytes("train.checkpoint.bytes", data)
            if corrupted is not data:
                with open(tmp, "wb") as f:
                    f.write(corrupted)
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
    _fsync_dir(d)
    # the checkpoint joins the black box: a resume/restart
    # investigation sees exactly which archives existed when
    journal.emit("train.checkpoint", path=path, size=entry["size"])
    return entry


def load_manifest(dir: str) -> Dict[str, Dict[str, int]]:
    try:
        with open(os.path.join(dir, MANIFEST_NAME)) as f:
            m = json.load(f)
        return m if isinstance(m, dict) else {}
    except (OSError, ValueError):
        return {}


def write_manifest(dir: str, manifest: Dict[str, Dict[str, int]]) -> None:
    path = os.path.join(dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(dir)


def verify_checkpoint(path: str,
                      entry: Optional[Dict[str, int]] = None) -> bool:
    """Is ``path`` a restorable archive? Checks the manifest entry's
    size + CRC32 when given (catches silent bit rot), then the zip's own
    structure and per-member CRCs (catches truncation with no manifest)."""
    try:
        if entry is not None:
            actual = _crc32_file(path)
            if (actual["size"] != entry.get("size")
                    or actual["crc32"] != entry.get("crc32")):
                return False
        if not zipfile.is_zipfile(path):
            return False
        with zipfile.ZipFile(path) as zf:
            return zf.testzip() is None
    except (OSError, zipfile.BadZipFile):
        return False


class CheckpointListener(TrainingListener):
    """Save the model periodically (reference semantics + retention).

    Usage::

        net.set_listeners(CheckpointListener(
            dir="checkpoints", every_n_iterations=500, keep_last=3))
    """

    def __init__(self, dir: str, every_n_iterations: Optional[int] = None,
                 every_n_epochs: Optional[int] = None,
                 every_n_minutes: Optional[float] = None,
                 keep_last: Optional[int] = None, keep_every: int = 1,
                 save_updater: bool = True, clock=None):
        if not (every_n_iterations or every_n_epochs or every_n_minutes):
            raise ValueError("Configure at least one of every_n_iterations / "
                             "every_n_epochs / every_n_minutes")
        self.dir = dir
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.every_n_minutes = every_n_minutes
        self.keep_last = keep_last
        self.keep_every = max(1, int(keep_every))
        self.save_updater = save_updater
        # the supervisor disarms an abandoned (hung-then-revoked) worker's
        # listener so a straggler step cannot write stale archives into a
        # directory the restarted run is checkpointing into
        self.armed = True
        # injectable clock
        self._clock = clock if clock is not None else time.monotonic
        self._last_time = self._clock()
        self._saved: List[str] = []
        os.makedirs(dir, exist_ok=True)
        # Resume the checkpoint counter past anything already on disk: a
        # fresh listener after a supervisor restart must not reuse index 0
        # — that would overwrite the oldest archive with the NEWEST state
        # while last_checkpoint_in's newest-by-counter ordering still
        # preferred the stale higher indices.
        indices = [i for i in map(_checkpoint_index, os.listdir(dir))
                   if i is not None]
        self._count = max(indices) + 1 if indices else 0

    def _save(self, model, tag: str) -> None:
        if not self.armed:
            return
        idx = self._count
        self._count += 1
        # keep_every is decided BEFORE saving: never write an archive
        # destined for immediate deletion (the kept set matches the old
        # save-then-unlink behaviour: every keep_every-th trigger)
        if (idx + 1) % self.keep_every != 0:
            return
        path = os.path.join(self.dir, f"checkpoint_{idx}_{tag}.zip")
        entry = atomic_save_model(model, path, save_updater=self.save_updater)
        manifest = load_manifest(self.dir)
        manifest[os.path.basename(path)] = entry
        self._saved.append(path)
        logger.info("Saved checkpoint: %s", path)
        if self.keep_last:
            while len(self._saved) > self.keep_last:
                old = self._saved.pop(0)
                manifest.pop(os.path.basename(old), None)
                if os.path.exists(old):
                    os.unlink(old)
        write_manifest(self.dir, manifest)

    def iteration_done(self, model, iteration, epoch, score):
        if self.every_n_iterations and iteration % self.every_n_iterations == 0:
            self._save(model, f"iter{iteration}")
        if self.every_n_minutes and (self._clock() - self._last_time) >= 60 * self.every_n_minutes:
            self._save(model, f"iter{iteration}")
            self._last_time = self._clock()

    def on_epoch_end(self, model, epoch):
        if self.every_n_epochs and (epoch + 1) % self.every_n_epochs == 0:
            self._save(model, f"epoch{epoch}")

    def last_checkpoint(self) -> Optional[str]:
        return self._saved[-1] if self._saved else None

    @staticmethod
    def last_checkpoint_in(dir: str) -> Optional[str]:
        """Newest *valid* checkpoint in ``dir``, or None.

        Candidates are ordered newest-first by checkpoint counter; each is
        verified (manifest CRC/size when recorded, zip structure always)
        and unreadable/corrupt archives are skipped with a warning instead
        of being handed to a restart that would restore garbage."""
        try:
            files = [f for f in os.listdir(dir)
                     if _checkpoint_index(f) is not None]
        except OSError:
            return None
        if not files:
            return None
        files.sort(key=_checkpoint_index, reverse=True)
        manifest = load_manifest(dir)
        for f in files:
            path = os.path.join(dir, f)
            if verify_checkpoint(path, manifest.get(f)):
                return path
            logger.warning(
                "Skipping unreadable/corrupt checkpoint %s (%s); falling "
                "back to the previous one", path,
                "manifest CRC/size mismatch or bad zip" if f in manifest
                else "bad zip, no manifest entry")
        logger.warning("No valid checkpoint found in %s (%d candidate(s) "
                       "all corrupt)", dir, len(files))
        return None


class AsyncCheckpointer:
    """Asynchronous checkpoints of the raw training state: the port's
    counterpart of the JAX package's ``OrbaxCheckpointer``
    (``checkpoint.py:267-343`` there; ``OrbaxCheckpointer`` is this class's
    other name), with the same ``save``, ``restore``, ``wait``, ``close`` and
    ``max_to_keep``.

    :meth:`save` copies the network's parameters, optimizer state and layer
    state to host memory on the calling thread (the fit goes on updating
    them in place), then writes ``<dir>/<step>/state.pt`` with
    ``torch.save`` on a background thread (tmp file, fsync, rename), with
    the iteration and epoch counters and the RNG stream position, and keeps
    the newest ``max_to_keep`` steps. :meth:`restore` copies a step (the
    newest by default) back into an initialised network in place, so packed
    state and captured graphs stay valid.
    """

    def __init__(self, dir: str, max_to_keep: int = 3):
        import threading
        self.dir = os.path.abspath(dir)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()  # guards: _threads
        self._threads: List = []

    def steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.dir)
                      if d.isdigit() and os.path.exists(os.path.join(self.dir, d, "state.pt")))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def save(self, net, step: Optional[int] = None) -> None:
        import threading

        import torch

        from deeplearning4j_tpu_torch.runtime.trees import tree_map
        step = int(net._iteration if step is None else step)
        payload = {
            "state": tree_map(lambda t: t.detach().to("cpu", copy=True)
                              if isinstance(t, torch.Tensor) else t, net._state_tree()),
            "iteration": net._iteration, "epoch": net._epoch, "rng": net.rng.get_state(),
        }
        path = os.path.join(self.dir, str(step), "state.pt")

        def write():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            torch.save(payload, tmp)
            with open(tmp, "rb") as f:
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(os.path.dirname(path))
            self._prune()

        t = threading.Thread(target=write, name="async-checkpoint", daemon=True)
        with self._lock:
            self._threads.append(t)
        t.start()

    def _prune(self) -> None:
        import shutil
        with self._lock:
            steps = self.steps()
            for s in steps[:-self.max_to_keep] if self.max_to_keep else []:
                shutil.rmtree(os.path.join(self.dir, str(s)), ignore_errors=True)

    def restore(self, net, step: Optional[int] = None):
        import torch

        from deeplearning4j_tpu_torch.runtime.state_packing import assign_state
        self.wait()
        net._ensure_init()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        payload = torch.load(os.path.join(self.dir, str(step), "state.pt"),
                             map_location="cpu", weights_only=False)
        from deeplearning4j_tpu_torch.runtime.trees import tree_map
        state = tree_map(lambda t: t.to(net.device) if isinstance(t, torch.Tensor) else t,
                         payload["state"])
        net._set_state_tree(assign_state(net._state_tree(), state))
        net._iteration = int(payload.get("iteration", 0))
        net._epoch = int(payload.get("epoch", 0))
        if payload.get("rng") is not None:
            net.rng.set_state(payload["rng"])
        return net

    def wait(self) -> None:
        with self._lock:
            threads, self._threads = self._threads, []
        for t in threads:
            t.join()

    def close(self) -> None:
        self.wait()


#: the JAX package's name for :class:`AsyncCheckpointer`
OrbaxCheckpointer = AsyncCheckpointer
