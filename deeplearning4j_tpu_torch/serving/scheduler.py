"""Preemptible background train/eval scheduler — the Arbiter analog
(counterpart of ``deeplearning4j_tpu/serving/scheduler.py``, with the same
job records, journal events, counters and ``scheduler_*`` families).

Even a well-tuned serving fleet leaves most device time idle. The
reference stack answered this workload class with **Arbiter**
(random/grid hyperparameter search over builder configs) and ran heavy
training off the serving path via ``SharedTrainingMaster``. This module
is the unified version: background jobs run ON the serving workers, in
the gaps traffic leaves, and yield the moment traffic returns.

Design invariants:

- **Admission is signal-gated.** A job only starts (or keeps running)
  while the live capacity/SLO signals the autoscaler already consumes
  say the worker has slack: per-model busy fractions under
  ``max_busy_fraction``, queue depth zero / headroom above
  ``min_queue_headroom``, fast-window SLO burn under ``max_fast_burn``.
  The same predicate that refuses admission triggers preemption — there
  is exactly one definition of "traffic needs the devices".
- **Preemption is free.** Job runners do bounded work per
  :meth:`JobRun.step` and checkpoint through the same atomics training
  uses (``atomic_save_model`` + the :class:`DistributedTrainer`
  residual/archive checkpoint). Resume is EXACT batch-skip: the batch
  schedule is a pure function of (seed, step index), and the restored
  archive carries updater state, RNG stream position and iteration
  counters — a preempted-then-resumed fine-tune's trajectory bit-matches
  an uninterrupted run (tested).
- **Exactly-once claims.** Job state lives in the shared
  :class:`~deeplearning4j_tpu_torch.serving.control_plane.FleetConfig`; a
  scheduler may only run a job after winning
  ``try_claim("scheduler.job:<id>")`` on the control plane's applied-actions
  ledger, so two schedulers racing the same job can never double-run it.
  The claim attempt is a chaos point (``serving.scheduler.claim``).
- **Every transition is a journal event.** submitted / claimed /
  started / preempted / resumed / completed / failed / cancelled each
  emit a typed ``runtime/journal.py`` event, so one ``/v1/debug/bundle``
  pull reconstructs a job's whole life with gapless seqs.
- **Harvest is measured, not assumed.** The scheduler accumulates the
  wall seconds its job steps actually ran (``harvested_busy_s``) and
  registers itself with :mod:`serving.capacity`, which folds the number
  into the ``device_idle_fraction`` headline. On the card every step ends
  by waiting for its own stream, so a step's seconds hold all of its card
  time, not only the host's enqueue time; they also hold the step's host
  work, so the sum is an upper bound on the card time harvested.
- **Job steps and serving captures exclude each other.** A job's step
  (except an eval, which goes through the batcher) holds
  ``compile_cache.CAPTURE_LOCK``: a replica captured at warm-up, at
  page-in or by the autoscaler's replica lever never records while a
  background step runs on the same card in the same process.

Job types: ``finetune`` (:class:`DistributedTrainer` steps over a fixed
npz dataset), ``eval`` (golden-set accuracy through the REAL registry
batcher path), ``score`` (offline batch scoring to an npz), ``sweep``
(Arbiter-style random/grid search over builder-config space, trial
granular preemption), and ``flywheel`` (the feedback flywheel's learning
half:
``DL4J_TPU_FEEDBACK_FILE`` labeled examples through a
:class:`DevicePrefetcher` feed into a transfer-learning +
early-stopping fine-tune whose candidate archive re-enters
``rolling_deploy(strategy="gated")`` via the injected ``deploy_fn``).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.runtime import chaos, journal
from deeplearning4j_tpu_torch.runtime.compile_cache import CAPTURE_LOCK

__all__ = ["JobStore", "Scheduler", "SchedulerConfig", "JobRun",
           "JOB_RUNNERS", "JOB_STATES", "CLAIM_POINT",
           "capacity_signals", "render_prometheus", "build_net_from_spec"]

logger = logging.getLogger(__name__)

#: the exactly-once claim's chaos point: fired before every ledger
#: claim attempt, so a drill can kill/hang/fail a scheduler mid-claim
#: and assert the job still runs at most once
CLAIM_POINT = "serving.scheduler.claim"

#: every lifecycle state a job record can hold (journal event
#: ``scheduler.<verb>`` mirrors each transition)
JOB_STATES = ("submitted", "claimed", "started", "preempted", "resumed",
              "completed", "failed", "cancelled")

# ============================================================ job store
class JobStore:
    """Job records in the shared :class:`FleetConfig` (``cfg["jobs"]``),
    with exactly-once run rights through the applied-actions ledger.

    The store is a thin veneer: every mutation goes through
    ``FleetConfig.mutate`` (cross-process flock + atomic replace), every
    read through ``snapshot()``, and the claim is ``try_claim`` on the
    same ledger rolling deploys use — no state of its own, so N
    schedulers and M submitters can share one store safely."""

    def __init__(self, config):
        self.config = config

    # ---- submit / read -------------------------------------------------
    def submit(self, jtype: str, payload: Dict[str, Any],
               job_id: Optional[str] = None, priority: int = 0) -> str:
        """Register a job (state ``submitted``); returns its id."""
        if job_id is None:
            job_id = f"{jtype}-{random.getrandbits(48):012x}"
        rec = {"id": job_id, "type": str(jtype), "payload": payload,
               "priority": int(priority), "state": "submitted",
               "owner": None, "submitted_at": time.time(),
               "progress": {}, "result": None, "error": None}
        def fn(cfg):
            cfg.setdefault("jobs", {})[job_id] = rec
        self.config.mutate(fn)
        journal.emit("scheduler.submit", job=job_id, type=jtype,
                     priority=int(priority))
        return job_id

    def jobs(self) -> Dict[str, Dict[str, Any]]:
        return dict((self.config.snapshot() or {}).get("jobs", {}))

    def get(self, job_id: str) -> Optional[Dict[str, Any]]:
        return self.jobs().get(job_id)

    # ---- claim / transitions -------------------------------------------
    def claim(self, job_id: str, owner: str) -> bool:
        """Try to win the job's exactly-once run right. Exactly one
        caller across every process sharing this config can ever win;
        the loser's attempt is still a journal event (``won=False``) so
        a claim race is visible in the bundle."""
        chaos.inject(CLAIM_POINT)
        won = self.config.try_claim(f"scheduler.job:{job_id}",
                                    {"owner": owner})
        journal.emit("scheduler.claim", job=job_id, owner=owner, won=won)
        if won:
            self.update(job_id, state="claimed", owner=owner)
        return won

    def update(self, job_id: str, **fields) -> Optional[Dict[str, Any]]:
        """Merge ``fields`` into the job record; a ``state`` change
        emits its journal event. Returns the updated record (or ``None``
        for an unknown id — an updater must tolerate a cancel race)."""
        out: Dict[str, Any] = {}
        def fn(cfg):
            rec = cfg.get("jobs", {}).get(job_id)
            if rec is None:
                return
            rec.update(fields)
            out.update(rec)
        self.config.mutate(fn)
        if not out:
            return None
        state = fields.get("state")
        if state and state != "claimed":  # claim emits its own event
            # one literal emit per transition (the journal linter's
            # emit-site <-> registry parity needs the spelling visible)
            attrs = dict(job=job_id, state=state,
                         owner=out.get("owner"), type=out.get("type"))
            if state == "started":
                journal.emit("scheduler.start", **attrs)
            elif state == "preempted":
                journal.emit("scheduler.preempt", **attrs)
            elif state == "resumed":
                journal.emit("scheduler.resume", **attrs)
            elif state == "completed":
                journal.emit("scheduler.complete", **attrs)
            elif state == "cancelled":
                journal.emit("scheduler.cancel", **attrs)
            else:
                journal.emit("scheduler.fail", **attrs)
        return out

    def cancel(self, job_id: str) -> bool:
        """Cancel a job that is not yet terminal. A RUNNING job is
        cancelled cooperatively by its scheduler at the next step
        boundary (the record flips first; the runner observes it)."""
        rec = self.get(job_id)
        if rec is None or rec["state"] in ("completed", "failed",
                                           "cancelled"):
            return False
        return self.update(job_id, state="cancelled") is not None


# ==================================================== admission signals
def capacity_signals(registry, slo=None) -> Callable[[], Dict[str, Any]]:
    """Build the scheduler's admission-signal callable from the live
    serving objects — the SAME numbers the autoscaler consumes: per-model
    busy fractions and queue depth/headroom from the capacity ledger,
    fast-window SLO burn from the monitor. Returns worst-case (max busy,
    max burn, min headroom) so one hot model blocks harvest."""
    def signals() -> Dict[str, Any]:
        from deeplearning4j_tpu_torch.serving import capacity as cap
        busy = 0.0
        depth = 0
        headroom: Optional[int] = None
        for name in registry.names():
            try:
                c = cap.model_capacity(registry.get(name))
            except Exception:
                continue  # cold or mid-swap: not a traffic signal
            busy = max(busy, c["utilization"]["busy_fraction"])
            depth += c["queue"]["depth"]
            h = c["queue"]["headroom_requests"]
            headroom = h if headroom is None else min(headroom, h)
        burn = 0.0
        if slo is not None:
            try:
                rep = slo.report()
                for m in rep.values():
                    windows = (m or {}).get("windows") or {}
                    if not windows:
                        continue
                    fast = windows[min(windows,
                                       key=lambda w: float(w))]
                    burn = max(burn, float(
                        fast.get("availability_burn_rate", 0.0)), float(
                        fast.get("latency_burn_rate", 0.0)))
            except Exception:
                pass  # a broken monitor must not wedge admission
        return {"busy_fraction": round(busy, 6), "queue_depth": depth,
                "queue_headroom": headroom, "fast_burn": round(burn, 6)}
    return signals


class SchedulerConfig:
    """Admission/preemption knobs (one predicate serves both)."""

    def __init__(self, tick_s: float = 0.05,
                 max_busy_fraction: float = 0.5,
                 max_queue_depth: int = 0,
                 min_queue_headroom: int = 1,
                 max_fast_burn: float = 1.0,
                 preempt_join_s: float = 30.0,
                 duty_fraction: float = 1.0,
                 job_nice: Optional[int] = None):
        self.tick_s = float(tick_s)
        self.max_busy_fraction = float(max_busy_fraction)
        self.max_queue_depth = int(max_queue_depth)
        self.min_queue_headroom = int(min_queue_headroom)
        self.max_fast_burn = float(max_fast_burn)
        self.preempt_join_s = float(preempt_join_s)
        # interference controls for core-sharing hosts: pace the job
        # thread to at most `duty_fraction` of wall time (an admission
        # tick is too coarse to protect millisecond tails; the pause
        # between steps is what keeps foreground p99 flat), and renice
        # it (Linux best-effort) so the kernel deschedules harvest the
        # moment a request thread becomes runnable
        self.duty_fraction = min(1.0, max(0.01, float(duty_fraction)))
        self.job_nice = None if job_nice is None else int(job_nice)

    def to_dict(self) -> Dict[str, Any]:
        return {"tick_s": self.tick_s,
                "max_busy_fraction": self.max_busy_fraction,
                "max_queue_depth": self.max_queue_depth,
                "min_queue_headroom": self.min_queue_headroom,
                "max_fast_burn": self.max_fast_burn,
                "duty_fraction": self.duty_fraction,
                "job_nice": self.job_nice}


# ============================================================== runners
class JobRun:
    """One job's in-memory execution. The contract that makes preemption
    instant and resume exact:

    - :meth:`step` does one BOUNDED unit (one global batch, one sweep
      trial, one eval chunk, one epoch) and returns True when done;
    - :meth:`checkpoint` persists everything a bit-exact continuation
      needs through atomic writes, returning the JSON progress dict the
      job record carries;
    - construction with a non-empty ``progress`` RESUMES: restore from
      the checkpoint, then skip exactly the completed units — never
      replay one.
    """

    #: whether :meth:`step` runs on the device itself (its own forward,
    #: backward and captures), so the scheduler runs it under
    #: ``CAPTURE_LOCK``; ``False`` for a runner that goes through the
    #: serving batcher, whose own captures take that lock
    exclusive_device = True

    def __init__(self, job: Dict[str, Any], ctx: "JobContext"):
        self.job = job
        self.payload = dict(job.get("payload") or {})
        self.progress = dict(job.get("progress") or {})
        self.ctx = ctx

    def step(self) -> bool:
        raise NotImplementedError

    def checkpoint(self) -> Dict[str, Any]:
        return dict(self.progress)

    def result(self) -> Dict[str, Any]:
        return {}


class JobContext:
    """What a scheduler hands its runners: the live registry (eval jobs
    go through the REAL batcher path), the injected gated-deploy hook,
    and the owning scheduler (cancel checks)."""

    def __init__(self, registry=None, deploy_fn=None, scheduler=None):
        self.registry = registry
        self.deploy_fn = deploy_fn
        self.scheduler = scheduler


def _one_hot(labels, n_out: int) -> np.ndarray:
    y = np.zeros((len(labels), n_out), np.float32)
    y[np.arange(len(labels)), np.asarray(labels, np.int64)] = 1.0
    return y


def _host(t) -> np.ndarray:
    """A network output on the host (a read that waits for the card); a
    bf16 output arrives as float32, which numpy holds."""
    if not hasattr(t, "detach"):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() and t.element_size() < 4 else t).numpy()


def _sync(net) -> None:
    """End a step on the card: wait for the stream the step ran on, so the
    step's measured wall seconds hold its device time, not only its enqueue
    time (they hold its host work too)."""
    import torch
    dev = getattr(net, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _features(a) -> np.ndarray:
    """A dataset's features: float32, except integer arrays (token ids),
    which keep their dtype — a float id would be cast with the activations
    (to bf16 under a bf16 compute dtype) and no longer name its token."""
    a = np.asarray(a)
    return a if np.issubdtype(a.dtype, np.integer) else a.astype(np.float32)


def _atomic_savez(path: str, **arrays) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def build_net_from_spec(spec: Dict[str, Any]):
    """A builder config from a JSON spec — the sweep's search space is
    over THESE knobs (the Arbiter analog: hyperparameters as data, so a
    trial's config travels through the job store). Keys: ``nin``,
    ``nout`` (required), ``hidden`` (list of widths), ``activation``,
    ``seed``, ``lr`` + ``updater`` ("sgd"/"adam"/None). Built on the
    environment's device."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import (DenseLayer, InputType,
                                       NeuralNetConfiguration, OutputLayer)
    from deeplearning4j_tpu_torch.train import Adam, Sgd
    updater = None
    name = spec.get("updater")
    lr = float(spec.get("lr", 0.1))
    if name == "adam":
        updater = Adam(lr)
    elif name == "sgd":
        updater = Sgd(lr)
    b = (NeuralNetConfiguration.builder()
         .seed(int(spec.get("seed", 7))).updater(updater).list())
    for width in (spec.get("hidden") or [16]):
        b = b.layer(DenseLayer(n_out=int(width),
                               activation=spec.get("activation", "tanh")))
    b = b.layer(OutputLayer(n_out=int(spec["nout"]),
                            activation="softmax"))
    conf = b.set_input_type(
        InputType.feed_forward(int(spec["nin"]))).build()
    return MultiLayerNetwork(conf).init()


class FineTuneRun(JobRun):
    """``finetune``: :class:`DistributedTrainer` steps over a fixed npz
    dataset with a deterministic (seed, step)->batch schedule. The
    checkpoint is the trainer's own group-consistent one (residuals
    first, then the atomic model archive), so resume restores updater
    state, codec residuals, RNG position and iteration counter — the
    continuation bit-matches the uninterrupted trajectory."""

    def __init__(self, job, ctx):
        super().__init__(job, ctx)
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        from deeplearning4j_tpu_torch.train.distributed import (
            DistributedConfig, DistributedTrainer)
        p = self.payload
        data = np.load(p["data"])
        self.x = _features(data["x"])
        self.y = np.asarray(data["y"], np.float32)
        self.batch_size = int(p.get("batch_size", 8))
        self.total_steps = int(p.get("steps", 10))
        seed = int(p.get("seed", 0))
        self._perm = np.random.default_rng(seed).permutation(len(self.x))
        ckpt_dir = p.get("checkpoint_dir") or (
            f"{p['archive']}.job-{job['id']}.ckpt")
        os.makedirs(ckpt_dir, exist_ok=True)
        net = MultiLayerNetwork.load(p["archive"], load_updater=True)
        self.trainer = DistributedTrainer(
            net, DistributedConfig(threshold=float(p.get("threshold", 0.0)),
                                   checkpoint_dir=ckpt_dir),
            world=int(p.get("world", 1)), rank=None)
        self.steps_done = int(self.progress.get("steps_done", 0))
        self.losses: List[float] = list(self.progress.get("losses", []))
        if self.steps_done:
            if not self.trainer.restore():
                raise RuntimeError(
                    f"job {job['id']}: {self.steps_done} steps recorded "
                    f"but no checkpoint in {ckpt_dir} — cannot resume")

    def _batch(self, i: int):
        n = len(self.x)
        idx = [self._perm[(i * self.batch_size + j) % n]
               for j in range(self.batch_size)]
        return self.x[idx], self.y[idx]

    def step(self) -> bool:
        x, y = self._batch(self.steps_done)
        self.losses.append(float(self.trainer.step(x, y)))
        # the loss was read before the update was applied: wait for that too
        _sync(self.trainer.net)
        self.steps_done += 1
        return self.steps_done >= self.total_steps

    def checkpoint(self) -> Dict[str, Any]:
        self.trainer._checkpoint(int(self.trainer.net._iteration))
        self.progress = {"steps_done": self.steps_done,
                         "losses": self.losses}
        return dict(self.progress)

    def result(self) -> Dict[str, Any]:
        out = self.payload.get("out")
        if out:
            from deeplearning4j_tpu_torch.train.checkpoint import atomic_save_model
            atomic_save_model(self.trainer.net, out)
        return {"steps": self.steps_done, "losses": self.losses,
                "final_loss": self.losses[-1] if self.losses else None,
                "out": out}


class EvalRun(JobRun):
    """``eval``: a golden set (or npz dataset) through the registry's
    REAL batcher path — the accuracy serving would deliver, not a
    flattering direct ``net.output``. One chunk per step, which ends in the
    host read of the batcher's answer."""

    exclusive_device = False

    def __init__(self, job, ctx):
        super().__init__(job, ctx)
        p = self.payload
        if ctx.registry is None:
            raise RuntimeError("eval job needs a live registry")
        self.model = p["model"]
        if p.get("golden"):
            from deeplearning4j_tpu_torch.serving.delivery import GoldenSet
            gs = GoldenSet.load(p["golden"])
            self.x, self.labels = gs.inputs, gs.labels
        else:
            data = np.load(p["data"])
            self.x = _features(data["x"])
            self.labels = (np.asarray(data["labels"])
                           if "labels" in data else None)
        self.chunk = int(p.get("batch_size", 16))
        self.done_rows = int(self.progress.get("done_rows", 0))
        self.correct = int(self.progress.get("correct", 0))

    def step(self) -> bool:
        lo = self.done_rows
        hi = min(lo + self.chunk, len(self.x))
        probs = np.asarray(self.ctx.registry.predict(
            self.model, self.x[lo:hi]))
        if self.labels is not None:
            self.correct += int(
                (probs.argmax(-1) == np.asarray(
                    self.labels[lo:hi])).sum())
        self.done_rows = hi
        return self.done_rows >= len(self.x)

    def checkpoint(self) -> Dict[str, Any]:
        self.progress = {"done_rows": self.done_rows,
                         "correct": self.correct}
        return dict(self.progress)

    def result(self) -> Dict[str, Any]:
        out = {"model": self.model, "examples": self.done_rows}
        if self.labels is not None and self.done_rows:
            out["accuracy"] = round(self.correct / self.done_rows, 6)
        return out


class ScoreRun(JobRun):
    """``score``: offline batch scoring — an archive's outputs over an
    npz dataset, written (atomically) to an output npz."""

    def __init__(self, job, ctx):
        super().__init__(job, ctx)
        from deeplearning4j_tpu_torch.models import MultiLayerNetwork
        p = self.payload
        data = np.load(p["data"])
        self.x = _features(data["x"])
        self.chunk = int(p.get("batch_size", 16))
        self.net = MultiLayerNetwork.load(p["archive"])
        self.done_rows = int(self.progress.get("done_rows", 0))
        self.outputs: List[np.ndarray] = []
        if self.done_rows:
            # deterministic recompute of the finished prefix: outputs are
            # pure functions of (frozen archive, rows), so a resume can
            # rebuild them instead of spilling partial results
            for lo in range(0, self.done_rows, self.chunk):
                hi = min(lo + self.chunk, self.done_rows)
                self.outputs.append(_host(self.net.output(self.x[lo:hi])))

    def step(self) -> bool:
        lo = self.done_rows
        hi = min(lo + self.chunk, len(self.x))
        # the host read waits for the card: the step ends synchronised
        self.outputs.append(_host(self.net.output(self.x[lo:hi])))
        self.done_rows = hi
        return self.done_rows >= len(self.x)

    def checkpoint(self) -> Dict[str, Any]:
        self.progress = {"done_rows": self.done_rows}
        return dict(self.progress)

    def result(self) -> Dict[str, Any]:
        outputs = (np.concatenate(self.outputs, axis=0)
                   if self.outputs else np.zeros((0,), np.float32))
        out = self.payload.get("out")
        if out:
            _atomic_savez(out, outputs=outputs)
        return {"examples": self.done_rows, "out": out}


class SweepRun(JobRun):
    """``sweep``: the Arbiter analog — random or grid search over
    builder-config space (:func:`build_net_from_spec` knobs). One TRIAL
    per step, so preemption lands on trial boundaries and resume re-runs
    nothing: the trial sequence is a pure function of (space, mode,
    seed), and each trial's own training is seeded by its spec."""

    def __init__(self, job, ctx):
        super().__init__(job, ctx)
        p = self.payload
        data = np.load(p["data"])
        self.x = _features(data["x"])
        self.y = np.asarray(data["y"], np.float32)
        self.base = dict(p.get("base") or {})
        self.base.setdefault("nin", self.x.shape[-1])
        self.base.setdefault("nout", self.y.shape[-1])
        self.steps = int(p.get("steps", 10))
        self.batch_size = int(p.get("batch_size", min(8, len(self.x))))
        self.trial_params = self._trial_sequence(
            dict(p.get("space") or {}), p.get("mode", "grid"),
            int(p.get("trials", 8)), int(p.get("seed", 0)))
        self.trials_done = int(self.progress.get("trials_done", 0))
        self.results: List[Dict[str, Any]] = list(
            self.progress.get("results", []))

    @staticmethod
    def _trial_sequence(space: Dict[str, List[Any]], mode: str,
                        trials: int, seed: int) -> List[Dict[str, Any]]:
        keys = sorted(space)
        if mode == "grid":
            return [dict(zip(keys, combo)) for combo in
                    itertools.product(*(space[k] for k in keys))]
        rng = random.Random(seed)
        return [{k: rng.choice(space[k]) for k in keys}
                for _ in range(trials)]

    def step(self) -> bool:
        spec = {**self.base, **self.trial_params[self.trials_done]}
        net = build_net_from_spec(spec)
        n = len(self.x)
        for i in range(self.steps):
            lo = (i * self.batch_size) % n
            idx = [(lo + j) % n for j in range(self.batch_size)]
            net.fit(self.x[idx], self.y[idx])
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        # score() reads the loss back to the host: the trial ends synchronised
        score = float(net.score(DataSet(self.x, self.y)))
        self.results.append({"params": spec, "score": round(score, 9)})
        self.trials_done += 1
        return self.trials_done >= len(self.trial_params)

    def checkpoint(self) -> Dict[str, Any]:
        self.progress = {"trials_done": self.trials_done,
                         "results": self.results}
        return dict(self.progress)

    def result(self) -> Dict[str, Any]:
        best = (min(self.results, key=lambda r: r["score"])
                if self.results else None)
        return {"trials": self.trials_done, "results": self.results,
                "best": best}


class FlywheelRun(JobRun):
    """``flywheel`` (ROADMAP item 5's learning half): labeled examples
    from the feedback file (live + keep-1 rollover) become a
    transfer-learning fine-tune — base archive grafted through
    ``TransferLearning``, fed through the :class:`DevicePrefetcher`
    training feed (``prefetch_buffer``), early-stopped on held-in loss —
    and the candidate archive (golden sidecar carried over) re-enters
    gated delivery through the injected ``deploy_fn``. One EPOCH per
    step; preemption checkpoints the net archive atomically."""

    def __init__(self, job, ctx):
        super().__init__(job, ctx)
        from deeplearning4j_tpu_torch.models import (FineTuneConfiguration,
                                               MultiLayerNetwork,
                                               TransferLearning)
        from deeplearning4j_tpu_torch.serving.delivery import (
            iter_feedback_examples)
        from deeplearning4j_tpu_torch.train import Sgd
        p = self.payload
        path = p.get("feedback_file") or os.environ.get(
            "DL4J_TPU_FEEDBACK_FILE")
        if not path:
            raise RuntimeError("flywheel job needs a feedback file "
                               "(payload or DL4J_TPU_FEEDBACK_FILE)")
        model_filter = p.get("model")
        rows = [r for r in iter_feedback_examples(path)
                if r.get("inputs") is not None
                and r.get("label") is not None
                and (model_filter is None
                     or r.get("model") == model_filter)]
        self.n_examples = len(rows)
        self.min_examples = int(p.get("min_examples", 4))
        self.base_archive = p["base_archive"]
        self.out_archive = p.get("out_archive",
                                 f"{self.base_archive}.flywheel.zip")
        self.ckpt = f"{self.out_archive}.job-{job['id']}.ckpt.zip"
        self.max_epochs = int(p.get("max_epochs", 20))
        self.patience = int(p.get("patience", 3))
        self.prefetch_buffer = int(p.get("prefetch_buffer", 2))
        self.batch_size = int(p.get("batch_size", 8))
        self.epochs_done = int(self.progress.get("epochs_done", 0))
        self.best_score = self.progress.get("best_score")
        self.bad_epochs = int(self.progress.get("bad_epochs", 0))
        self._stopped = bool(self.progress.get("stopped", False))
        if self.n_examples < self.min_examples:
            self.net = None
            return
        if self.epochs_done and os.path.exists(self.ckpt):
            self.net = MultiLayerNetwork.load(self.ckpt,
                                              load_updater=True)
        else:
            base = MultiLayerNetwork.load(self.base_archive)
            b = TransferLearning.builder(base).fine_tune_configuration(
                FineTuneConfiguration(updater=Sgd(float(p.get("lr", 0.05)))))
            if p.get("freeze_up_to") is not None:
                b = b.set_feature_extractor(int(p["freeze_up_to"]))
            self.net = b.build()
        nout = int(self.net.conf.layers[-1].n_out)
        self.x = _features([r["inputs"] for r in rows])
        self.y = _one_hot([int(r["label"]) for r in rows], nout)

    def _iterator(self):
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
        sets = [DataSet(self.x[lo:lo + self.batch_size],
                        self.y[lo:lo + self.batch_size])
                for lo in range(0, len(self.x), self.batch_size)]
        return ListDataSetIterator(sets, batch_size=self.batch_size)

    def step(self) -> bool:
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        if self.net is None or self._stopped:
            return True
        # the flywheel's feed goes through the DevicePrefetcher path —
        # same staged-on-device pipeline full training uses
        self.net.fit(self._iterator(), epochs=1,
                     prefetch_buffer=self.prefetch_buffer)
        # score() reads the loss back to the host: the epoch ends synchronised
        score = float(self.net.score(DataSet(self.x, self.y)))
        self.epochs_done += 1
        if self.best_score is None or score < self.best_score - 1e-12:
            self.best_score = score
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if (self.epochs_done >= self.max_epochs
                or self.bad_epochs >= self.patience):
            self._stopped = True
        return self._stopped

    def checkpoint(self) -> Dict[str, Any]:
        if self.net is not None:
            from deeplearning4j_tpu_torch.train.checkpoint import atomic_save_model
            atomic_save_model(self.net, self.ckpt)
        self.progress = {"epochs_done": self.epochs_done,
                         "best_score": self.best_score,
                         "bad_epochs": self.bad_epochs,
                         "stopped": self._stopped}
        return dict(self.progress)

    def result(self) -> Dict[str, Any]:
        if self.net is None:
            return {"status": "insufficient_data",
                    "examples": self.n_examples,
                    "min_examples": self.min_examples}
        from deeplearning4j_tpu_torch.serving.delivery import GoldenSet
        from deeplearning4j_tpu_torch.train.checkpoint import atomic_save_model
        atomic_save_model(self.net, self.out_archive)
        # the candidate inherits its deploy bar: the base archive's
        # golden sidecar rides along so the gated pipeline can gate it
        golden = GoldenSet.for_archive(self.base_archive)
        if golden is not None:
            golden.save(GoldenSet.sidecar(self.out_archive))
        out = {"status": "trained", "examples": self.n_examples,
               "epochs": self.epochs_done,
               "best_score": self.best_score,
               "archive": self.out_archive, "deployed": False}
        if self.ctx.deploy_fn is not None:
            report = self.ctx.deploy_fn(self.out_archive, self.payload)
            out["deployed"] = True
            out["deploy"] = report
        return out


#: runner registry (type -> JobRun subclass); extendable per Scheduler
JOB_RUNNERS: Dict[str, type] = {
    "finetune": FineTuneRun,
    "eval": EvalRun,
    "score": ScoreRun,
    "sweep": SweepRun,
    "flywheel": FlywheelRun,
}


# ============================================================ scheduler
class Scheduler:
    """One worker's harvest loop: a ``fleet-scheduler`` control thread
    ticking every ``tick_s``, admitting at most one background job when
    the signals show slack and preempting it within one tick when they
    stop. Callable tick-by-tick without the thread (tests drive
    :meth:`tick` directly under a fake signal)."""

    def __init__(self, store: JobStore, signals=None,
                 worker_id: str = "worker", registry=None,
                 config: Optional[SchedulerConfig] = None,
                 deploy_fn=None, runners: Optional[Dict[str, type]] = None):
        self.store = store
        self.worker_id = worker_id
        self.config = config or SchedulerConfig()
        if signals is None and registry is not None:
            signals = capacity_signals(registry)
        self._signals = signals or (lambda: {})
        self._runners = dict(JOB_RUNNERS)
        if runners:
            self._runners.update(runners)
        self.ctx = JobContext(registry=registry, deploy_fn=deploy_fn,
                              scheduler=self)
        self._lock = threading.Lock()  # guards: (_active, _job_thread,
        #   _harvested_busy_s, counters) against tick/job/scrape threads
        self._stop = threading.Event()
        self._preempt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._job_thread: Optional[threading.Thread] = None
        self._active: Optional[Dict[str, Any]] = None
        self._harvested_busy_s = 0.0
        self._counters = {"completed_total": 0, "failed_total": 0,
                          "preemptions_total": 0, "resumes_total": 0,
                          "claims_won_total": 0, "claims_lost_total": 0,
                          "admission_blocked_total": 0,
                          "cancelled_total": 0}
        self._last_preempt: Optional[Dict[str, float]] = None

    # ---- lifecycle -----------------------------------------------------
    def start(self) -> "Scheduler":
        from deeplearning4j_tpu_torch.serving import capacity
        capacity.attach_harvest(self.harvest_snapshot)
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"fleet-scheduler-{self.worker_id}",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the control loop; a running job is preempted (and
        checkpointed) first, so nothing is lost and a later scheduler
        resumes it exactly."""
        from deeplearning4j_tpu_torch.serving import capacity
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.config.preempt_join_s + 5.0)
            self._thread = None
        self._preempt_active("shutdown")
        capacity.detach_harvest()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                logger.exception("scheduler tick failed")
            self._stop.wait(self.config.tick_s)

    # ---- admission / preemption ---------------------------------------
    def _has_slack(self, sig: Dict[str, Any]) -> bool:
        cfg = self.config
        if float(sig.get("busy_fraction", 0.0)) > cfg.max_busy_fraction:
            return False
        if int(sig.get("queue_depth", 0)) > cfg.max_queue_depth:
            return False
        headroom = sig.get("queue_headroom")
        if headroom is not None and int(headroom) < cfg.min_queue_headroom:
            return False
        if float(sig.get("fast_burn", 0.0)) > cfg.max_fast_burn:
            return False
        return True

    def tick(self) -> Optional[str]:
        """One control decision. Returns what it did (for tests):
        ``"preempted"``, ``"started"``, ``"resumed"``, ``"blocked"``,
        ``"running"`` or ``None`` (idle, nothing to do)."""
        try:
            sig = self._signals() or {}
        except Exception:
            sig = {}  # a broken signal source reads as "no slack info"
        slack = self._has_slack(sig)
        with self._lock:
            active = self._active
            job_thread = self._job_thread
        if active is not None:
            if job_thread is not None and not job_thread.is_alive():
                with self._lock:  # job finished on its own
                    self._job_thread = None
                    self._active = None
                return None
            if not slack:
                t0 = time.monotonic()
                self._preempt_active("traffic")
                self._last_preempt = {
                    "signals": sig,
                    "join_s": round(time.monotonic() - t0, 6)}
                return "preempted"
            return "running"
        if not slack:
            with self._lock:
                self._counters["admission_blocked_total"] += 1
            return "blocked"
        return self._admit()

    def _admit(self) -> Optional[str]:
        jobs = self.store.jobs()
        # own preempted work resumes before new work starts: finishing
        # a half-done fine-tune beats fanning out
        mine = sorted((j for j in jobs.values()
                       if j["state"] == "preempted"
                       and j.get("owner") == self.worker_id),
                      key=lambda j: (-j["priority"], j["id"]))
        for job in mine:
            rec = self.store.update(job["id"], state="resumed")
            if rec is not None:
                with self._lock:
                    self._counters["resumes_total"] += 1
                self._launch(rec)
                return "resumed"
        pending = sorted((j for j in jobs.values()
                          if j["state"] == "submitted"),
                         key=lambda j: (-j["priority"], j["id"]))
        for job in pending:
            won = self.store.claim(job["id"], self.worker_id)
            with self._lock:
                self._counters["claims_won_total" if won
                               else "claims_lost_total"] += 1
            if won:
                rec = self.store.update(job["id"], state="started")
                if rec is None:
                    continue  # cancelled between claim and start
                self._launch(rec)
                return "started"
        return None

    def _launch(self, job: Dict[str, Any]) -> None:
        self._preempt.clear()
        t = threading.Thread(
            target=self._run_job, args=(job,),
            name=f"fleet-scheduler-job-{job['id']}", daemon=True)
        with self._lock:
            self._active = job
            self._job_thread = t
        t.start()

    def _preempt_active(self, cause: str) -> None:
        with self._lock:
            t = self._job_thread
            active = self._active
        if t is None or active is None:
            return
        self._preempt.set()
        t.join(timeout=self.config.preempt_join_s)
        with self._lock:
            self._job_thread = None
            self._active = None
            self._counters["preemptions_total"] += 1

    # ---- the job thread ------------------------------------------------
    def _run_job(self, job: Dict[str, Any]) -> None:
        job_id = job["id"]
        if self.config.job_nice is not None:
            try:
                os.setpriority(os.PRIO_PROCESS,
                               threading.get_native_id(),
                               self.config.job_nice)
            except (AttributeError, OSError):
                pass  # not Linux / not permitted: pacing still applies
        try:
            runner = self._runners[job["type"]](job, self.ctx)
        except Exception as e:
            logger.exception("job %s failed to build", job_id)
            self.store.update(job_id, state="failed", error=str(e))
            with self._lock:
                self._counters["failed_total"] += 1
            return
        while True:
            if self._preempt.is_set():
                try:
                    progress = runner.checkpoint()
                except Exception as e:
                    self.store.update(job_id, state="failed",
                                      error=f"checkpoint failed: {e}")
                    with self._lock:
                        self._counters["failed_total"] += 1
                    return
                self.store.update(job_id, state="preempted",
                                  progress=progress)
                return
            rec = self.store.get(job_id)
            if rec is not None and rec["state"] == "cancelled":
                with self._lock:
                    self._counters["cancelled_total"] += 1
                return  # cancel already journaled by the store
            t0 = time.perf_counter()
            try:
                # a device step and a serving capture exclude each other
                with (CAPTURE_LOCK if getattr(runner, "exclusive_device", True)
                      else contextlib.nullcontext()):
                    done = runner.step()
            except Exception as e:
                logger.exception("job %s step failed", job_id)
                self.store.update(job_id, state="failed", error=str(e))
                with self._lock:
                    self._counters["failed_total"] += 1
                return
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self._harvested_busy_s += dt
            if done:
                try:
                    result = runner.result()
                except Exception as e:
                    logger.exception("job %s finalize failed", job_id)
                    self.store.update(job_id, state="failed",
                                      error=str(e))
                    with self._lock:
                        self._counters["failed_total"] += 1
                    return
                self.store.update(job_id, state="completed",
                                  progress=runner.progress,
                                  result=result)
                with self._lock:
                    self._counters["completed_total"] += 1
                return
            duty = self.config.duty_fraction
            if duty < 1.0:
                # hold the measured duty cycle: a step that took dt is
                # followed by dt*(1-d)/d of yield, so harvest never
                # claims more than `duty` of wall time from the cores
                # serving shares. Waiting on the preempt flag keeps
                # preemption within one control tick even mid-pause.
                self._preempt.wait(min(1.0, dt * (1.0 - duty) / duty))

    # ---- observability -------------------------------------------------
    def harvest_snapshot(self) -> Dict[str, Any]:
        """What :mod:`serving.capacity` folds into ``/v1/capacity``: the
        measured harvested busy seconds plus the job/claim counters and
        the active job (one glance says what the idle time bought)."""
        with self._lock:
            running = (self._job_thread is not None
                       and self._job_thread.is_alive())
            snap: Dict[str, Any] = {
                "worker": self.worker_id,
                "harvested_busy_s": round(self._harvested_busy_s, 6),
                "active_job": (self._active or {}).get("id")
                if running else None,
                **dict(self._counters),
            }
        if self._last_preempt is not None:
            snap["last_preempt_join_s"] = self._last_preempt["join_s"]
        snap["config"] = self.config.to_dict()
        states: Dict[str, int] = {}
        try:
            for j in self.store.jobs().values():
                states[j["state"]] = states.get(j["state"], 0) + 1
        except Exception:
            pass  # a torn store read must not break a scrape
        snap["jobs"] = states
        return snap

    def reset_harvest(self) -> None:
        """Zero the harvested-seconds counter (aligns the harvest window
        with a serving metrics ``reset_window`` for A/B measurement)."""
        with self._lock:
            self._harvested_busy_s = 0.0


def render_prometheus(snap: Dict[str, Any]) -> str:
    """``scheduler_*`` gauges from a :meth:`Scheduler.harvest_snapshot`
    (the worker ``/metrics`` section when a scheduler is attached)."""
    lines = ["# TYPE scheduler_harvested_busy_s gauge",
             f"scheduler_harvested_busy_s {snap['harvested_busy_s']}",
             f"scheduler_active {int(snap.get('active_job') is not None)}"]
    for c in ("completed_total", "failed_total", "preemptions_total",
              "resumes_total", "claims_won_total", "claims_lost_total",
              "admission_blocked_total", "cancelled_total"):
        if c in snap:
            lines.append(f"scheduler_{c} {snap[c]}")
    for state, n in sorted((snap.get("jobs") or {}).items()):
        lines.append(f'scheduler_jobs{{state="{state}"}} {n}')
    return "\n".join(lines) + "\n"
