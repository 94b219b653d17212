"""Multi-process data-parallel trainer with threshold-encoded gradient
exchange (the reference's ``SharedTrainingMaster`` encoded-update path).

Counterpart of ``deeplearning4j_tpu/train/distributed.py``. Each step every
rank computes its shard's gradient (scaled by ``1/world``), threshold-encodes
it with the host codec (:mod:`~deeplearning4j_tpu_torch.native`; sparse or
2-bit bitmap, whichever is predicted smaller, the unsent remainder kept in
the rank's residual), frames it with a CRC32 header, allgathers the frames
in two phases (sizes, then payloads padded to the round's max) and decodes
every rank's frame in rank order into the combined update, which the
network's own optimizer applies. ``threshold == 0`` selects the dense
float32 transport. A corrupted or failed exchange raises
:class:`ExchangeError`, never a silent divergence.

- :class:`CollectiveExchange` moves the frames over ``torch.distributed``
  (gloo, host byte tensors; :func:`~..runtime.mesh.initialize_multihost`
  joins the group), whether the ranks compute on the CPU or on a card —
  two ranks may share one card, which NCCL would refuse.
- :class:`DistributedTrainer` steps through captured graphs on the card
  (:class:`~..runtime.compile_cache.AotCache`: the local gradient, and the
  update), takes an optional ``plan`` that splits the local step over this
  process's mesh (fsdp/tensor; the cross-process exchange stays the data
  axis), overlaps the exchange with the next step's compute
  (``overlap_window=1``), re-broadcasts rank 0's parameters
  (``resync_every``), and checkpoints with per-rank residuals for an exact
  resume.
- :class:`DistributedSupervisor` launches the workers with ``subprocess``,
  watches exit codes and heartbeat files, and on a death or a stall kills
  the group and relaunches it on a fresh port, within a restart budget.

Determinism contract: every rank iterates the same global batches and
slices its rows, so the loopback oracle (``rank=None``: one process
simulates every rank, with per-rank residuals and the same rank-order
combine) is the N-process trajectory bit for bit. Every reduction is a
gather and a sum in fixed rank order.

Chaos points: ``train.distributed.exchange`` fires once per step before the
exchange; ``train.distributed.exchange.bytes`` passes each encoded payload
through byte corruption after its CRC is taken.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import struct
import subprocess
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.native import TreeCodec
from deeplearning4j_tpu_torch.runtime import chaos, trace
from deeplearning4j_tpu_torch.runtime.compile_cache import AotCache
from deeplearning4j_tpu_torch.runtime.profiler import ExchangeStats
from deeplearning4j_tpu_torch.runtime.state_packing import assign_state
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_unflatten_like
from deeplearning4j_tpu_torch.train.checkpoint import (CheckpointListener, atomic_save_model,
                                                       load_manifest, write_manifest)
from deeplearning4j_tpu_torch.train.fault_tolerance import HeartbeatMonitor, TrainingFailure

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<iiIf")  # format, payload nbytes, crc32, local loss


class ExchangeError(RuntimeError):
    """A gradient exchange failed or arrived corrupted. Fatal to the step:
    the worker must die and restart from a checkpoint."""


# --------------------------------------------------------------------------
# process-group plumbing shared by the supervisor, tests and chip_smoke.py
def free_port() -> str:
    """An OS-assigned free TCP port for the process group's rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def worker_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment for a worker subprocess: this one with the repository
    on ``PYTHONPATH``."""
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    if extra:
        env.update(extra)
    return env


_children_lock = threading.Lock()  # guards: _children
_children: List[subprocess.Popen] = []


def _track_child(proc: subprocess.Popen) -> None:
    with _children_lock:
        _children.append(proc)


def live_worker_pids() -> List[int]:
    """PIDs of worker subprocesses launched here that are still alive."""
    with _children_lock:
        _children[:] = [p for p in _children if p.poll() is None]
        return [p.pid for p in _children]


def kill_stray_workers() -> List[int]:
    """Kill every still-live tracked worker; returns their PIDs."""
    with _children_lock:
        stray = [p for p in _children if p.poll() is None]
        for p in stray:
            try:
                p.kill()
            except OSError:
                pass
        for p in stray:
            try:
                p.wait(timeout=10)
            except Exception:
                pass
        _children[:] = [p for p in _children if p.poll() is None]
    return [p.pid for p in stray]


# --------------------------------------------------------------------------
# transports
class CollectiveExchange:
    """The multi-process transport over ``torch.distributed`` (gloo). Pure
    data movement: gathers are bit-exact, and the combine happens on the
    host in rank order. Outside a process group it is the one-process
    degenerate case."""

    def __init__(self):
        import torch.distributed as dist
        self._dist = dist
        self._group = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if self._group else 1
        self.rank = dist.get_rank() if self._group else 0

    def gather_bytes(self, payload: bytes) -> List[bytes]:
        """Allgather one variable-length payload per rank: sizes first,
        then payloads padded to the round's max."""
        if not self._group:
            return [payload]
        dist = self._dist
        size = torch.tensor([len(payload)], dtype=torch.int64)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(self.world)]
        dist.all_gather(sizes, size)
        sizes = [int(s) for s in sizes]
        buf = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
        if payload:
            buf[:len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        out = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(out, buf)
        return [out[p][:sizes[p]].numpy().tobytes() for p in range(self.world)]

    def broadcast(self, arr: np.ndarray) -> np.ndarray:
        """Rank 0's array to everyone (parameter re-sync)."""
        if not self._group:
            return arr
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
        self._dist.broadcast(t, src=0)
        return t.numpy()

    def barrier(self, name: str) -> None:
        if self._group:
            self._dist.barrier()


class LoopbackExchange:
    """Single-process stand-in: the loopback oracle hands it every
    simulated rank's payload at once."""

    def __init__(self, world: int):
        self.world = int(world)
        self.rank = 0

    def gather_bytes(self, payloads: List[bytes]) -> List[bytes]:
        if len(payloads) != self.world:
            raise ExchangeError(f"loopback gather got {len(payloads)} payloads for "
                                f"world={self.world}")
        return list(payloads)

    def broadcast(self, arr: np.ndarray) -> np.ndarray:
        return arr

    def barrier(self, name: str) -> None:
        pass


# --------------------------------------------------------------------------
# the codec + transport layer
class GradientExchange:
    """Threshold-encoded gradient combine over a transport (JAX ``:229``);
    one per rank state. The frame is ``<format int32, nbytes int32, crc32
    uint32, loss f32>`` then the payload; the CRC is taken before the
    ``train.distributed.exchange.bytes`` chaos point, so injected corruption
    is what the receiver's check catches."""

    def __init__(self, codec: TreeCodec, stats: Optional[ExchangeStats] = None):
        self.codec = codec
        self.stats = stats or ExchangeStats()
        self.threshold = codec.threshold

    @property
    def dense(self) -> bool:
        return self.threshold == 0.0

    def make_payload(self, flat_contribution: np.ndarray, loss: float) -> bytes:
        """One rank's scaled gradient contribution as a framed payload
        (updates that rank's residual)."""
        t0 = time.perf_counter()
        if self.dense:
            fmt = TreeCodec.FORMAT_DENSE
            payload = np.ascontiguousarray(flat_contribution, np.float32).tobytes()
        else:
            fmt, payload = self.codec.encode(flat_contribution)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        payload = chaos.transform_bytes("train.distributed.exchange.bytes", payload)
        self.stats.record("encode", time.perf_counter() - t0)
        return _HEADER.pack(fmt, len(payload), crc, float(loss)) + payload

    def combine(self, frames: Sequence[bytes]) -> Tuple[np.ndarray, float]:
        """CRC-check every frame and decode-accumulate in rank order:
        ``(combined flat update, mean loss)``, the same bits on every rank
        and in the loopback oracle."""
        t0 = time.perf_counter()
        combined = np.zeros(self.codec.size, np.float32)
        loss_sum = 0.0
        for p, frame in enumerate(frames):
            if len(frame) < _HEADER.size:
                raise ExchangeError(f"short exchange frame from rank {p}: {len(frame)} bytes")
            fmt, nbytes, crc, loss = _HEADER.unpack(frame[:_HEADER.size])
            payload = frame[_HEADER.size:]
            if len(payload) != nbytes:
                raise ExchangeError(f"rank {p} frame declares {nbytes} payload bytes, "
                                    f"carries {len(payload)}")
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                raise ExchangeError(f"CRC mismatch in rank {p}'s encoded update — "
                                    "corrupted exchange")
            if fmt == TreeCodec.FORMAT_DENSE:
                contrib = np.frombuffer(payload, np.float32)
                if contrib.size != self.codec.size:
                    raise ExchangeError(f"rank {p} dense frame has {contrib.size} elements, "
                                        f"expected {self.codec.size}")
                combined += contrib
            else:
                self.codec.decode_into(fmt, payload, combined)
            loss_sum += loss
        self.stats.record("decode", time.perf_counter() - t0)
        return combined, loss_sum / max(1, len(frames))


# --------------------------------------------------------------------------
# trainer
@dataclasses.dataclass
class DistributedConfig:
    """Knobs of :class:`DistributedTrainer` (JAX ``:305``). ``threshold``
    is in units of the scaled per-rank contribution (0 = dense transport);
    ``resync_every`` re-broadcasts rank 0's parameters every N steps;
    ``checkpoint_every`` steps between checkpoints (rank 0 writes the
    archive, every rank its residual); ``overlap_window=1`` computes step
    k+1's gradients before step k's exchange is applied (a staleness-1
    schedule the loopback oracle runs too)."""

    threshold: float = 1e-3
    resync_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    keep_last: int = 3
    heartbeat_file: Optional[str] = None
    overlap_window: int = 0


class DistributedTrainer:
    """Data-parallel trainer: N lock-step ranks exchanging threshold-encoded
    updates (JAX ``:333``).

    Worker mode (inside a process group, or world 1 standalone): ``fit``
    takes a deterministic iterator of global batches, slices this rank's
    rows, computes the local gradient, exchanges and applies the combined
    update through the network's optimizer. Loopback mode (``rank=None``,
    explicit ``world``): one process simulates every rank — the reference
    the multi-process run is held to bit for bit.

    The network provides ``_loss`` and an optimizer (``MultiLayerNetwork``'s
    surface); single (x, y) workloads only.
    """

    def __init__(self, net, config: Optional[DistributedConfig] = None,
                 world: Optional[int] = None, rank: Optional[int] = -1, profiler=None,
                 plan=None):
        self.net = net
        self.config = config or DistributedConfig()
        if self.config.overlap_window not in (0, 1):
            raise ValueError("overlap_window supports 0 (synchronous) or 1 (one-deep in-flight "
                             "exchange window)")
        self.stats = ExchangeStats()
        self.profiler = profiler
        if profiler is not None:
            profiler.attach_exchange(self.stats)
        self.loopback = rank is None
        if self.loopback:
            if not world or world < 1:
                raise ValueError("loopback mode needs an explicit world size")
            self.world, self.rank = int(world), 0
            self.transport = LoopbackExchange(self.world)
        else:
            self.transport = CollectiveExchange()
            self.world = self.transport.world if world is None else int(world)
            self.rank = self.transport.rank if rank == -1 else int(rank)
            if self.world != self.transport.world:
                raise ValueError(f"world={self.world} but the process group has "
                                 f"{self.transport.world} ranks")
        net._ensure_init()
        self.plan = plan
        self._plan_state = None
        if plan is not None:
            if getattr(plan, "pipe_size", 1) > 1:
                raise NotImplementedError("DistributedTrainer shards the local step with "
                                          "fsdp/tensor axes; pipeline plans train through "
                                          "ParallelWrapper.fit")
            if tree_leaves(net._model_state):
                raise NotImplementedError("DistributedTrainer: layer state under a plan is "
                                          "not ported")
        self._leaves = tree_leaves(net._params)
        n_rank_states = self.world if self.loopback else 1
        self._exchanges = [GradientExchange(TreeCodec(self._leaves, self.config.threshold),
                                            stats=self.stats)
                           for _ in range(n_rank_states)]
        # per-rank layer state evolves from the rank's own rows; rank 0's is
        # the state of record
        self._rank_model_states = [net._model_state for _ in range(n_rank_states)]
        self._grad_aot = AotCache("distributed.grad")
        self._apply_aot = AotCache("distributed.apply")
        self.losses: List[float] = []
        self._inflight = None
        self._last_mean_loss: Optional[float] = None
        self._xchg_thread: Optional[threading.Thread] = None
        self._xchg_req = None
        self._xchg_res = None
        self._epoch_start_iters: Dict[int, int] = {}
        if self.config.checkpoint_dir:
            os.makedirs(self.config.checkpoint_dir, exist_ok=True)
            self._epoch_start_iters = self._load_epoch_starts()

    def reset_stats(self) -> ExchangeStats:
        """Start the encode/exchange/decode/apply split afresh (after warm-up
        steps, whose captures would weigh in the means); returns the new
        :class:`ExchangeStats`."""
        self.stats = ExchangeStats()
        for ex in self._exchanges:
            ex.stats = self.stats
        if self.profiler is not None:
            self.profiler.attach_exchange(self.stats)
        return self.stats

    # --------------------------------------------------------- step functions
    def _generator(self, seed: int):
        """The step's generator for one rank: every rank draws the same
        stream (as every JAX rank folds the same key)."""
        gen = getattr(self.net, "_device_gen", None)
        if self.net.device.type == "cuda" and gen is not None:
            return gen.manual_seed(seed)
        return torch.Generator(device="cpu").manual_seed(seed)

    def _sharded(self):
        if self._plan_state is None:
            from deeplearning4j_tpu_torch.parallel.sharding import shard_train_state
            self._plan_state = shard_train_state(self.net, self.plan)
        return self._plan_state

    def _grad_step(self, x, y, generator, state_leaves):
        """``(loss, flat float32 gradient, new layer state leaves)`` of one
        rank's rows, on the network's device; ``state_leaves`` are the
        rank's layer state, in the leaf order of the network's."""
        net = self.net
        model_state = tree_unflatten_like(net._model_state, list(state_leaves))
        if self.plan is not None:
            from deeplearning4j_tpu_torch.parallel.sharding import shard_batch_tree
            st = self._sharded()
            grads, losses, _ = st.replica_gradients(
                lambda rep, a, g: net._replica_loss(rep.tree, a, g),
                shard_batch_tree(self.plan, (x, y, None, None)), generator)
            full = st.full_gradients(grads)
            flat = torch.cat([g.reshape(-1).float() for g in full])
            return st.mean_loss(losses), flat, []
        leaves = tree_leaves(net._params)
        trained = [t for t in leaves if t.is_floating_point()]
        for t in trained:
            t.requires_grad_(True)
        try:
            loss, new_state, _ = net._loss(net._params, model_state, x, y, generator, None, None)
            grads = iter(torch.autograd.grad(loss, trained, allow_unused=True))
        finally:
            for t in trained:
                t.requires_grad_(False)
        parts = []
        for t in leaves:
            g = next(grads) if t.is_floating_point() else None
            parts.append(torch.zeros(t.numel(), dtype=torch.float32, device=t.device)
                         if g is None else g.reshape(-1).float())
        return loss.detach(), torch.cat(parts), tree_leaves(new_state)

    def _apply_step(self, flat):
        """The combined update through the network's optimizer, in place."""
        net = self.net
        leaves = tree_leaves(net._params)
        codec = self._exchanges[0].codec
        grads = [flat[lo:lo + sz].reshape(shape).to(t.dtype)
                 for lo, sz, shape, t in zip(codec.offsets.tolist(), codec.sizes, codec.shapes,
                                             leaves)]
        net._ensure_optimizer().step(net._params, tree_unflatten_like(net._params, grads))
        net._apply_constraints()

    def _local_grad(self, rank_ix: int, x, y, generator):
        """One rank's ``(loss, flat scaled gradient, exchange)`` through the
        captured-graph path."""
        net = self.net
        xt, yt = net._as_input(x), net._as_input(y)
        if self.plan is not None:
            self._sharded().load_params()
        state = self._rank_model_states[rank_ix]
        key = (tuple(xt.shape), xt.dtype, tuple(yt.shape),
               self.plan.signature() if self.plan is not None else None)
        self._grad_aot.generators = net._device_generators()
        loss, flat, new_leaves = self._grad_aot.call(key, self._grad_step, xt, yt, generator,
                                                     list(tree_leaves(state)))
        if new_leaves:
            self._rank_model_states[rank_ix] = tree_unflatten_like(state, list(new_leaves))
        ex = self._exchanges[rank_ix]
        flat = flat.cpu().numpy()
        # scale BEFORE encoding, so the decoded sum approximates the MEAN
        # gradient (the dense path's learning-rate semantics)
        flat /= np.float32(self.world)
        return float(loss), flat, ex

    def _apply(self, combined: np.ndarray) -> None:
        t0 = time.perf_counter()
        flat = torch.from_numpy(combined).to(self.net.device)
        self._apply_aot.call(("apply",), self._apply_step, flat)
        self.net._model_state = assign_state(self.net._model_state, self._rank_model_states[0])
        self.stats.record("apply", time.perf_counter() - t0)

    # ----------------------------------------------------------------- step
    def step(self, x: np.ndarray, y: np.ndarray) -> float:
        """One lock-step distributed step over one global batch; returns the
        combined (mean-of-ranks) loss. Runs inside a ``train.step`` span."""
        with trace.span("train.step") as tsp:
            if tsp.recording:
                tsp.set("rank", "loopback" if self.loopback else self.rank)
                tsp.set("world", self.world)
                tsp.set("step", int(self.net._iteration) + 1)
            return self._step_inner(x, y)

    def _step_inner(self, x, y) -> float:
        b = x.shape[0]
        if b % self.world:
            raise ValueError(f"global batch of {b} not divisible by world={self.world}")
        n_local = b // self.world
        net = self.net
        if net.device.type == "cuda" and getattr(net, "_device_gen", None) is None:
            net._seed_device_generator()
        seed = int(torch.randint(0, 2 ** 62, (), generator=net.rng.next_generator()))
        chaos.inject("train.distributed.exchange")
        if self.loopback:
            send, lsum = [], 0.0
            for r in range(self.world):
                lo = r * n_local
                loss, flat, ex = self._local_grad(r, x[lo:lo + n_local], y[lo:lo + n_local],
                                                  self._generator(seed))
                send.append(ex.make_payload(flat, loss))
                lsum += loss
            loss = lsum / self.world
        else:
            lo = self.rank * n_local
            loss, flat, ex = self._local_grad(0, x[lo:lo + n_local], y[lo:lo + n_local],
                                              self._generator(seed))
            send = ex.make_payload(flat, loss)
        handle = self._begin_gather(send)
        if self.config.overlap_window:
            prev, self._inflight = self._inflight, handle
            mean_loss = self._complete_exchange(prev) if prev is not None else float(loss)
        else:
            mean_loss = self._complete_exchange(handle)
        step_no = int(net._iteration) + 1
        net._iteration = step_no
        net._score = mean_loss
        if self.config.resync_every and step_no % self.config.resync_every == 0:
            self.flush()
            self.resync_params()
        if (self.config.checkpoint_every and self.config.checkpoint_dir
                and step_no % self.config.checkpoint_every == 0):
            self.flush()
            self._checkpoint(step_no)
        if self.config.heartbeat_file:
            self._beat(step_no)
        return mean_loss

    # --------------------------------------------------- overlapped exchange
    def _exchange_worker(self) -> None:
        while True:
            item = self._xchg_req.get()
            if item is None:
                return
            try:
                self._xchg_res.put(("ok", self.transport.gather_bytes(item)))
            except BaseException as e:
                self._xchg_res.put(("err", e))

    def _begin_gather(self, send):
        sent = len(send[0]) if isinstance(send, list) else len(send)
        if self.loopback or not self.config.overlap_window:
            t0 = time.perf_counter()
            frames = self.transport.gather_bytes(send)
            self.stats.record("exchange", time.perf_counter() - t0)
            return {"frames": frames, "sent": sent}
        if self._xchg_thread is None:
            self._xchg_req, self._xchg_res = queue.Queue(), queue.Queue()
            self._xchg_thread = threading.Thread(target=self._exchange_worker,
                                                 name="dist-exchange", daemon=True)
            self._xchg_thread.start()
        self._xchg_req.put(send)
        return {"frames": None, "sent": sent}

    def _complete_exchange(self, handle) -> float:
        frames = handle["frames"]
        if frames is None:
            t0 = time.perf_counter()
            status, payload = self._xchg_res.get()
            # the recorded exchange time is the WAIT: the overlap shows as ~0
            self.stats.record("exchange", time.perf_counter() - t0)
            if status == "err":
                raise payload
            frames = payload
        dense_bytes = 4 * self._exchanges[0].codec.size
        wire = max(len(f) for f in frames)  # the gather pads to the round max
        self.stats.record_bytes(dense_bytes, wire, handle["sent"])
        combined, mean_loss = self._exchanges[0].combine(frames)
        self._apply(combined)
        self.losses.append(mean_loss)
        self._last_mean_loss = mean_loss
        return mean_loss

    def flush(self) -> Optional[float]:
        """Combine and apply an in-flight exchange (``overlap_window``);
        ``None`` when nothing was pending."""
        if self._inflight is None:
            return None
        handle, self._inflight = self._inflight, None
        return self._complete_exchange(handle)

    def close(self) -> None:
        """Join the overlap exchange thread (a no-op when never started)."""
        if self._xchg_thread is not None:
            self._xchg_req.put(None)
            self._xchg_thread.join(timeout=10)
            self._xchg_thread = None

    def resync_params(self) -> None:
        """Re-broadcast rank 0's parameters to every rank (the drift bound;
        bit-transparent when the ranks are in lock-step)."""
        ex = self._exchanges[0]
        leaves = tree_leaves(self.net._params)
        flat = ex.codec.flatten([t.detach().float().cpu().numpy() for t in leaves])
        synced = self.transport.broadcast(flat)
        if synced is not flat:
            with torch.no_grad():
                for t, a in zip(leaves, ex.codec.unflatten(synced)):
                    t.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(t.dtype))

    # ------------------------------------------------------------------ fit
    def fit(self, iterator, epochs: int = 1):
        """The epoch loop over a deterministic global-batch iterator (every
        rank holds the same one). With a checkpoint directory a restarted
        worker restores first (:meth:`restore`) and skips the batches of the
        epoch in progress that it has already trained."""
        if self.profiler is not None:
            self.profiler.start()
        try:
            while self.net._epoch < int(epochs):
                e = int(self.net._epoch)
                start_iter = self._epoch_start_iters.get(e)
                if start_iter is None:
                    self._epoch_start_iters[e] = int(self.net._iteration)
                    self._save_epoch_starts()
                    skip = 0
                else:
                    skip = max(0, int(self.net._iteration) - start_iter)
                iterator.reset()
                seen = 0
                while iterator.has_next():
                    ds = iterator.next()
                    seen += 1
                    if seen <= skip:
                        continue  # deterministic replay into the void
                    t0 = time.perf_counter()
                    x, y = np.asarray(ds.features), np.asarray(ds.labels)
                    if self.profiler is not None:
                        self.profiler.record_data_wait(time.perf_counter() - t0)
                        t1 = time.perf_counter()
                        loss = self.step(x, y)
                        self.profiler.record_dispatch(time.perf_counter() - t1)
                    else:
                        loss = self.step(x, y)
                    for lst in self.net._listeners:
                        lst.iteration_done(self.net, self.net._iteration, self.net._epoch, loss)
                self.net._epoch = e + 1
                self.flush()
        finally:
            self.close()
            if self.profiler is not None:
                self.profiler.stop()
        return self.net

    # ---------------------------------------------------------- persistence
    def _beat(self, step_no: int) -> None:
        try:
            with open(self.config.heartbeat_file, "w") as f:
                f.write(str(step_no))
        except OSError:
            logger.warning("could not write heartbeat %s", self.config.heartbeat_file)

    def _residual_path(self, rank: int, step_no: int) -> str:
        return os.path.join(self.config.checkpoint_dir, f"exchange_r{rank}_s{step_no}.npz")

    def _checkpoint(self, step_no: int) -> None:
        """Group-consistent checkpoint: every rank's residual first, a
        barrier, then rank 0's archive — a committed archive at step k
        implies every rank's residual for step k is on disk."""
        cfg = self.config
        ranks = range(self.world) if self.loopback else [self.rank]
        for r in ranks:
            ex = self._exchanges[r if self.loopback else 0]
            path = self._residual_path(r, step_no)
            tmp = path + f".tmp.{os.getpid()}.npz"
            np.savez(tmp, residual=ex.codec.residual, step=step_no)
            os.replace(tmp, path)
        self.transport.barrier(f"ckpt-residuals-{step_no}")
        if self.loopback or self.rank == 0:
            archive = os.path.join(cfg.checkpoint_dir, f"checkpoint_{step_no}_dist.zip")
            entry = atomic_save_model(self.net, archive)
            manifest = load_manifest(cfg.checkpoint_dir)
            manifest[os.path.basename(archive)] = entry
            write_manifest(cfg.checkpoint_dir, manifest)
            self._prune(step_no)
        self.transport.barrier(f"ckpt-archive-{step_no}")

    def _prune(self, newest_step: int) -> None:
        cfg = self.config
        steps = sorted({s for s in (_dist_checkpoint_step(f)
                                    for f in os.listdir(cfg.checkpoint_dir)) if s is not None})
        manifest = load_manifest(cfg.checkpoint_dir)
        changed = False
        for s in steps[:-max(1, cfg.keep_last)]:
            for f in os.listdir(cfg.checkpoint_dir):
                if _dist_checkpoint_step(f) == s:
                    changed |= manifest.pop(f, None) is not None
                    try:
                        os.unlink(os.path.join(cfg.checkpoint_dir, f))
                    except OSError:
                        pass
        if changed:
            write_manifest(cfg.checkpoint_dir, manifest)

    def restore(self) -> bool:
        """Restore the newest valid checkpoint: the archive into the
        network, this rank's residual into its codec. True when one was
        restored; refuses an encoded-stream resume without its residual."""
        cfg = self.config
        if not cfg.checkpoint_dir:
            return False
        ckpt = CheckpointListener.last_checkpoint_in(cfg.checkpoint_dir)
        if ckpt is None:
            return False
        logger.warning("rank %d restoring from %s", self.rank, ckpt)
        net = self.net
        loaded = type(net).load(ckpt, device=net.device)
        with torch.no_grad():
            for dst, src in zip(tree_leaves(net._params), tree_leaves(loaded._params)):
                dst.copy_(src)
        net._model_state = assign_state(net._model_state, loaded._model_state)
        net._optimizer = None
        net._restored_updater_leaves = loaded._restored_updater_leaves
        net._iteration, net._epoch = loaded._iteration, loaded._epoch
        net.rng.set_state(loaded.rng.get_state())
        self._jit_reset()
        step_no = int(net._iteration)
        ranks = range(self.world) if self.loopback else [self.rank]
        for r in ranks:
            ex = self._exchanges[r if self.loopback else 0]
            try:
                blob = np.load(self._residual_path(r, step_no))
                if int(blob["step"]) != step_no:
                    raise ValueError("stale residual")
                ex.codec.residual = np.ascontiguousarray(blob["residual"], np.float32)
            except (OSError, ValueError, KeyError):
                if not ex.dense:
                    raise TrainingFailure(
                        f"rank {r}: no residual state for checkpoint step {step_no} — cannot "
                        "exact-resume the encoded stream") from None
        self._inflight = None
        self._last_mean_loss = None
        self._rank_model_states = [net._model_state for _ in self._rank_model_states]
        self._epoch_start_iters = self._load_epoch_starts()
        return True

    def _jit_reset(self) -> None:
        self._grad_aot.clear()
        self._apply_aot.clear()
        self._plan_state = None

    def _epoch_starts_path(self) -> str:
        return os.path.join(self.config.checkpoint_dir, "trainer_state.json")

    def _load_epoch_starts(self) -> Dict[int, int]:
        try:
            with open(self._epoch_starts_path()) as f:
                return {int(k): int(v) for k, v in json.load(f)["epoch_start_iters"].items()}
        except (OSError, ValueError, KeyError, TypeError):
            return {}

    def _save_epoch_starts(self) -> None:
        if not self.config.checkpoint_dir or (self.rank != 0 and not self.loopback):
            return
        path = self._epoch_starts_path()
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"epoch_start_iters": self._epoch_start_iters}, f)
            os.replace(tmp, path)
        except OSError:
            logger.warning("could not persist trainer state to %s", path)


def _dist_checkpoint_step(filename: str) -> Optional[int]:
    """Step number of a distributed checkpoint file (archive or residual)."""
    if filename.startswith("checkpoint_") and filename.endswith("_dist.zip"):
        mid = filename[len("checkpoint_"):-len("_dist.zip")]
        return int(mid) if mid.isdigit() else None
    if filename.startswith("exchange_r") and filename.endswith(".npz"):
        parts = filename[:-len(".npz")].split("_s")
        return int(parts[-1]) if parts[-1].isdigit() else None
    return None


# --------------------------------------------------------------------------
# supervisor
class DistributedSupervisor:
    """Launch, watch and restart a local multi-process training group (JAX
    ``:873``): a lost worker stalls every peer in the collective, so
    recovery is kill the group, re-form it on a fresh port, relaunch, and
    let the workers restore the newest checkpoint.

    ``make_argv(rank, port)`` is a worker's full argv; its script calls
    :func:`~..runtime.mesh.initialize_multihost` with that port and runs a
    :class:`DistributedTrainer`. Workers start with ``subprocess`` (never a
    fork of a process whose CUDA context is up). Heartbeat files written by
    the workers (``DistributedConfig.heartbeat_file``) beat one
    :class:`~.fault_tolerance.HeartbeatMonitor`; a death (exit code) or a
    stall (stale heartbeats) starts a restart round, within
    ``max_restarts`` (per ``restart_window_s`` if given)."""

    def __init__(self, make_argv: Callable[[int, str], List[str]], num_processes: int,
                 heartbeat_files: Sequence[str], max_restarts: int = 3,
                 restart_window_s: Optional[float] = None, heartbeat_timeout_s: float = 120.0,
                 poll_s: float = 0.2, env: Optional[Dict[str, str]] = None):
        self.make_argv = make_argv
        self.num_processes = int(num_processes)
        self.heartbeat_files = [str(h) for h in heartbeat_files]
        self.max_restarts = int(max_restarts)
        self.restart_window_s = restart_window_s
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.poll_s = float(poll_s)
        self.env = env
        self.restarts = 0
        self._restart_times: deque = deque()
        self.rounds: List[Dict[str, object]] = []

    def _launch(self, port: str) -> List[subprocess.Popen]:
        """One worker per rank; output to temporary files (a full pipe would
        block a worker mid-step and read as a stall)."""
        import tempfile
        env = self.env if self.env is not None else worker_env()
        procs = []
        for rank in range(self.num_processes):
            out_f = tempfile.NamedTemporaryFile(mode="w+", prefix=f"dl4j-dist-r{rank}-out-",
                                                delete=False)
            err_f = tempfile.NamedTemporaryFile(mode="w+", prefix=f"dl4j-dist-r{rank}-err-",
                                                delete=False)
            p = subprocess.Popen(self.make_argv(rank, port), env=env, text=True, stdout=out_f,
                                 stderr=err_f)
            p._dl4j_capture = (out_f, err_f)  # type: ignore[attr-defined]
            _track_child(p)
            procs.append(p)
        return procs

    @staticmethod
    def _collect(p: subprocess.Popen) -> Tuple[str, str]:
        """Reap one exited worker: its ``(stdout, stderr)``."""
        try:
            p.wait(timeout=60)
        except Exception:
            p.kill()
        texts = []
        for f in getattr(p, "_dl4j_capture", ()):
            try:
                f.flush()
                f.seek(0)
                texts.append(f.read())
            except (OSError, ValueError):
                texts.append("")
            finally:
                try:
                    f.close()
                    os.unlink(f.name)
                except OSError:
                    pass
        return tuple(texts) if len(texts) == 2 else ("", "")

    @classmethod
    def _kill_group(cls, procs: List[subprocess.Popen]) -> List[Tuple[str, str]]:
        for p in procs:
            if p.poll() is None:
                p.kill()
        return [cls._collect(p) for p in procs]

    def _register_restart(self, cause: str) -> None:
        now = time.monotonic()
        self.restarts += 1
        self._restart_times.append(now)
        if self.restart_window_s is not None:
            while self._restart_times and now - self._restart_times[0] > self.restart_window_s:
                self._restart_times.popleft()
            recent = len(self._restart_times)
            budget = f"{self.max_restarts} restarts in {self.restart_window_s:.0f}s"
        else:
            recent = self.restarts
            budget = f"{self.max_restarts} restarts"
        if recent > self.max_restarts:
            raise TrainingFailure(f"distributed training giving up after {budget} (last "
                                  f"cause: {cause})")
        logger.warning("distributed group failed (%s); restart %d within budget %s", cause,
                       recent, budget)

    def run(self, round_timeout_s: float = 600.0) -> List[Tuple[str, str]]:
        """Supervise until a round finishes cleanly (every worker exits 0)
        or the restart budget runs out (:class:`TrainingFailure`). Returns
        the clean round's per-rank ``(stdout, stderr)``. The group is killed
        on every way out."""
        while True:
            port = free_port()
            procs = self._launch(port)
            monitor = HeartbeatMonitor(self.heartbeat_timeout_s)
            seen: Dict[int, float] = {}
            cause = None
            deadline = time.monotonic() + round_timeout_s
            done = False
            try:
                while True:
                    for i, hb in enumerate(self.heartbeat_files):
                        try:
                            m = os.stat(hb).st_mtime
                        except OSError:
                            continue
                        if seen.get(i) != m:
                            seen[i] = m
                            monitor.beat()
                    codes = [p.poll() for p in procs]
                    if any(c not in (None, 0) for c in codes):
                        cause = f"worker exited with codes {[c for c in codes if c is not None]}"
                        break
                    if all(c == 0 for c in codes):
                        outs = [self._collect(p) for p in procs]
                        self.rounds.append({"port": port, "outcome": "success"})
                        done = True
                        return outs
                    if self.heartbeat_files:
                        try:
                            monitor.check()
                        except TrainingFailure as e:
                            cause = f"stalled group: {e}"
                            break
                    if time.monotonic() > deadline:
                        cause = f"round timeout after {round_timeout_s:.0f}s"
                        break
                    time.sleep(self.poll_s)
            finally:
                if not done:
                    self._kill_group(procs)
            self.rounds.append({"port": port, "outcome": cause})
            self._register_restart(cause)
