"""Device replicas for the serving pipeline.

Counterpart of ``deeplearning4j_tpu/serving/replica.py``. A
:class:`Replica` is one copy of the served parameters and layer state, with
its own CUDA stream: on one device in the classic pool, or over a disjoint
group of ``plan.devices_per_replica()`` positions of the device list under
a :class:`~..parallel.sharding.ParallelPlan` (a plan slice; the plan's
``data`` axis is the replica fan-out). The replica's forward mirrors
``MultiLayerNetwork._forward`` / ``ComputationGraph._forward_all`` on the
replica's own tensors, as the JAX ``_output_fn`` mirrors ``output``, so a
replica's answer is ``model.output`` at the same bucket shape.

Plan slices: a slice with a ``pipe`` axis packs the network's trunk by
:class:`~..parallel.plan_exec.PipePlanExecutor` (one stage piece on each
pipe position) and runs the executor's serving forward
(:meth:`~..parallel.plan_exec.PipePlanExecutor.make_forward`); a tensor or
FSDP slice places the parameters by ``placements_of`` (tensor-split leaves
as :class:`~..nn.tensor_shards.TensorShards` pieces the attention layers
compute with where they lie, FSDP-split leaves stored in pieces and
gathered at use) and runs the network's own forward. Each slice captures
into its replica's own cache, keyed ``(index, plan.signature(), request
signature)``.

On a CUDA device each (replica, input signature) is captured once into a
``torch.cuda.CUDAGraph`` by the replica's own
:class:`~..runtime.compile_cache.AotCache` (``"replica"``) and replayed on
the replica's stream. The host-to-device copy of the padded batch stays
outside the graph: the dispatch copies the pinned pad buffer to the device
on the replica's stream, replays, and starts an asynchronous copy of the
output into pinned host memory followed by an event, so it returns without
waiting. :meth:`ReplicaPool.aot_count` counts the caches' entries, one per
(bucket, replica) once warmed; with ``aot_dispatch`` off the forward runs
eagerly and the pool keeps an eager ledger of the pairs it ran instead. A
capture that fails at warm-up raises: nothing dispatches eagerly in its
place.

Streams: PyTorch keeps one cuBLAS workspace per (handle, stream) for the
life of the process, so a pool takes its replica streams and capture streams
from a process-wide free list, each stream keeping its role, and
:meth:`ReplicaPool.close` (the batcher's shutdown) gives them back with the
replicas' tensors and graphs (under ``CAPTURE_LOCK``: no graph is destroyed
while another stream captures): a model paged out and in again reuses the
streams instead of leaving a workspace behind per cycle. Two live replicas
never share a stream.

Parameters are copied at replica creation, already cast to the compute
dtype ``_forward`` would cast them to (the same bits, once). Each replica
records what it holds, by mesh position (``Replica.placed``), for the
capacity ledger.

A duck-typed model without the network internals is served through its own
``output`` as one pseudo-replica (JAX ``:215-222``), counted honestly.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime.compile_cache import CAPTURE_LOCK, AotCache, aot_enabled
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.state_packing import step_args_signature
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map, tree_unflatten_like
from deeplearning4j_tpu_torch.serving.capacity import position_key

ArrayOrDict = Union[np.ndarray, Dict[str, np.ndarray]]

logger = logging.getLogger(__name__)


def _request_signature(x) -> tuple:
    """Cache-key component for one padded batch: shapes, dtypes, devices."""
    return step_args_signature((x,))


def _host_copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Tensor ``t``'s values on the host: bfloat16 (which numpy lacks)
    widened to float32 on the device first (exactly), then copied without
    waiting into pinned memory on a CUDA device; on the CPU, ``t`` itself."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _numpy(t):
    if isinstance(t, (list, tuple)):
        return [_numpy(v) for v in t]
    if isinstance(t, dict):
        return {k: _numpy(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


# ------------------------------------------------------------- streams
_stream_lock = threading.Lock()  # guards: _free_streams
# (device, role) -> idle streams; a stream keeps its role ("replica" or
# "capture"), so the (cuBLAS handle, stream) pairs that captures meet recur
_free_streams: Dict[tuple, List["torch.cuda.Stream"]] = {}


def _take_stream(device: torch.device, role: str):
    """A ``role`` stream of ``device`` from the free list, or a new one."""
    with _stream_lock:
        free = _free_streams.get((str(torch.device(device)), role))
        if free:
            return free.pop()
    return torch.cuda.Stream(device=device)


def _give_streams(streams) -> None:
    """Return idle ``(role, stream)`` pairs to the free list (their work is
    done)."""
    with _stream_lock:
        for role, s in streams:
            if s is not None:
                _free_streams.setdefault((str(s.device), role), []).append(s)


class Pending:
    """A dispatched forward whose output is on its way to the host: the
    pinned host tensors (a tree) and the event recorded after their copy
    (``None`` on the CPU, where the values are already there)."""

    __slots__ = ("host", "event")

    def __init__(self, host, event):
        self.host = host
        self.event = event

    def wait(self):
        """Block until the copy has landed; the output as numpy (bfloat16
        widened to float32), a list for several outputs."""
        if self.event is not None:
            self.event.synchronize()
        return _numpy(self.host)


class Replica:
    """One copy of the served parameters and layer state: on one device, or
    over a plan slice's device group (``devices``; ``device`` is its home,
    where requests land). ``placed`` lists every tensor it holds with its
    mesh position. (Per-replica batch counts live in
    ``ServingMetrics.replica_batches``.)"""

    __slots__ = ("index", "device", "params", "model_state", "in_flight",
                 "devices", "plan", "placed", "fn", "step_fn", "stream", "aot")

    def __init__(self, index: int, device, params, model_state, stream=None,
                 devices=None, plan=None):
        self.index = int(index)
        self.device = device
        self.params = params
        self.model_state = model_state
        self.in_flight = 0        # dispatched, readback not yet complete
        self.devices = list(devices) if devices is not None else [device]
        self.plan = plan          # the replica's slice plan (None: classic)
        self.placed: List[tuple] = []  # (position key, tensor)
        self.fn = None            # forward over this replica's tensors
        self.step_fn = None       # session step over this replica's tensors
        self.stream = stream      # CUDA stream of this replica's forwards
        self.aot = AotCache("replica")  # this replica's captured graphs

    def release(self) -> List:
        """Drop the tensors, forwards and graphs; the streams to give back."""
        streams = [("replica", self.stream), ("capture", self.aot._stream)]
        self.aot.clear()
        self.params = self.model_state = self.fn = self.step_fn = None
        self.placed = []
        self.stream = None
        return streams


class _Stored:
    """An FSDP-split leaf of a plan slice: its pieces stored one per
    position along ``dim``, gathered onto the home device at use."""

    __slots__ = ("pieces", "dim")

    def __init__(self, pieces, dim: int):
        self.pieces = list(pieces)
        self.dim = int(dim)

    def gather(self, device) -> torch.Tensor:
        return torch.cat([p.to(device) for p in self.pieces], dim=self.dim)


def _visible_devices(model) -> List[torch.device]:
    """The visible CUDA devices, or the one CPU device when the model lives
    there (the caller or the environment asked for it)."""
    dev = getattr(model, "device", None)
    if dev is None:
        dev = get_environment().resolve_device(None)
    dev = torch.device(dev)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _copy_cast(t: torch.Tensor, device, dtype) -> torch.Tensor:
    """``t`` copied onto ``device``, floating tensors cast to ``dtype`` (as
    ``cast_floating`` casts them), contiguous."""
    t = t.detach()
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype, copy=True).contiguous()
    return t.to(device, copy=True).contiguous()


class ReplicaPool:
    """N replicas of one model with least-loaded routing.

    ``acquire()`` claims the least-loaded replica (round-robin among ties,
    so single-threaded traffic still exercises every replica and keeps its
    graphs warm); ``dispatch`` issues the forward on the replica's stream
    WITHOUT waiting for the result; ``release`` returns the replica after
    readback. ``plan`` makes each replica a plan slice over
    ``plan.devices_per_replica()`` positions of ``devices``; ``n_replicas``
    clamps to ``len(devices) // devices_per_replica``.
    """

    def __init__(self, model, n_replicas: int = 1,
                 devices: Optional[Sequence] = None, plan=None):
        if hasattr(model, "_ensure_init") and getattr(model, "_params", 1) is None:
            model._ensure_init()
        self.model = model
        self.plan = plan
        n = max(1, int(n_replicas or 1))
        self._graph_inputs = list(getattr(getattr(model, "conf", None), "inputs", []) or [])
        self._outputs = list(getattr(getattr(model, "conf", None), "outputs", []) or [])
        fallback = self._fallback(model)
        if plan is not None and fallback:
            raise ValueError(f"ReplicaPool(plan=...): {type(model).__name__} lacks the "
                             f"network internals a plan slice places")
        devs = ([torch.device(d) for d in devices] if devices
                else (None if fallback else _visible_devices(model)))
        self._group_size = plan.devices_per_replica() if plan is not None else 1
        if devs is not None:
            if self._group_size > len(devs):
                raise ValueError(f"plan {plan.kind} needs {self._group_size} devices per "
                                 f"replica, have {len(devs)}")
            max_n = len(devs) // self._group_size
            if n > max_n:
                logger.warning("ReplicaPool: %d replicas requested but only %d device(s) "
                               "(%d per replica); clamping", n, len(devs), self._group_size)
                n = max_n
        self._devs = devs
        # the cache of every replica not yet retired, by index (a retired
        # replica keeps its own for the batches still in flight on it)
        self._caches: Dict[int, AotCache] = {}
        # the caches are not locked: warm-ups and resizes run on other threads
        # than the dispatch thread, so every call into one holds this
        self._aot_lock = threading.Lock()  # guards: _caches, _eager
        self._eager: set = set()  # (index, signature) run eagerly
        self._lock = threading.Lock()  # guards: _rr, _next_index, replicas, in_flight, _retired, _closed
        self._rr = 0
        self._closed = False
        self._retired: List[Replica] = []
        self.replicas: List[Replica] = []
        self._fallback_model = fallback
        if fallback:
            if n > 1:
                logger.warning(
                    "ReplicaPool: %s lacks the MultiLayerNetwork/ComputationGraph "
                    "internals; serving through its own output() (1 replica, %d "
                    "requested)", type(model).__name__, n)
            dev = torch.device(getattr(model, "device", None) or "cpu")
            self.replicas.append(Replica(0, dev, None, None))
            self._next_index = 1
            return
        for i in range(n):
            self.replicas.append(self._mint_replica(i))
        # indices are NEVER reused: the cache keys on (index, signature), and a
        # recycled index could hand a new replica a graph over another's tensors
        self._next_index = n

    @staticmethod
    def _fallback(model) -> bool:
        """Duck-typed models without the MultiLayerNetwork/ComputationGraph
        internals serve through their own ``output``."""
        conf = getattr(model, "conf", None)
        graph = bool(list(getattr(conf, "inputs", []) or []))
        has_fwd = hasattr(model, "_forward_all") if graph else hasattr(model, "_forward")
        return not (conf is not None and has_fwd and hasattr(model, "_params"))

    @property
    def fallback(self) -> bool:
        return self._fallback_model

    def __len__(self) -> int:
        with self._lock:
            return len(self.replicas)

    def aot_count(self) -> int:
        """Captured-graph entries of the replicas' caches plus the eager
        ledger: one per (bucket, replica) pair when warmed."""
        with self._aot_lock:
            return sum(len(c) for c in self._caches.values()) + len(self._eager)

    def live_replicas(self) -> List[Replica]:
        """The routable replicas, none once the pool is closed."""
        with self._lock:
            return [] if self._closed else list(self.replicas)

    def position_of(self, device) -> str:
        """The position key of the first position on ``device``."""
        device = torch.device(device) if device is not None else torch.device("cpu")
        for i, d in enumerate(self._devs or []):
            if d == device:
                return position_key(d, i)
        return position_key(device, 0)

    # ------------------------------------------------------------- replicas
    def _replica_group(self, idx: int) -> List[int]:
        """The positions replica ``idx`` lives on: disjoint groups of the
        group size while they last, then reused round-robin."""
        gs = self._group_size
        n_groups = max(1, len(self._devs) // gs)
        g = idx % n_groups
        return list(range(g * gs, (g + 1) * gs))

    def _mint_replica(self, idx: int, device=None) -> Replica:
        """One parameter and state copy: on one device (the round-robin
        position, or ``device``), or over the replica's plan slice."""
        if self.plan is not None:
            rep = self._mint_slice(idx)
        else:
            if device is None:
                pos = self._replica_group(idx)[0]
            else:
                device = torch.device(device)
                pos = next((i for i, d in enumerate(self._devs) if d == device), 0)
            rep = self._mint_classic(idx, pos, device)
        with self._aot_lock:
            self._caches[idx] = rep.aot
        return rep

    def _streams_for(self, rep: Replica) -> None:
        if rep.device.type == "cuda":
            rep.stream = _take_stream(rep.device, "replica")
            rep.aot._stream = _take_stream(rep.device, "capture")

    def _mint_classic(self, idx: int, pos: int, device=None) -> Replica:
        """The parameters cast to the compute dtype (as ``_forward`` casts
        them), the state as is, at position ``pos``."""
        model = self.model
        device = device if device is not None else self._devs[pos]
        cdt = get_environment().compute_dtype
        with torch.no_grad():
            params = tree_map(lambda t: _copy_cast(t, device, cdt), model._params)
            state = tree_map(lambda t: t.detach().to(device, copy=True), model._model_state)
        rep = Replica(idx, device, params, state)
        key = position_key(device, pos)
        rep.placed = [(key, t) for t in tree_leaves([params, state])]
        self._streams_for(rep)
        rep.fn, rep.step_fn = self._replica_fns(rep)
        return rep

    def _mint_slice(self, idx: int) -> Replica:
        """A plan-slice replica over its group of positions (see the module
        docstring)."""
        positions = self._replica_group(idx)
        group = [self._devs[p] for p in positions]
        if (aot_enabled() and group[0].type == "cuda"
                and len({str(d) for d in group}) > 1):
            raise NotImplementedError(
                "plan-sliced serving captures a replica's forward as one CUDA graph on "
                f"one card; the group {[str(d) for d in group]} spans several (serve it "
                "with aot_dispatch off, or over positions of one card)")
        slice_plan = self.plan.replica_slice(group)
        mesh = slice_plan.mesh
        shape = tuple(mesh.shape[a] for a in mesh.axis_names)

        def at(**coords):
            flat = int(np.ravel_multi_index(tuple(int(coords.get(a, 0))
                                                  for a in mesh.axis_names), shape))
            p = positions[flat]
            return self._devs[p], position_key(self._devs[p], p)

        home, home_key = at()
        cdt = get_environment().compute_dtype
        model = self.model
        placed: List[tuple] = []
        with torch.no_grad():
            state = tree_map(lambda t: t.detach().to(home, copy=True), model._model_state)
            placed += [(home_key, t) for t in tree_leaves(state)]
            if slice_plan.pipe_size > 1:
                params, fwd = self._place_pipe(model, slice_plan, at, cdt, placed)
            else:
                params, fwd = self._place_split(model, slice_plan, at, home, cdt, placed)
        rep = Replica(idx, home, params, state, devices=group, plan=slice_plan)
        rep.placed = placed
        self._streams_for(rep)
        rep.fn = lambda x: fwd(params, state, x)
        return rep

    def _place_pipe(self, model, slice_plan, at, cdt, placed):
        """The trunk packed by the executor, stage ``s``'s piece on pipe
        position ``s``; the head and tail layers on the home position."""
        from deeplearning4j_tpu_torch.nn.tensor_shards import TensorShards
        from deeplearning4j_tpu_torch.parallel.plan_exec import TRUNK_KEY, PipePlanExecutor
        from deeplearning4j_tpu_torch.runtime.trees import tree_paths
        ex = PipePlanExecutor(model, slice_plan)
        packed = ex.pack_params(model._params)
        home, home_key = at()
        leaves = []
        for path, t in zip(tree_paths(packed), tree_leaves(packed)):
            if path[0] == TRUNK_KEY:
                pieces = []
                for s in range(ex.S):
                    dev, key = at(pipe=s)
                    piece = _copy_cast(t.narrow(0, s, 1), dev, cdt)
                    placed.append((key, piece))
                    pieces.append(piece)
                leaves.append(TensorShards(pieces, 0))
                continue
            if tuple(slice_plan.leaf_spec(path, tuple(t.shape))) != ():
                raise NotImplementedError(
                    f"a pipe slice serves its head and tail layers whole; {path} splits "
                    f"under plan {slice_plan.kind}")
            piece = _copy_cast(t, home, cdt)
            placed.append((home_key, piece))
            leaves.append(piece)
        return tree_unflatten_like(packed, leaves), ex.make_forward()

    def _place_split(self, model, slice_plan, at, home, cdt, placed):
        """Leaves placed by ``placements_of``: tensor-split leaves as
        :class:`TensorShards` pieces computed where they lie, FSDP-split ones
        stored in pieces and gathered at use, the rest whole on the home
        position. The forward is the network's own."""
        from deeplearning4j_tpu_torch.nn.tensor_shards import TensorShards
        from deeplearning4j_tpu_torch.parallel.sharding import placements_of
        _, home_key = at()
        leaves = []
        stored = False
        for t, p in zip(tree_leaves(model._params), placements_of(slice_plan, model._params)):
            if p.axis is None:
                piece = _copy_cast(t, home, cdt)
                placed.append((home_key, piece))
                leaves.append(piece)
                continue
            pieces = []
            for j in range(p.n):
                dev, key = at(**{p.axis: j})
                piece = _copy_cast(p.piece(t, j), dev, cdt)
                placed.append((key, piece))
                pieces.append(piece)
            if p.compute:
                leaves.append(TensorShards(pieces, p.dim))
            else:
                leaves.append(_Stored(pieces, p.dim))
                stored = True
        params = tree_unflatten_like(model._params, leaves)
        graph = self._graph_inputs

        def gathered(tree):
            if not stored:
                return tree
            return tree_map(lambda v: v.gather(home) if isinstance(v, _Stored) else v, tree)

        def fwd(p, s, x):
            p = gathered(p)
            if graph:
                acts, _, _ = model._forward_all(p, s, x, training=False)
                outs = [acts[o] for o in self._outputs]
                return outs[0] if len(outs) == 1 else outs
            return model._forward(p, s, x)[0]
        return params, fwd

    def _replica_fns(self, rep: Replica):
        """The replica's forward (mirror of ``output``) and session step
        (mirror of ``_rnn_step``'s inference branch) over its own tensors."""
        model, p, s = self.model, rep.params, rep.model_state
        if self._graph_inputs:
            outputs = self._outputs

            def fwd(inputs):
                acts, _, _ = model._forward_all(p, s, inputs, training=False)
                outs = [acts[o] for o in outputs]
                return outs[0] if len(outs) == 1 else outs

            name = self._graph_inputs[0]

            def step(carries, xb):
                acts, _, _, new = model._forward_all(p, s, {name: xb}, training=False,
                                                     carries=carries)
                return acts[outputs[0]], new
        else:
            def fwd(x):
                return model._forward(p, s, x)[0]

            def step(carries, xb):
                out, _, _, new = model._forward(p, s, xb, carries=carries)
                return out, new
        return fwd, step

    def create_replica(self, device=None) -> Replica:
        """Mint a NEW parameter copy WITHOUT publishing it for routing. The
        caller warms it (:meth:`forward_blocking` works on an unpublished
        replica), then :meth:`publish_replica` makes it routable, so a new
        replica never captures on live traffic. Devices (or plan groups) are
        assigned round-robin past the initial set."""
        if self._fallback_model:
            raise ValueError(
                f"cannot scale a fallback pool ({type(self.model).__name__} "
                f"serves through its own output() with no device routing)")
        with self._lock:
            idx = self._next_index
            self._next_index += 1
        return self._mint_replica(idx, device if self.plan is None else None)

    def publish_replica(self, replica: Replica) -> int:
        """Make a warmed replica routable; returns the new pool size."""
        with self._lock:
            self.replicas.append(replica)
            return len(self.replicas)

    def retire_replica(self) -> Optional[Replica]:
        """Remove the NEWEST replica from routing (replica 0 stays), or
        ``None`` when only one remains. In-flight batches hold their own
        reference and complete normally on the replica's graphs, which go
        with it at :meth:`close`; the pool drops its cache from
        :meth:`aot_count` so the count keeps describing the live pool."""
        with self._lock:
            if len(self.replicas) <= 1:
                return None
            rep = self.replicas.pop()
            self._retired.append(rep)
        with self._aot_lock:
            self._caches.pop(rep.index, None)
            self._eager = {k for k in self._eager if k[0] != rep.index}
        return rep

    def close(self) -> None:
        """Free the pool once nothing is in flight (the batcher's shutdown):
        every replica's tensors and graphs go, and their streams return to
        the free list. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            reps = list(self.replicas) + self._retired
            self._retired = []
        streams = []
        with self._aot_lock, CAPTURE_LOCK:  # no graph goes while a stream captures
            self._caches.clear()
            self._eager.clear()
            for rep in reps:
                streams += rep.release()
        _give_streams(streams)

    # ------------------------------------------------------------- routing
    def acquire(self) -> Replica:
        """Claim the least-loaded replica (ties broken round-robin) and
        count the dispatch against it."""
        with self._lock:
            low = min(r.in_flight for r in self.replicas)
            ties = [r for r in self.replicas if r.in_flight == low]
            rep = ties[self._rr % len(ties)]
            self._rr += 1
            rep.in_flight += 1
            return rep

    def release(self, replica: Replica) -> None:
        """Un-claim after readback completed OR after a dispatch that
        never executed."""
        with self._lock:
            replica.in_flight -= 1

    def total_in_flight(self) -> int:
        with self._lock:
            return sum(r.in_flight for r in self.replicas)

    # ------------------------------------------------------------ dispatch
    def _to_device(self, replica: Replica, x):
        """The pinned (or CPU) pad buffer(s) on the replica's device, copied
        on its stream without waiting."""
        def one(t):
            t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
            if t.dtype == torch.float64:
                t = t.float()
            if replica.device.type == "cuda":
                return t.to(replica.device, non_blocking=True)
            return t
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        return one(x)

    def _run(self, replica: Replica, key, fn, *args):
        """``fn(*args)`` through the replica's cache (a replay once captured),
        or eagerly with ``aot_dispatch`` off (counted in the eager ledger)."""
        with self._aot_lock:
            if aot_enabled():
                return replica.aot.call(key, fn, *args)
            self._eager.add(key)
        return fn(*args)

    def dispatch(self, replica: Replica, x) -> Pending:
        """Issue the forward on ``replica`` and return a :class:`Pending`
        WITHOUT waiting for it: on a CUDA device the copy in, the replay and
        the copy out are queued on the replica's stream, so the device
        executes while the host goes on coalescing the next batch."""
        if self._fallback_model:
            with torch.inference_mode():
                out = (self.model.output(*[x[n] for n in (self._graph_inputs or sorted(x))])
                       if isinstance(x, dict) else self.model.output(x))
            return Pending(_numpy(out), None)
        if replica.fn is None:
            raise RuntimeError("the replica pool is closed")
        if self._graph_inputs and not isinstance(x, dict):
            x = {self._graph_inputs[0]: x}
        if isinstance(x, dict):
            x = {n: x[n] for n in self._graph_inputs}
        with torch.inference_mode(), _on_stream(replica):
            xd = self._to_device(replica, x)
            key = ((replica.index, _request_signature(xd)) if replica.plan is None else
                   (replica.index, replica.plan.signature(), _request_signature(xd)))
            try:
                out = self._run(replica, key, replica.fn, xd)
                host = tree_map(lambda t: _host_copy(t, replica.device), out)
            except BaseException:
                # the copy in may still be reading the pad buffer: let it land
                # before the caller hands the buffer back to its pool
                if replica.stream is not None:
                    replica.stream.synchronize()
                raise
            event = None
            if replica.stream is not None:
                event = torch.cuda.Event()
                event.record(replica.stream)
        return Pending(host, event)

    def forward_blocking(self, replica: Replica, x):
        """Dispatch + readback on one replica: the warm-up path (see
        :meth:`warm`). Bypasses the in-flight accounting."""
        return self.warm(lambda: self.dispatch(replica, x))

    @staticmethod
    def warm(call):
        """``call()`` (a dispatch or a session step) and its output; on a
        CUDA device with ``aot_dispatch`` on, twice: the first call at a new
        shape warms up on the cache's side stream, the second captures. A
        failure raises to the caller."""
        pending = call()
        out = pending.wait()
        if pending.event is None or not aot_enabled():
            return out
        return call().wait()

    # ---------------------------------------------------------- session step
    def step(self, replica: Replica, carries, xb) -> Pending:
        """One session step on ``replica`` at the fixed session bucket:
        ``carries`` (a tree of host arrays, batch = bucket) and ``xb`` go in
        as static inputs, ``(out, new_carries)`` come back as a
        :class:`Pending`."""
        if replica.step_fn is None:
            raise ValueError("session steps run on classic replicas only (not plan slices)")
        with torch.inference_mode(), _on_stream(replica):
            cd = tree_map(lambda a: self._to_device(replica, a), carries)
            xd = self._to_device(replica, xb)
            key = (replica.index, "session", _request_signature((cd, xd)))
            try:
                out, new = self._run(replica, key, replica.step_fn, cd, xd)
                host = (_host_copy(out, replica.device),
                        tree_map(lambda t: _carry_copy(t, replica.device), new))
            except BaseException:
                if replica.stream is not None:
                    replica.stream.synchronize()
                raise
            event = None
            if replica.stream is not None:
                event = torch.cuda.Event()
                event.record(replica.stream)
        return Pending(host, event)

    def state_bytes(self) -> int:
        """Device bytes of the replicas' parameter and state copies."""
        return int(sum(t.numel() * t.element_size()
                       for r in self.live_replicas() for _, t in r.placed))


def _carry_copy(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A carry's values on the host in its own dtype (carries round-trip
    exactly), without waiting on a CUDA device."""
    t = t.detach()
    if device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _on_stream(replica: Replica):
    """``torch.cuda.stream(replica.stream)`` on a CUDA replica, nothing on
    the CPU."""
    if replica.stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(replica.stream)
