"""Device replicas for the serving pipeline.

Counterpart of ``deeplearning4j_tpu/serving/replica.py``. A
:class:`Replica` is one copy of the served parameters and layer state on one
``torch.device``, with its own CUDA stream. The replica's forward mirrors
``MultiLayerNetwork._forward`` / ``ComputationGraph._forward_all`` on the
replica's own tensors, as the JAX ``_output_fn`` mirrors ``output``, so a
replica's answer is ``model.output`` at the same bucket shape.

On a CUDA device each (replica, input signature) is captured once into a
``torch.cuda.CUDAGraph`` by the replica's own
:class:`~..runtime.compile_cache.AotCache` (``"replica"``, keyed
``(replica.index, signature)``) and replayed on the replica's stream. The
host-to-device copy of the padded batch stays outside the graph (a capture
cannot hold a copy from pageable or pinned host memory): the dispatch copies
the pinned pad buffer to the device on the replica's stream, replays, and
starts an asynchronous copy of the output into pinned host memory followed
by an event, so it returns without waiting. :meth:`ReplicaPool.aot_count`
counts the caches' entries, one per (bucket, replica) once warmed; with
``aot_dispatch`` off the forward runs eagerly and the pool keeps an eager
ledger of the (replica, signature) pairs it ran instead. A capture that
fails at warm-up raises: nothing dispatches eagerly in its place.

The captured graphs of one replica share its cache's memory pool and
capture stream and replay in order on the replica's stream; two replicas
never share a cache, so their graphs may replay at once (two replicas on one
device, two batches in flight).

Parameters are copied at replica creation, already cast to the compute dtype
``_forward`` would cast them to on every call (the same bits, once): a
served model's weights and its compute dtype are frozen for the lifetime of
its batcher, and the supported update path is the registry's hot-swap.

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

from deeplearning4j_tpu_torch.nn.base import cast_floating
from deeplearning4j_tpu_torch.runtime.compile_cache import AotCache, aot_enabled
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.state_packing import step_args_signature
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map

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
    """One copy of the served parameters and layer state on one device,
    with the stream its forwards run on. (Per-replica batch counts live in
    ``ServingMetrics.replica_batches``.)"""

    __slots__ = ("index", "device", "params", "model_state", "in_flight",
                 "devices", "fn", "step_fn", "stream", "aot")

    def __init__(self, index: int, device, params, model_state, stream=None):
        self.index = int(index)
        self.device = device
        self.params = params
        self.model_state = model_state
        self.in_flight = 0        # dispatched, readback not yet complete
        self.devices = [device]
        self.fn = None            # forward over this replica's tensors
        self.step_fn = None       # session step over this replica's tensors
        self.stream = stream      # CUDA stream of this replica's forwards
        self.aot = AotCache("replica")  # this replica's captured graphs


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


class ReplicaPool:
    """N device replicas of one model with least-loaded routing.

    ``acquire()`` claims the least-loaded replica (round-robin among ties,
    so single-threaded traffic still exercises every replica and keeps its
    graphs warm); ``dispatch`` issues the forward on the replica's stream
    WITHOUT waiting for the result; ``release`` returns the replica after
    readback.
    """

    def __init__(self, model, n_replicas: int = 1,
                 devices: Optional[Sequence] = None, plan=None):
        if plan is not None:
            raise NotImplementedError(
                "ReplicaPool(plan=...): plan-sliced serving is not ported yet")
        if hasattr(model, "_ensure_init") and getattr(model, "_params", 1) is None:
            model._ensure_init()
        self.model = model
        n = max(1, int(n_replicas or 1))
        self._graph_inputs = list(getattr(getattr(model, "conf", None), "inputs", []) or [])
        self._outputs = list(getattr(getattr(model, "conf", None), "outputs", []) or [])
        fallback = self._fallback(model)
        devs = ([torch.device(d) for d in devices] if devices
                else (None if fallback else _visible_devices(model)))
        if devs is not None and n > len(devs):
            logger.warning("ReplicaPool: %d replicas requested but only %d device(s); "
                           "clamping", n, len(devs))
            n = len(devs)
        self._devs = devs
        # the cache of every replica not yet retired, by index (a retired
        # replica keeps its own for the batches still in flight on it)
        self._caches: Dict[int, AotCache] = {}
        # the caches are not locked: warm-ups and resizes run on other threads
        # than the dispatch thread, so every call into one holds this
        self._aot_lock = threading.Lock()  # guards: _caches, _eager
        self._eager: set = set()  # (index, signature) run eagerly
        self._lock = threading.Lock()  # guards: _rr, _next_index, replicas, in_flight
        self._rr = 0
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
            self.replicas.append(self._mint_replica(i, devs[i % len(devs)]))
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

    # ------------------------------------------------------------- replicas
    def _mint_replica(self, idx: int, device: torch.device) -> Replica:
        """One parameter and state copy on ``device``: the parameters cast to
        the compute dtype (as ``_forward`` casts them), the state as is."""
        model = self.model
        cdt = get_environment().compute_dtype
        with torch.no_grad():
            params = tree_map(lambda t: t.detach().to(device, copy=True),
                              cast_floating(model._params, cdt))
            state = tree_map(lambda t: t.detach().to(device, copy=True),
                             model._model_state)
        stream = torch.cuda.Stream(device=device) if device.type == "cuda" else None
        rep = Replica(idx, device, params, state, stream=stream)
        rep.fn, rep.step_fn = self._replica_fns(rep)
        with self._aot_lock:
            self._caches[idx] = rep.aot
        return rep

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
        replica never captures on live traffic. Devices are assigned
        round-robin past the initial set."""
        if self._fallback_model:
            raise ValueError(
                f"cannot scale a fallback pool ({type(self.model).__name__} "
                f"serves through its own output() with no device routing)")
        with self._lock:
            idx = self._next_index
            self._next_index += 1
        dev = torch.device(device) if device is not None else self._devs[idx % len(self._devs)]
        return self._mint_replica(idx, dev)

    def publish_replica(self, replica: Replica) -> int:
        """Make a warmed replica routable; returns the new pool size."""
        with self._lock:
            self.replicas.append(replica)
            return len(self.replicas)

    def retire_replica(self) -> Optional[Replica]:
        """Remove the NEWEST replica from routing (replica 0 stays), or
        ``None`` when only one remains. In-flight batches hold their own
        reference and complete normally on the replica's graphs, which go
        with it; the pool drops its cache so :meth:`aot_count` keeps
        describing the live pool."""
        with self._lock:
            if len(self.replicas) <= 1:
                return None
            rep = self.replicas.pop()
        with self._aot_lock:
            self._caches.pop(rep.index, None)
            self._eager = {k for k in self._eager if k[0] != rep.index}
        return rep

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
        if self._graph_inputs and not isinstance(x, dict):
            x = {self._graph_inputs[0]: x}
        if isinstance(x, dict):
            x = {n: x[n] for n in self._graph_inputs}
        with torch.inference_mode(), _on_stream(replica):
            xd = self._to_device(replica, x)
            key = (replica.index, _request_signature(xd))
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
        with self._lock:
            reps = list(self.replicas)
        return int(sum(t.numel() * t.element_size() for r in reps
                       for t in tree_leaves([r.params or {}, r.model_state or {}])
                       if isinstance(t, torch.Tensor)))


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
