"""Parallel plans: how parameters, optimizer state and batches map onto a
mesh, and the sharded train state that runs one step over it.

Counterpart of ``deeplearning4j_tpu/parallel/sharding.py``. A
:class:`ParallelPlan` names the mesh axes and, through its ``param_rule``,
gives every parameter leaf a :class:`PartitionSpec` (at most one split
dimension). The factories and :meth:`ParallelPlan.compose` keep the JAX
package's placement rules as they are (``_fsdp_rule``, ``_tensor_rule``,
the expert rule), as do ``signature``/``describe``/``replica_slice``.

Where the JAX package hands the shardings to XLA (GSPMD inserts the
collectives), one process drives the mesh here (:class:`ShardedTrainState`):

- the batch rows split over the plan's batch axes (``data``, ``fsdp``):
  one *replica* per coordinate, in rank order (the last axis fastest);
- a leaf split over ``data``/``fsdp``/``expert`` is *stored* in pieces on
  the devices of that axis (piece ``j`` on the device at coordinate
  ``j``, the others at 0) with its optimizer state, and gathered onto each
  replica's device before the step;
- a leaf split over ``model`` (tensor parallelism) or ``pipe`` (a stacked
  pipeline trunk, ``plan_exec.py``) is *computed* in pieces: each replica
  holds piece ``j`` on its device at that axis' coordinate ``j``, and the
  layers compute with :class:`~..nn.tensor_shards.TensorShards`;
- a replicated leaf is stored once, on the mesh's first device (it is the
  network's own tensor there), and copied to each replica.

A step copies the stored pieces onto the replicas, runs each replica's
loss and gradients under autograd, sums every piece's gradient over the
replicas on its owner's device in rank order and divides by the replica
count (the mean gradient of the global batch), and steps one optimizer per
owner on the pieces it owns. No reduction is left to a backend: every sum
is a copy and an add in fixed order, so a run is deterministic, and a
composed plan whose placements equal a single-axis factory's is that plan
bit for bit. The elementwise updaters make the per-piece update the
whole-leaf update's piece.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.tensor_shards import TensorShards, rank_sum
from deeplearning4j_tpu_torch.runtime.mesh import (DATA_AXIS, EXPERT_AXIS, FSDP_AXIS, MODEL_AXIS,
                                                   PIPE_AXIS, SEQ_AXIS, Mesh, MeshSpec,
                                                   create_mesh)
from deeplearning4j_tpu_torch.runtime.trees import (tree_leaves, tree_paths,
                                                    tree_unflatten_like)

#: axes whose pieces a replica computes with where they lie
COMPUTE_AXES = (MODEL_AXIS, PIPE_AXIS)


class PartitionSpec:
    """Per-dimension mesh axis (or ``None``) of one leaf; ``P()`` is
    replicated (the role of ``jax.sharding.PartitionSpec``). Not a tuple,
    so that a tree of specs keeps one leaf per parameter."""

    __slots__ = ("axes",)

    def __init__(self, *axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self) -> int:
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __eq__(self, other) -> bool:
        return tuple(self) == tuple(other)

    def __hash__(self) -> int:
        return hash(self.axes)

    def __repr__(self) -> str:
        return f"P{self.axes!r}"


P = PartitionSpec


def _leaf_key(path) -> Optional[str]:
    keys = [k for k in path if isinstance(k, str)]
    return keys[-1] if keys else None


def _fsdp_rule(axis: str, axis_size: int, min_size: int):
    """Shard every large leaf's first divisible dim over ``axis`` (JAX
    ``:52``); small leaves stay replicated."""
    def rule(path, shape):
        if int(np.prod(shape)) < min_size:
            return P()
        for dim, s in enumerate(shape):
            if s % axis_size == 0 and s >= axis_size:
                spec = [None] * len(shape)
                spec[dim] = axis
                return P(*spec)
        return P()
    return rule


def _tensor_rule(tp: int):
    """Megatron-style split over ``model`` (JAX ``:67``): columns of
    W_q/W_k/W_v/W_ff1 and their biases, rows of W_o/W_ff2."""
    COL = ("W_q", "W_k", "W_v", "b_q", "b_k", "b_v", "W_ff1", "b_ff1")
    ROW = ("W_o", "W_ff2")

    def rule(path, shape):
        leaf = _leaf_key(path)
        if leaf in COL and shape[-1] % tp == 0:
            return P(*([None] * (len(shape) - 1) + [MODEL_AXIS]))
        if leaf in ROW and len(shape) >= 2 and shape[-2] % tp == 0:
            return P(*([None] * (len(shape) - 2) + [MODEL_AXIS, None]))
        return P()
    return rule


@dataclasses.dataclass
class ParallelPlan:
    """Placement of state and batch over a named-axis mesh (JAX ``:88``).

    ``param_rule(path, shape) -> PartitionSpec`` places each parameter leaf
    (``path`` its key path); ``None`` replicates everything. ``batch_axis``
    is the axis or axes the batch rows split over. ``pipe_microbatches`` is
    the GPipe schedule depth of pipe plans (1 = staged-sequential, the
    setting at which a trajectory is the unpipelined one bit for bit)."""

    mesh: Mesh
    param_rule: Optional[Callable[[Tuple[Any, ...], Tuple[int, ...]], PartitionSpec]] = None
    batch_axis: Union[str, Tuple[str, ...]] = DATA_AXIS
    kind: str = "data_parallel"
    pipe_microbatches: int = 1

    @staticmethod
    def data_parallel(mesh: Mesh) -> "ParallelPlan":
        return ParallelPlan(mesh=mesh, param_rule=None, kind="data_parallel")

    @staticmethod
    def fsdp(mesh: Mesh, min_size: int = 1024) -> "ParallelPlan":
        """Single-axis FSDP: batch and parameters split over ``data``."""
        return ParallelPlan(mesh=mesh,
                            param_rule=_fsdp_rule(DATA_AXIS, mesh.shape[DATA_AXIS], min_size),
                            kind="fsdp")

    @staticmethod
    def tensor_parallel(mesh: Mesh) -> "ParallelPlan":
        return ParallelPlan(mesh=mesh, param_rule=_tensor_rule(mesh.shape[MODEL_AXIS]),
                            kind="tensor_parallel")

    @staticmethod
    def expert_parallel(mesh: Mesh) -> "ParallelPlan":
        """Expert tables (``W_e1``, ``W_e2``, ``b_e1``, ``b_e2``) split on
        their leading expert dim over ``expert`` (JAX ``:127``). The port
        has no MoE layer yet, so this plan is held by its placements."""
        ep = mesh.shape[EXPERT_AXIS]
        keys = ("W_e1", "W_e2", "b_e1", "b_e2")

        def rule(path, shape):
            leaf = _leaf_key(path)
            if leaf in keys:
                if not shape or shape[0] % ep:
                    raise ValueError(
                        f"expert table {leaf} has {shape[0] if shape else 0} experts, not "
                        f"divisible by expert-axis size {ep} — replicating would silently "
                        f"disable expert parallelism")
                return P(*([EXPERT_AXIS] + [None] * (len(shape) - 1)))
            return P()

        return ParallelPlan(mesh=mesh, param_rule=rule, kind="expert_parallel")

    @staticmethod
    def compose(data: int = 1, fsdp: int = 1, tensor: int = 1, pipe: int = 1, seq: int = 1, *,
                devices_: Optional[Sequence] = None, min_size: int = 1024,
                microbatches: int = 1) -> "ParallelPlan":
        """One mesh over every requested axis (JAX ``:150``; sizes 1..N, one
        may be -1), axis order ``pipe, data, fsdp, model, seq``: batch rows
        over ``(data, fsdp)``, tensor keys over ``model`` (checked first),
        then ``fsdp`` on the first divisible dim; ``pipe`` > 1 selects the
        pipeline executor, ``seq`` > 1 ring attention."""
        sizes = {PIPE_AXIS: pipe, DATA_AXIS: data, FSDP_AXIS: fsdp, MODEL_AXIS: tensor,
                 SEQ_AXIS: seq}
        if sum(1 for v in sizes.values() if v == -1) > 1:
            raise ValueError("at most one composed axis may be -1")
        spec = {k: int(v) for k, v in sizes.items() if v == -1 or int(v) > 1}
        if not spec:
            spec = {DATA_AXIS: 1}
        mesh = create_mesh(MeshSpec(spec), devices_=devices_)
        shp = mesh.shape
        rules = []
        if shp.get(MODEL_AXIS, 1) > 1:
            rules.append(_tensor_rule(shp[MODEL_AXIS]))
        if shp.get(FSDP_AXIS, 1) > 1:
            rules.append(_fsdp_rule(FSDP_AXIS, shp[FSDP_AXIS], min_size))

        def rule(path, shape):
            for r in rules:
                s = r(path, shape)
                if tuple(s) != ():
                    return s
            return P()

        batch_axes = tuple(a for a in (DATA_AXIS, FSDP_AXIS) if a in shp)
        kind = "compose(" + ",".join(f"{a}={shp[a]}" for a in mesh.axis_names) + ")"
        return ParallelPlan(mesh=mesh, param_rule=rule if rules else None,
                            batch_axis=batch_axes or DATA_AXIS, kind=kind,
                            pipe_microbatches=max(1, int(microbatches)))

    # ---------------------------------------------------------- introspection
    def batch_axes(self) -> Tuple[str, ...]:
        axes = self.batch_axis if isinstance(self.batch_axis, tuple) else (self.batch_axis,)
        return tuple(a for a in axes if a in self.mesh.shape)

    def batch_divisor(self) -> int:
        n = 1
        for a in self.batch_axes():
            n *= self.mesh.shape[a]
        return max(1, n)

    def axis_size(self, axis: str) -> int:
        return int(self.mesh.shape.get(axis, 1))

    @property
    def pipe_size(self) -> int:
        return self.axis_size(PIPE_AXIS)

    @property
    def seq_size(self) -> int:
        return self.axis_size(SEQ_AXIS)

    def devices_per_replica(self) -> int:
        """Devices of one plan-slice replica: every axis but ``data``."""
        n = 1
        for a, s in self.mesh.shape.items():
            if a != DATA_AXIS:
                n *= int(s)
        return max(1, n)

    def signature(self) -> Tuple:
        """Hashable identity for captured-graph keys: kind, ordered axes,
        batch axes and the pipe schedule (JAX ``:249``)."""
        return ("plan", self.kind, tuple((a, int(self.mesh.shape[a]))
                                         for a in self.mesh.axis_names),
                self.batch_axes(), int(self.pipe_microbatches))

    def describe(self) -> Dict[str, Any]:
        return {"kind": self.kind,
                "axes": {a: int(self.mesh.shape[a]) for a in self.mesh.axis_names},
                "batch_axes": list(self.batch_axes()),
                "pipe_microbatches": int(self.pipe_microbatches)}

    def replica_slice(self, devices) -> "ParallelPlan":
        """The per-replica sub-plan over one replica's devices: the same axes
        minus ``data`` (JAX ``:265``)."""
        axes = {a: int(s) for a, s in self.mesh.shape.items() if a != DATA_AXIS and int(s) > 1}
        if not axes:
            axes = {DATA_AXIS: 1}
        mesh = create_mesh(MeshSpec(axes), devices_=list(devices))
        batch = tuple(a for a in self.batch_axes() if a in mesh.shape)
        return ParallelPlan(mesh=mesh, param_rule=self.param_rule, batch_axis=batch or DATA_AXIS,
                            kind=self.kind + "/slice", pipe_microbatches=self.pipe_microbatches)

    # ---- application
    def leaf_spec(self, path, shape) -> PartitionSpec:
        spec = self.param_rule(tuple(path), tuple(shape)) if self.param_rule else P()
        if len(spec) > len(shape):  # never shard scalars or absent dims
            spec = P()
        return spec

    def param_sharding(self, tree) -> Any:
        """A :class:`PartitionSpec` per leaf of ``tree``, nested as it."""
        leaves = tree_leaves(tree)
        return tree_unflatten_like(tree, [self.leaf_spec(p, tuple(l.shape))
                                          for p, l in zip(tree_paths(tree), leaves)])

    def replica_coords(self) -> List[Dict[str, int]]:
        """The batch-axis coordinate of each replica, in rank order."""
        return self.mesh.coords(self.batch_axes())


#: The JAX package's older name: a strategy is a plan.
ShardingStrategy = ParallelPlan


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives: replicated (``axis`` None) or split along
    ``dim`` into ``n`` equal pieces over ``axis``."""

    axis: Optional[str] = None
    dim: int = 0
    n: int = 1

    @property
    def compute(self) -> bool:
        return self.axis in COMPUTE_AXES

    def piece(self, t: torch.Tensor, j: int) -> torch.Tensor:
        c = t.shape[self.dim] // self.n
        return t.narrow(self.dim, j * c, c)


def placements_of(plan: ParallelPlan, params) -> List[Placement]:
    """Each leaf's :class:`Placement` by the plan's rule."""
    out = []
    for path, leaf in zip(tree_paths(params), tree_leaves(params)):
        spec = plan.leaf_spec(path, tuple(leaf.shape))
        split = [(d, a) for d, a in enumerate(spec) if a is not None]
        if not split:
            out.append(Placement())
            continue
        if len(split) > 1:
            raise NotImplementedError(f"leaf {path} splits over several axes {spec}")
        dim, axis = split[0]
        out.append(Placement(axis, dim, plan.axis_size(axis)))
    return out


def batch_rows(t: torch.Tensor, n: int, r: int) -> torch.Tensor:
    if t.shape[0] % n:
        raise ValueError(f"Batch size {t.shape[0]} not divisible by data-parallel size {n}")
    c = t.shape[0] // n
    return t.narrow(0, r * c, c)


def _split_tree(tree, n: int, r: int, device):
    """Replica ``r``'s rows of every tensor of a batch tree, copied onto
    ``device``; ``None`` stays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _split_tree(v, n, r, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_split_tree(v, n, r, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return batch_rows(tree, n, r).to(device, copy=True)
    return tree


def shard_batch(strategy: ParallelPlan, *arrays):
    """Split batch tensors over the plan's replicas: per array, the list of
    each replica's rows on its device (pad-free: the rows must divide by the
    data-parallel degree, JAX ``:317``)."""
    n = strategy.batch_divisor()
    coords = strategy.replica_coords()
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
            continue
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        if t.shape[0] % n:
            raise ValueError(f"Batch size {t.shape[0]} not divisible by data-parallel size {n}")
        out.append([batch_rows(t, n, r).to(strategy.mesh.device_at(**c), copy=True)
                    for r, c in enumerate(coords)])
    return out if len(out) > 1 else out[0]


def shard_batch_tree(strategy: ParallelPlan, tree):
    """:func:`shard_batch` over a tree (a graph's input dict, label list,
    mask dict): one tree per replica."""
    n = strategy.batch_divisor()
    return [_split_tree(tree, n, r, strategy.mesh.device_at(**c))
            for r, c in enumerate(strategy.replica_coords())]


# ------------------------------------------------------------------ the state
def _like(s, ref) -> bool:
    """Whether ``s`` has ``ref``'s tree structure and leaf shapes (an
    optimizer state subtree that mirrors a layer's parameters)."""
    if isinstance(ref, dict):
        return (isinstance(s, dict) and set(s) == set(ref)
                and all(_like(s[k], ref[k]) for k in ref))
    if isinstance(ref, (list, tuple)):
        return (isinstance(s, (list, tuple)) and len(s) == len(ref)
                and all(_like(a, b) for a, b in zip(s, ref)))
    return isinstance(s, torch.Tensor) and isinstance(ref, torch.Tensor) and s.shape == ref.shape


def state_pairs(full, piece, params_k):
    """``(full leaf, piece leaf, parameter position or None)`` over a layer's
    optimizer state, whole and owned: a leaf in a subtree that mirrors the
    parameters carries its parameter's position in ``tree_leaves(params_k)``;
    the rest (counts) carry ``None``."""
    if _like(full, params_k):
        for pos, (a, b) in enumerate(zip(tree_leaves(full), tree_leaves(piece))):
            yield a, b, pos
    elif isinstance(full, dict):
        for k in sorted(full):
            yield from state_pairs(full[k], piece[k], params_k)
    elif isinstance(full, (list, tuple)):
        for a, b in zip(full, piece):
            yield from state_pairs(a, b, params_k)
    elif isinstance(full, torch.Tensor):
        yield full, piece, None


class _Replica:
    __slots__ = ("index", "coord", "home", "buffers", "tree", "train")

    def __init__(self, index, coord, home):
        self.index, self.coord, self.home = index, coord, home


class ShardedTrainState:
    """A parameter tree and its optimizer, placed over a plan's mesh (the
    role of the JAX package's ``shard_train_state``, ``:302``): owned
    pieces, one optimizer per owner, replica buffers, and the step.

    ``params`` is the network's tree (on the mesh's first device; its
    replicated leaves are stored as they are), ``placements`` one
    :class:`Placement` per leaf, ``optimizer`` a
    :class:`~..train.updaters.NetworkOptimizer` over ``params`` whose
    transforms the owners reuse; ``load_state`` starts the owners from its
    state (else from zeros)."""

    def __init__(self, plan: ParallelPlan, params, placements: List[Placement], optimizer,
                 load_state: bool = True):
        from deeplearning4j_tpu_torch.train.updaters import NetworkOptimizer
        self.plan = plan
        self.mesh = plan.mesh
        self.params = params
        self.leaves: List[torch.Tensor] = tree_leaves(params)
        self.place = placements
        self.origin = self.mesh.device_at()
        for t in self.leaves:
            if t.device != self.origin:
                raise ValueError(f"the network's parameters live on {t.device}; the mesh's "
                                 f"first device is {self.origin}")
        # owners: () is the origin; (axis, j) with j >= 1 the rest
        self.slots: List[Tuple] = [()]
        for p in self.place:
            if p.axis is not None:
                for j in range(1, p.n):
                    if (p.axis, j) not in self.slots:
                        self.slots.append((p.axis, j))
        self.slot_device = {s: (self.origin if not s else self.mesh.device_at(**{s[0]: s[1]}))
                            for s in self.slots}
        # owned[slot][i]: the piece of leaf i that slot owns (empty if none)
        self.owned: Dict[Tuple, List[torch.Tensor]] = {s: [] for s in self.slots}
        with torch.no_grad():
            for t, p in zip(self.leaves, self.place):
                for s in self.slots:
                    j = self._piece_index(p, s)
                    dev = self.slot_device[s]
                    if j is None:
                        self.owned[s].append(torch.empty((0,), dtype=t.dtype, device=dev))
                    elif p.axis is None:
                        self.owned[s].append(t)  # the network's own tensor
                    else:
                        self.owned[s].append(p.piece(t, j).to(dev, copy=True).contiguous())
        self.trees = {s: tree_unflatten_like(params, self.owned[s]) for s in self.slots}
        self.optimizers = {s: NetworkOptimizer(optimizer.transforms, self.trees[s],
                                               optimizer.normalization, optimizer.decay)
                           for s in self.slots}
        self.optimizer = optimizer
        if load_state:
            self._move_state(optimizer, to_owners=True)
        self.replicas: List[_Replica] = []
        for r, coord in enumerate(plan.replica_coords()):
            rep = _Replica(r, coord, self.mesh.device_at(**coord))
            bufs, train = [], []
            for t, p in zip(self.leaves, self.place):
                if p.compute:
                    pieces = [torch.empty_like(p.piece(t, j), device=self.mesh.device_at(
                        **coord, **{p.axis: j})) for j in range(p.n)]
                    bufs.append(TensorShards(pieces, p.dim))
                    train.append(pieces if t.is_floating_point() else [])
                else:
                    buf = torch.empty_like(t, device=rep.home)
                    bufs.append(buf)
                    train.append([buf] if t.is_floating_point() else [])
            rep.buffers, rep.train = bufs, train
            rep.tree = tree_unflatten_like(params, bufs)
            self.replicas.append(rep)

    @staticmethod
    def _piece_index(p: Placement, slot) -> Optional[int]:
        if p.axis is None:
            return 0 if not slot else None
        if not slot:
            return 0
        return slot[1] if slot[0] == p.axis else None

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def has_split(self) -> bool:
        return any(p.axis is not None for p in self.place)

    def signature(self) -> tuple:
        """Addresses of every stored and replica tensor: a graph captured
        over this state stays valid while it does not change."""
        ts = [t for s in self.slots for t in self.owned[s]]
        ts += [t for rep in self.replicas for ts_ in rep.train for t in ts_]
        return tuple(t.data_ptr() for t in ts)

    # ---------------------------------------------------------------- state
    def _layer_offsets(self):
        off, out = 0, {}
        for k in sorted(self.params):
            n = len(tree_leaves(self.params[k]))
            out[k] = off
            off += n
        return out

    def _move_state(self, optimizer, to_owners: bool) -> None:
        """Copy the optimizer state between ``optimizer`` (whole leaves) and
        the owners' (their pieces): into the owners, or back."""
        offsets = self._layer_offsets()
        with torch.no_grad():
            for s in self.slots:
                opt = self.optimizers[s]
                for k, st in optimizer.state.items():
                    for f, piece, pos in state_pairs(st, opt.state[k], self.params[k]):
                        if pos is None:
                            if to_owners:
                                piece.copy_(f)
                            elif not s:
                                f.copy_(piece)
                            continue
                        p = self.place[offsets[k] + pos]
                        j = self._piece_index(p, s)
                        if j is None or not piece.numel():
                            continue
                        view = f if p.axis is None else p.piece(f, j)
                        if to_owners:
                            piece.copy_(view)
                        else:
                            view.copy_(piece)

    def reset_optimizer_state(self) -> None:
        """The owners' optimizer state back to a fresh optimizer's, in place
        (the tensors a captured step reads stay where they are)."""
        from deeplearning4j_tpu_torch.train.updaters import NetworkOptimizer
        with torch.no_grad():
            for s in self.slots:
                opt = self.optimizers[s]
                fresh = NetworkOptimizer(opt.transforms, self.trees[s], opt.normalization,
                                         opt.decay)
                for t, f in zip(tree_leaves(opt.state), tree_leaves(fresh.state), strict=True):
                    t.copy_(f)

    def load_optimizer_state(self, optimizer) -> None:
        """The owners' optimizer state reloaded from ``optimizer``'s (whole
        leaves), in place."""
        self._move_state(optimizer, to_owners=True)

    def sync_back(self, optimizer=None) -> None:
        """Write the owned pieces into the network's tensors and, given the
        network's ``optimizer``, the owners' state into it."""
        with torch.no_grad():
            for i, (t, p) in enumerate(zip(self.leaves, self.place)):
                if p.axis is None:
                    continue
                for s in self.slots:
                    j = self._piece_index(p, s)
                    if j is not None:
                        p.piece(t, j).copy_(self.owned[s][i])
        if optimizer is not None:
            self._move_state(optimizer, to_owners=False)

    # ------------------------------------------------------------------ step
    def broadcast(self) -> None:
        """The stored pieces onto every replica: whole leaves copied, stored
        splits gathered, computed splits copied piece by piece."""
        with torch.no_grad():
            for rep in self.replicas:
                for i, (p, buf) in enumerate(zip(self.place, rep.buffers)):
                    if p.axis is None:
                        buf.copy_(self.owned[()][i])
                        continue
                    for j in range(p.n):
                        src = self.owned[self._owner(p, j)][i]
                        if p.compute:
                            buf.pieces[j].copy_(src)
                        else:
                            p.piece(buf, j).copy_(src)

    @staticmethod
    def _owner(p: Placement, j: int) -> Tuple:
        return () if j == 0 else (p.axis, j)

    def replica_gradients(self, loss_fn, replica_args: Sequence, generator):
        """Every replica's loss and gradients on freshly broadcast
        parameters: ``(grads, losses, replica 0's new layer state)``, with
        ``grads[r][i]`` replica ``r``'s gradient of leaf ``i`` (a list: one
        tensor, or the computed pieces). ``loss_fn(replica, args, generator)
        -> (loss, new_state)`` is a replica's loss on its tree
        (``replica.tree``, at ``replica.coord`` on ``replica.home``);
        ``replica_args[r]`` are replica ``r``'s batch arguments on its
        device."""
        self.broadcast()
        grads, losses, state0 = [], [], None
        for rep in self.replicas:
            train = [t for ts in rep.train for t in ts]
            for t in train:
                t.requires_grad_(True)
            try:
                loss, new_state = loss_fn(rep, replica_args[rep.index], generator)
                g = torch.autograd.grad(loss, train, allow_unused=True) if train else ()
            finally:
                for t in train:
                    t.requires_grad_(False)
            g = [torch.zeros_like(t) if gi is None else gi for t, gi in zip(train, g)]
            it = iter(g)
            grads.append([[next(it) for _ in ts] for ts in rep.train])
            losses.append(loss.detach())
            if rep.index == 0:
                state0 = new_state
        return grads, losses, state0

    def mean_loss(self, losses) -> torch.Tensor:
        mean = rank_sum(losses, self.origin)
        return mean / len(losses) if len(losses) > 1 else mean

    def step(self, loss_fn, replica_args: Sequence, generator):
        """One training step (:meth:`replica_gradients`, the rank-order
        reduction, the owners' updates). Returns the mean loss (on the first
        device) and replica 0's new layer state."""
        grads, losses, state0 = self.replica_gradients(loss_fn, replica_args, generator)
        self.apply_gradients(grads)
        return self.mean_loss(losses), state0

    def full_gradients(self, grads) -> List[torch.Tensor]:
        """The reduced gradient of every leaf, whole, on the first device
        (the owners' pieces gathered in order)."""
        reduced = self.reduce(grads)
        out = []
        for i, (t, p) in enumerate(zip(self.leaves, self.place)):
            if p.axis is None:
                out.append(reduced[()][i])
                continue
            parts = [reduced[self._owner(p, j)][i].to(self.origin) for j in range(p.n)]
            out.append(torch.cat(parts, dim=p.dim))
        return out

    def load_params(self) -> None:
        """Refresh the stored pieces from the network's whole tensors
        (after the network's own optimizer has stepped them)."""
        with torch.no_grad():
            for i, (t, p) in enumerate(zip(self.leaves, self.place)):
                if p.axis is None:
                    continue
                for s in self.slots:
                    j = self._piece_index(p, s)
                    if j is not None:
                        self.owned[s][i].copy_(p.piece(t, j))

    def reduce(self, grads) -> Dict[Tuple, List[torch.Tensor]]:
        """Per owner, the gradient of each owned piece: the replicas'
        gradients summed on the owner's device in rank order, divided by the
        replica count. ``grads[r][i]`` is replica ``r``'s gradient of leaf
        ``i`` (a list: one tensor, or the computed pieces)."""
        R = len(grads)
        out = {s: [] for s in self.slots}
        with torch.no_grad():
            for i, (t, p) in enumerate(zip(self.leaves, self.place)):
                for s in self.slots:
                    j = self._piece_index(p, s)
                    dev = self.slot_device[s]
                    if j is None or not t.is_floating_point():
                        out[s].append(torch.zeros_like(self.owned[s][i]))
                        continue
                    parts = []
                    for g in grads:
                        gi = g[i]
                        if p.axis is None:
                            parts.append(gi[0])
                        elif p.compute:
                            parts.append(gi[j])
                        else:
                            parts.append(p.piece(gi[0], j))
                    acc = rank_sum(parts, dev)
                    if R > 1:
                        acc.div_(R)
                    out[s].append(acc)
        return out

    def apply_gradients(self, grads) -> None:
        reduced = self.reduce(grads)
        for s in self.slots:
            self.optimizers[s].step(self.trees[s], tree_unflatten_like(self.params, reduced[s]))


def shard_train_state(model, strategy: ParallelPlan) -> ShardedTrainState:
    """A network's parameters and optimizer placed by ``strategy`` (JAX
    ``:302``); the network's tensors stay the replicated leaves' store."""
    return ShardedTrainState(strategy, model._params,
                             placements_of(strategy, model._params),
                             model._ensure_optimizer())
