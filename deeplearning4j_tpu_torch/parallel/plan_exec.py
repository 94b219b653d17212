"""Plan executors: run a network through a plan with a ``pipe`` axis.

Counterpart of ``deeplearning4j_tpu/parallel/plan_exec.py``.
:class:`PipePlanExecutor` finds a ``MultiLayerNetwork``'s uniform trunk,
packs it into a stage-stacked tree (leading dim = pipe stages, stored one
stage piece per pipe device), and gives the replica loss that routes the
trunk through :func:`~.pipeline.gpipe` while the head and tail layers replay
the network's own ``_forward``. ``ParallelWrapper.fit`` drives it through
the same :class:`~.sharding.ShardedTrainState` step as the other plans
(``data`` splits the rows over pipelines, one per data coordinate).

Shape of the thing::

    layers:  [head ...][ trunk: S stages x k layers each ][... tail, output]
    params:  {head keys..., "__pipe_trunk__": {"t0": stacked, ...}, tail keys}

Numerics: a trunk row's math is the network's, op for op, so with
``pipe_microbatches=1`` the trained trajectory is plain data parallelism's
bit for bit; at M > 1 the microbatch gradients reassociate the batch
contraction (close, not bitwise). The trunk must be a run of
shape-preserving, stateless, identical layers with no per-layer feature
that couples stages (weight noise, constraints, l1/l2, weight decay,
frozen flags, global gradient normalization) — refused by name otherwise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from deeplearning4j_tpu_torch.nn.base import cast_floating
from deeplearning4j_tpu_torch.nn.tensor_shards import TensorShards
from deeplearning4j_tpu_torch.parallel.pipeline import gpipe
from deeplearning4j_tpu_torch.parallel.sharding import (ParallelPlan, Placement,
                                                        ShardedTrainState)
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.mesh import PIPE_AXIS
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map, tree_paths

#: params key holding the stage-stacked trunk subtree
TRUNK_KEY = "__pipe_trunk__"


def _layer_key(i, layer) -> str:
    from deeplearning4j_tpu_torch.models.multi_layer_network import _layer_key as lk
    return lk(i, layer)


class PipePlanExecutor:
    """Pipe-axis executor for one (MultiLayerNetwork, plan) pair (JAX
    ``:58``)."""

    def __init__(self, model, plan: ParallelPlan):
        if plan.pipe_size < 2:
            raise ValueError("PipePlanExecutor needs a pipe axis of size >= 2; "
                             f"plan {plan.kind} has {plan.pipe_size}")
        if not hasattr(model, "layers") or not hasattr(model, "_forward"):
            raise NotImplementedError(
                "pipe-axis plans drive MultiLayerNetwork-style layer stacks; "
                f"{type(model).__name__} has no uniform layer list to stage")
        self.model = model
        self.plan = plan
        self.S = plan.pipe_size
        model._ensure_init()
        self._find_trunk()

    # ------------------------------------------------------------ eligibility
    def _find_trunk(self) -> None:
        model, S = self.model, self.S
        layers = model.layers
        n = len(layers)
        params, state = model._params, model._model_state
        g = model.conf.global_conf

        def eligible(i):
            layer = layers[i]
            k = _layer_key(i, layer)
            if i == n - 1 and hasattr(layer, "compute_loss"):
                return False  # the loss head stays in the tail
            if i in model.conf.preprocessors or state.get(k) or k not in params:
                return False
            if getattr(layer, "weight_noise", None) is not None or layer.frozen:
                return False
            if getattr(layer, "constraints", None) or getattr(layer, "bias_constraints", None):
                return False
            l1 = layer.l1 if layer.l1 is not None else g.l1
            l2 = layer.l2 if layer.l2 is not None else g.l2
            wd = layer.weight_decay if layer.weight_decay is not None else g.weight_decay
            return not (l1 or l2 or wd)

        def sig(i):
            p = params[_layer_key(i, layers[i])]
            return ([(path, tuple(t.shape), t.dtype) for path, t in
                     zip(tree_paths(p), tree_leaves(p))])

        def uniform(i, j):
            a, b = layers[i], layers[j]
            return (type(a) is type(b)
                    and getattr(a, "activation", None) == getattr(b, "activation", None)
                    and getattr(a, "updater", None) == getattr(b, "updater", None)
                    and sig(i) == sig(j))

        best: Tuple[int, int] = (0, 0)
        i = 0
        while i < n:
            if not eligible(i):
                i += 1
                continue
            j = i + 1
            while j < n and eligible(j) and uniform(i, j):
                j += 1
            if j - i > best[1]:
                best = (i, j - i)
            i = j
        start, length = best
        length -= length % S  # spare layers stay in the tail
        if length < S:
            raise ValueError(
                f"no uniform trunk of >= {S} shape-preserving stateless layers found for a "
                f"pipe axis of {S} (longest run: {best[1]}); pipe plans need a "
                "transformer-style stack — use fsdp/tensor axes for this model instead")
        if g.gradient_normalization:
            raise NotImplementedError(
                "global gradient normalization couples pipe stages through the stacked trunk "
                "— train this model unpipelined, or drop gradient_normalization")
        self.t0, self.n_trunk, self.k = start, length, length // S
        self.head: List[int] = list(range(start))
        self.tail: List[int] = list(range(start + length, n))
        self.trunk_keys = {_layer_key(i, layers[i]) for i in range(start, start + length)}

    # ---------------------------------------------------------- param packing
    def _trunk_layer(self, s: int, j: int) -> int:
        return self.t0 + s * self.k + j

    def pack_params(self, params: Dict[str, Any]) -> Dict[str, Any]:
        """Per-layer tree -> packed tree: trunk keys collapse into
        ``TRUNK_KEY`` holding, per in-stage position j, the stage-stacked
        leaves (new tensors); the other leaves are the same tensors."""
        from deeplearning4j_tpu_torch.parallel.pipeline import stack_stage_params
        layers = self.model.layers
        packed = {k: v for k, v in params.items() if k not in self.trunk_keys}
        with torch.no_grad():
            packed[TRUNK_KEY] = {
                f"t{j}": stack_stage_params([
                    params[_layer_key(self._trunk_layer(s, j), layers[self._trunk_layer(s, j)])]
                    for s in range(self.S)])
                for j in range(self.k)}
        return packed

    def repack(self, packed: Dict[str, Any]) -> None:
        """Copy the network's current per-layer trunk values into an
        existing packed tree, in place."""
        layers = self.model.layers
        with torch.no_grad():
            for s in range(self.S):
                for j in range(self.k):
                    i = self._trunk_layer(s, j)
                    src = tree_leaves(self.model._params[_layer_key(i, layers[i])])
                    for d, t in zip(tree_leaves(packed[TRUNK_KEY][f"t{j}"]), src):
                        d[s].copy_(t)

    def unpack_into(self, packed: Dict[str, Any], params: Dict[str, Any]) -> None:
        """Copy a packed tree's trunk back into the per-layer ``params``."""
        layers = self.model.layers
        with torch.no_grad():
            for s in range(self.S):
                for j in range(self.k):
                    i = self._trunk_layer(s, j)
                    dst = tree_leaves(params[_layer_key(i, layers[i])])
                    src = tree_leaves(packed[TRUNK_KEY][f"t{j}"])
                    for d, t in zip(dst, src):
                        d.copy_(t[s])

    def placements(self, packed) -> List[Placement]:
        """Trunk leaves split on their stage dim over ``pipe``; the rest by
        the plan's rule (fsdp/tensor)."""
        out = []
        for path, leaf in zip(tree_paths(packed), tree_leaves(packed)):
            if path[0] == TRUNK_KEY:
                out.append(Placement(PIPE_AXIS, 0, self.S))
                continue
            spec = self.plan.leaf_spec(path, tuple(leaf.shape))
            split = [(d, a) for d, a in enumerate(spec) if a is not None]
            out.append(Placement(split[0][1], split[0][0], self.plan.axis_size(split[0][1]))
                       if split else Placement())
        return out

    def packed_optimizer(self, packed):
        """Head/tail layers keep their update; the trunk trains under its
        (uniform) layer's updater on the stacked leaves. Elementwise
        updaters make stacked and per-layer updates the same bits."""
        from deeplearning4j_tpu_torch.train.updaters import NetworkOptimizer
        opt = self.model._ensure_optimizer()
        layers = self.model.layers
        transforms = {k: u for k, u in opt.transforms.items() if k not in self.trunk_keys}
        transforms[TRUNK_KEY] = opt.transforms[_layer_key(self.t0, layers[self.t0])]
        decay = {k: d for k, d in opt.decay.items() if k not in self.trunk_keys}
        return NetworkOptimizer(transforms, packed, {}, decay)

    def packed_state(self) -> Tuple[ShardedTrainState, Dict[str, Any]]:
        """``(sharded state over the packed tree, the packed tree)``. The
        updater slots start fresh for the packed tree (as the JAX package's
        ``packed_state``), so a fit that starts here matches the unpipelined
        fit from the same parameters under SGD-family updaters."""
        packed = self.pack_params(self.model._params)
        opt = self.packed_optimizer(packed)
        return ShardedTrainState(self.plan, packed, self.placements(packed), opt,
                                 load_state=False), packed

    def sync_back(self, state: ShardedTrainState, packed) -> None:
        """The trained pieces back into the network's per-layer tensors; the
        network's updater state starts afresh (JAX ``sync_back``)."""
        state.sync_back()
        self.unpack_into(packed, self.model._params)
        self.model._optimizer = None

    # -------------------------------------------------------------- forward
    def _apply_outer_layer(self, params, state, new_state, x, i, training, generator):
        """One head/tail layer as ``MultiLayerNetwork._forward`` runs it, on
        the layer state ``state``. Returns ``(x, last_input)``."""
        model = self.model
        layer = model.layers[i]
        k = _layer_key(i, layer)
        if i in model.conf.preprocessors:
            x = model.conf.preprocessors[i].pre_process(x, None)
        p = params.get(k, {})
        if i == len(model.layers) - 1 and hasattr(layer, "compute_loss"):
            x = layer._apply_input_dropout(x, layer._g, training, generator)
            return layer.activate(p, x), x
        s = state.get(k, {})
        x, s_new = layer.forward(p, s, x, training=training, generator=generator, mask=None)
        if s:
            new_state[k] = s_new
        return x, None

    def _stage_fn(self, training: bool, generator):
        t0, k, layers = self.t0, self.k, self.model.layers

        def stage_fn(stage_tree, mb):
            x = mb
            for j in range(k):
                x, _ = layers[t0 + j].forward(stage_tree[f"t{j}"], {}, x, training=training,
                                              generator=generator, mask=None)
            return x

        return stage_fn

    def packed_forward(self, params, x, *, training: bool, generator, at=None,
                       model_state=None):
        """``(out, output layer input, new_state)``: the packed twin of
        ``MultiLayerNetwork._forward`` for the pipeline at ``at`` (the
        replica's data coordinate), over ``model_state`` (default: the
        network's)."""
        cdt = get_environment().compute_dtype
        if x.is_floating_point() and x.dtype != cdt:
            x = x.to(cdt)
        params = cast_floating(params, cdt)
        state = self.model._model_state if model_state is None else model_state
        new_state = dict(state)
        last_in = x
        for i in self.head:
            x, _ = self._apply_outer_layer(params, state, new_state, x, i, training,
                                           generator)
        trunk = tree_map(lambda ts: TensorShards([ts.piece(s, cdt) for s in range(self.S)], 0),
                         params[TRUNK_KEY])
        # the schedule depth must divide this call's rows: the largest
        # divisor <= the plan's (per-row results do not depend on the split)
        m = math.gcd(int(x.shape[0]), self.plan.pipe_microbatches)
        x = gpipe(self._stage_fn(training, generator), trunk, x, mesh=self.plan.mesh,
                  n_microbatches=m, at=at)
        for i in self.tail:
            x, li = self._apply_outer_layer(params, state, new_state, x, i, training,
                                            generator)
            if li is not None:
                last_in = li
        return x, last_in, new_state

    # ----------------------------------------------------------------- serve
    def make_forward(self):
        """``fwd(packed_params, model_state, x, mask=None) -> output``: the
        packed twin of ``MultiLayerNetwork.output``'s forward, for serving
        (JAX ``:404-417``). Serving builds one executor per replica group,
        so the schedule runs over that group's pipe positions."""
        def fwd(params, model_state, x, mask=None):
            if mask is not None:
                raise NotImplementedError(
                    "feature masks are not supported under pipe-axis plans")
            out, _, _ = self.packed_forward(params, x, training=False, generator=None,
                                            model_state=model_state)
            return out

        return fwd

    def packed_loss(self, params, args, generator, at=None):
        """A replica's training loss through the pipeline: ``args`` are
        ``(x, y, fm, lm)``; feature masks do not stream through the ring."""
        from deeplearning4j_tpu_torch.train.updaters import reg_score
        x, y, fm, lm = args
        if fm is not None:
            raise NotImplementedError("feature masks are not supported under pipe-axis plans")
        model = self.model
        params = model._perturbed(params, generator)
        _, last_in, new_state = self.packed_forward(params, x, training=True,
                                                    generator=generator, at=at)
        n = len(model.layers)
        final = model.layers[-1]
        if not hasattr(final, "compute_loss"):
            raise ValueError("Last layer must be an output/loss layer")
        k = _layer_key(n - 1, final)
        loss = final.compute_loss(cast_floating(params.get(k, {}),
                                                get_environment().compute_dtype),
                                  last_in, y, mask=lm)
        # the trunk's layers carry no penalty (an eligibility rule)
        reg = reg_score([(_layer_key(i, model.layers[i]), model.layers[i])
                         for i in self.head + self.tail], params, model.conf.global_conf)
        if reg is not None:
            loss = loss + reg
        return loss, new_state
