"""ParallelWrapper: multi-device training driver.

Counterpart of ``deeplearning4j_tpu/parallel/wrapper.py`` (upstream
``org.deeplearning4j.parallelism.ParallelWrapper``). One process drives the
plan's mesh: each step splits the batch over the replicas, runs every
replica's loss and gradients, sums the gradients in rank order on their
owners' devices and steps the owners' optimizers
(:class:`~.sharding.ShardedTrainState`) — synchronous all-reduce SGD,
averaging every iteration, as the JAX package's one SPMD program is. No
trainer threads, no averaging frequency, no encoded updates.

The feed path is the fit loops': :func:`~..train.prefetch.batch_source`
stages ``prefetch_buffer`` batches ahead on the mesh's first device,
:class:`~..runtime.state_packing.GroupedDispatch` groups
``env.dispatch_unroll`` steps a dispatch, and listener delivery rides
:class:`~..train.prefetch.AsyncLossDelivery` when every listener is
stateless. Where the mesh's devices are one device (a mesh that repeats
``cuda:0``, or the CPU), a step — every replica's forward and backward, the
copies, the sums and the updates — goes through the network's
:class:`~..runtime.compile_cache.AotCache` (``__aot_pw__``): captured as
one CUDA graph on the card and replayed; each key has its own static
buffers, so two replicas on one device never share one. A mesh over
several physical devices steps eagerly. Plans with a ``pipe`` axis go
through :class:`~.plan_exec.PipePlanExecutor` (:meth:`_fit_pipe`).

Differences from the JAX package, refused by name where they apply: a
network with layer state (BatchNormalization's running statistics) trains
on one replica only (the JAX step's statistics are the global batch's,
which one replica per device cannot give without a synchronised norm);
gradient normalization, constraints, and (on tensor-split layers) weight
noise and l1/l2 need whole leaves, so they are refused on split plans.
After ``fit`` the network's tensors and optimizer state hold the trained
values.
"""

from __future__ import annotations

from typing import Optional

from deeplearning4j_tpu_torch.parallel.sharding import (ParallelPlan, ShardedTrainState,
                                                        ShardingStrategy, shard_batch_tree,
                                                        shard_train_state)
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, create_mesh, devices
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_paths
from deeplearning4j_tpu_torch.train.listeners import PerformanceListener


def _is_graph(model) -> bool:
    from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
    return isinstance(model, ComputationGraph)


class ParallelWrapper:
    """Usage (the reference's builder)::

        pw = (ParallelWrapper.builder(net)
              .workers(8)                      # optional; default all devices
              .strategy("data_parallel")       # or "fsdp" / "tensor_parallel"
              .prefetch_buffer(2)
              .build())
        pw.fit(iterator, epochs=2)

    or ``ParallelWrapper(net, plan)`` with any :class:`ParallelPlan`.
    """

    def __init__(self, model, strategy: Optional[ParallelPlan] = None,
                 prefetch_buffer: int = 2):
        self.model = model
        if strategy is None:
            strategy = ShardingStrategy.data_parallel(create_mesh())
        self.strategy = strategy
        self.prefetch_buffer = max(0, int(prefetch_buffer))
        self._state: Optional[ShardedTrainState] = None
        # the pipe path's (executor, state, packed tree, the network's leaves)
        self._pipe = None
        self._unrolled = {}

    class Builder:
        def __init__(self, model):
            self._model = model
            self._workers = None
            self._strategy_name = "data_parallel"
            self._prefetch_buffer = 2

        def workers(self, n: int) -> "ParallelWrapper.Builder":
            self._workers = int(n)
            return self

        def strategy(self, name: str) -> "ParallelWrapper.Builder":
            self._strategy_name = name
            return self

        def averaging_frequency(self, n: int) -> "ParallelWrapper.Builder":
            return self  # synchronous all-reduce == averaging every iteration

        def prefetch_buffer(self, n: int) -> "ParallelWrapper.Builder":
            self._prefetch_buffer = max(0, int(n))
            return self

        def build(self) -> "ParallelWrapper":
            devs = devices(str(self._model.device) if self._model.device is not None else None)
            if self._workers:
                devs = devs[: self._workers]
            if self._strategy_name == "tensor_parallel":
                mesh = create_mesh({DATA_AXIS: 1, MODEL_AXIS: -1}, devices_=devs)
            else:
                mesh = create_mesh(devices_=devs)
            factory = {"data_parallel": ShardingStrategy.data_parallel,
                       "fsdp": ShardingStrategy.fsdp,
                       "tensor_parallel": ShardingStrategy.tensor_parallel}[self._strategy_name]
            return ParallelWrapper(self._model, factory(mesh),
                                   prefetch_buffer=self._prefetch_buffer)

    @staticmethod
    def builder(model) -> "ParallelWrapper.Builder":
        return ParallelWrapper.Builder(model)

    # ------------------------------------------------------------ refusals
    def _check_supported(self) -> None:
        """The wrapper drives the plain SGD step; modes the network's own
        fit special-cases would train with other gradients here, so they
        are refused (JAX ``:117-143``)."""
        g = self.model.conf.global_conf
        algo = getattr(g, "optimization_algo", None) or "STOCHASTIC_GRADIENT_DESCENT"
        if algo != "STOCHASTIC_GRADIENT_DESCENT":
            raise NotImplementedError(
                f"ParallelWrapper supports optimization_algo=SGD only (got {algo!r}); legacy "
                "solvers run single-context via the model's own fit()")

    def _check_not_tbptt(self, x) -> None:
        from deeplearning4j_tpu_torch.models._tbptt import is_sequence_array
        if getattr(self.model.conf, "tbptt_fwd_length", None) and is_sequence_array(x):
            raise NotImplementedError(
                "tBPTT training under ParallelWrapper is not supported — the wrapper would run "
                "full-sequence BPTT instead of the model's tBPTT chunking; use the model's own "
                "fit(), or full-sequence BPTT (unset tbptt_fwd_length) to train sharded")

    def _check_placements(self, state: ShardedTrainState, params) -> None:
        model = self.model
        g = model.conf.global_conf
        if state.n_replicas > 1 and tree_leaves(model._model_state):
            raise NotImplementedError(
                "ParallelWrapper: layer state (BatchNormalization running statistics) over "
                f"{state.n_replicas} replicas is not ported: the statistics would be each "
                "replica's, not the global batch's")
        if not state.has_split():
            return
        if g.gradient_normalization:
            raise NotImplementedError("ParallelWrapper: gradient_normalization needs whole "
                                      f"leaves, and plan {self.strategy.kind} splits some")
        split_layers, computed = set(), set()
        for path, p in zip(tree_paths(params), state.place):
            if p.axis is not None:
                split_layers.add(path[0])
                if p.compute:
                    computed.add(path[0])
        for k, layer in self._named_layers():
            if k in split_layers and (getattr(layer, "constraints", None)
                                      or getattr(layer, "bias_constraints", None)):
                raise NotImplementedError(f"ParallelWrapper: constraints of layer {k!r} need its "
                                          f"whole weights, and plan {self.strategy.kind} splits "
                                          "them")
            if k in computed:
                l1 = layer.l1 if layer.l1 is not None else g.l1
                l2 = layer.l2 if layer.l2 is not None else g.l2
                if l1 or l2 or getattr(layer, "weight_noise", None) is not None:
                    raise NotImplementedError(
                        f"ParallelWrapper: l1/l2 and weight noise of layer {k!r} are not ported "
                        "under a tensor-parallel split")

    def _named_layers(self):
        model = self.model
        if _is_graph(model):
            return [(n.name, n.obj) for n in model.conf.nodes if n.kind == "layer"]
        from deeplearning4j_tpu_torch.models.multi_layer_network import _layer_key
        return [(_layer_key(i, l), l) for i, l in enumerate(model.layers)]

    # ------------------------------------------------------------- batches
    def _prepare_batch(self, batch, staged: bool = False):
        """One batch as step arguments on the mesh's first device, and its
        row count (pure with respect to the model's state: the prefetcher
        runs it ahead of the step)."""
        model = self.model
        n_div = self.strategy.batch_divisor()
        if _is_graph(model):
            inputs, labels, masks = model._coerce_batch(batch, staged=staged)
            for v in inputs.values():
                self._check_not_tbptt(v)
            n = next(iter(inputs.values())).shape[0]
            args = (inputs, labels, masks)
        else:
            x, y, fm, lm = model._coerce_batch(batch, staged=staged)
            self._check_not_tbptt(x)
            n = x.shape[0]
            args = (x, y, fm, lm)
        if n % n_div:
            raise ValueError(f"Batch size {n} not divisible by data-parallel size {n_div}")
        return args, n

    def _insert_rng(self, args):
        """The step's arguments with the next generator spliced in at
        dispatch time (its order follows submission, never prefetch)."""
        gen = self.model._step_generator()
        if _is_graph(self.model):
            return (args[0], args[1], gen, args[2])
        return (args[0], args[1], gen, args[2], args[3])

    @staticmethod
    def _batch_of(args):
        """``(batch tree, generator)`` of a step's arguments."""
        if len(args) == 4:  # graph: (inputs, labels, gen, masks)
            return (args[0], args[1], args[3]), args[2]
        return (args[0], args[1], args[3], args[4]), args[2]

    # ---------------------------------------------------------------- step
    def _aot(self):
        from deeplearning4j_tpu_torch.runtime.compile_cache import AotCache
        return self.model._runtime_cache.setdefault("__aot_pw__", AotCache("pw-step"))

    def _single_device(self) -> bool:
        return len({str(d) for d in self.strategy.mesh.device_list()}) == 1

    def _make_step(self, state: ShardedTrainState, loss_fn, after=None):
        """The step function ``(*step args) -> loss`` over ``state``: the
        rows split over the replicas (copies to their devices), the
        sharded step, then ``after(new_state)``."""
        def step(*args):
            batch, gen = self._batch_of(args)
            loss, new_state = state.step(loss_fn, shard_batch_tree(state.plan, batch), gen)
            if after is not None:
                after(new_state)
            return loss

        return step

    def _dispatch(self, state, step_fn, args):
        if not self._single_device():
            return step_fn(*args)
        from deeplearning4j_tpu_torch.runtime.state_packing import step_args_signature
        return self._aot().call(("pw", self.strategy.signature(), state.signature(),
                                 step_args_signature(args)), step_fn, *args)

    def _run_group(self, state, step_fn, group):
        """K compatible steps as one dispatch (one graph on the card)."""
        from deeplearning4j_tpu_torch.runtime.state_packing import (make_unrolled_step,
                                                                    step_args_signature)
        k = len(group)
        if not self._single_device():
            return [step_fn(*args) for args, _n in group]
        if k not in self._unrolled:
            self._unrolled[k] = make_unrolled_step(step_fn, k)
        losses = self._aot().call(("pw-group", self.strategy.signature(), state.signature(), k,
                                   step_args_signature(group[0][0])),
                                  self._unrolled[k], [args for args, _n in group])
        return [losses[i] for i in range(k)]

    def _begin(self, state: ShardedTrainState) -> None:
        """A fresh state: captured graphs over any other are dropped."""
        sig = state.signature()
        self._aot().evict(lambda key: key[2] != sig)
        self._unrolled = {}
        self._state = state

    # ----------------------------------------------------------------- fit
    def fit(self, iterator, epochs: int = 1, profiler=None):
        """Distributed fit (JAX ``:278``): the network's listener and epoch
        semantics, the batches split across the mesh, prefetched
        ``prefetch_buffer`` deep, losses delivered on the async path.
        Plans with a ``pipe`` axis go through :meth:`_fit_pipe`."""
        if self.strategy.pipe_size > 1:
            return self._fit_pipe(iterator, epochs, profiler)
        from deeplearning4j_tpu_torch.runtime.state_packing import assign_state
        self._check_supported()
        model = self.model
        model._ensure_init()
        state = self._reuse_state()
        if state is None:
            state = shard_train_state(model, self.strategy)
            self._check_placements(state, model._params)
            self._begin(state)
        model._seed_device_generator()
        self._aot().generators = model._device_generators()

        def after(new_state):
            if not state.has_split():
                model._apply_constraints()
            model._model_state = assign_state(model._model_state, new_state)

        step_fn = self._make_step(state, lambda rep, a, g: model._replica_loss(rep.tree, a, g),
                                  after)
        try:
            self._run_epochs(iterator, epochs, profiler, state, step_fn)
        finally:
            state.sync_back(model._optimizer)
        return model

    def _reuse_state(self) -> Optional[ShardedTrainState]:
        """The last fit's sharded state when the network still holds the
        same tensors and optimizer (its captured graphs then replay): the
        stored pieces and the owners' optimizer state reloaded from the
        network, in place. ``None`` when anything moved."""
        state, model = self._state, self.model
        if (state is None or state.plan is not self.strategy
                or state.optimizer is not model._optimizer
                or len(state.leaves) != len(tree_leaves(model._params))
                or any(a is not b for a, b in zip(state.leaves, tree_leaves(model._params)))):
            return None
        state.load_params()
        state.load_optimizer_state(model._optimizer)
        return state

    def _run_epochs(self, iterator, epochs, profiler, state, step_fn) -> None:
        from deeplearning4j_tpu_torch.runtime.state_packing import GroupedDispatch
        from deeplearning4j_tpu_torch.train.prefetch import (AsyncLossDelivery, batch_source,
                                                             stateless_listeners)
        from deeplearning4j_tpu_torch.train.profiler import submit_timed
        model = self.model
        if _is_graph(model):
            from deeplearning4j_tpu_torch.models.computation_graph import (
                _cg_group_compatible as base_compat)
        else:
            from deeplearning4j_tpu_torch.models.multi_layer_network import (
                _group_compatible as base_compat)
        stateless = stateless_listeners(model)

        def deliver(n, loss):
            model._score = loss
            model._iteration += 1
            for lst in model._listeners:
                if isinstance(lst, PerformanceListener):
                    lst.record_batch(n)
                lst.iteration_done(model, model._iteration, model._epoch, loss)

        adel = (AsyncLossDelivery(deliver, profiler=profiler)
                if (model._listeners or profiler is not None) and stateless else None)
        sink = adel.submit if adel is not None else deliver
        gd = GroupedDispatch(
            unroll=(get_environment().dispatch_unroll if stateless else 1),
            compatible=lambda a, b: base_compat(a[0], b[0]),
            run_single=lambda item: self._dispatch(state, step_fn, item[0]),
            run_group=lambda group: self._run_group(state, step_fn, group),
            deliver=lambda item, loss: sink(item[1], loss))
        drain = adel.flush if adel is not None else (lambda: None)
        if profiler is not None:
            profiler.start()
        try:
            for _ in range(int(epochs)):
                for lst in model._listeners:
                    lst.on_epoch_start(model, model._epoch)
                src = batch_source(iterator, self._prepare_batch, self.prefetch_buffer, profiler,
                                   device=state.origin,
                                   staged_prepare=lambda b: self._prepare_batch(b, staged=True))
                try:
                    for args, n in src:
                        submit_timed(gd, (self._insert_rng(args), n), profiler)
                finally:
                    src.close()
                gd.flush()
                drain()  # on_epoch_end must observe every iteration
                for lst in model._listeners:
                    lst.on_epoch_end(model, model._epoch)
                model._epoch += 1
        finally:
            gd.drain_on_error()
            if adel is not None:
                adel.shutdown()  # never raises; original errors win
            if profiler is not None:
                profiler.stop()
        if adel is not None:
            adel.raise_pending()

    def _fit_pipe(self, iterator, epochs: int, profiler=None):
        """Pipe-axis fit (JAX ``:214``): the network's uniform trunk
        stage-stacked and streamed through the GPipe schedule, one pipeline
        per data coordinate, through the same step and feed path; the
        trained parameters are written back into the network."""
        from deeplearning4j_tpu_torch.parallel.plan_exec import PipePlanExecutor
        self._check_supported()
        model = self.model
        if _is_graph(model):
            raise NotImplementedError("pipe-axis plans drive MultiLayerNetwork layer stacks; "
                                      "ComputationGraph topologies have no linear trunk to stage")
        model._ensure_init()
        leaves = tree_leaves(model._params)
        pipe = self._pipe
        if pipe is not None and pipe[0].plan is self.strategy and len(pipe[3]) == len(
                leaves) and all(a is b for a, b in zip(pipe[3], leaves)):
            # the same tensors: repack in place, so the captured steps replay
            ex, state, packed, _ = pipe
            ex.repack(packed)
            state.load_params()
            state.reset_optimizer_state()
        else:
            ex = PipePlanExecutor(model, self.strategy)
            state, packed = ex.packed_state()
            self._check_placements(state, packed)
            self._begin(state)
            self._pipe = (ex, state, packed, leaves)
        model._seed_device_generator()
        self._aot().generators = model._device_generators()

        def loss_fn(rep, args, gen):
            return ex.packed_loss(rep.tree, args, gen, at=rep.coord)

        step = self._make_step(state, loss_fn)
        try:
            self._run_epochs(iterator, epochs, profiler, state, step)
        finally:
            ex.sync_back(state, packed)
        return model

