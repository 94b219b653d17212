"""MultiLayerNetwork: linear layer stack, training and inference.

Counterpart of ``deeplearning4j_tpu/models/multi_layer_network.py``:
``init``, ``fit`` (with truncated BPTT), ``score``, ``output``,
``feed_forward``, ``evaluate`` (and its regression and ROC forms), mask
propagation (a layer with ``transform_mask`` realigns the features mask
for the layers after it, and the default labels mask of per-timestep labels
is the mask at the output, JAX ``:212-214``, ``:592-602``),
listeners, the stateful RNN API (``rnn_time_step``,
``rnn_time_step_external``, ``rnn_activate_using_stored_state``,
``rnn_get_state``/``rnn_set_state``/``rnn_zero_state``/
``rnn_clear_previous_state``), the external-errors mode
(``backprop_gradient``, ``fit_external``), ``summary``, ``clone`` and
``save``/``load``. ``_forward`` keeps the JAX semantics of ``:156-215``: a
layer's input preprocessor (``conf.preprocessors``) reshapes its input
first; the input and the parameters are cast to ``compute_dtype`` (the
parameters stay ``default_dtype`` masters, and their gradients come back
through the cast); layers apply their input dropout in training; the output
layer runs through ``activate`` (a softmax at every timestep for
``RnnOutputLayer``); carries start in ``carry_dtype``. The loss adds the
layers' l1/l2 penalties (JAX ``_reg_score``). In training a layer with
``weight_noise`` sees its perturbed weights (the loss too), and after each
update the layers' ``constraints``/``bias_constraints`` project the
parameters (JAX ``:187``, ``:232``, ``:278``).

``fit`` runs the JAX package's training runtime (``:370-500`` there):
the steps go through :class:`~..runtime.state_packing.PackedStepLoop` and
:class:`~..runtime.state_packing.GroupedDispatch` (``env.dispatch_unroll``
steps a dispatch), the batches through
:func:`~..train.prefetch.batch_source` (``prefetch_buffer``), listener
delivery through :class:`~..train.prefetch.AsyncLossDelivery` when every
listener is stateless, and dispatch timing through
:func:`~..train.profiler.submit_timed`. A step is ``_loss`` ->
``torch.autograd`` -> :class:`~..train.updaters.NetworkOptimizer`, all in
place; on a CUDA device it is captured once and replayed
(:class:`~..runtime.compile_cache.AotCache`), one graph for a group. A
truncated-BPTT batch flushes the group, drains the delivery and runs its
chunks eagerly, the carries detached between chunks (JAX ``:505-524``).
The inference entry points run under ``torch.inference_mode``, so the
recurrent layers launch the kernels' inference instance there.

Parameters live on one device, chosen at :meth:`init`: ``cuda`` unless the
caller asks for the CPU (``device="cpu"`` or
``get_environment().set_device("cpu")``).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.models._tbptt import (carry_dtype, is_sequence_array,
                                                    slice_time)
from deeplearning4j_tpu_torch.nn.base import Layer, cast_floating
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.constraints import apply_layer_constraints, apply_weight_noise
from deeplearning4j_tpu_torch.nn.recurrent_layers import BaseRecurrentLayer
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.rng import RngManager, generator_for, recomputed
from deeplearning4j_tpu_torch.runtime.state_packing import assign_state
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map, tree_unflatten_like
from deeplearning4j_tpu_torch.train.listeners import PerformanceListener, TrainingListener
from deeplearning4j_tpu_torch.train.prefetch import as_device_tensor
from deeplearning4j_tpu_torch.train.updaters import NetworkOptimizer, reg_score


def _layer_key(i: int, layer: Layer) -> str:
    return layer.name or f"layer_{i}"


def trained_leaves(params, frozen_keys) -> List[torch.Tensor]:
    """The floating-point leaves of ``params`` that take a gradient: not
    those of a frozen layer, whose update is zero (the ``NoOp`` updater),
    so the backward pass stops at the first layer that trains."""
    frozen = {id(t) for k in frozen_keys for t in tree_leaves(params.get(k, {}))}
    return [t for t in tree_leaves(params) if t.is_floating_point() and id(t) not in frozen]


def leaf_gradients(params, leaves, trained, grads):
    """The gradient of every leaf, nested as ``params``: ``grads`` (in
    ``trained`` order) where there is one, zeros elsewhere."""
    by_id = dict(zip((id(t) for t in trained), grads))
    return tree_unflatten_like(params, [by_id.get(id(t)) if by_id.get(id(t)) is not None
                                        else torch.zeros_like(t) for t in leaves])


def _group_compatible(a, b) -> bool:
    """Whether two buffered (x, y, generator, fm, lm) step tuples may share
    one grouped dispatch: same input/label shapes and mask presence."""
    return (a[0].shape == b[0].shape and a[1].shape == b[1].shape
            and (a[3] is None) == (b[3] is None)
            and (a[4] is None) == (b[4] is None))


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, device=None):
        self.conf = conf
        self.layers: List[Layer] = conf.layers
        for l in self.layers:
            l._g = conf.global_conf
        self.rng = RngManager(conf.global_conf.seed)
        self._requested_device = device
        self.device: Optional[torch.device] = None
        self._params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._model_state: Dict[str, Dict[str, torch.Tensor]] = {}
        self._optimizer: Optional[NetworkOptimizer] = None
        # updaterState.npz arrays of a restored archive, loaded into the
        # optimizer when it is built
        self._restored_updater_leaves: Optional[List[np.ndarray]] = None
        self._listeners: List[TrainingListener] = []
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self._rnn_carries: Optional[Dict[str, Any]] = None
        # the training runtime's per-network cache: the packed state, the
        # captured graphs (``__aot__``), the step functions
        self._runtime_cache: Dict[str, Any] = {}
        self._device_gen: Optional[torch.Generator] = None

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict] = None) -> "MultiLayerNetwork":
        """Draw the parameters (or take ``params``) and the layers' state,
        and place them on the network's device. Each layer draws from its own
        generator, folded from the config seed and the layer index."""
        self.device = get_environment().resolve_device(self._requested_device)
        g = self.conf.global_conf
        if g.dtype is None:
            g = dataclasses.replace(g, dtype=get_environment().default_dtype)
        new_params: Dict[str, Dict] = {}
        model_state: Dict[str, Dict] = {}
        for i, layer in enumerate(self.layers):
            if params is not None and not layer.has_state:
                continue  # given params: only the layers' state is drawn
            it = self.conf.layer_input_types[i] if self.conf.layer_input_types else None
            p, s = layer.init(generator_for(g.seed, i), it, g)
            if p and params is None:
                new_params[_layer_key(i, layer)] = p
            if s:
                model_state[_layer_key(i, layer)] = s
        self._params = tree_map(lambda t: t.to(self.device),
                                new_params if params is None else params)
        self._model_state = tree_map(lambda t: t.to(self.device), model_state)
        self._optimizer = None  # built at the first fit, on these parameters
        self._restored_updater_leaves = None
        self._rnn_carries = None
        self._runtime_cache = {}
        return self

    def _ensure_init(self) -> None:
        if self._params is None:
            self.init()

    def _as_input(self, x, staged: bool = False) -> torch.Tensor:
        """Tensor on the network's device; float64 becomes float32, as the
        JAX package (64-bit off) reads it. ``staged``: through pinned host
        memory, without waiting (the prefetcher's stream orders it)."""
        return as_device_tensor(x, self.device, staged)

    # --------------------------------------------------------------- forward
    def _forward(self, params, model_state, x, *, training: bool = False,
                 generator: Optional[torch.Generator] = None, fmask=None,
                 carries: Optional[Dict] = None):
        """Compose all layers; returns ``(out, last_in, new_state,
        new_carries)``. ``last_in`` is the output layer's input after its
        input dropout, so the loss and the output see the same activations.
        ``new_state`` is ``model_state`` with each stateful layer's new state
        (``BatchNormalization``'s running statistics in training), as JAX
        ``:208-212`` keeps it."""
        cdt = get_environment().compute_dtype
        if x.is_floating_point() and x.dtype != cdt:
            x = x.to(cdt)
        params = cast_floating(params, cdt)
        new_carries = {} if carries is not None else None
        new_state = dict(model_state)
        last_in = x
        n = len(self.layers)
        # a chain: every layer boundary is a cut point, so with remat on each
        # hidden layer is recomputed in the backward pass (JAX :171-176)
        remat = (get_environment().remat_segments and training and carries is None
                 and n > 2)
        for i, layer in enumerate(self.layers):
            k = _layer_key(i, layer)
            if i in self.conf.preprocessors:
                x = self.conf.preprocessors[i].pre_process(x, fmask)
            p = params.get(k, {})
            if i == n - 1 and hasattr(layer, "compute_loss"):
                x = layer._apply_input_dropout(x, layer._g, training, generator)
                last_in = x
                x = layer.activate(p, x)
            elif carries is not None and isinstance(layer, BaseRecurrentLayer):
                x = layer._apply_input_dropout(x, layer._g, training, generator)
                x, new_carries[k] = layer.forward_with_carry(
                    p, carries[k], x, training=training, generator=generator, mask=fmask)
            else:
                s = model_state.get(k, {})
                if remat:
                    x, s_new = recomputed(
                        lambda x_, l_=layer, p_=p, s_=s, m_=fmask: l_.forward(
                            p_, s_, x_, training=True, generator=generator, mask=m_), x)
                else:
                    x, s_new = layer.forward(p, s, x, training=training, generator=generator,
                                             mask=fmask)
                if s:
                    new_state[k] = s_new
            if fmask is not None and hasattr(layer, "transform_mask"):
                # a layer that changes the time axis realigns the mask
                fmask = layer.transform_mask(fmask)
        return x, last_in, new_state, new_carries

    def _output_time_mask(self, fmask):
        """The features mask carried through every layer that changes the
        time axis (JAX ``:592-602``): the default labels mask of
        per-timestep labels lines up with the output's time axis, not the
        input's."""
        if fmask is None:
            return None
        for layer in self.layers:
            if hasattr(layer, "transform_mask"):
                fmask = layer.transform_mask(fmask)
        return fmask

    def _perturbed(self, params, generator):
        """``params`` cast to ``compute_dtype``, with each layer that has
        ``weight_noise`` seeing its perturbed weights (JAX ``_forward``
        ``:187``), drawn from ``generator``; unchanged without one."""
        if generator is None or not any(l.weight_noise is not None for l in self.layers):
            return params
        params = cast_floating(params, get_environment().compute_dtype)
        out = dict(params)
        for i, layer in enumerate(self.layers):
            k = _layer_key(i, layer)
            if layer.weight_noise is not None and k in out:
                out[k] = apply_weight_noise(layer, out[k], generator)
        return out

    def _apply_constraints(self) -> None:
        """Project the parameters by the layers' constraints, in place
        (JAX ``_apply_constraints``, after each update)."""
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                k = _layer_key(i, layer)
                if k not in self._params:
                    continue
                for name, t in apply_layer_constraints(layer, self._params[k]).items():
                    if t is not self._params[k][name]:
                        self._params[k][name].copy_(t)

    def _loss(self, params, model_state, x, y, generator=None, fmask=None, lmask=None,
              carries=None, training: bool = True):
        """The output layer's loss on ``(x, y)`` plus the l1/l2 penalty of
        the (uncast) parameters (JAX ``:217-275``); returns ``(loss,
        new_state, new_carries)``. In training the forward and the loss see
        the weights perturbed by the layers' weight noise."""
        final = self.layers[-1]
        if not hasattr(final, "compute_loss"):
            raise ValueError("Last layer must be an output/loss layer to compute loss")
        reg = reg_score([(_layer_key(i, l), l) for i, l in enumerate(self.layers)], params,
                        self.conf.global_conf)
        params = cast_floating(params, get_environment().compute_dtype)
        if training:
            params = self._perturbed(params, generator)
        _, last_in, new_state, new_carries = self._forward(
            params, model_state, x, training=training, generator=generator, fmask=fmask,
            carries=carries)
        k = _layer_key(len(self.layers) - 1, final)
        loss = final.compute_loss(params.get(k, {}), last_in, y, mask=lmask)
        if reg is not None:
            loss = loss + reg
        return loss, new_state, new_carries

    def _zero_carries(self, batch: int, dtype) -> Dict[str, Any]:
        return {_layer_key(i, layer): layer.init_carry(batch, dtype, self.device)
                for i, layer in enumerate(self.layers)
                if isinstance(layer, BaseRecurrentLayer)}

    # ------------------------------------------------------------- inference
    def output(self, x, training: bool = False, mask=None) -> torch.Tensor:
        """Forward pass (reference ``output(INDArray)``). As in the JAX
        package (``:612-625``), ``training`` is accepted and the pass runs
        in inference mode: no dropout, no gradient."""
        self._ensure_init()
        with torch.inference_mode():
            m = None if mask is None else self._as_input(mask)
            out, _, _, _ = self._forward(self._params, self._model_state,
                                         self._as_input(x), fmask=m)
        return out

    def _rnn_step(self, carries, x, training: bool = False):
        """One chunk from ``carries``: ``(out, new_carries)``; in training
        with dropout and weight noise, without a gradient."""
        if not training:
            with torch.inference_mode():
                out, _, _, new_carries = self._forward(self._params, self._model_state, x,
                                                       carries=carries)
            return out, new_carries
        generator = self.rng.next_generator()
        with torch.no_grad():
            out, _, _, new_carries = self._forward(
                self._perturbed(self._params, generator), self._model_state, x,
                training=True, generator=generator, carries=carries)
        return out, new_carries

    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful sequence inference (reference ``rnnTimeStep``): feeds a
        (batch, time, size) chunk, returns the output and stores the
        recurrent state for the next call."""
        self._ensure_init()
        x = self._as_input(x)
        if self._rnn_carries is None:
            self._rnn_carries = self._zero_carries(
                x.shape[0], carry_dtype(x, get_environment().compute_dtype))
        out, self._rnn_carries = self._rnn_step(self._rnn_carries, x)
        return out

    def rnn_activate_using_stored_state(self, x, training: bool = False,
                                        store_last_for_tbptt: bool = False) -> torch.Tensor:
        """Reference ``rnnActivateUsingStoredState`` (JAX ``:722-735``):
        forward a sequence from the STORED recurrent state (zeros when none
        is stored); with ``store_last_for_tbptt`` the final state replaces
        it. Returns the output activations."""
        self._ensure_init()
        x = self._as_input(x)
        if self._rnn_carries is None:
            self._rnn_carries = self._zero_carries(
                x.shape[0], carry_dtype(x, get_environment().compute_dtype))
        out, new_carries = self._rnn_step(self._rnn_carries, x, training)
        if store_last_for_tbptt:
            self._rnn_carries = new_carries
        return out

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_get_state(self):
        """Copy of the stored recurrent state: ``{layer_key: carry}`` (``(h,
        c)`` for an LSTM, ``(h,)`` for a GRU or SimpleRnn) of CPU tensors
        whose dtypes match the carries exactly, or ``None``. Round-trips
        exactly through :meth:`rnn_set_state`."""
        if self._rnn_carries is None:
            return None
        return tree_map(lambda t: t.detach().to("cpu", copy=True), self._rnn_carries)

    def rnn_set_state(self, state) -> None:
        """Install a state from :meth:`rnn_get_state` (tensors or numpy
        arrays); ``None`` clears. Dtypes are kept as given."""
        self._ensure_init()
        self._rnn_carries = (None if state is None else
                             tree_map(lambda t: torch.as_tensor(t).to(self.device), state))

    def rnn_zero_state(self, batch: int, like=None):
        """Fresh zero state for a ``batch``-row stream; ``like`` (an example
        input) pins the carry dtype as the stateful path does."""
        self._ensure_init()
        dt = (get_environment().compute_dtype if like is None else
              carry_dtype(self._as_input(like), get_environment().compute_dtype))
        return self._zero_carries(batch, dt)

    def rnn_time_step_external(self, x, state):
        """Pure-functional ``rnnTimeStep``: advance ``state`` (from
        :meth:`rnn_get_state`/:meth:`rnn_zero_state`, or ``None``) by one
        chunk without touching the stored state. Returns ``(out, new_state)``."""
        self._ensure_init()
        x = self._as_input(x)
        if state is None:
            state = self._zero_carries(
                x.shape[0], carry_dtype(x, get_environment().compute_dtype))
        else:
            state = tree_map(lambda t: torch.as_tensor(t).to(self.device), state)
        return self._rnn_step(state, x)

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1, mask=None,
            labels_mask=None, prefetch_buffer: int = 0,
            profiler=None) -> "MultiLayerNetwork":
        """``fit(iterator)``, ``fit(iterator, epochs=N)`` or
        ``fit(x, y[, mask, labels_mask])`` (JAX ``:370-409``). ``mask`` is
        the features mask; the labels mask of per-timestep labels defaults
        to it.

        ``prefetch_buffer > 0`` stages that many coerced batches on the
        device ahead of the step through a background
        :class:`~..train.prefetch.DevicePrefetcher` (the trajectory is the
        synchronous loop's, bit for bit); ``profiler`` takes a
        :class:`~..train.profiler.TrainingProfiler` that splits each
        iteration into data-wait, dispatch and step time."""
        self._ensure_init()
        if labels is not None:
            ds = DataSet(np.asarray(data), np.asarray(labels), features_mask=mask,
                         labels_mask=labels_mask)
            iterator = ListDataSetIterator([ds], batch_size=len(ds))
        else:
            iterator = data
        from deeplearning4j_tpu_torch.runtime.state_packing import PackedStepLoop
        self._seed_device_generator()
        ploop = PackedStepLoop.for_network(self)
        if profiler is not None:
            profiler.start()
        try:
            self._fit_epochs(iterator, int(epochs), ploop,
                             prefetch_buffer=int(prefetch_buffer), profiler=profiler)
        finally:
            ploop.sync(release=True)
            if profiler is not None:
                profiler.stop()
        return self

    def _coerce_batch(self, ds, staged: bool = False):
        """A DataSet minibatch as tensors ``(x, y, fm, lm)`` on the device
        (JAX ``train/prefetch.py:70-84``); ``staged`` copies from pinned
        memory without waiting (the prefetcher's path)."""
        x, y = self._as_input(ds.features, staged), self._as_input(ds.labels, staged)
        fm = None if ds.features_mask is None else self._as_input(ds.features_mask, staged)
        lm = self._as_input(ds.labels_mask, staged) if ds.labels_mask is not None \
            else (self._output_time_mask(fm) if y.dim() == 3 else None)
        return x, y, fm, lm

    def _fit_epochs(self, iterator, epochs: int, ploop, prefetch_buffer: int = 0,
                    profiler=None) -> None:
        """JAX ``_fit_epochs`` (``:411-455``): the steps go through a
        :class:`~..runtime.state_packing.GroupedDispatch` over the packed
        loop, and listener delivery through an
        :class:`~..train.prefetch.AsyncLossDelivery` when every listener is
        stateless; a state-reading listener turns packing, grouping and
        async delivery off together."""
        from deeplearning4j_tpu_torch.runtime.state_packing import GroupedDispatch
        from deeplearning4j_tpu_torch.train.prefetch import (AsyncLossDelivery,
                                                             stateless_listeners)
        def deliver(n, loss):
            self._iteration_done(loss, n)

        adel = (AsyncLossDelivery(deliver, profiler=profiler)
                if (self._listeners or profiler is not None)
                and stateless_listeners(self) else None)
        # only the batch SIZE crosses into the delivery queue
        sink = adel.submit if adel is not None else deliver
        gd = GroupedDispatch(
            unroll=(get_environment().dispatch_unroll if ploop.enabled else 1),
            compatible=_group_compatible,
            run_single=lambda a: ploop.step(*a)[0],
            run_group=ploop.step_group,
            deliver=lambda args, loss: sink(args[0].shape[0], loss))
        try:
            self._run_epochs(iterator, epochs, ploop, gd,
                             drain=(adel.flush if adel is not None else (lambda: None)),
                             prefetch_buffer=prefetch_buffer, profiler=profiler)
        finally:
            gd.drain_on_error()
            if adel is not None:
                adel.shutdown()  # never raises; original errors win
        if adel is not None:
            adel.raise_pending()

    def _run_epochs(self, iterator, epochs: int, ploop, gd, drain=lambda: None,
                    prefetch_buffer: int = 0, profiler=None) -> None:
        from deeplearning4j_tpu_torch.train.prefetch import batch_source
        from deeplearning4j_tpu_torch.train.profiler import submit_timed
        if self.conf.global_conf.optimization_algo != "STOCHASTIC_GRADIENT_DESCENT":
            raise NotImplementedError(
                f"optimization_algo={self.conf.global_conf.optimization_algo!r} is not "
                "ported to deeplearning4j_tpu_torch yet")
        for _ in range(epochs):
            for lst in self._listeners:
                lst.on_epoch_start(self, self._epoch)
            # the source resets, and iterating resets again, as JAX's fit does
            src = batch_source(iterator, self._coerce_batch, prefetch_buffer, profiler,
                               device=self.device,
                               staged_prepare=lambda ds: self._coerce_batch(ds, staged=True))
            try:
                for x, y, fm, lm in src:
                    if self.conf.tbptt_fwd_length and is_sequence_array(x):
                        gd.flush()
                        drain()  # tBPTT notifies listeners inline (ordered)
                        ploop.sync(release=True)
                        self._fit_tbptt(x, y, fm, lm)
                        continue
                    submit_timed(gd, (x, y, self._step_generator(), fm, lm), profiler)
            finally:
                src.close()
            gd.flush()
            drain()  # on_epoch_end must observe every iteration_done
            for lst in self._listeners:
                lst.on_epoch_end(self, self._epoch)
            self._epoch += 1

    def _fit_tbptt(self, x, y, fmask, lmask) -> None:
        """Split the time axis into tbptt-length chunks, carrying the hidden
        state across them with the gradient cut (JAX ``:505-524``); eager,
        one step a chunk."""
        L = int(self.conf.tbptt_fwd_length)
        carries = self._zero_carries(
            x.shape[0], carry_dtype(x, get_environment().compute_dtype))
        for t0 in range(0, x.shape[1], L):
            loss, carries = self._train_step(
                slice_time(x, t0, L), y[:, t0:t0 + L] if y.dim() >= 3 else y,
                None if fmask is None else fmask[:, t0:t0 + L],
                None if lmask is None else lmask[:, t0:t0 + L], carries,
                generator=self._step_generator())
            carries = tree_map(lambda t: t.detach(), carries)
            self._iteration_done(loss)

    def _train_step(self, x, y, fmask, lmask, carries=None, generator=None):
        """One step: loss, gradients of the float parameters through the
        compute-dtype cast, and the optimizer's update in place; the layers'
        new state (``BatchNormalization``'s running statistics) is copied
        into the old, as the JAX step's ``model_state=new_state`` replaces
        it (in place, so that a captured step writes where the next replay
        reads). The parameters may nest (``"attn"``, ``"stack"``): every
        leaf is walked in :func:`tree_leaves` order. Returns the detached
        loss and the new carries."""
        optimizer = self._ensure_optimizer()
        leaves = tree_leaves(self._params)
        trained = trained_leaves(self._params, self._frozen_keys())
        for t in trained:
            t.requires_grad_(True)
        try:
            loss, new_state, new_carries = self._loss(
                self._params, self._model_state, x, y,
                generator if generator is not None else self.rng.next_generator(),
                fmask, lmask, carries)
            grads = iter(torch.autograd.grad(loss, trained, allow_unused=True))
        finally:
            for t in trained:
                t.requires_grad_(False)
        optimizer.step(self._params, leaf_gradients(self._params, leaves, trained, grads))
        self._apply_constraints()
        self._model_state = assign_state(self._model_state, new_state)
        return loss.detach(), new_carries

    def _frozen_keys(self) -> List[str]:
        return [_layer_key(i, l) for i, l in enumerate(self.layers) if l.frozen]

    # ------------------------------------------------------------- runtime
    def _train_step_fn(self):
        """The step the packed loop dispatches: ``(x, y, generator, fm, lm)
        -> loss``, the state updated in place."""
        fn = self._runtime_cache.get("__step__")
        if fn is None:
            # a weak reference: the network's own cache must not keep it
            # alive in a cycle (its graphs would then die whenever the
            # cyclic collector runs, not when the network is dropped)
            net = weakref.ref(self)

            def fn(x, y, generator, fm, lm):
                return net()._train_step(x, y, fm, lm, generator=generator)[0]
            self._runtime_cache["__step__"] = fn
        return fn

    def _replica_loss(self, params, args, generator):
        """One replica's training loss on its rows, for the sharded step of
        ``parallel/sharding.py``: ``args`` are ``(x, y, fm, lm)`` on the
        replica's device, ``params`` its tree; returns ``(loss,
        new_state)``."""
        x, y, fm, lm = args
        loss, new_state, _ = self._loss(params, self._model_state, x, y, generator, fm, lm)
        return loss, new_state

    def _state_tree(self):
        return {"params": self._params, "opt": self._ensure_optimizer().state,
                "state": self._model_state}

    def _set_state_tree(self, tree) -> None:
        self._params = tree["params"]
        self._optimizer.state = tree["opt"]
        self._model_state = tree["state"]

    def _seed_device_generator(self) -> None:
        """On a CUDA device: the fit's mask stream, seeded from the
        network's key (:mod:`~..runtime.rng`)."""
        if self.device.type == "cuda":
            if self._device_gen is None:
                self._device_gen = torch.Generator(device=self.device)
            self._device_gen.manual_seed(self.rng.peek_seed())

    def _device_generators(self):
        return [] if self._device_gen is None else [self._device_gen]

    def _step_generator(self) -> torch.Generator:
        """A step's generator argument: the next CPU generator of the
        network's stream, or on a CUDA device (the stream advanced all the
        same) the fit's device generator."""
        gen = self.rng.next_generator()
        return self._device_gen if self.device.type == "cuda" else gen

    # ------------------------------------------------------ external errors
    def _external_vjp(self, x, epsilon, generator):
        """The training forward of ``x`` (dropout and weight noise from
        ``generator``, none without one) and its vjp with ``epsilon`` =
        dL/dOutput: ``(param_grads, dL/dInput, new_state)``, the gradients
        nested as the parameters."""
        x = self._as_input(x).detach()
        leaves = tree_leaves(self._params)
        trained = [t for t in leaves if t.is_floating_point()]
        for t in trained:
            t.requires_grad_(True)
        x.requires_grad_(x.is_floating_point())
        try:
            out, _, new_state, _ = self._forward(
                self._perturbed(self._params, generator), self._model_state, x,
                training=True, generator=generator)
            eps = self._as_input(epsilon).to(out.dtype)
            wrt = trained + ([x] if x.requires_grad else [])
            grads = list(torch.autograd.grad(out, wrt, grad_outputs=eps, allow_unused=True))
        finally:
            for t in trained:
                t.requires_grad_(False)
        gx = grads.pop() if x.requires_grad else None
        if gx is None and x.requires_grad:
            gx = torch.zeros_like(x)
        it = iter(grads)
        per_leaf = []
        for t in leaves:
            g = next(it) if t.is_floating_point() else None
            per_leaf.append(torch.zeros_like(t) if g is None else g)
        return tree_unflatten_like(self._params, per_leaf), gx, new_state

    def backprop_gradient(self, x, epsilon):
        """Reference external-errors mode (``backpropGradient(epsilon)``,
        JAX ``:650-671``): given dL/dOutput computed outside this network,
        ``(param_gradients, dL/dInput)`` of a training forward without
        dropout. No update."""
        self._ensure_init()
        gp, gx, _ = self._external_vjp(x, epsilon, None)
        return gp, gx

    def fit_external(self, x, epsilon):
        """An external-errors training step (JAX ``:673-704``): backprop
        ``epsilon`` (dL/dOutput) through a training forward (dropout, weight
        noise) and apply the configured updater; the layers' new state
        replaces the old. Returns dL/dInput."""
        self._ensure_init()
        optimizer = self._ensure_optimizer()
        gp, gx, new_state = self._external_vjp(x, epsilon, self.rng.next_generator())
        optimizer.step(self._params, gp)
        self._model_state = tree_map(lambda t: t.detach(), new_state)
        self._iteration += 1
        return gx

    def _iteration_done(self, loss, batch_size: Optional[int] = None) -> None:
        """Listener bookkeeping after one iteration; a
        ``PerformanceListener`` first counts the batch's examples (JAX
        ``:417-423``; the truncated-BPTT chunks count none). With a
        listener that reads state, it runs where the step ran; otherwise
        on the delivery thread."""
        self._score = loss
        self._iteration += 1
        for lst in self._listeners:
            if batch_size is not None and isinstance(lst, PerformanceListener):
                lst.record_batch(batch_size)
            lst.iteration_done(self, self._iteration, self._epoch, loss)

    def score(self, dataset=None) -> float:
        """Loss on a DataSet without dropout (reference ``score(DataSet)``,
        JAX ``:742-760``), or the most recent minibatch's loss when called
        with no argument."""
        if dataset is None:
            return float(self._score)
        self._ensure_init()
        with torch.inference_mode():
            x, y, fm, lm = self._coerce_batch(dataset)
            loss, _, _ = self._loss(self._params, self._model_state, x, y, None, fm, lm,
                                    training=False)
        return float(loss)

    def set_listeners(self, *listeners: TrainingListener) -> None:
        self._listeners = list(listeners)

    def add_listeners(self, *listeners: TrainingListener) -> None:
        self._listeners.extend(listeners)

    def get_listeners(self) -> List[TrainingListener]:
        return list(self._listeners)

    def _ensure_optimizer(self) -> NetworkOptimizer:
        """The optimizer, built at first use (it raises by name on an
        updater or option that is not ported); moments restored from an
        archive are loaded into it then."""
        if self._optimizer is None:
            keys = [_layer_key(i, l) for i, l in enumerate(self.layers)]
            opt = NetworkOptimizer.for_network(self.layers, keys, self.conf.global_conf,
                                               self._params)
            if self._restored_updater_leaves is not None:
                from deeplearning4j_tpu_torch.models.serializer import load_leaves_like
                opt.state = load_leaves_like(self._restored_updater_leaves, opt.state)
                self._restored_updater_leaves = None
            self._optimizer = opt
        return self._optimizer

    def updater_state(self):
        """The optimizer's state per layer key (RmsProp: ``{param: nu}``;
        Adam: ``{"count", "mu", "nu"}``, nested as the parameters), in the
        leaf order of the JAX package's ``opt_state`` (empty for ``Sgd``)."""
        self._ensure_init()
        return self._ensure_optimizer().state

    # ------------------------------------------------------------ inspection
    def feed_forward(self, x, num_layers: Optional[int] = None) -> List[torch.Tensor]:
        """The input and every layer's activation (reference
        ``feedForward``, JAX ``:627-642``): each layer's inference forward
        on the uncast parameters, after its preprocessor; ``num_layers``
        stops after that many layers."""
        self._ensure_init()
        with torch.inference_mode():
            cur = self._as_input(x)
            acts = [cur]
            stop = len(self.layers) if num_layers is None else int(num_layers)
            for i, layer in enumerate(self.layers[:stop]):
                if i in self.conf.preprocessors:
                    cur = self.conf.preprocessors[i].pre_process(cur)
                k = _layer_key(i, layer)
                cur, _ = layer.forward(self._params.get(k, {}), self._model_state.get(k, {}),
                                       cur, training=False)
                acts.append(cur)
        return acts

    def feed_forward_to_layer(self, layer_num: int, x) -> List[torch.Tensor]:
        """Reference ``feedForwardToLayer(layerNum, input)``: the input and
        the activations of layers ``0..layer_num`` inclusive."""
        return self.feed_forward(x, num_layers=layer_num + 1)

    def _predictions(self, batch, mask=None) -> np.ndarray:
        out = self.output(batch.features, mask=mask)
        return (out.float() if out.dtype == torch.bfloat16 else out).cpu().numpy()

    def evaluate(self, iterator):
        """Classification evaluation over an iterator (reference
        ``evaluate(DataSetIterator)``, JAX ``:762-775``): the labels mask, or
        else the features mask carried to the output's time axis
        (:meth:`_output_time_mask`), selects the timesteps of sequence
        output."""
        from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
        ev = Evaluation()
        iterator.reset()
        for batch in iterator:
            m = batch.labels_mask
            if m is None and batch.features_mask is not None:
                m = self._output_time_mask(self._as_input(batch.features_mask)).cpu().numpy()
            ev.eval(np.asarray(batch.labels), self._predictions(batch, batch.features_mask),
                    mask=None if m is None else np.asarray(m))
        return ev

    def evaluate_regression(self, iterator):
        from deeplearning4j_tpu_torch.evaluation.regression import RegressionEvaluation
        ev = RegressionEvaluation()
        iterator.reset()
        for batch in iterator:
            ev.eval(np.asarray(batch.labels), self._predictions(batch))
        return ev

    def evaluate_roc(self, iterator, threshold_steps: int = 0):
        from deeplearning4j_tpu_torch.evaluation.roc import ROC
        roc = ROC(threshold_steps)
        iterator.reset()
        for batch in iterator:
            roc.eval(np.asarray(batch.labels), self._predictions(batch))
        return roc

    # -------------------------------------------------------------- plumbing
    def params(self):
        return self._params

    def set_params(self, params) -> None:
        """Replace the parameters (nested as :meth:`params`; tensors or
        numpy arrays), copied onto the network's device."""
        copied = tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor)
                          else torch.from_numpy(np.array(t)), params)
        if self._params is None:
            self.init(params=copied)
        else:
            self._params = tree_map(lambda t: t.to(self.device), copied)

    def num_params(self) -> int:
        if self._params is None:
            return 0
        return int(sum(t.numel() for t in tree_leaves(self._params)))

    def get_layer(self, key) -> Layer:
        """Layer by index or name (reference ``getLayer``)."""
        if isinstance(key, int):
            return self.layers[key]
        for i, l in enumerate(self.layers):
            if _layer_key(i, l) == key or l.name == key:
                return l
        raise KeyError(key)

    def summary(self) -> str:
        """Layer table: index, name, type, shape, parameter count (reference
        ``MultiLayerNetwork.summary()``), the JAX package's text for the same
        configuration. Its shape column is empty there (the JAX
        ``InputType`` has no ``describe``), and so here."""
        self._ensure_init()
        rows = [("idx", "name", "type", "nIn -> nOut", "params")]
        total = 0
        for i, layer in enumerate(self.layers):
            k = _layer_key(i, layer)
            n = sum(t.numel() for t in tree_leaves(self._params.get(k, {})))
            total += n
            rows.append((str(i), k, type(layer).__name__, "", f"{n:,}"))
        widths = [max(len(r[c]) for r in rows) for c in range(5)]
        lines = ["  ".join(v.ljust(w) for v, w in zip(r, widths)) for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        lines.append(f"Total parameters: {total:,}")
        return "\n".join(lines)

    @property
    def iteration(self) -> int:
        return self._iteration

    @property
    def epoch(self) -> int:
        return self._epoch

    def save(self, path: str, save_updater: bool = True, normalizer=None) -> None:
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        ModelSerializer.write_model(self, path, save_updater=save_updater,
                                    normalizer=normalizer)

    @staticmethod
    def load(path: str, device=None, load_updater: bool = True) -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        return ModelSerializer.restore_multi_layer_network(path, device=device,
                                                           load_updater=load_updater)

    def clone(self) -> "MultiLayerNetwork":
        """A network of the same configuration with copies of the
        parameters and the layers' state, on the same device, and a fresh
        optimizer (JAX ``:936-942``)."""
        net = MultiLayerNetwork(MultiLayerConfiguration.from_dict(self.conf.to_dict()),
                                device=self.device or self._requested_device)
        if self._params is not None:
            net.init(params=tree_map(torch.clone, self._params))
            net._model_state = tree_map(torch.clone, self._model_state)
        return net
