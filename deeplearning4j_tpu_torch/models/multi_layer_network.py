"""MultiLayerNetwork: linear layer stack, inference path.

Counterpart of ``deeplearning4j_tpu/models/multi_layer_network.py``:
``init``, ``output``, the stateful RNN API (``rnn_time_step``,
``rnn_time_step_external``, ``rnn_get_state``/``rnn_set_state``/
``rnn_zero_state``/``rnn_clear_previous_state``) and ``save``/``load``.
``_forward`` keeps the JAX semantics of ``:156-215``: the input and the
parameters are cast to ``compute_dtype``; the output layer runs through
``activate`` (a softmax at every timestep for ``RnnOutputLayer``); carries
start in ``carry_dtype``. PyTorch runs eagerly, so there is no jit cache;
every entry point runs under ``torch.inference_mode``. ``fit`` comes with
training.

Parameters live on one device, chosen at :meth:`init`: ``cuda`` unless the
caller asks for the CPU (``device="cpu"`` or
``get_environment().set_device("cpu")``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models._tbptt import carry_dtype
from deeplearning4j_tpu_torch.nn.base import Layer, cast_floating
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.recurrent_layers import BaseRecurrentLayer
from deeplearning4j_tpu_torch.runtime.environment import get_environment
from deeplearning4j_tpu_torch.runtime.rng import RngManager, generator_for


def _layer_key(i: int, layer: Layer) -> str:
    return layer.name or f"layer_{i}"


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return fn(tree)


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
        self._iteration = 0
        self._epoch = 0
        self._rnn_carries: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict] = None) -> "MultiLayerNetwork":
        """Draw the parameters (or take ``params``) and place them on the
        network's device. Each layer draws from its own generator, folded
        from the config seed and the layer index."""
        self.device = get_environment().resolve_device(self._requested_device)
        g = self.conf.global_conf
        if g.dtype is None:
            g = dataclasses.replace(g, dtype=get_environment().default_dtype)
        new_params: Dict[str, Dict] = {}
        model_state: Dict[str, Dict] = {}
        if params is None:
            for i, layer in enumerate(self.layers):
                it = self.conf.layer_input_types[i] if self.conf.layer_input_types else None
                p, s = layer.init(generator_for(g.seed, i), it, g)
                if p:
                    new_params[_layer_key(i, layer)] = p
                if s:
                    model_state[_layer_key(i, layer)] = s
        else:
            new_params = params
        self._params = _map_tensors(new_params, lambda t: t.to(self.device))
        self._model_state = _map_tensors(model_state, lambda t: t.to(self.device))
        self._rnn_carries = None
        return self

    def _ensure_init(self) -> None:
        if self._params is None:
            self.init()

    def _as_input(self, x) -> torch.Tensor:
        """Tensor on the network's device; float64 becomes float32, as the
        JAX package (64-bit off) reads it."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(self.device)

    # --------------------------------------------------------------- forward
    def _forward(self, params, model_state, x, *, fmask=None,
                 carries: Optional[Dict] = None):
        """Compose all layers (inference); returns ``(out, new_carries)``."""
        cdt = get_environment().compute_dtype
        if x.is_floating_point() and x.dtype != cdt:
            x = x.to(cdt)
        params = cast_floating(params, cdt)
        new_carries = {} if carries is not None else None
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            k = _layer_key(i, layer)
            p = params.get(k, {})
            if i == n - 1 and hasattr(layer, "compute_loss"):
                x = layer.activate(p, x)
            elif carries is not None and isinstance(layer, BaseRecurrentLayer):
                x, new_carries[k] = layer.forward_with_carry(p, carries[k], x, mask=fmask)
            else:
                x, _ = layer.forward(p, model_state.get(k, {}), x, mask=fmask)
        return x, new_carries

    def _zero_carries(self, batch: int, dtype) -> Dict[str, Any]:
        return {_layer_key(i, layer): layer.init_carry(batch, dtype, self.device)
                for i, layer in enumerate(self.layers)
                if isinstance(layer, BaseRecurrentLayer)}

    # ------------------------------------------------------------- inference
    def output(self, x, training: bool = False, mask=None) -> torch.Tensor:
        """Forward pass (reference ``output(INDArray)``)."""
        if training:
            raise NotImplementedError("training-mode forward comes with fit")
        self._ensure_init()
        with torch.inference_mode():
            m = None if mask is None else self._as_input(mask)
            out, _ = self._forward(self._params, self._model_state, self._as_input(x),
                                   fmask=m)
        return out

    def _rnn_step(self, carries, x):
        with torch.inference_mode():
            return self._forward(self._params, self._model_state, x, carries=carries)

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

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_get_state(self):
        """Copy of the stored recurrent state: ``{layer_key: (h, c)}`` of CPU
        tensors whose dtypes match the carries exactly, or ``None``. Round-
        trips exactly through :meth:`rnn_set_state`."""
        if self._rnn_carries is None:
            return None
        return _map_tensors(self._rnn_carries, lambda t: t.detach().to("cpu", copy=True))

    def rnn_set_state(self, state) -> None:
        """Install a state from :meth:`rnn_get_state` (tensors or numpy
        arrays); ``None`` clears. Dtypes are kept as given."""
        self._ensure_init()
        self._rnn_carries = (None if state is None else
                             _map_tensors(state, lambda t: torch.as_tensor(t).to(self.device)))

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
            state = _map_tensors(state, lambda t: torch.as_tensor(t).to(self.device))
        return self._rnn_step(state, x)

    # -------------------------------------------------------------- plumbing
    def params(self):
        return self._params

    def save(self, path: str) -> None:
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        ModelSerializer.write_model(self, path)

    @staticmethod
    def load(path: str, device=None) -> "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        return ModelSerializer.restore_multi_layer_network(path, device=device)
