"""Core feed-forward layers.

Counterpart of ``deeplearning4j_tpu/nn/core_layers.py``: ``DenseLayer``,
``OutputLayer``, ``LossLayer``, ``ActivationLayer``, ``DropoutLayer``,
``EmbeddingLayer``, ``EmbeddingSequenceLayer``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer, keep_mask, register_layer
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.initializers import init_weights
from deeplearning4j_tpu_torch.ops.losses import LossFunction, compute_loss


def _param_dtype(g: GlobalConfig) -> torch.dtype:
    return g.dtype if g.dtype is not None else torch.float32


@register_layer
@dataclasses.dataclass
class DenseLayer(Layer):
    """Fully-connected layer: y = act(x @ W + b). W: (nIn, nOut)."""

    n_out: int = 0
    n_in: Optional[int] = None  # inferred from the input type when None
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.recurrent(self.n_out, input_type.timesteps)
        return InputType.feed_forward(self.n_out)

    def _nin(self, input_type: InputType) -> int:
        if self.n_in is not None:
            return self.n_in
        return input_type.size if input_type.kind in ("feedforward", "recurrent") \
            else input_type.flat_size()

    def init(self, generator, input_type, g: GlobalConfig):
        n_in = self._nin(input_type)
        dt = _param_dtype(g)
        params = {"W": init_weights(generator, (n_in, self.n_out), self._winit(g),
                                    fan=(n_in, self.n_out), dtype=dt)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self._binit(g)), dtype=dt)
        return params, {}

    def preoutput(self, params, x):
        if not x.is_floating_point():  # integer rows promote as jnp promotes them
            x = x.to(params["W"].dtype)
        y = x @ params["W"]
        return y + params["b"] if self.has_bias else y

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        x = self._apply_input_dropout(x, self._g, training, generator)
        return get_activation(self._act(self._g))(self.preoutput(params, x)), state


@register_layer
@dataclasses.dataclass
class OutputLayer(DenseLayer):
    """Dense + loss head (reference ``OutputLayer``): the training loss reads
    the pre-activation; inference applies the activation."""

    loss: Any = LossFunction.MCXENT

    def activate(self, params, x):
        """Forward WITHOUT input dropout — the network applies this layer's
        input dropout itself, so loss and output see the same input."""
        return get_activation(self._act(self._g))(self.preoutput(params, x))

    def compute_loss(self, params, x, labels, mask=None, state=None):
        return compute_loss(self.loss, labels, self.preoutput(params, x),
                            activation=self._act(self._g), mask=mask)


@register_layer
@dataclasses.dataclass
class LossLayer(Layer):
    """Loss without params (reference ``LossLayer``)."""

    loss: Any = LossFunction.MCXENT

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        return self.activate(params, x), state

    def activate(self, params, x):
        return get_activation(self._act(self._g))(x)

    def compute_loss(self, params, x, labels, mask=None, state=None):
        return compute_loss(self.loss, labels, x, activation=self._act(self._g), mask=mask)


@register_layer
@dataclasses.dataclass
class ActivationLayer(Layer):
    """Standalone activation (reference ``ActivationLayer``)."""

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        return get_activation(self._act(self._g))(x), state


@register_layer
@dataclasses.dataclass
class DropoutLayer(Layer):
    """Standalone dropout (reference ``DropoutLayer``); ``dropout`` is the
    retain probability."""

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        p = self._dropout(self._g) or 0.5
        if not training or generator is None or p >= 1.0:
            return x, state
        return torch.where(keep_mask(x, p, generator), x / p, torch.zeros_like(x)), state


@register_layer
@dataclasses.dataclass
class EmbeddingLayer(Layer):
    """Index -> vector lookup (reference ``EmbeddingLayer``): (batch,) or
    (batch, 1) int indices -> (batch, nOut)."""

    n_in: int = 0  # vocab size
    n_out: int = 0
    has_bias: bool = False

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def init(self, generator, input_type, g: GlobalConfig):
        dt = _param_dtype(g)
        params = {"W": init_weights(generator, (self.n_in, self.n_out), self._winit(g),
                                    fan=(self.n_in, self.n_out), dtype=dt)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self._binit(g)), dtype=dt)
        return params, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        idx = x.long()
        if idx.dim() == 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self._act(self._g))(y), state


@register_layer
@dataclasses.dataclass
class EmbeddingSequenceLayer(Layer):
    """(batch, time) ints -> (batch, time, nOut) (reference
    ``EmbeddingSequenceLayer``)."""

    n_in: int = 0
    n_out: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps if input_type.kind == "recurrent" else None
        return InputType.recurrent(self.n_out, t)

    def init(self, generator, input_type, g: GlobalConfig):
        return {"W": init_weights(generator, (self.n_in, self.n_out), self._winit(g),
                                  fan=(self.n_in, self.n_out), dtype=_param_dtype(g))}, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        y = params["W"][x.long()]
        return get_activation(self._act(self._g))(y), state
