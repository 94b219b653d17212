"""Recurrent layers: ``LSTM``, ``GravesLSTM`` and ``RnnOutputLayer``.

Counterpart of ``deeplearning4j_tpu/nn/recurrent_layers.py``. Gate weights
are packed ``(nIn, 4H)`` in the order [i, f, g, o]; sequences are
(batch, time, features) and masks (batch, time), where masked steps carry
the state through unchanged. The input projection ``x @ W + b`` for the
whole sequence is one matmul laid out (time, batch, 4H); the recurrence then
runs in a kernel, routed as in the JAX package (``:139-164``):

- unmasked plain ``LSTM`` -> :func:`~..ops.kernels.fused_lstm.fused_lstm`;
- ``GravesLSTM`` (any mask) and masked ``LSTM`` ->
  :func:`~..ops.kernels.fused_lstm_graves.fused_graves_lstm`.

Unlike the TPU kernels, these take every batch size, width and length, so
the default cell always routes to a kernel. The wrappers are differentiable:
in training (some input needs a gradient) they launch the forward kernel's
saving instance and, in the backward pass, the backward kernel; under
``torch.inference_mode`` they launch the inference instance. A cell with
other activations runs the plain time loop, which autograd differentiates.
``forward(..., training=True, generator=...)`` drops the layer's input as
the JAX layer does. Stateful inference and truncated BPTT use the explicit
carry API (``init_carry`` + ``forward_with_carry``); ``MultiLayerNetwork``
owns the carries. GRU, SimpleRnn, Bidirectional and LastTimeStep come in a
later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer, register_layer
from deeplearning4j_tpu_torch.nn.core_layers import OutputLayer, _param_dtype
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import Activation, get_activation
from deeplearning4j_tpu_torch.ops.initializers import init_weights
from deeplearning4j_tpu_torch.ops.kernels.fused_lstm import fused_lstm
from deeplearning4j_tpu_torch.ops.kernels.fused_lstm_graves import fused_graves_lstm
from deeplearning4j_tpu_torch.ops.losses import LossFunction


@dataclasses.dataclass
class BaseRecurrentLayer(Layer):
    n_out: int = 0
    n_in: Optional[int] = None

    def _cell_act(self):
        """Cell-output activation: the layer's own setting wins; an explicit
        non-identity GLOBAL activation is honored; otherwise tanh."""
        if self.activation is not None:
            return get_activation(self.activation)
        g_act = self._g.activation if self._g is not None else None
        if g_act not in (None, Activation.IDENTITY, "identity"):
            return get_activation(g_act)
        return get_activation("tanh")

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)

    def _nin(self, input_type: InputType) -> int:
        return self.n_in if self.n_in is not None else input_type.size

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def forward_with_carry(self, params, carry, x, *, training=False, generator=None,
                           mask=None):
        raise NotImplementedError

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        x = self._apply_input_dropout(x, self._g, training, generator)
        carry = self.init_carry(x.shape[0], x.dtype, x.device)
        y, _ = self.forward_with_carry(params, carry, x, training=training,
                                       generator=generator, mask=mask)
        return y, state


@register_layer
@dataclasses.dataclass
class LSTM(BaseRecurrentLayer):
    """LSTM with packed gates [i, f, g, o]; forget-gate bias init
    (reference ``LSTM.forgetGateBiasInit``, default 1.0)."""

    forget_gate_bias_init: float = 1.0
    gate_activation: Any = "sigmoid"

    def init(self, generator, input_type, g: GlobalConfig):
        n_in, H = self._nin(input_type), self.n_out
        dt = _param_dtype(g)
        b = torch.zeros((4 * H,), dtype=dt)
        b[H:2 * H] = self.forget_gate_bias_init
        return {
            "W": init_weights(generator, (n_in, 4 * H), self._winit(g), fan=(n_in, H), dtype=dt),
            "W_rec": init_weights(generator, (H, 4 * H), self._winit(g), fan=(H, H), dtype=dt),
            "b": b,
        }, {}

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        H = self.n_out
        return (torch.zeros((batch, H), dtype=dtype, device=device),
                torch.zeros((batch, H), dtype=dtype, device=device))

    def _kernel_act_ok(self) -> bool:
        """The kernels implement the default activations only."""
        return (get_activation(self.gate_activation) is get_activation("sigmoid")
                and self._cell_act() is get_activation("tanh"))

    def _step(self, params, h, c, zx_t):
        """One step of the plain time loop (non-default activations)."""
        H = self.n_out
        act, gate = self._cell_act(), get_activation(self.gate_activation)
        w = params["W_rec"]
        ct = torch.promote_types(h.dtype, w.dtype)
        z = zx_t.to(ct) + h.to(ct) @ w.to(ct)
        i, f = gate(z[:, :H]), gate(z[:, H:2 * H])
        g_, o = torch.tanh(z[:, 2 * H:3 * H]), gate(z[:, 3 * H:])
        c_new = f * c + i * g_
        return o * act(c_new), c_new

    def forward_with_carry(self, params, carry, x, *, training=False, generator=None,
                           mask=None):
        # (time, batch, 4H): one whole-sequence matmul, hoisted out of the loop
        zxs = torch.matmul(x.transpose(0, 1), params["W"]) + params["b"]
        ms = None if mask is None else mask.transpose(0, 1).to(zxs.dtype).contiguous()
        h0, c0 = carry
        if self._kernel_act_ok() and type(self) in _KERNEL_TYPES:
            dt = zxs.dtype
            h0, c0 = h0.to(dt).contiguous(), c0.to(dt).contiguous()
            w_rec = params["W_rec"].contiguous()
            if type(self) is LSTM and ms is None:
                ys, h, c = fused_lstm(zxs, w_rec, h0, c0)
            else:
                peep = params.get("peephole")
                ys, h, c = fused_graves_lstm(
                    zxs, w_rec, None if peep is None else peep.to(dt).contiguous(),
                    h0, c0, ms)
            return ys.transpose(0, 1), (h, c)
        return self._scan(params, h0, c0, zxs, ms)

    def _scan(self, params, h, c, zxs, ms):
        ys = []
        for t in range(zxs.shape[0]):
            h_new, c_new = self._step(params, h, c, zxs[t])
            if ms is not None:
                m = ms[t][:, None].to(h_new.dtype)
                h_new = m * h_new + (1 - m) * h
                c_new = m * c_new + (1 - m) * c
            h, c = h_new, c_new
            ys.append(h)
        return torch.stack(ys, dim=1), (h, c)


@register_layer
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (reference ``GravesLSTM``)."""

    def init(self, generator, input_type, g: GlobalConfig):
        params, state = super().init(generator, input_type, g)
        H = self.n_out
        params["peephole"] = init_weights(generator, (3 * H,), self._winit(g),
                                          fan=(H, H), dtype=_param_dtype(g))
        return params, state

    def _step(self, params, h, c, zx_t):
        H = self.n_out
        act, gate = self._cell_act(), get_activation(self.gate_activation)
        w, p = params["W_rec"], params["peephole"]
        ct = torch.promote_types(h.dtype, w.dtype)
        z = zx_t.to(ct) + h.to(ct) @ w.to(ct)
        p = p.to(ct)
        i = gate(z[:, :H] + c * p[:H])
        f = gate(z[:, H:2 * H] + c * p[H:2 * H])
        g_ = torch.tanh(z[:, 2 * H:3 * H])
        c_new = f * c + i * g_
        o = gate(z[:, 3 * H:] + c_new * p[2 * H:])
        return o * act(c_new), c_new


# Types served by the kernels. Subclasses may change the math, so
# membership is exact-type.
_KERNEL_TYPES = (LSTM, GravesLSTM)


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Time-distributed output head (reference ``RnnOutputLayer``): dense +
    loss at every timestep of (batch, time, nIn)."""

    loss: Any = LossFunction.MCXENT

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)
