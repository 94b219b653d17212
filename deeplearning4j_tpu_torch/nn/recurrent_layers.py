"""Recurrent layers: ``LSTM``, ``GravesLSTM``, ``SimpleRnn``, ``GRU``, the
``Bidirectional`` and ``LastTimeStep`` wrappers, and ``RnnOutputLayer``.

Counterpart of ``deeplearning4j_tpu/nn/recurrent_layers.py``. Gate weights
are packed ``(nIn, kH)``: [i, f, g, o] for the LSTMs, [r, u, n] for the
GRU; sequences are (batch, time, features) and masks (batch, time), where
masked steps carry the state through unchanged. The input projection
``x @ W + b`` for the whole sequence is one matmul laid out (time, batch,
kH); the recurrence then runs in a kernel, routed as in the JAX package
(``:139-164``, ``:289-298``):

- unmasked plain ``LSTM`` -> :func:`~..ops.kernels.fused_lstm.fused_lstm`;
- ``GravesLSTM`` (any mask) and masked ``LSTM`` ->
  :func:`~..ops.kernels.fused_lstm_graves.fused_graves_lstm`;
- unmasked reset-after ``GRU`` with no ``b_rec`` and the default
  activations -> :func:`~..ops.kernels.fused_gru.fused_gru`.

Unlike the TPU kernels, these take every batch size, width and length, so
the default cells always route to a kernel. The wrappers are differentiable:
in training (some input needs a gradient) they launch the forward kernel's
saving instance and, in the backward pass, the backward kernel; under
``torch.inference_mode`` they launch the inference instance. What the JAX
package never sends to a kernel (other activations, a reset-before or
masked GRU, ``b_rec``, ``SimpleRnn``, subclasses) runs the plain time loop,
which autograd differentiates. ``forward(..., training=True,
generator=...)`` drops the layer's input as the JAX layer does. Stateful
inference and truncated BPTT use the explicit carry API (``init_carry`` +
``forward_with_carry``; the LSTMs carry ``(h, c)``, SimpleRnn and GRU
``(h,)``); ``MultiLayerNetwork`` owns the carries. The wrappers hold no
carry: they run whole sequences, as in the JAX package.
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
from deeplearning4j_tpu_torch.ops.kernels.fused_gru import fused_gru
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


def _plain_loop(step, h, zxs, ms):
    """Run ``step(h, zx_t) -> h'`` over the time axis of ``zxs`` (T, B, .);
    masked steps hold h. Returns ``(ys (B, T, H), h)``."""
    ys = []
    for t in range(zxs.shape[0]):
        h_new = step(h, zxs[t])
        if ms is not None:
            m = ms[t][:, None].to(h_new.dtype)
            h_new = m * h_new + (1 - m) * h
        h = h_new
        ys.append(h)
    return torch.stack(ys, dim=1), h


@register_layer
@dataclasses.dataclass
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN: h' = act(x W + h W_rec + b) (reference ``SimpleRnn``,
    default activation tanh). Plain time loop, as in the JAX package."""

    def init(self, generator, input_type, g: GlobalConfig):
        n_in, H = self._nin(input_type), self.n_out
        dt = _param_dtype(g)
        return {
            "W": init_weights(generator, (n_in, H), self._winit(g), fan=(n_in, H), dtype=dt),
            "W_rec": init_weights(generator, (H, H), self._winit(g), fan=(H, H), dtype=dt),
            "b": torch.full((H,), float(self._binit(g)), dtype=dt),
        }, {}

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),)

    def forward_with_carry(self, params, carry, x, *, training=False, generator=None,
                           mask=None):
        act = self._cell_act()
        zxs = torch.matmul(x.transpose(0, 1), params["W"]) + params["b"]  # hoisted
        ms = None if mask is None else mask.transpose(0, 1)
        w = params["W_rec"]

        def step(h, zx_t):
            ct = torch.promote_types(h.dtype, w.dtype)
            return act(zx_t.to(ct) + h.to(ct) @ w.to(ct))

        ys, h = _plain_loop(step, carry[0], zxs, ms)
        return ys, (h,)


@register_layer
@dataclasses.dataclass
class GRU(BaseRecurrentLayer):
    """GRU with packed gates [r, u, n].

    ``reset_after=True`` (default) is the CuDNN/modern-Keras cell
    (``n = tanh(x_n + r * (h @ U_n [+ b_rn]))``); ``reset_after=False`` is
    the classic reset-BEFORE variant (``n = tanh(x_n + (r*h) @ U_n)``). An
    optional ``b_rec`` param (recurrent bias, CuDNN's second bias set) is
    applied inside the reset product, matching Keras's dual-bias
    semantics."""

    reset_after: bool = True
    gate_activation: Any = "sigmoid"

    def init(self, generator, input_type, g: GlobalConfig):
        n_in, H = self._nin(input_type), self.n_out
        dt = _param_dtype(g)
        return {
            "W": init_weights(generator, (n_in, 3 * H), self._winit(g), fan=(n_in, H),
                              dtype=dt),
            "W_rec": init_weights(generator, (H, 3 * H), self._winit(g), fan=(H, H), dtype=dt),
            "b": torch.zeros((3 * H,), dtype=dt),
        }, {}

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),)

    def _kernel_eligible(self, mask, b_rec) -> bool:
        """The kernel's fixed cell (JAX ``:289-292``): unmasked, this exact
        type, reset-after, no recurrent bias, sigmoid gates, tanh."""
        return (mask is None and type(self) is GRU and self.reset_after and b_rec is None
                and get_activation(self.gate_activation) is get_activation("sigmoid")
                and self._cell_act() is get_activation("tanh"))

    def forward_with_carry(self, params, carry, x, *, training=False, generator=None,
                           mask=None):
        H = self.n_out
        zxs = torch.matmul(x.transpose(0, 1), params["W"]) + params["b"]  # hoisted
        b_rec = params.get("b_rec")
        (h0,) = carry
        if self._kernel_eligible(mask, b_rec):
            ys, h = fused_gru(zxs, params["W_rec"].contiguous(),
                              h0.to(zxs.dtype).contiguous())
            return ys.transpose(0, 1), (h,)
        gate, act = get_activation(self.gate_activation), self._cell_act()
        ms = None if mask is None else mask.transpose(0, 1)
        w = params["W_rec"]

        def step(h, zx):
            ct = torch.promote_types(h.dtype, w.dtype)
            wc, hc, zx = w.to(ct), h.to(ct), zx.to(ct)
            # reset-before needs only the r/u thirds here; the n third runs
            # on (r*h) below
            zh = hc @ (wc if self.reset_after else wc[:, :2 * H])
            if b_rec is not None:
                zh = zh + (b_rec if self.reset_after else b_rec[:2 * H]).to(ct)
            r = gate(zx[:, :H] + zh[:, :H])
            u = gate(zx[:, H:2 * H] + zh[:, H:2 * H])
            if self.reset_after:
                n = act(zx[:, 2 * H:] + r * zh[:, 2 * H:])
            else:
                zn = (r * hc) @ wc[:, 2 * H:]
                if b_rec is not None:
                    zn = zn + b_rec[2 * H:].to(ct)
                n = act(zx[:, 2 * H:] + zn)
            return (1 - u) * n + u * hc

        ys, h = _plain_loop(step, h0, zxs, ms)
        return ys, (h,)


@register_layer
@dataclasses.dataclass
class Bidirectional(Layer):
    """Bidirectional wrapper (reference ``Bidirectional``): runs the wrapped
    recurrent layer forward and on the time-reversed sequence; merge modes
    CONCAT / ADD / MUL / AVERAGE. Parameters nest as ``{"fwd", "bwd"}``.
    On CUDA a wrapped default ``GRU`` launches its kernel twice per call."""

    layer: Any = None  # a BaseRecurrentLayer (or dict after deserialization)
    mode: str = "concat"

    def __post_init__(self):
        if isinstance(self.layer, dict):
            self.layer = Layer.from_dict(self.layer)

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.layer.output_type(input_type)
        if self.mode.lower() == "concat":
            return InputType.recurrent(inner.size * 2, inner.timesteps)
        return inner

    def init(self, generator, input_type, g: GlobalConfig):
        self.layer._g = g
        fwd, _ = self.layer.init(generator, input_type, g)
        bwd, _ = self.layer.init(generator, input_type, g)
        return {"fwd": fwd, "bwd": bwd}, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        self.layer._g = self._g
        y_f, _ = self.layer.forward(params["fwd"], {}, x, training=training,
                                    generator=generator, mask=mask)
        m_rev = None if mask is None else torch.flip(mask, dims=(1,))
        y_b, _ = self.layer.forward(params["bwd"], {}, torch.flip(x, dims=(1,)),
                                    training=training, generator=generator, mask=m_rev)
        y_b = torch.flip(y_b, dims=(1,))
        mode = self.mode.lower()
        if mode == "concat":
            return torch.cat([y_f, y_b], dim=-1), state
        if mode == "add":
            return y_f + y_b, state
        if mode == "mul":
            return y_f * y_b, state
        return 0.5 * (y_f + y_b), state


@register_layer
@dataclasses.dataclass
class LastTimeStep(Layer):
    """Extract the last (mask-aware) timestep (reference ``LastTimeStep``),
    of the wrapped layer's output when it wraps one."""

    layer: Any = None

    def __post_init__(self):
        if isinstance(self.layer, dict):
            self.layer = Layer.from_dict(self.layer)

    def output_type(self, input_type: InputType) -> InputType:
        inner = self.layer.output_type(input_type) if self.layer else input_type
        return InputType.feed_forward(inner.size)

    def init(self, generator, input_type, g: GlobalConfig):
        if self.layer is None:
            return {}, {}
        self.layer._g = g
        return self.layer.init(generator, input_type, g)

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        if self.layer is not None:
            self.layer._g = self._g
            x, state = self.layer.forward(params, state, x, training=training,
                                          generator=generator, mask=mask)
        rows = torch.arange(x.shape[0], device=x.device)
        if mask is not None:
            idx = torch.clamp(mask.to(torch.int64).sum(dim=1) - 1, min=0)
            return x[rows, idx], state
        return x[:, -1], state


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Time-distributed output head (reference ``RnnOutputLayer``): dense +
    loss at every timestep of (batch, time, nIn)."""

    loss: Any = LossFunction.MCXENT

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(self.n_out, input_type.timesteps)
