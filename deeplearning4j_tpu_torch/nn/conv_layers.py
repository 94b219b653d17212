"""Convolution, pooling and normalization layers.

Counterpart of ``deeplearning4j_tpu/nn/conv_layers.py``, for the layers the
ResNet-50 slice runs: ``ConvolutionLayer`` (``:55-98``), ``SubsamplingLayer``
(``:169-206``), ``BatchNormalization`` (``:209-266``) and
``GlobalPoolingLayer`` (``:416-450``). The other conv-family layers of that
file are not ported yet; a configuration that names one raises by name.

Layout: the public tensors are the JAX package's, NHWC activations and HWIO
kernels (``:10``), so configurations, archives and tests compare like with
like. Inside, a convolution or pooling runs on the NCHW view of the NHWC
tensor (``permute(0, 3, 1, 2)``, no copy), which is PyTorch's channels_last
layout, and the result is viewed back as NHWC: cuDNN takes channels_last
natively. ``same`` mode pads as XLA's ``SAME`` does (the extra row or column
at the bottom and right), explicitly where the two sides differ.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer, register_layer
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import get_activation
from deeplearning4j_tpu_torch.ops.initializers import init_weights


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _out_size(size: int, k: int, s: int, p: int, same: bool, dilation: int = 1) -> int:
    if same:
        return -(-size // s)  # ceil
    eff = (k - 1) * dilation + 1
    return (size + 2 * p - eff) // s + 1


def _same_pads(size: int, k: int, s: int, dilation: int = 1) -> Tuple[int, int]:
    """XLA's ``SAME`` padding of one spatial axis: (low, high)."""
    eff = (k - 1) * dilation + 1
    total = max((-(-size // s) - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


def _pad_nhwc(x: torch.Tensor, ph: Tuple[int, int], pw: Tuple[int, int],
              value: float = 0.0) -> torch.Tensor:
    if not any(ph + pw):
        return x
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor (channels_last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


class PoolingType(str, enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


@register_layer
@dataclasses.dataclass
class ConvolutionLayer(Layer):
    """2-D convolution. Kernel HWIO (kh, kw, in, out)."""

    n_out: int = 0
    kernel_size: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    dilation: Any = (1, 1)
    convolution_mode: str = "truncate"  # "truncate" | "same"
    has_bias: bool = True

    def _geom(self):
        return (_pair(self.kernel_size), _pair(self.stride), _pair(self.padding),
                _pair(self.dilation), self.convolution_mode.lower() == "same")

    def output_type(self, input_type: InputType) -> InputType:
        (kh, kw), (sh, sw), (ph, pw), (dh, dw), same = self._geom()
        h = _out_size(input_type.height, kh, sh, ph, same, dh)
        w = _out_size(input_type.width, kw, sw, pw, same, dw)
        return InputType.convolutional(h, w, self.n_out)

    def init(self, generator, input_type, g: GlobalConfig):
        (kh, kw), _, _, _, _ = self._geom()
        c_in = input_type.channels
        dt = g.dtype if g.dtype is not None else torch.float32
        params = {"W": init_weights(generator, (kh, kw, c_in, self.n_out), self._winit(g),
                                    fan=(kh * kw * c_in, kh * kw * self.n_out), dtype=dt)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self._binit(g)), dtype=dt)
        return params, {}

    def is_plain_1x1(self) -> bool:
        """A 1x1 kernel, no padding, no dilation, no bias, identity
        activation, no input dropout and no weight noise (with the network's
        defaults, ``_g``): the convolution is the product ``x[:, ::sh, ::sw,
        :] @ W[0, 0]`` in either mode."""
        (kh, kw), _, (ph, pw), (dh, dw), _ = self._geom()
        act = self._act(self._g)
        return ((kh, kw, ph, pw, dh, dw) == (1, 1, 0, 0, 1, 1) and not self.has_bias
                and str(getattr(act, "value", act)).lower() == "identity"
                and self._dropout(self._g) is None and self.weight_noise is None)

    def subsample(self, x: torch.Tensor) -> torch.Tensor:
        """The input positions a plain 1x1 convolution reads (its strides)."""
        _, (sh, sw), _, _, _ = self._geom()
        return x if (sh, sw) == (1, 1) else x[:, ::sh, ::sw, :]

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        x = self._apply_input_dropout(x, self._g, training, generator)
        (kh, kw), (sh, sw), (ph, pw), (dh, dw), same = self._geom()
        if same:
            pads_h = _same_pads(x.shape[1], kh, sh, dh)
            pads_w = _same_pads(x.shape[2], kw, sw, dw)
        else:
            pads_h, pads_w = (ph, ph), (pw, pw)
        if pads_h[0] == pads_h[1] and pads_w[0] == pads_w[1]:
            padding = (pads_h[0], pads_w[0])
        else:
            x, padding = _pad_nhwc(x, pads_h, pads_w), (0, 0)
        y = F.conv2d(_nchw(x), params["W"].permute(3, 2, 0, 1), stride=(sh, sw),
                     padding=padding, dilation=(dh, dw))
        y = _nhwc(y)
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self._act(self._g))(y), state


@register_layer
@dataclasses.dataclass
class SubsamplingLayer(Layer):
    """Pooling (reference ``SubsamplingLayer``): max / avg / sum / p-norm.
    Padding is ``-inf`` for max and 0 otherwise; avg divides each window by
    the count of its input (not padding) positions, as JAX ``:197-201``."""

    pooling_type: Any = PoolingType.MAX
    kernel_size: Any = (2, 2)
    stride: Any = (2, 2)
    padding: Any = (0, 0)
    convolution_mode: str = "truncate"
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        (kh, kw), (sh, sw), (ph, pw) = _pair(self.kernel_size), _pair(self.stride), _pair(self.padding)
        same = self.convolution_mode.lower() == "same"
        h = _out_size(input_type.height, kh, sh, ph, same)
        w = _out_size(input_type.width, kw, sw, pw, same)
        return InputType.convolutional(h, w, input_type.channels)

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        (kh, kw), (sh, sw), (ph, pw) = _pair(self.kernel_size), _pair(self.stride), _pair(self.padding)
        if self.convolution_mode.lower() == "same":
            pads_h, pads_w = _same_pads(x.shape[1], kh, sh), _same_pads(x.shape[2], kw, sw)
        else:
            pads_h, pads_w = (ph, ph), (pw, pw)
        pt = PoolingType(self.pooling_type)
        k, s = (kh, kw), (sh, sw)
        if pt == PoolingType.MAX:
            y = F.max_pool2d(_nchw(_pad_nhwc(x, pads_h, pads_w, float("-inf"))), k, s)
            return _nhwc(y), state

        def window_sum(v):
            return F.avg_pool2d(_nchw(_pad_nhwc(v, pads_h, pads_w)), k, s, divisor_override=1)

        if pt == PoolingType.SUM:
            y = window_sum(x)
        elif pt == PoolingType.AVG:
            y = window_sum(x) / window_sum(torch.ones_like(x[:1, :, :, :1]))
        else:  # PNORM
            p = float(self.pnorm)
            y = window_sum(x.abs() ** p) ** (1.0 / p)
        return _nhwc(y), state


@register_layer
@dataclasses.dataclass
class BatchNormalization(Layer):
    """Batch norm (reference ``BatchNormalization``): per-channel (last axis)
    statistics; the running mean and variance in the layer's state, updated
    with ``decay`` momentum in training.

    Training takes the shifted single-pass statistics of JAX ``:231-256``:
    with the running mean as the shift, ``s1 = sum(x - shift)`` and ``s2 =
    sum((x - shift)^2)`` in float32 (float64 for float64 inputs, which the
    JAX package does not have), ``mean = shift + s1/n`` and ``var =
    max(s2/n - (s1/n)^2, 0)``. :meth:`apply_batch_stats` takes ``s1`` and
    ``s2`` from elsewhere: the ``ComputationGraph`` hands it those of the
    ``conv_stats`` kernel when this layer's only input is a plain 1x1
    convolution. Mean and variance are cast to the input's dtype before
    ``(x - mean) * rsqrt(var + eps)``, as in JAX."""

    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    use_gamma_beta: bool = True
    has_state = True

    def _nchan(self, input_type: InputType) -> int:
        return input_type.channels if input_type.kind == "convolutional" else input_type.flat_size()

    def init(self, generator, input_type, g: GlobalConfig):
        n = self._nchan(input_type)
        dt = g.dtype if g.dtype is not None else torch.float32
        params = {}
        if self.use_gamma_beta and not self.lock_gamma_beta:
            params = {"gamma": torch.ones((n,), dtype=dt), "beta": torch.zeros((n,), dtype=dt)}
        state = {"mean": torch.zeros((n,), dtype=torch.float32),
                 "var": torch.ones((n,), dtype=torch.float32)}
        return params, state

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        if training:
            axes = tuple(range(x.dim() - 1))
            d = x.to(torch.promote_types(x.dtype, torch.float32)) - state["mean"]
            return self.apply_batch_stats(params, state, x, d.sum(axes), (d * d).sum(axes),
                                          x.numel() // x.shape[-1])
        return self._normalize(params, x, state["mean"].to(x.dtype),
                               state["var"].to(x.dtype)), state

    def apply_batch_stats(self, params, state, x, s1, s2, n: int):
        """Normalize ``x`` with the batch statistics given by the shifted
        sums ``s1``, ``s2`` over ``n`` rows (shift = the running mean);
        returns ``(y, new_state)``. Gradients flow through ``s1`` and ``s2``;
        the new running statistics are detached."""
        shift = state["mean"]
        dmean = s1 / n
        mean = shift + dmean
        var = torch.clamp(s2 / n - dmean * dmean, min=0.0)
        with torch.no_grad():
            new_state = {"mean": self.decay * state["mean"] + (1 - self.decay) * mean,
                         "var": self.decay * state["var"] + (1 - self.decay) * var}
        return self._normalize(params, x, mean.to(x.dtype), var.to(x.dtype)), new_state

    def _normalize(self, params, x, mean, var):
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if "gamma" in params:
            y = y * params["gamma"] + params["beta"]
        return get_activation(self._act(self._g))(y)

    def regularizable_params(self):
        return ()  # gamma/beta are never l1/l2-regularized in the reference


@register_layer
@dataclasses.dataclass
class GlobalPoolingLayer(Layer):
    """Global pooling over the spatial or time axes (reference
    ``GlobalPoolingLayer``); mask-aware for sequences."""

    pooling_type: Any = PoolingType.MAX
    pnorm: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind == "recurrent":
            return InputType.feed_forward(input_type.size)
        return InputType.feed_forward(input_type.channels)

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        axes = tuple(range(1, x.dim() - 1))  # every axis between batch and channels
        pt = PoolingType(self.pooling_type)
        p = float(self.pnorm)
        if x.dim() == 3 and mask is not None:
            m = mask[..., None].to(x.dtype)
            if pt == PoolingType.MAX:
                y = torch.where(m > 0, x, torch.full_like(x, float("-inf"))).amax(1)
            elif pt == PoolingType.SUM:
                y = (x * m).sum(1)
            elif pt == PoolingType.AVG:
                y = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
            else:
                y = ((x.abs() ** p) * m).sum(1) ** (1.0 / p)
            return y, state
        if pt == PoolingType.MAX:
            return x.amax(axes), state
        if pt == PoolingType.SUM:
            return x.sum(axes), state
        if pt == PoolingType.AVG:
            return x.mean(axes), state
        return (x.abs() ** p).sum(axes) ** (1.0 / p), state
