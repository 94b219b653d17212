"""Convolution, pooling and normalization layers.

Counterpart of ``deeplearning4j_tpu/nn/conv_layers.py``, every layer of it:
``ConvolutionLayer`` (``:55-98``), ``Convolution1DLayer`` (``:101-166``,
causal mode and its mask reduction), ``SubsamplingLayer`` (``:169-206``),
``BatchNormalization`` (``:209-266``), ``LocalResponseNormalization``
(``:270``), ``Upsampling2D`` (``:291``), ``ZeroPaddingLayer`` (``:308``),
``SeparableConvolution2D`` (``:332``), ``Deconvolution2D`` (``:372``),
``SpaceToDepthLayer`` (``:397``) and ``GlobalPoolingLayer`` (``:416-450``),
with the JAX parameter names (``W``, ``b``, ``W_depth``, ``W_point``) and
shapes, so archives cross unchanged.

Layout: the public tensors are the JAX package's, NHWC activations and HWIO
kernels (``:10``), so configurations, archives and tests compare like with
like. Inside, a convolution or pooling runs on the NCHW view of the NHWC
tensor (``permute(0, 3, 1, 2)``, no copy), which is PyTorch's channels_last
layout, and the result is viewed back as NHWC: cuDNN takes channels_last
natively. ``same`` mode pads as XLA's ``SAME`` does (the extra row or column
at the bottom and right), explicitly where the two sides differ.

Where PyTorch's functional form means something else than the JAX call, the
layer maps it explicitly: ``Deconvolution2D`` is ``lax.conv_transpose``
without ``transpose_kernel`` (the HWIO kernel is not flipped, the padding
applies to the stride-dilated input, ``SAME`` by lax's own rule), so it runs
``F.conv_transpose2d`` on the flipped, permuted kernel and then crops or
zero-pads the result to lax's padding; ``LocalResponseNormalization``
divides by ``(k + alpha * sum)^beta`` (``F.local_response_norm`` takes
``alpha / n``); ``SpaceToDepthLayer`` orders its channels ``(bh, bw, c)``
(``F.pixel_unshuffle`` gives ``(c, bh, bw)``).
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
        """A ``ConvolutionLayer`` itself (not a subclass) with a 1x1 kernel, no padding, no dilation, no bias, identity
        activation, no input dropout and no weight noise (with the network's
        defaults, ``_g``): the convolution is the product ``x[:, ::sh, ::sw,
        :] @ W[0, 0]`` in either mode."""
        (kh, kw), _, (ph, pw), (dh, dw), _ = self._geom()
        act = self._act(self._g)
        return (type(self) is ConvolutionLayer
                and (kh, kw, ph, pw, dh, dw) == (1, 1, 0, 0, 1, 1) and not self.has_bias
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


def _int0(v) -> int:
    return int(v[0]) if isinstance(v, (tuple, list)) else int(v)


@register_layer
@dataclasses.dataclass
class Convolution1DLayer(ConvolutionLayer):
    """1-D convolution over (batch, time, features), kernel ``(k, 1, in,
    out)`` (the JAX width-1 2-D form). ``convolution_mode="causal"`` pads
    ``(k - 1) * d`` steps on the left only, so step ``t`` sees inputs up to
    ``t``."""

    kernel_size: Any = 3
    stride: Any = 1
    padding: Any = 0
    dilation: Any = 1

    def _geom1d(self):
        return (_int0(self.kernel_size), _int0(self.stride), _int0(self.padding),
                _int0(self.dilation), self.convolution_mode.lower() == "same")

    def _is_causal(self) -> bool:
        return self.convolution_mode.lower() == "causal"

    def _time_pads(self, t: int, window: int, s: int, p: int, same: bool, d: int = 1):
        """(left, right) padding of the time axis for a window of ``window``
        taps ``d`` apart."""
        if self._is_causal():
            return (window - 1) * d, 0
        return _same_pads(t, window, s, d) if same else (p, p)

    def output_type(self, input_type: InputType) -> InputType:
        k, s, p, d, same = self._geom1d()
        t = input_type.timesteps
        if self._is_causal():
            t_out = None if t is None else -(-t // s)  # left padding keeps ceil(t/s)
        else:
            t_out = None if t is None else _out_size(t, k, s, p, same, d)
        return InputType.recurrent(self.n_out, t_out)

    def init(self, generator, input_type, g: GlobalConfig):
        k = self._geom1d()[0]
        c_in = input_type.size
        dt = g.dtype if g.dtype is not None else torch.float32
        params = {"W": init_weights(generator, (k, 1, c_in, self.n_out), self._winit(g),
                                    fan=(k * c_in, k * self.n_out), dtype=dt)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self._binit(g)), dtype=dt)
        return params, {}

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        x = self._apply_input_dropout(x, self._g, training, generator)
        k, s, p, d, same = self._geom1d()
        lo, hi = self._time_pads(x.shape[1], k, s, p, same, d)
        xt = x.transpose(1, 2)  # (batch, features, time)
        if lo != hi:
            xt, lo = F.pad(xt, (lo, hi)), 0
        y = F.conv1d(xt, params["W"][:, 0].permute(2, 1, 0), stride=s, padding=lo,
                     dilation=d).transpose(1, 2)
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self._act(self._g))(y), state

    def transform_mask(self, mask):
        """The (batch, time) mask reduced with the convolution's geometry (JAX
        ``:151-166``): an output step is valid if any input step in its
        window is, a max-pool of ``(k - 1) * d + 1`` steps at the layer's
        stride, padded with zeros; float32."""
        if mask is None:
            return None
        k, s, p, d, same = self._geom1d()
        eff = (k - 1) * d + 1
        m = mask.to(torch.float32)
        lo, hi = self._time_pads(m.shape[1], eff, s, p, same)
        return F.max_pool1d(F.pad(m[:, None, :], (lo, hi)), eff, s)[:, 0, :]


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
class LocalResponseNormalization(Layer):
    """LRN across channels (reference ``LocalResponseNormalization``):
    ``x / (k + alpha * sum)^beta``, the sum of ``x^2`` over a centred window
    of ``n`` channels, zero beyond the edges (JAX ``:270-288``; not
    ``F.local_response_norm``, which scales ``alpha`` by ``1/n``)."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        half, c = self.n // 2, x.shape[-1]
        padded = F.pad(x * x, (half, half))
        win = sum(padded[..., i:i + c] for i in range(self.n))
        return x / ((self.k + self.alpha * win) ** self.beta), state


@register_layer
@dataclasses.dataclass
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling (reference ``Upsampling2D``)."""

    size: Any = (2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        sh, sw = _pair(self.size)
        return InputType.convolutional(input_type.height * sh, input_type.width * sw,
                                       input_type.channels)

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2), state


@register_layer
@dataclasses.dataclass
class ZeroPaddingLayer(Layer):
    """Spatial zero padding (reference ``ZeroPaddingLayer``): ``(ph, pw)`` or
    ``((top, bottom), (left, right))``."""

    padding: Any = (1, 1)

    def _pads(self):
        p = self.padding
        if isinstance(p, (tuple, list)) and len(p) == 2 and isinstance(p[0], (tuple, list)):
            return tuple(p[0]), tuple(p[1])
        ph, pw = _pair(p)
        return (ph, ph), (pw, pw)

    def output_type(self, input_type: InputType) -> InputType:
        (pt, pb), (pl, pr) = self._pads()
        return InputType.convolutional(input_type.height + pt + pb,
                                       input_type.width + pl + pr, input_type.channels)

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        ph, pw = self._pads()
        return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1])), state


@register_layer
@dataclasses.dataclass
class SeparableConvolution2D(ConvolutionLayer):
    """Depthwise-separable convolution (reference
    ``SeparableConvolution2D``): a depthwise convolution, ``W_depth`` of
    shape ``(kh, kw, 1, c_in * dm)`` whose output channel ``o`` reads input
    channel ``o // dm`` (lax's ``feature_group_count=c_in``, PyTorch's
    ``groups=c_in`` on the same channel order), then a 1x1 pointwise
    ``W_point`` of shape ``(1, 1, c_in * dm, n_out)``."""

    depth_multiplier: int = 1

    def init(self, generator, input_type, g: GlobalConfig):
        (kh, kw), _, _, _, _ = self._geom()
        c_in, dm = input_type.channels, self.depth_multiplier
        dt = g.dtype if g.dtype is not None else torch.float32
        params = {
            "W_depth": init_weights(generator, (kh, kw, 1, c_in * dm), self._winit(g),
                                    fan=(kh * kw, kh * kw * dm), dtype=dt),
            "W_point": init_weights(generator, (1, 1, c_in * dm, self.n_out), self._winit(g),
                                    fan=(c_in * dm, self.n_out), dtype=dt),
        }
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self._binit(g)), dtype=dt)
        return params, {}

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
        y = F.conv2d(_nchw(x), params["W_depth"].permute(3, 2, 0, 1), stride=(sh, sw),
                     padding=padding, dilation=(dh, dw), groups=x.shape[-1])
        y = _nhwc(y) @ params["W_point"][0, 0]
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self._act(self._g))(y), state


def _transpose_pads(k: int, s: int, same: bool, p: int = 0) -> Tuple[int, int]:
    """lax's padding of the stride-dilated input of a transposed convolution
    along one axis (lax ``_conv_transpose_padding``): ``SAME`` gives an
    output of ``size * s``; an explicit forward padding ``p`` gives ``k - 1
    - p`` on each side."""
    if not same:
        return k - 1 - p, k - 1 - p
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


@register_layer
@dataclasses.dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution (reference ``Deconvolution2D``), as JAX
    ``:372-394`` computes it: ``lax.conv_transpose`` of the HWIO kernel ``(kh,
    kw, in, out)`` without ``transpose_kernel``, i.e. the correlation of the
    stride-dilated input, padded by :func:`_transpose_pads`, with the
    unflipped kernel. ``F.conv_transpose2d`` correlates with the spatially
    flipped ``(in, out, kh, kw)`` kernel over a padding of ``k - 1`` on each
    side, so the layer hands it ``W`` flipped and permuted and then crops (or
    zero-pads) each side of its result to lax's padding. Dilation is not
    applied (nor in JAX)."""

    def output_type(self, input_type: InputType) -> InputType:
        (kh, kw), (sh, sw), (ph, pw), _, same = self._geom()
        if same:
            h, w = input_type.height * sh, input_type.width * sw
        else:
            h = sh * (input_type.height - 1) + kh - 2 * ph
            w = sw * (input_type.width - 1) + kw - 2 * pw
        return InputType.convolutional(h, w, self.n_out)

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        x = self._apply_input_dropout(x, self._g, training, generator)
        (kh, kw), (sh, sw), (ph, pw), _, same = self._geom()
        (ha, hb), (wa, wb) = _transpose_pads(kh, sh, same, ph), _transpose_pads(kw, sw, same, pw)
        w = params["W"].flip(0, 1).permute(2, 3, 0, 1)
        if ha == hb and wa == wb and 0 <= kh - 1 - ha and 0 <= kw - 1 - wa:
            y = F.conv_transpose2d(_nchw(x), w, stride=(sh, sw),
                                   padding=(kh - 1 - ha, kw - 1 - wa))
        else:  # the full result has k - 1 on each side: crop or pad to lax's
            y = F.pad(F.conv_transpose2d(_nchw(x), w, stride=(sh, sw)),
                      (wa - (kw - 1), wb - (kw - 1), ha - (kh - 1), hb - (kh - 1)))
        y = _nhwc(y)
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self._act(self._g))(y), state


@register_layer
@dataclasses.dataclass
class SpaceToDepthLayer(Layer):
    """Space-to-depth (reference ``SpaceToDepthLayer``): each ``b x b``
    block becomes ``b * b * c`` channels in the order ``(bh, bw, c)`` (JAX
    ``:410-412``)."""

    block_size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        b = self.block_size
        return InputType.convolutional(input_type.height // b, input_type.width // b,
                                       input_type.channels * b * b)

    def forward(self, params, state, x, *, training=False, generator=None, mask=None):
        n, h, w, c = x.shape
        b = self.block_size
        y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, h // b, w // b, c * b * b), state


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
