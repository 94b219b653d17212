"""Activation functions.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``: the reference's
activation set (``org.nd4j.linalg.activations.Activation``) as plain
functions on tensors. Names match case-insensitively, so configs written
with DL4J-style UPPERCASE names round-trip. The layers' ``gelu`` is the
tanh-approximate form. :func:`gelu_tanh_recompute` and
:func:`gelu_exact_recompute` (JAX ``:74-135``), which the op registry's
``gelu`` runs, save only their input for the backward and recompute tanh
or erf there; the exact form uses the JAX package's rational erf
(:func:`_fusable_erf`, Abramowitz-Stegun 7.1.26), not ``torch.erf``, so the
two packages agree to the last bits.
"""

from __future__ import annotations

import enum
from typing import Callable, Union

import torch
import torch.nn.functional as F


class Activation(str, enum.Enum):
    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    TANH = "tanh"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    HARDTANH = "hardtanh"
    SOFTMAX = "softmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    SWISH = "swish"
    MISH = "mish"
    CUBE = "cube"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    THRESHOLDEDRELU = "thresholdedrelu"


def _identity(x):
    return x


def _hard_sigmoid(x):
    # DL4J/Keras hardSigmoid: clip(0.2x + 0.5, 0, 1)
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


_FNS: dict[str, Callable] = {
    "identity": _identity,
    "relu": torch.relu,
    "relu6": F.relu6,
    "leakyrelu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "elu": F.elu,
    "selu": F.selu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "hardsigmoid": _hard_sigmoid,
    "hard_sigmoid": _hard_sigmoid,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "swish": F.silu,
    "mish": F.mish,
    "cube": lambda x: x ** 3,
    "rationaltanh": lambda x: 1.7159 * torch.tanh((2.0 / 3.0) * x),
    "rectifiedtanh": lambda x: torch.clamp(torch.tanh(x), min=0.0),
    "thresholdedrelu": lambda x: torch.where(x > 1.0, x, torch.zeros_like(x)),
}


_GELU_C = 0.7978845608028654  # sqrt(2/pi)


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    # float32 accumulation for low precision; float64 stays float64
    return torch.promote_types(dt, torch.float32)


def _gelu_tanh_value(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``'s formula, in its order."""
    cdf = 0.5 * (1.0 + torch.tanh(_GELU_C * (x + 0.044715 * (x ** 3))))
    return x * cdf


def _fusable_erf(z: torch.Tensor) -> torch.Tensor:
    """Abramowitz-Stegun 7.1.26 rational erf (absolute error below 1.5e-7)
    in plain mul/add/div/exp ops (JAX ``:94``)."""
    s = torch.sign(z)
    a = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    return s * (1.0 - poly * torch.exp(-a * a))


def _gelu_exact_value(af: torch.Tensor) -> torch.Tensor:
    return 0.5 * af * (1.0 + _fusable_erf(af * 0.7071067811865476))


class GeluTanhRecompute(torch.autograd.Function):
    """Tanh-approximate gelu that saves only its input and recomputes tanh
    in the backward (JAX ``gelu_tanh_recompute``)."""

    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return _gelu_tanh_value(a)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        af = a.to(_acc_dtype(a.dtype))
        t = torch.tanh(_GELU_C * (af + 0.044715 * af ** 3))
        d = 0.5 * (1.0 + t) + 0.5 * af * (1.0 - t * t) * _GELU_C * (
            1.0 + 3 * 0.044715 * af * af)
        return (g.to(af.dtype) * d).to(a.dtype)


class GeluExactRecompute(torch.autograd.Function):
    """Exact (erf) gelu with the rational erf, saving only its input (JAX
    ``gelu_exact_recompute``): computed in float32 (float64 stays float64)
    and rounded to the input's dtype."""

    @staticmethod
    def forward(ctx, a):
        ctx.save_for_backward(a)
        return _gelu_exact_value(a.to(_acc_dtype(a.dtype))).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        (a,) = ctx.saved_tensors
        af = a.to(_acc_dtype(a.dtype))
        cdf = 0.5 * (1.0 + _fusable_erf(af * 0.7071067811865476))
        pdf = torch.exp(-0.5 * af * af) * 0.3989422804014327
        return (g.to(af.dtype) * (cdf + af * pdf)).to(a.dtype)


def gelu_tanh_recompute(a: torch.Tensor) -> torch.Tensor:
    return GeluTanhRecompute.apply(a)


def gelu_exact_recompute(a: torch.Tensor) -> torch.Tensor:
    return GeluExactRecompute.apply(a)


def get_activation(name: Union[str, Activation, Callable]) -> Callable:
    """Resolve an activation by enum, name (any case), or pass a callable
    through."""
    if callable(name) and not isinstance(name, (str, Activation)):
        return name
    key = (name.value if isinstance(name, Activation) else str(name)).lower()
    if key not in _FNS:
        raise ValueError(f"Unknown activation {name!r}; known: {sorted(_FNS)}")
    return _FNS[key]


def single_pass_norm_stats(x: torch.Tensor, axis: int = -1):
    """Shifted single-pass ``(mean, var)`` in float32 over ``axis``, with
    ``keepdim``: a per-row pivot (the first element along the axis, cut from
    the gradient) is subtracted before the sums, which avoids the
    ``E[x^2] - E[x]^2`` cancellation of the raw single-pass form on
    large-mean, small-variance rows. Used by ``layer_norm``."""
    xf = x.float()
    shift = xf.narrow(axis, 0, 1).detach()
    d = xf - shift
    dmean = d.mean(dim=axis, keepdim=True)
    var = torch.clamp_min((d * d).mean(dim=axis, keepdim=True) - dmean * dmean, 0.0)
    return shift + dmean, var
