"""Activation functions.

Counterpart of ``deeplearning4j_tpu/ops/activations.py``: the reference's
activation set (``org.nd4j.linalg.activations.Activation``) as plain
functions on tensors. Names match case-insensitively, so configs written
with DL4J-style UPPERCASE names round-trip. The JAX package's recompute-
in-backward gelu variants are a training-memory device; the values here are
the same (tanh-approximate gelu, rational-erf free).
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
