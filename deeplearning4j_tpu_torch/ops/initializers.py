"""Weight initialisation schemes.

Counterpart of ``deeplearning4j_tpu/ops/initializers.py``: the reference's
``WeightInit`` enum with the same distributions, drawn from an explicit
``torch.Generator``. A fresh port network does not draw the JAX package's
numbers; weights cross between the packages through the archive.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Sequence, Tuple

import torch


class WeightInit(str, enum.Enum):
    XAVIER = "xavier"
    XAVIER_UNIFORM = "xavier_uniform"
    XAVIER_FAN_IN = "xavier_fan_in"
    RELU = "relu"
    RELU_UNIFORM = "relu_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    SIGMOID_UNIFORM = "sigmoid_uniform"
    NORMAL = "normal"
    UNIFORM = "uniform"
    ZERO = "zero"
    ONES = "ones"
    IDENTITY = "identity"
    VAR_SCALING_NORMAL_FAN_IN = "var_scaling_normal_fan_in"
    VAR_SCALING_NORMAL_FAN_OUT = "var_scaling_normal_fan_out"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"
    VAR_SCALING_UNIFORM_FAN_IN = "var_scaling_uniform_fan_in"
    VAR_SCALING_UNIFORM_FAN_OUT = "var_scaling_uniform_fan_out"
    VAR_SCALING_UNIFORM_FAN_AVG = "var_scaling_uniform_fan_avg"
    DISTRIBUTION = "distribution"


def init_weights(generator: torch.Generator, shape: Sequence[int],
                 scheme="xavier", fan: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32,
                 distribution: Optional[dict] = None) -> torch.Tensor:
    """Draw a weight tensor on the CPU from ``generator``.

    ``fan`` is (fan_in, fan_out); if omitted, the last dim is fan_out and
    the product of the rest fan_in (a 1-D shape uses its length for both).
    """
    scheme = WeightInit(scheme) if not isinstance(scheme, WeightInit) else scheme
    shape = tuple(int(s) for s in shape)
    if fan is None:
        fan_out = shape[-1] if shape else 1
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else (shape[0] if shape else 1)
    else:
        fan_in, fan_out = fan
    fan_in = max(1, int(fan_in))
    fan_out = max(1, int(fan_out))

    def normal(std):
        return (torch.randn(shape, generator=generator) * std).to(dtype)

    def uniform(limit):
        return ((torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit).to(dtype)

    s, W = scheme, WeightInit
    if s == W.XAVIER:
        return normal(math.sqrt(2.0 / (fan_in + fan_out)))
    if s == W.XAVIER_UNIFORM:
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if s in (W.XAVIER_FAN_IN, W.LECUN_NORMAL, W.NORMAL):
        return normal(math.sqrt(1.0 / fan_in))
    if s == W.RELU:
        return normal(math.sqrt(2.0 / fan_in))
    if s == W.RELU_UNIFORM:
        return uniform(math.sqrt(6.0 / fan_in))
    if s == W.LECUN_UNIFORM:
        return uniform(math.sqrt(3.0 / fan_in))
    if s == W.SIGMOID_UNIFORM:
        return uniform(4.0 * math.sqrt(6.0 / (fan_in + fan_out)))
    if s == W.UNIFORM:
        return uniform(1.0 / math.sqrt(fan_in))
    if s == W.ZERO:
        return torch.zeros(shape, dtype=dtype)
    if s == W.ONES:
        return torch.ones(shape, dtype=dtype)
    if s == W.IDENTITY:
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-D shape")
        return torch.eye(shape[0], dtype=dtype)
    if s == W.DISTRIBUTION:
        return _from_distribution(generator, shape, dtype, distribution or {})
    if s in (W.VAR_SCALING_NORMAL_FAN_IN, W.VAR_SCALING_UNIFORM_FAN_IN):
        n = fan_in
    elif s in (W.VAR_SCALING_NORMAL_FAN_OUT, W.VAR_SCALING_UNIFORM_FAN_OUT):
        n = fan_out
    else:
        n = (fan_in + fan_out) / 2.0
    if "uniform" in s.value:
        return uniform(math.sqrt(3.0 / n))
    return normal(math.sqrt(1.0 / n))


def _from_distribution(generator, shape, dtype, dist: dict) -> torch.Tensor:
    """DL4J ``Distribution`` configs: {"type": "normal"|"uniform"|
    "truncated_normal"|"constant"|"orthogonal", ...params}."""
    kind = dist.get("type", "normal").lower()
    if kind == "normal":
        t = dist.get("mean", 0.0) + torch.randn(shape, generator=generator) * dist.get("std", 1.0)
    elif kind == "truncated_normal":
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t = dist.get("mean", 0.0) + t * dist.get("std", 1.0)
    elif kind == "uniform":
        lo, hi = dist.get("lower", -1.0), dist.get("upper", 1.0)
        t = lo + torch.rand(shape, generator=generator) * (hi - lo)
    elif kind == "constant":
        t = torch.full(shape, float(dist.get("value", 0.0)))
    elif kind == "orthogonal":
        t = torch.empty(shape)
        torch.nn.init.orthogonal_(t, gain=dist.get("gain", 1.0), generator=generator)
    else:
        raise ValueError(f"Unknown distribution type {kind!r}")
    return t.to(dtype)
