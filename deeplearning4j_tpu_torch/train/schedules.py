"""Learning-rate schedules.

Counterpart of ``deeplearning4j_tpu/train/schedules.py`` (reference
``org.nd4j.linalg.schedule.*``): ``StepSchedule``, ``ExponentialSchedule``,
``InverseSchedule``, ``PolySchedule``, ``SigmoidSchedule``, ``MapSchedule``
and ``CycleSchedule``, with the same fields and the same JSON
(``to_dict``/``from_dict`` through a name registry).

``value_at(step)`` computes as the JAX package's ``jnp`` does with 64-bit
off: the step is an int32 count, the arithmetic is float32 (a Python float
enters as a float32 scalar), and the result is a 0-d float32 CPU tensor.
Divisions by a tensor are written as tensor divisions: ``float / tensor``
in PyTorch multiplies by the reciprocal, which is not the same rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Type

import torch

_SCHED_REGISTRY: Dict[str, Type["Schedule"]] = {}
_F32 = torch.float32


def register_schedule(cls):
    _SCHED_REGISTRY[cls.__name__] = cls
    return cls


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32)


def _count(step) -> torch.Tensor:
    """The step as the 0-d int32 count optax passes."""
    return torch.as_tensor(step).to(torch.int32).reshape(())


@dataclasses.dataclass
class Schedule:
    initial_value: float = 1e-3

    def value_at(self, step) -> torch.Tensor:
        return _f32(self.initial_value)

    def __call__(self, step) -> torch.Tensor:
        return self.value_at(step)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "Schedule":
        d = dict(d)
        cls = _SCHED_REGISTRY[d.pop("@type")]
        if cls is MapSchedule and "values" in d:
            d["values"] = {int(k): float(v) for k, v in d["values"].items()}
        return cls(**d)


@register_schedule
@dataclasses.dataclass
class StepSchedule(Schedule):
    """value * decay_rate ^ floor(step / step_size)"""

    decay_rate: float = 0.1
    step_size: int = 1000

    def value_at(self, step):
        n = torch.floor(_count(step).to(_F32) / _f32(self.step_size))
        return self.initial_value * torch.pow(_f32(self.decay_rate), n)


@register_schedule
@dataclasses.dataclass
class ExponentialSchedule(Schedule):
    gamma: float = 0.99

    def value_at(self, step):
        return self.initial_value * torch.pow(_f32(self.gamma), _count(step).to(_F32))


@register_schedule
@dataclasses.dataclass
class InverseSchedule(Schedule):
    gamma: float = 0.01
    power: float = 1.0

    def value_at(self, step):
        base = 1.0 + self.gamma * _count(step).to(_F32)
        return _f32(self.initial_value) / torch.pow(base, _f32(self.power))


@register_schedule
@dataclasses.dataclass
class PolySchedule(Schedule):
    power: float = 2.0
    max_iter: int = 10000

    def value_at(self, step):
        frac = torch.clamp(_count(step).to(_F32) / _f32(self.max_iter), 0.0, 1.0)
        return self.initial_value * torch.pow(1.0 - frac, _f32(self.power))


@register_schedule
@dataclasses.dataclass
class SigmoidSchedule(Schedule):
    gamma: float = 0.01
    step_size: int = 1000

    def value_at(self, step):
        z = self.gamma * (_count(step) - self.step_size).to(_F32)
        return _f32(self.initial_value) / (1.0 + torch.exp(z))


@register_schedule
@dataclasses.dataclass
class MapSchedule(Schedule):
    """Piecewise-constant: {step: value}, holds the last value reached."""

    values: Dict[int, float] = dataclasses.field(default_factory=dict)

    def value_at(self, step):
        step = _count(step)
        out = _f32(self.initial_value)
        for k in sorted(self.values):
            out = torch.where(step >= k, _f32(self.values[k]), out)
        return out


@register_schedule
@dataclasses.dataclass
class CycleSchedule(Schedule):
    """1cycle policy (reference ``CycleSchedule``): ramp up, ramp down, then
    anneal over the final ``annealing_length`` steps."""

    max_value: float = 1e-2
    cycle_length: int = 1000
    annealing_length: int = 100
    annealing_decay: float = 0.1

    def value_at(self, step):
        up = _f32(max(self.cycle_length // 2, 1))
        pos = torch.remainder(_count(step), self.cycle_length + self.annealing_length)
        posf = pos.to(_F32)
        rise = self.max_value - self.initial_value
        ramp_up = self.initial_value + rise * (posf / up)
        ramp_down = self.max_value - rise * ((pos - self.cycle_length // 2).to(_F32) / up)
        frac = torch.clamp((pos - self.cycle_length).to(_F32)
                           / _f32(max(self.annealing_length, 1)), 0.0, 1.0)
        anneal = self.initial_value * (1.0 - (1.0 - self.annealing_decay) * frac)
        return torch.where(pos < self.cycle_length // 2, ramp_up,
                           torch.where(pos < self.cycle_length, ramp_down, anneal))
