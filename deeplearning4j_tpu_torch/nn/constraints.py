"""Weight constraints and weight noise.

Counterpart of ``deeplearning4j_tpu/nn/constraints.py`` (reference
``org.deeplearning4j.nn.conf.constraint.*`` and
``org.deeplearning4j.nn.conf.weightnoise.{DropConnect,WeightNoise}``).
Constraints are projections of the parameters after each updater step (the
reference's ``BaseLayer.applyConstraints``); the networks call
:func:`apply_layer_constraints` after the update, under ``no_grad``. Weight
noise perturbs the weights a training forward sees (DropConnect: a
Bernoulli mask on the weights; WeightNoise: gaussian noise added or
multiplied), and the gradient flows through the perturbation to the
weights. The ``to_dict`` forms are the JAX package's, so a configuration
with constraints or noise crosses between the packages.

The noise is drawn from an explicit ``torch.Generator``: the step's CPU
generator gives one seed per weight, and the draw is made on the weight's
device from a generator seeded by it (as dropout's ``keep_mask`` does). The
draws differ from the JAX package's stream, as every draw of the two
packages does; :meth:`DropConnect.draw` and :meth:`WeightNoise.draw` are the
only places they are made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


class Constraint:
    """A projection of a parameter after each update."""

    def apply(self, w: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"type": type(self).__name__}
        d.update({f.name: getattr(self, f.name) for f in dataclasses.fields(self)})
        return d

    @staticmethod
    def from_dict(d: dict) -> "Constraint":
        cls = _CONSTRAINTS[d["type"]]
        return cls(**{k: v for k, v in d.items() if k != "type"})


def _norms(w: torch.Tensor, axes) -> torch.Tensor:
    if axes is None:
        return torch.sqrt((w * w).sum())
    return torch.sqrt((w * w).sum(dim=tuple(int(a) for a in axes), keepdim=True))


@dataclasses.dataclass
class MaxNormConstraint(Constraint):
    """Scale the weights down so that the norm over ``axes`` is at most
    ``max_norm``."""

    max_norm: float = 1.0
    axes: Optional[Sequence[int]] = (0,)

    def apply(self, w):
        n = _norms(w, self.axes)
        return w * torch.clamp(torch.full_like(n, self.max_norm) / torch.clamp_min(n, 1e-12),
                               max=1.0)


@dataclasses.dataclass
class MinMaxNormConstraint(Constraint):
    """Clamp the norm over ``axes`` into ``[min_norm, max_norm]``, moved
    there at ``rate`` (reference ``MinMaxNormConstraint``)."""

    min_norm: float = 0.0
    max_norm: float = 1.0
    rate: float = 1.0
    axes: Optional[Sequence[int]] = (0,)

    def apply(self, w):
        n = _norms(w, self.axes)
        clipped = torch.clamp(n, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1.0 - self.rate) * n
        return w * (target / torch.clamp_min(n, 1e-12))


@dataclasses.dataclass
class UnitNormConstraint(Constraint):
    axes: Optional[Sequence[int]] = (0,)

    def apply(self, w):
        return w / torch.clamp_min(_norms(w, self.axes), 1e-12)


@dataclasses.dataclass
class NonNegativeConstraint(Constraint):
    def apply(self, w):
        return torch.clamp_min(w, 0.0)


_CONSTRAINTS = {c.__name__: c for c in (MaxNormConstraint, MinMaxNormConstraint,
                                        UnitNormConstraint, NonNegativeConstraint)}


def constraints_from_config(value):
    """A layer's ``constraints``/``bias_constraints`` field as read from
    JSON: a constraint, a dict, or a list of either, as a list of
    :class:`Constraint` (JAX ``Layer.from_dict``)."""
    if value is None:
        return None
    vs = value if isinstance(value, list) else [value]
    return [Constraint.from_dict(v) if isinstance(v, dict) else v for v in vs]


def apply_layer_constraints(layer, layer_params):
    """One layer's parameters projected by its constraints: the weights
    (``regularizable_params``) by ``constraints``, the bias ``b`` by
    ``bias_constraints``. Returns a new dict; leaves without a constraint
    are the same tensors."""
    cs = getattr(layer, "constraints", None)
    bcs = getattr(layer, "bias_constraints", None)
    if not cs and not bcs:
        return layer_params
    wkeys = set(layer.regularizable_params())
    out = dict(layer_params)
    for k, v in layer_params.items():
        if not isinstance(v, torch.Tensor):
            continue
        active = cs if k in wkeys else (bcs if k == "b" else None)
        if active:
            for c in (active if isinstance(active, (list, tuple)) else [active]):
                v = c.apply(v)
            out[k] = v
    return out


def _device_generator(generator: torch.Generator, device) -> torch.Generator:
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass
class DropConnect:
    """A Bernoulli mask on the WEIGHTS in training (reference
    ``DropConnect``); ``p`` is the retain probability, as dropout's."""

    p: float = 0.5
    apply_to_bias: bool = False

    def draw(self, generator: torch.Generator, w: torch.Tensor) -> torch.Tensor:
        """The keep mask: true with probability ``p``, on ``w``'s device."""
        gen = _device_generator(generator, w.device)
        return torch.rand(w.shape, generator=gen, device=w.device) < self.p

    def apply(self, generator: torch.Generator, w: torch.Tensor) -> torch.Tensor:
        keep = self.draw(generator, w)
        return torch.where(keep, w / self.p, torch.zeros((), dtype=w.dtype,
                                                         device=w.device)).to(w.dtype)

    def to_dict(self) -> dict:
        return {"type": "DropConnect", "p": self.p, "apply_to_bias": self.apply_to_bias}


@dataclasses.dataclass
class WeightNoise:
    """Gaussian noise on the weights in training, added or multiplied
    (reference ``WeightNoise`` with a normal distribution)."""

    stddev: float = 0.01
    mean: float = 0.0
    additive: bool = True
    apply_to_bias: bool = False

    def draw(self, generator: torch.Generator, w: torch.Tensor) -> torch.Tensor:
        """Standard normal float32 draws of ``w``'s shape on its device."""
        gen = _device_generator(generator, w.device)
        return torch.randn(w.shape, generator=gen, device=w.device, dtype=torch.float32)

    def apply(self, generator: torch.Generator, w: torch.Tensor) -> torch.Tensor:
        noise = (self.mean + self.stddev * self.draw(generator, w)).to(w.dtype)
        return w + noise if self.additive else w * noise

    def to_dict(self) -> dict:
        return {"type": "WeightNoise", "stddev": self.stddev, "mean": self.mean,
                "additive": self.additive, "apply_to_bias": self.apply_to_bias}


def weight_noise_from_config(value):
    """A layer's ``weight_noise`` field as read from JSON (JAX
    ``Layer.from_dict``): a dict becomes :class:`DropConnect` or
    :class:`WeightNoise` by its ``type``."""
    if not isinstance(value, dict):
        return value
    cls = DropConnect if value.get("type") == "DropConnect" else WeightNoise
    return cls(**{a: b for a, b in value.items() if a != "type"})


def apply_weight_noise(layer, layer_params, generator: Optional[torch.Generator]):
    """The weights a training forward sees: each weight (and the bias with
    ``apply_to_bias``), in sorted key order, perturbed by the layer's
    weight noise. The identity without noise or without a generator
    (inference)."""
    wn = getattr(layer, "weight_noise", None)
    if wn is None or generator is None:
        return layer_params
    wkeys = set(layer.regularizable_params())
    out = dict(layer_params)
    for k in sorted(layer_params):
        v = layer_params[k]
        if isinstance(v, torch.Tensor) and (k in wkeys or (k == "b" and wn.apply_to_bias)):
            out[k] = wn.apply(generator, v)
    return out
