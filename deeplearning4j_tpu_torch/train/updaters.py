"""Updaters (optimizers), configuration only.

Counterpart of ``deeplearning4j_tpu/train/updaters.py``: the reference's
``Sgd``, ``Adam``, ``AdaMax``, ``AMSGrad``, ``Nadam``, ``Nesterovs``,
``RmsProp``, ``AdaGrad``, ``AdaDelta`` and ``NoOp`` as serializable
dataclasses with the same defaults and the same ``to_dict``/``from_dict``
schema, so a ``configuration.json`` written by either package parses here.
The optimizer math comes with training; a learning-rate schedule is kept as
its JSON dict until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type

_UPDATER_REGISTRY: Dict[str, Type["Updater"]] = {}


def register_updater(cls):
    _UPDATER_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class Updater:
    learning_rate: Any = 1e-3  # float, or a schedule's JSON dict

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Updater":
        d = dict(d)
        name = d.pop("@type")
        if name not in _UPDATER_REGISTRY:
            raise KeyError(f"Unknown updater {name!r}; known: {sorted(_UPDATER_REGISTRY)}")
        return _UPDATER_REGISTRY[name](**d)


@register_updater
@dataclasses.dataclass
class Sgd(Updater):
    pass


@register_updater
@dataclasses.dataclass
class Adam(Updater):
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


@register_updater
@dataclasses.dataclass
class AdaMax(Adam):
    pass


@register_updater
@dataclasses.dataclass
class AMSGrad(Adam):
    pass


@register_updater
@dataclasses.dataclass
class Nadam(Adam):
    pass


@register_updater
@dataclasses.dataclass
class Nesterovs(Updater):
    learning_rate: Any = 0.1
    momentum: float = 0.9


@register_updater
@dataclasses.dataclass
class RmsProp(Updater):
    rms_decay: float = 0.95
    epsilon: float = 1e-8


@register_updater
@dataclasses.dataclass
class AdaGrad(Updater):
    epsilon: float = 1e-6


@register_updater
@dataclasses.dataclass
class AdaDelta(Updater):
    rho: float = 0.95
    epsilon: float = 1e-6


@register_updater
@dataclasses.dataclass
class NoOp(Updater):
    pass
