"""Updaters (optimizers).

Counterpart of ``deeplearning4j_tpu/train/updaters.py``: the reference's
``Sgd``, ``Adam``, ``AdaMax``, ``AMSGrad``, ``Nadam``, ``Nesterovs``,
``RmsProp``, ``AdaGrad``, ``AdaDelta`` and ``NoOp`` as serializable
dataclasses with the same defaults and the same ``to_dict``/``from_dict``
schema, so a ``configuration.json`` written by either package parses here.

The math of ``Sgd``, ``RmsProp`` and ``NoOp`` is ported: each is the optax
0.2.6 transform the JAX package builds (``optax.sgd``, ``optax.rmsprop``,
``optax.set_to_zero``), with the same state, the same float operations in
the same order, and the same state leaf order in ``updaterState.npz``. The
other updaters, learning-rate schedules (kept as their JSON dict), gradient
normalization, weight decay and l1/l2 raise ``NotImplementedError`` by name
when a network trains with them.

:class:`NetworkOptimizer` is the counterpart of the JAX network's
``_build_tx``/``_layer_transform`` (``multi_layer_network.py:118-153``): one
transform per layer key, the layer's own updater or the global one
(``Sgd(0.1)`` when none is configured), ``NoOp`` for a frozen layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Type

import torch

_UPDATER_REGISTRY: Dict[str, Type["Updater"]] = {}


def register_updater(cls):
    _UPDATER_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class Updater:
    learning_rate: Any = 1e-3  # float, or a schedule's JSON dict

    def _lr(self) -> float:
        if isinstance(self.learning_rate, dict):
            raise NotImplementedError(
                f"learning-rate schedule {self.learning_rate.get('@type', '?')!r} is "
                "not ported to deeplearning4j_tpu_torch yet")
        return float(self.learning_rate)

    def init_state(self, param: torch.Tensor) -> Optional[torch.Tensor]:
        """The parameter's moment (its leaf of the optax state), or None."""
        raise NotImplementedError(f"the {type(self).__name__} updater is not ported "
                                  "to deeplearning4j_tpu_torch yet")

    def apply(self, param: torch.Tensor, grad: torch.Tensor,
              state: Optional[torch.Tensor]) -> None:
        """One step on ``param`` and its moment ``state``, in place."""
        raise NotImplementedError(f"the {type(self).__name__} updater is not ported "
                                  "to deeplearning4j_tpu_torch yet")

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
    """``optax.sgd(lr)``: ``p += -lr * g``; no state."""

    def init_state(self, param):
        return None

    def apply(self, param, grad, state):
        param.add_((-self._lr()) * grad)


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
    """``optax.rmsprop(lr, decay, eps)`` (``scale_by_rms`` then the learning
    rate): ``nu`` starts at 0, ``nu = (1 - decay) * g^2 + decay * nu``,
    ``p += -lr * (rsqrt(nu + eps) * g)``. eps sits INSIDE the square root,
    unlike ``torch.optim.RMSprop``."""

    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, param):
        return torch.zeros_like(param)

    def apply(self, param, grad, nu):
        nu.copy_((1.0 - self.rms_decay) * (grad ** 2) + self.rms_decay * nu)
        param.add_((-self._lr()) * (torch.rsqrt(nu + self.epsilon) * grad))


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
    """``optax.set_to_zero()``: no update, no state."""

    def init_state(self, param):
        return None

    def apply(self, param, grad, state):
        pass


def _unported(name: str, value) -> None:
    if value:
        raise NotImplementedError(f"{name}={value!r} is not ported to "
                                  "deeplearning4j_tpu_torch yet")


class NetworkOptimizer:
    """The per-layer optimizer of a network: ``transforms`` maps each layer
    key that has parameters to its :class:`Updater`. ``state`` is
    ``{layer_key: {param_name: nu}}`` for the stateful layers, so
    :func:`~..models.serializer.tree_leaves` of it is the JAX package's
    ``jax.tree.leaves(opt_state)`` order (``optax.multi_transform`` keeps
    one inner state per layer label, sorted, each holding that layer's
    moments in sorted parameter order)."""

    def __init__(self, transforms: Dict[str, Updater], params: Dict[str, Dict]):
        self.transforms = transforms
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for k, upd in transforms.items():
            moments = {n: upd.init_state(t) for n, t in params[k].items()}
            if any(m is not None for m in moments.values()):
                self.state[k] = moments

    @staticmethod
    def for_network(layers, layer_keys: List[str], global_conf, params) -> "NetworkOptimizer":
        """Transforms as ``_layer_transform`` builds them; raises by name on
        what is not ported."""
        g = global_conf
        _unported("gradient_normalization", g.gradient_normalization)
        default = g.updater if g.updater is not None else Sgd(0.1)
        transforms: Dict[str, Updater] = {}
        for k, layer in zip(layer_keys, layers):
            if k not in params:
                continue
            for name in ("l1", "l2", "weight_decay"):
                _unported(name, getattr(layer, name) if getattr(layer, name) is not None
                          else getattr(g, name))
            for name in ("constraints", "bias_constraints", "weight_noise"):
                _unported(name, getattr(layer, name))
            upd = NoOp() if layer.frozen else (layer.updater or default)
            upd._lr()  # a schedule raises here, before any step
            transforms[k] = upd
        return NetworkOptimizer(transforms, params)

    def step(self, params: Dict[str, Dict[str, torch.Tensor]],
             grads: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Apply one update to ``params`` in place (``optax.apply_updates``:
        the update is added in the parameter's dtype)."""
        with torch.no_grad():
            for k, upd in self.transforms.items():
                moments = self.state.get(k, {})
                for n, p in params[k].items():
                    upd.apply(p, grads[k][n].to(p.dtype), moments.get(n))
