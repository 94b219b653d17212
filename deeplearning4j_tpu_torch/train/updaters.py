"""Updaters (optimizers).

Counterpart of ``deeplearning4j_tpu/train/updaters.py``: the reference's
``Sgd``, ``Adam``, ``AdaMax``, ``AMSGrad``, ``Nadam``, ``Nesterovs``,
``RmsProp``, ``AdaGrad``, ``AdaDelta`` and ``NoOp`` as serializable
dataclasses with the same defaults and the same ``to_dict``/``from_dict``
schema, so a ``configuration.json`` written by either package parses here.

The math of ``Sgd``, ``Adam``, ``Nesterovs``, ``RmsProp`` and ``NoOp`` is
ported: each is the optax 0.2.6 transform the JAX package builds
(``optax.sgd``, ``optax.adam``, ``optax.sgd(nesterov=True)``,
``optax.rmsprop``, ``optax.set_to_zero``), with the same
state, the same float operations in the same order, and the same state leaf
order in ``updaterState.npz``. A layer's update runs as ``torch._foreach_*``
ops over all its leaves, a few launches per layer instead of a few per leaf.
The other updaters, learning-rate
schedules (kept as their JSON dict), gradient normalization, weight decay
and l1/l2 raise ``NotImplementedError`` by name when a network trains with
them.

:class:`NetworkOptimizer` is the counterpart of the JAX network's
``_build_tx``/``_layer_transform`` (``multi_layer_network.py:118-153``): one
transform per layer key, the layer's own updater or the global one
(``Sgd(0.1)`` when none is configured), ``NoOp`` for a frozen layer. A
layer's parameters may nest (``"attn"``, ``"stack"``): they, their
gradients and their moments are walked in :func:`tree_leaves` order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Type

import torch

from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map

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

    def init_state(self, params) -> Any:
        """One layer's part of the optax state for its parameter tree
        ``params``, as a tree whose :func:`tree_leaves` are in the JAX
        package's ``jax.tree.leaves(opt_state)`` order; None when there is
        none."""
        raise NotImplementedError(f"the {type(self).__name__} updater is not ported "
                                  "to deeplearning4j_tpu_torch yet")

    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              state: Any) -> None:
        """One step, in place, on one layer's parameter leaves ``params``
        (``grads`` line up with them leaf by leaf) and its ``state``."""
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

    def init_state(self, params):
        return None

    def apply(self, params, grads, state):
        torch._foreach_add_(params, torch._foreach_mul(grads, -self._lr()))


_INT32_MAX = 2 ** 31 - 1


@register_updater
@dataclasses.dataclass
class Adam(Updater):
    """``optax.adam(lr, b1, b2, eps)`` (``scale_by_adam`` with ``eps_root``
    0, then the learning rate), written out because its float order is not
    ``torch.optim.Adam``'s: ``mu = (1 - b1) * g + b1 * mu`` and ``nu = (1 -
    b2) * g^2 + b2 * nu`` in the parameter's dtype; ``count`` (int32) steps
    by one; ``p += -lr * (mu / bc1) / (sqrt(nu / bc2) + eps)`` with the
    bias corrections ``bc = 1 - b^count`` formed in float32, as jnp forms
    them. eps sits OUTSIDE the square root. The state of a layer is
    ``{"count", "mu", "nu"}``, whose sorted leaves are optax's (count, the mu
    leaves, the nu leaves). ``count`` stays on the host, a 0-d int32 CPU
    tensor, so the bias corrections are host scalars and a step reads
    nothing back from the device."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def apply(self, params, grads, state):
        count = min(int(state["count"]) + 1, _INT32_MAX)  # optax safe_increment
        state["count"].fill_(count)
        one = torch.ones((), dtype=torch.float32)
        bc1 = float(one - torch.tensor(self.beta1, dtype=torch.float32) ** count)
        bc2 = float(one - torch.tensor(self.beta2, dtype=torch.float32) ** count)
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        term = torch._foreach_mul(grads, 1.0 - self.beta1)
        torch._foreach_mul_(mu, self.beta1)
        torch._foreach_add_(mu, term)
        term = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(term, 1.0 - self.beta2)
        torch._foreach_mul_(nu, self.beta2)
        torch._foreach_add_(nu, term)
        update = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, -self._lr())
        torch._foreach_add_(params, update)


@register_updater
@dataclasses.dataclass
class AdaMax(Adam):
    init_state = Updater.init_state  # the math is not ported: raises by name
    apply = Updater.apply


@register_updater
@dataclasses.dataclass
class AMSGrad(Adam):
    init_state = Updater.init_state  # the math is not ported: raises by name
    apply = Updater.apply


@register_updater
@dataclasses.dataclass
class Nadam(Adam):
    init_state = Updater.init_state  # the math is not ported: raises by name
    apply = Updater.apply


@register_updater
@dataclasses.dataclass
class Nesterovs(Updater):
    """``optax.sgd(lr, momentum, nesterov=True)`` (``trace`` then the
    learning rate): ``trace = g + momentum * trace``, then ``p += -lr * (g +
    momentum * trace)`` with the new trace, in the parameter's dtype. The
    state of a layer is its ``trace``, nested as its parameters, so its
    leaves are optax's ``TraceState`` leaves in sorted parameter order."""

    learning_rate: Any = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return tree_map(torch.zeros_like, params)

    def apply(self, params, grads, state):
        trace = tree_leaves(state)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        update = torch._foreach_mul(trace, self.momentum)
        torch._foreach_add_(update, grads)
        torch._foreach_mul_(update, -self._lr())
        torch._foreach_add_(params, update)


@register_updater
@dataclasses.dataclass
class RmsProp(Updater):
    """``optax.rmsprop(lr, decay, eps)`` (``scale_by_rms`` then the learning
    rate): ``nu`` starts at 0, ``nu = (1 - decay) * g^2 + decay * nu``,
    ``p += -lr * (rsqrt(nu + eps) * g)``. eps sits INSIDE the square root,
    unlike ``torch.optim.RMSprop``."""

    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, params):
        return tree_map(torch.zeros_like, params)

    def apply(self, params, grads, state):
        nu = tree_leaves(state)
        term = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(term, 1.0 - self.rms_decay)
        torch._foreach_mul_(nu, self.rms_decay)
        torch._foreach_add_(nu, term)
        update = torch._foreach_add(nu, self.epsilon)
        torch._foreach_rsqrt_(update)
        torch._foreach_mul_(update, grads)
        torch._foreach_mul_(update, -self._lr())
        torch._foreach_add_(params, update)


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

    def init_state(self, params):
        return None

    def apply(self, params, grads, state):
        pass


def _unported(name: str, value) -> None:
    if value:
        raise NotImplementedError(f"{name}={value!r} is not ported to "
                                  "deeplearning4j_tpu_torch yet")


class NetworkOptimizer:
    """The per-layer optimizer of a network: ``transforms`` maps each layer
    key that has parameters to its :class:`Updater`. ``state`` maps the
    stateful layers' keys to their state (``{param: nu}`` for RmsProp,
    ``{param: trace}`` for Nesterovs, ``{"count", "mu", "nu"}`` for Adam,
    each nested as the layer's
    parameters), so :func:`tree_leaves` of it is the JAX package's
    ``jax.tree.leaves(opt_state)`` order (``optax.multi_transform`` keeps
    one inner state per layer label, sorted, each holding that layer's
    leaves in sorted, nested parameter order)."""

    def __init__(self, transforms: Dict[str, Updater], params: Dict[str, Any]):
        self.transforms = transforms
        self.state: Dict[str, Any] = {}
        for k, upd in transforms.items():
            st = upd.init_state(params[k])
            if st is not None:
                self.state[k] = st

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

    def step(self, params: Dict[str, Any], grads: Dict[str, Any]) -> None:
        """Apply one update to ``params`` in place (``optax.apply_updates``:
        the update is added in the parameter's dtype). ``grads`` is nested
        as ``params``."""
        with torch.no_grad():
            for k, upd in self.transforms.items():
                ps = tree_leaves(params[k])
                gs = [g.to(p.dtype) for p, g in zip(ps, tree_leaves(grads[k]), strict=True)]
                upd.apply(ps, gs, self.state.get(k))
