"""Updaters (optimizers), gradient normalization, weight decay and l1/l2.

Counterpart of ``deeplearning4j_tpu/train/updaters.py``: the reference's
``Sgd``, ``Adam``, ``AdaMax``, ``AMSGrad``, ``Nadam``, ``Nesterovs``,
``RmsProp``, ``AdaGrad``, ``AdaDelta`` and ``NoOp`` as serializable
dataclasses with the same defaults and the same ``to_dict``/``from_dict``
schema, so a ``configuration.json`` written by either package parses here.
``learning_rate`` is a float or a :class:`~.schedules.Schedule`.

Each updater is the optax 0.2.6 transform the JAX package builds
(``optax.sgd``, ``adam``, ``adamax``, ``amsgrad``, ``nadam``,
``sgd(nesterov=True)``, ``rmsprop``, ``adagrad``, ``adadelta(1.0)``,
``set_to_zero``), with the same state, the same float operations in the
same order, and the same state leaf order in ``updaterState.npz``. A
layer's update runs as ``torch._foreach_*`` ops over all its leaves, a few
launches per layer instead of a few per leaf. With a schedule, optax scales
by ``scale_by_schedule``, whose int32 ``count`` is one more state leaf
after the updater's own (``AdaDelta`` and ``NoOp`` take no learning rate,
so no leaf).

:class:`NetworkOptimizer` is the counterpart of the JAX network's
``_build_tx``/``_layer_transform`` (``multi_layer_network.py:118-153``): one
chain per layer key, the layer's own updater or the global one (``Sgd(0.1)``
when none is configured), ``NoOp`` alone for a frozen layer. The chain is
the global gradient normalization (:func:`normalize_gradients`; its norms
are the layer's, as optax's sit inside each layer's chain), then the
updater, then the decoupled weight decay (``-lr_t * wd * p`` on the
regularizable leaves, with a ``count`` of its own). A layer's parameters may
nest (``"attn"``, ``"stack"``): they, their gradients and their moments are
walked in :func:`tree_leaves` order. :func:`reg_score` is the l1/l2 penalty
the networks add to their loss (JAX ``_reg_score``).

Where the count lives decides how the count-dependent scalars are formed.
On the CPU it is a host tensor, and the bias corrections and schedule
values are host floats, as before (the CPU tests hold these against optax).
On a CUDA device the count is a 0-d int32 tensor there, as optax keeps it,
and the scalars are 0-d device tensors computed from it: a step reads
nothing back from the card, and a captured CUDA graph of it reads the
count of each replay instead of the one it was captured with. The eager
and the captured steps on the card take this same path, so they compute
alike (a division by a device tensor is a true division; by a host float
PyTorch multiplies by the reciprocal).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

import torch

from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map, tree_paths
from deeplearning4j_tpu_torch.train.schedules import Schedule

_UPDATER_REGISTRY: Dict[str, Type["Updater"]] = {}
_INT32_MAX = 2 ** 31 - 1
_ONE = torch.ones((), dtype=torch.float32)


def register_updater(cls):
    _UPDATER_REGISTRY[cls.__name__] = cls
    return cls


def _zero_count(device=None) -> torch.Tensor:
    """A 0-d int32 step count, on ``device`` (the parameters'): on the CPU
    the bias corrections and schedule values are host scalars; on a CUDA
    device they are formed there (module docstring)."""
    return torch.zeros((), dtype=torch.int32, device=device)


def _device_of(params) -> Optional[torch.device]:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves and isinstance(leaves[0], torch.Tensor) else None


def _increment(count: torch.Tensor):
    """optax ``safe_increment`` of a count, in place; returns the new value:
    a Python int for a host count, the count tensor itself on a device."""
    if count.is_cuda:
        count.copy_(torch.where(count < _INT32_MAX, count + 1, count))
        return count
    n = min(int(count) + 1, _INT32_MAX)
    count.fill_(n)
    return n


def _next(count):
    """``count + 1`` saturated at int32's maximum (Nadam's look-ahead)."""
    if isinstance(count, torch.Tensor):
        return torch.where(count < _INT32_MAX, count + 1, count)
    return min(count + 1, _INT32_MAX)


def _bias_correction(decay: float, count):
    """``1 - decay ** count`` in float32, as jnp forms it: a host float for a
    host count, a 0-d float32 tensor on the count's device otherwise."""
    if isinstance(count, torch.Tensor):
        base = torch.full((), decay, dtype=torch.float32, device=count.device)
        return 1.0 - torch.pow(base, count)
    return float(_ONE - torch.tensor(decay, dtype=torch.float32) ** count)


def _scalar(v):
    """A schedule's value as the step uses it: a host float from a host
    tensor, the 0-d device tensor as it is."""
    return v if v.is_cuda else float(v)


def _moment(moments, term, decay: float) -> None:
    """``moments = (1 - decay) * term + decay * moments``, in place
    (``term`` is consumed)."""
    torch._foreach_mul_(term, 1.0 - decay)
    torch._foreach_mul_(moments, decay)
    torch._foreach_add_(moments, term)


def _square(xs) -> List[torch.Tensor]:
    return torch._foreach_mul(xs, xs)


@dataclasses.dataclass
class Updater:
    learning_rate: Any = 1e-3  # float or Schedule

    #: whether optax scales this updater's direction by the learning rate
    #: (``AdaDelta`` scales by 1.0 and ``NoOp`` not at all)
    _takes_lr = True

    def _lr(self):
        """The learning rate: a float, or the Schedule (as the JAX package
        hands it to optax and to the weight decay)."""
        if isinstance(self.learning_rate, Schedule):
            return self.learning_rate
        return float(self.learning_rate)

    def _scheduled(self) -> bool:
        return self._takes_lr and isinstance(self.learning_rate, Schedule)

    def init_state(self, params) -> Any:
        """One layer's part of the optax state for its parameter tree
        ``params``, as a tree whose :func:`tree_leaves` are in the JAX
        package's ``jax.tree.leaves(opt_state)`` order; None when there is
        none."""
        inner = self._init(params)
        return (inner, _zero_count(_device_of(params))) if self._scheduled() else inner

    def update(self, grads: List[torch.Tensor], state: Any,
               params: List[torch.Tensor]) -> List[torch.Tensor]:
        """The updates of one step for one layer's leaves (``grads`` line
        up with ``params`` leaf by leaf, and are consumed), with ``state``
        advanced in place."""
        if self._scheduled():
            state, count = state
            neg_lr = -_scalar(self.learning_rate(count))
            _increment(count)
        else:
            neg_lr = -self._lr()
        updates = self._direction(grads, state, params)
        if self._takes_lr:
            torch._foreach_mul_(updates, neg_lr)
        return updates

    def _init(self, params) -> Any:
        return None

    def _direction(self, grads, state, params) -> List[torch.Tensor]:
        """The ``scale_by_*`` part of the transform: the update before the
        learning rate, in tensors the caller may change in place."""
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = v.to_dict() if isinstance(v, Schedule) else v
        return d

    @staticmethod
    def from_dict(d: dict) -> "Updater":
        d = dict(d)
        name = d.pop("@type")
        if name not in _UPDATER_REGISTRY:
            raise KeyError(f"Unknown updater {name!r}; known: {sorted(_UPDATER_REGISTRY)}")
        if isinstance(d.get("learning_rate"), dict):
            d["learning_rate"] = Schedule.from_dict(d["learning_rate"])
        return _UPDATER_REGISTRY[name](**d)


@register_updater
@dataclasses.dataclass
class Sgd(Updater):
    """``optax.sgd(lr)``: ``p += -lr * g``; no state."""

    def _direction(self, grads, state, params):
        return list(grads)


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
    leaves, the nu leaves)."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def _init(self, params):
        return {"count": _zero_count(_device_of(params)),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def _moments(self, grads, state):
        """Both moments updated in place; returns them and the new count."""
        count = _increment(state["count"])
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        torch._foreach_mul_(mu, self.beta1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.beta1))
        _moment(nu, _square(grads), self.beta2)
        return mu, nu, count

    def _direction(self, grads, state, params):
        mu, nu, count = self._moments(grads, state)
        updates = torch._foreach_div(mu, _bias_correction(self.beta1, count))
        denom = torch._foreach_div(nu, _bias_correction(self.beta2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(updates, denom)
        return updates


@register_updater
@dataclasses.dataclass
class AdaMax(Adam):
    """``optax.adamax(lr, b1, b2, eps)``: ``mu`` as Adam's, the infinity
    moment ``nu = max(|g| + eps, b2 * nu)``, ``p += -lr * (mu / bc1) /
    nu``. State ``{"count", "mu", "nu"}``."""

    def _direction(self, grads, state, params):
        count = _increment(state["count"])
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        torch._foreach_mul_(mu, self.beta1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.beta1))
        peak = torch._foreach_abs(grads)
        torch._foreach_add_(peak, self.epsilon)
        torch._foreach_mul_(nu, self.beta2)
        torch._foreach_maximum_(nu, peak)
        updates = torch._foreach_div(mu, _bias_correction(self.beta1, count))
        torch._foreach_div_(updates, nu)
        return updates


@register_updater
@dataclasses.dataclass
class AMSGrad(Adam):
    """``optax.amsgrad(lr, b1, b2, eps)``: Adam's moments, ``nu_max =
    max(nu_max, nu / bc2)``, ``p += -lr * (mu / bc1) / (sqrt(nu_max) +
    eps)``. State ``{"count", "mu", "nu", "nu_max"}`` (optax's field
    order)."""

    def _init(self, params):
        return {**super()._init(params), "nu_max": tree_map(torch.zeros_like, params)}

    def _direction(self, grads, state, params):
        mu, nu, count = self._moments(grads, state)
        nu_max = tree_leaves(state["nu_max"])
        torch._foreach_maximum_(nu_max, torch._foreach_div(
            nu, _bias_correction(self.beta2, count)))
        updates = torch._foreach_div(mu, _bias_correction(self.beta1, count))
        denom = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(updates, denom)
        return updates


@register_updater
@dataclasses.dataclass
class Nadam(Adam):
    """``optax.nadam(lr, b1, b2, eps)`` (``scale_by_adam(nesterov=True)``):
    Adam's moments, then ``mu_hat = b1 * mu / (1 - b1^(count + 1)) + (1 -
    b1) * g / (1 - b1^count)`` with the incremented count, ``p += -lr *
    mu_hat / (sqrt(nu / bc2) + eps)``. State ``{"count", "mu", "nu"}``."""

    def _direction(self, grads, state, params):
        mu, nu, count = self._moments(grads, state)
        updates = torch._foreach_div(
            mu, _bias_correction(self.beta1, _next(count)))
        torch._foreach_mul_(updates, self.beta1)
        now = torch._foreach_div(grads, _bias_correction(self.beta1, count))
        torch._foreach_mul_(now, 1.0 - self.beta1)
        torch._foreach_add_(updates, now)
        denom = torch._foreach_div(nu, _bias_correction(self.beta2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        torch._foreach_div_(updates, denom)
        return updates


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

    def _init(self, params):
        return tree_map(torch.zeros_like, params)

    def _direction(self, grads, state, params):
        trace = tree_leaves(state)
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        updates = torch._foreach_mul(trace, self.momentum)
        torch._foreach_add_(updates, grads)
        return updates


@register_updater
@dataclasses.dataclass
class RmsProp(Updater):
    """``optax.rmsprop(lr, decay, eps)`` (``scale_by_rms`` then the learning
    rate): ``nu`` starts at 0, ``nu = (1 - decay) * g^2 + decay * nu``,
    ``p += -lr * (rsqrt(nu + eps) * g)``. eps sits INSIDE the square root,
    unlike ``torch.optim.RMSprop``."""

    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def _init(self, params):
        return tree_map(torch.zeros_like, params)

    def _direction(self, grads, state, params):
        nu = tree_leaves(state)
        _moment(nu, _square(grads), self.rms_decay)
        updates = torch._foreach_add(nu, self.epsilon)
        torch._foreach_rsqrt_(updates)
        torch._foreach_mul_(updates, grads)
        return updates


@register_updater
@dataclasses.dataclass
class AdaGrad(Updater):
    """``optax.adagrad(lr, eps=epsilon)`` (``scale_by_rss`` then the
    learning rate): the sum of squares starts at 0.1 (optax's
    ``initial_accumulator_value``), ``s = g^2 + s``, ``p += -lr * (where(s >
    0, rsqrt(s + eps), 0) * g)``. The state of a layer is ``s``, nested as
    its parameters."""

    epsilon: float = 1e-6

    def _init(self, params):
        return tree_map(lambda p: torch.full_like(p, 0.1), params)

    def _direction(self, grads, state, params):
        sums = tree_leaves(state)
        torch._foreach_add_(sums, _square(grads))
        inv = torch._foreach_add(sums, self.epsilon)
        torch._foreach_rsqrt_(inv)
        updates = [torch.where(s > 0, r, 0.0) for s, r in zip(sums, inv)]
        torch._foreach_mul_(updates, grads)
        return updates


@register_updater
@dataclasses.dataclass
class AdaDelta(Updater):
    """``optax.adadelta(1.0, rho, eps)``: the reference's AdaDelta has no
    learning rate, so the configured one is not used (only by the weight
    decay). ``g = g + 0 * p`` (optax's zero weight decay), ``e_g = (1 - rho)
    * g^2 + rho * e_g``, ``u = sqrt(e_x + eps) / sqrt(e_g + eps) * g``,
    ``e_x = (1 - rho) * u^2 + rho * e_x``, ``p += -u``. State ``{"e_g",
    "e_x"}``."""

    rho: float = 0.95
    epsilon: float = 1e-6
    _takes_lr = False

    def _init(self, params):
        return {"e_g": tree_map(torch.zeros_like, params),
                "e_x": tree_map(torch.zeros_like, params)}

    def _direction(self, grads, state, params):
        e_g, e_x = tree_leaves(state["e_g"]), tree_leaves(state["e_x"])
        g = torch._foreach_add(grads, torch._foreach_mul(params, 0.0))
        _moment(e_g, _square(g), self.rho)
        updates = torch._foreach_add(e_x, self.epsilon)
        torch._foreach_sqrt_(updates)
        denom = torch._foreach_add(e_g, self.epsilon)
        torch._foreach_sqrt_(denom)
        torch._foreach_div_(updates, denom)
        torch._foreach_mul_(updates, g)
        _moment(e_x, _square(updates), self.rho)
        torch._foreach_neg_(updates)
        return updates


@register_updater
@dataclasses.dataclass
class NoOp(Updater):
    """``optax.set_to_zero()``: zero updates, no state."""

    _takes_lr = False

    def _direction(self, grads, state, params):
        return [torch.zeros_like(g) for g in grads]


# ---- gradient normalization (reference GradientNormalization) ----

_CLIP_ELEMENTWISE = ("clipelementwiseabsolutevalue", "clip_element_wise_absolute_value")
_CLIP_L2 = ("clipl2perlayer", "clip_l2_per_layer", "clipl2perparamtype",
            "clip_l2_per_param_type")
_RENORM_L2 = ("renormalizel2perlayer", "renormalize_l2_per_layer",
              "renormalizel2perparamtype", "renormalize_l2_per_param_type")
_CLIP_GLOBAL = ("clipglobalnorm", "clip_global_norm")


def _l2(g: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((g * g).sum())


def normalize_gradients(kind: str, threshold: float,
                        grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """One layer's gradients under the reference's gradient normalization,
    as the JAX package's optax transform computes it (``updaters.py:173-
    205``): an elementwise clip; per leaf (a leaf is a parameter type) an L2
    clip to ``threshold`` or a renormalization to unit L2; or a clip of the
    layer's gradients by their joint L2 norm (``optax.clip_by_global_norm``
    inside the layer's chain)."""
    k = kind.lower()
    if k in _CLIP_ELEMENTWISE:
        return [torch.clamp(g, -threshold, threshold) for g in grads]
    if k in _CLIP_L2:
        return [g * torch.clamp(torch.full_like(n, threshold) / (n + 1e-12), max=1.0)
                for g, n in ((g, _l2(g)) for g in grads)]
    if k in _RENORM_L2:
        return [g / (_l2(g) + 1e-12) for g in grads]
    if k in _CLIP_GLOBAL:
        total = None
        for g in grads:
            s = (g * g).sum()
            total = s if total is None else total + s
        norm = torch.sqrt(total)
        return [torch.where(norm < threshold, g, (g / norm) * threshold) for g in grads]
    raise ValueError(f"Unknown gradient normalization {kind!r}")


# ---- regularization ----

def regularizable_mask(layer, params) -> List[bool]:
    """Per leaf of ``params`` (:func:`tree_leaves` order): whether a key on
    its path is one of the layer's regularizable parameter names (JAX
    ``_mask_keys``: weights, not biases or normalization scales)."""
    keys = set(layer.regularizable_params())
    return [any(k in keys for k in path) for path in tree_paths(params)]


def reg_score(named_layers, params, g) -> Optional[torch.Tensor]:
    """The l1/l2 penalty over the regularizable parameters (JAX
    ``_reg_score``): ``l1 * sum|w| + 0.5 * l2 * sum(w^2)`` per leaf, layer
    by layer, leaves in sorted order, summed in float32 from zero. None when
    no layer has l1 or l2. ``named_layers`` are ``(key, layer)`` pairs."""
    total = None
    for k, layer in named_layers:
        if k not in params:
            continue
        l1 = layer.l1 if layer.l1 is not None else g.l1
        l2 = layer.l2 if layer.l2 is not None else g.l2
        if not l1 and not l2:
            continue
        for w, use in zip(tree_leaves(params[k]), regularizable_mask(layer, params[k])):
            if not use:
                continue
            if total is None:
                total = torch.zeros((), dtype=torch.float32, device=w.device)
            if l1:
                total = total + l1 * w.abs().sum()
            if l2:
                total = total + (0.5 * l2) * (w * w).sum()
    return total


@dataclasses.dataclass
class WeightDecay:
    """Decoupled (AdamW-style) weight decay after the updater (JAX
    ``decoupled_weight_decay``): ``u - lr_t * wd * p`` on the leaves of
    ``mask``, with ``lr_t`` the updater's learning rate (a schedule's value
    at this decay's own ``count``)."""

    wd: float
    lr: Any  # float or Schedule
    mask: List[bool]

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        return {"count": _zero_count(device)}

    def apply(self, updates, params, state) -> None:
        count = state["count"]
        if isinstance(self.lr, Schedule):
            scale = _scalar(self.lr(count) * self.wd)
        else:
            scale = self.lr * self.wd
        count.add_(1)
        idx = [i for i, use in enumerate(self.mask) if use]
        if idx:
            torch._foreach_sub_([updates[i] for i in idx],
                                torch._foreach_mul([params[i] for i in idx], scale))


class NetworkOptimizer:
    """The per-layer optimizer of a network: ``transforms`` maps each layer
    key that has parameters to its :class:`Updater`; ``normalization``
    maps a key to its gradient normalization ``(kind, threshold)``;
    ``decay`` maps a key to its :class:`WeightDecay`. ``state`` maps the
    stateful layers' keys to their state: the updater's (``{param: nu}``
    for RmsProp, ``{"count", "mu", "nu"}`` for Adam, ...; with a schedule,
    ``(that, count)``), and with weight decay ``(that, {"count"})``, so
    :func:`tree_leaves` of it is the JAX package's
    ``jax.tree.leaves(opt_state)`` order (``optax.multi_transform`` keeps
    one inner state per layer label, sorted, each the states of its chain
    in order)."""

    def __init__(self, transforms: Dict[str, Updater], params: Dict[str, Any],
                 normalization: Optional[Dict[str, Tuple[str, float]]] = None,
                 decay: Optional[Dict[str, WeightDecay]] = None):
        self.transforms = transforms
        self.normalization = normalization or {}
        self.decay = decay or {}
        self.state: Dict[str, Any] = {}
        for k, upd in transforms.items():
            st = upd.init_state(params[k])
            if k in self.decay:
                st = (st, self.decay[k].init_state(_device_of(params[k])))
            if st is not None:
                self.state[k] = st

    @staticmethod
    def for_network(layers, layer_keys: List[str], global_conf, params) -> "NetworkOptimizer":
        """The chains as ``_layer_transform`` builds them. Constraints and
        weight noise are not part of the chain: the networks apply them
        around the step (:mod:`~..nn.constraints`)."""
        g = global_conf
        default = g.updater if g.updater is not None else Sgd(0.1)
        transforms: Dict[str, Updater] = {}
        normalization: Dict[str, Tuple[str, float]] = {}
        decay: Dict[str, WeightDecay] = {}
        for k, layer in zip(layer_keys, layers):
            if k not in params:
                continue
            if layer.frozen:
                transforms[k] = NoOp()
                continue
            upd = layer.updater or default
            transforms[k] = upd
            if g.gradient_normalization:
                normalization[k] = (g.gradient_normalization,
                                    float(g.gradient_normalization_threshold))
            wd = layer.weight_decay if layer.weight_decay is not None else g.weight_decay
            if wd:
                decay[k] = WeightDecay(float(wd), upd._lr(),
                                       regularizable_mask(layer, params[k]))
        return NetworkOptimizer(transforms, params, normalization, decay)

    def step(self, params: Dict[str, Any], grads: Dict[str, Any]) -> None:
        """Apply one update to ``params`` in place (``optax.apply_updates``:
        the update is added in the parameter's dtype). ``grads`` is nested
        as ``params`` and is consumed."""
        with torch.no_grad():
            for k, upd in self.transforms.items():
                ps = tree_leaves(params[k])
                gs = [g.to(p.dtype) for p, g in zip(ps, tree_leaves(grads[k]), strict=True)]
                st = self.state.get(k)
                if k in self.decay:
                    st, decay_state = st
                if k in self.normalization:
                    gs = normalize_gradients(*self.normalization[k], gs)
                updates = upd.update(gs, st, ps)
                if k in self.decay:
                    self.decay[k].apply(updates, ps, decay_state)
                torch._foreach_add_(ps, updates)
