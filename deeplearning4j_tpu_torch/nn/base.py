"""Layer base class and serde registry.

Counterpart of ``deeplearning4j_tpu/nn/base.py``. A layer is one dataclass
that is both the serializable config (``to_dict``/``from_dict`` through a
name registry, in the JAX package's JSON schema) and the implementation
(``init``/``forward`` on plain dicts of tensors).

Forward contract, as in the JAX package::

    y, new_state = layer.forward(params, state, x, training=..., generator=..., mask=...)

- ``params``: dict of tensors ("W", "b", ...); ``state``: dict of
  non-trainable tensors;
- ``generator``: ``torch.Generator`` for stochastic layers in training;
- ``mask``: optional (batch, time) validity mask for sequence data.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Type

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.ops.losses import LossFunction

_ENUMS = (Activation, WeightInit, LossFunction)

_LAYER_REGISTRY: Dict[str, Type["Layer"]] = {}


def register_layer(cls: Type["Layer"]) -> Type["Layer"]:
    """Class decorator: registers the layer under its class name for serde."""
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def get_layer_class(name: str) -> Type["Layer"]:
    if name not in _LAYER_REGISTRY:
        raise KeyError(
            f"Layer type {name!r} is not ported to deeplearning4j_tpu_torch yet; "
            f"ported: {sorted(_LAYER_REGISTRY)}")
    return _LAYER_REGISTRY[name]


def cast_floating(tree, dtype: torch.dtype):
    """Cast the floating-point tensors of a nested dict/list/tuple to
    ``dtype`` (the mixed-precision policy: parameters stay
    ``default_dtype`` and are cast to ``compute_dtype`` right before use)."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point() and tree.dtype != dtype:
        return tree.to(dtype)
    return tree


def keep_mask(x: torch.Tensor, keep: float, generator: torch.Generator) -> torch.Tensor:
    """Boolean dropout mask of ``x``'s shape, true with probability
    ``keep``, drawn on ``x``'s device from a generator there, seeded by one
    draw from ``generator``, the step's CPU generator
    (``RngManager.next_generator``): a step does no per-element host work
    and copies no mask to the device. The masks differ from the JAX
    package's stream (and between CPU and device), as every draw of the two
    packages does. A generator already on ``x``'s CUDA device (a fit's
    stream, :func:`~..runtime.rng.device_generator`) is drawn from
    directly."""
    from deeplearning4j_tpu_torch.runtime.rng import device_generator
    device_gen = device_generator(generator, x.device)
    return torch.rand(x.shape, generator=device_gen, device=x.device) < keep


@dataclasses.dataclass
class GlobalConfig:
    """Network-wide defaults that layers inherit when their own field is
    None; the same fields as the JAX package's, so one
    ``configuration.json`` builds either network."""

    seed: int = 0
    weight_init: WeightInit = WeightInit.XAVIER
    activation: Any = Activation.IDENTITY
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    dropout: Optional[float] = None  # retain probability, DL4J convention
    bias_init: float = 0.0
    updater: Any = None  # train.updaters.Updater
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    dtype: Any = None  # resolved against the runtime Environment
    optimization_algo: str = "STOCHASTIC_GRADIENT_DESCENT"
    max_num_line_search_iterations: int = 5
    solver_iterations: int = 10


@dataclasses.dataclass
class Layer:
    """Base layer config. Fields that default to ``None`` inherit from
    :class:`GlobalConfig`. ``constraints``/``bias_constraints`` (lists of
    :class:`~.constraints.Constraint`) project the parameters after each
    update, and ``weight_noise`` (:class:`~.constraints.DropConnect` or
    :class:`~.constraints.WeightNoise`) perturbs the weights a training
    forward sees."""

    name: Optional[str] = None
    activation: Any = None
    weight_init: Any = None
    bias_init: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    weight_decay: Optional[float] = None
    dropout: Optional[float] = None  # retain probability applied to layer INPUT
    updater: Any = None
    frozen: bool = False
    constraints: Any = None
    bias_constraints: Any = None
    weight_noise: Any = None
    # GlobalConfig attached by the network at build time (not serialized)
    _g: Any = dataclasses.field(default=None, repr=False, compare=False)
    # whether init returns a state (not a field: a property of the layer type)
    has_state = False

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init(self, generator: torch.Generator, input_type: InputType, g: GlobalConfig
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Return (params, state) on the CPU. Default: parameterless layer."""
        return {}, {}

    def forward(self, params: Dict, state: Dict, x, *, training: bool = False,
                generator: Optional[torch.Generator] = None, mask=None) -> Tuple[Any, Dict]:
        raise NotImplementedError

    def regularizable_params(self) -> Tuple[str, ...]:
        """Param keys subject to l1/l2 and weight decay (weights, not
        biases), matched against every key on a parameter's path."""
        return ("W", "W_rec", "W_point", "W_depth", "W_q", "W_k", "W_v", "W_o")

    def _act(self, g: GlobalConfig):
        return self.activation if self.activation is not None else g.activation

    def _winit(self, g: GlobalConfig):
        return self.weight_init if self.weight_init is not None else g.weight_init

    def _binit(self, g: GlobalConfig) -> float:
        return self.bias_init if self.bias_init is not None else g.bias_init

    def _dropout(self, g: GlobalConfig):
        return self.dropout if self.dropout is not None else g.dropout

    def _apply_input_dropout(self, x, g: GlobalConfig, training: bool, generator):
        """DL4J semantics: ``dropOut(p)`` on a layer drops the layer's INPUT
        with retain probability p, inverted scaling."""
        p = self._dropout(g)
        if not training or p is None or p >= 1.0 or generator is None:
            return x
        return torch.where(keep_mask(x, p, generator), x / p, torch.zeros_like(x))

    def to_dict(self) -> dict:
        d = {"@type": type(self).__name__}
        for f in dataclasses.fields(self):
            if f.name.startswith("_"):
                continue
            v = getattr(self, f.name)
            if v is None or v == f.default:
                continue
            if isinstance(v, _ENUMS):
                v = v.value
            elif hasattr(v, "to_dict"):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)) and v and hasattr(v[0], "to_dict"):
                v = [e.to_dict() for e in v]
            d[f.name] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Layer":
        d = dict(d)
        target = get_layer_class(d.pop("@type", cls.__name__))
        field_names = {f.name for f in dataclasses.fields(target)}
        kwargs = {}
        for k, v in d.items():
            if k not in field_names:
                continue
            if k == "updater" and isinstance(v, dict):
                from deeplearning4j_tpu_torch.train.updaters import Updater
                v = Updater.from_dict(v)
            elif k in ("constraints", "bias_constraints") and v is not None:
                from deeplearning4j_tpu_torch.nn.constraints import constraints_from_config
                v = constraints_from_config(v)
            elif k == "weight_noise":
                from deeplearning4j_tpu_torch.nn.constraints import weight_noise_from_config
                v = weight_noise_from_config(v)
            kwargs[k] = v
        return target(**kwargs)

