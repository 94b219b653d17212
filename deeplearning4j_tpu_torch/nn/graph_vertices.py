"""Graph vertices for ComputationGraph.

Counterpart of ``deeplearning4j_tpu/nn/graph_vertices.py`` (reference
``org.deeplearning4j.nn.conf.graph.*``): ``MergeVertex``,
``ElementWiseVertex`` (add / product / subtract / average / max / min /
dot), ``SubsetVertex``, ``StackVertex``/``UnstackVertex``,
``ScaleVertex``/``ShiftVertex``, ``L2NormalizeVertex``, ``ReshapeVertex``,
``PreprocessorVertex`` (an input preprocessor as a vertex), with the same
JSON (``to_dict``/``from_dict`` through a name registry). Pure functions of
their inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Type

import torch

from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.preprocessors import InputPreProcessor

_VERTEX_REGISTRY: Dict[str, Type["GraphVertex"]] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class GraphVertex:
    def forward(self, *inputs):
        raise NotImplementedError

    def output_type(self, *input_types: InputType) -> InputType:
        return input_types[0]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "GraphVertex":
        d = dict(d)
        name = d.pop("@type")
        if name not in _VERTEX_REGISTRY:
            raise KeyError(f"Graph vertex type {name!r} is not ported to "
                           f"deeplearning4j_tpu_torch yet; ported: {sorted(_VERTEX_REGISTRY)}")
        cls = _VERTEX_REGISTRY[name]
        if cls is PreprocessorVertex and isinstance(d.get("preprocessor"), dict):
            d["preprocessor"] = InputPreProcessor.from_dict(d["preprocessor"])
        return cls(**d)


@register_vertex
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenate along the feature (last) axis."""

    def forward(self, *inputs):
        return torch.cat(inputs, dim=-1)

    def output_type(self, *its: InputType) -> InputType:
        it = its[0]
        if it.kind == "convolutional":
            return InputType.convolutional(it.height, it.width, sum(i.channels for i in its))
        if it.kind == "recurrent":
            return InputType.recurrent(sum(i.size for i in its), it.timesteps)
        return InputType.feed_forward(sum(i.flat_size() for i in its))


@register_vertex
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Pointwise combine: add / product / subtract / average / max / min /
    dot, folded left to right as in JAX ``:70-105``."""

    op: str = "add"

    def forward(self, *inputs):
        op = self.op.lower()
        if op == "add":
            out = inputs[0]
            for x in inputs[1:]:
                out = out + x
            return out
        if op in ("product", "mul"):
            out = inputs[0]
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "subtract":
            return inputs[0] - inputs[1]
        if op in ("average", "avg"):
            out = inputs[0]  # Python's sum(): 0 + x0 + x1 + ...
            for x in inputs[1:]:
                out = out + x
            return out / len(inputs)
        if op == "max":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        if op == "min":
            out = inputs[0]
            for x in inputs[1:]:
                out = torch.minimum(out, x)
            return out
        if op == "dot":
            # Keras Dot(axes=-1, normalize=False) over matching feature axes
            return (inputs[0] * inputs[1]).sum(-1, keepdim=True)
        raise ValueError(f"Unknown elementwise op {self.op!r}")


@register_vertex
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Feature-axis slice [from_idx, to_idx] inclusive (reference semantics)."""

    from_idx: int = 0
    to_idx: int = 0

    def forward(self, *inputs):
        return inputs[0][..., self.from_idx:self.to_idx + 1]

    def output_type(self, *its: InputType) -> InputType:
        n = self.to_idx - self.from_idx + 1
        it = its[0]
        if it.kind == "recurrent":
            return InputType.recurrent(n, it.timesteps)
        return InputType.feed_forward(n)


@register_vertex
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """Stack along the batch axis (reference ``StackVertex``)."""

    def forward(self, *inputs):
        return torch.cat(inputs, dim=0)


@register_vertex
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Take the i-th of n equal batch-axis chunks."""

    from_idx: int = 0
    stack_size: int = 1

    def forward(self, *inputs):
        x = inputs[0]
        n = x.shape[0] // self.stack_size
        return x[self.from_idx * n:(self.from_idx + 1) * n]


@register_vertex
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def forward(self, *inputs):
        return inputs[0] * self.scale


@register_vertex
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def forward(self, *inputs):
        return inputs[0] + self.shift


@register_vertex
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    eps: float = 1e-8

    def forward(self, *inputs):
        x = inputs[0]
        return x / (torch.sqrt((x * x).sum(-1, keepdim=True)) + self.eps)


@register_vertex
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """An input preprocessor (:mod:`~.preprocessors`) as a vertex."""

    preprocessor: InputPreProcessor = None

    def forward(self, *inputs):
        return self.preprocessor.pre_process(inputs[0])

    def output_type(self, *its: InputType) -> InputType:
        return self.preprocessor.output_type(its[0])

    def to_dict(self) -> dict:
        return {"@type": "PreprocessorVertex", "preprocessor": self.preprocessor.to_dict()}


@register_vertex
@dataclasses.dataclass
class ReshapeVertex(GraphVertex):
    shape: Tuple[int, ...] = ()

    def forward(self, *inputs):
        return inputs[0].reshape((inputs[0].shape[0],) + tuple(self.shape))
