"""Input type system for shape inference.

Counterpart of ``deeplearning4j_tpu/nn/inputs.py`` (reference
``org.deeplearning4j.nn.conf.inputs.InputType``): each layer declares its
output type given an input type, so the network infers every parameter
shape from ``set_input_type(...)`` at build time.

Layouts are the JAX package's, kept so configs and archives are shared:
feed-forward ``(batch, size)``, recurrent ``(batch, time, size)``,
convolutional ``(batch, height, width, channels)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str  # "feedforward" | "recurrent" | "convolutional" | "convolutional3d"
    size: Optional[int] = None  # feedforward / recurrent feature size
    timesteps: Optional[int] = None  # recurrent (None = dynamic)
    height: Optional[int] = None
    width: Optional[int] = None
    channels: Optional[int] = None
    depth: Optional[int] = None  # 3d conv

    # -- factories (names mirror the reference API) --
    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="feedforward", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="recurrent", size=int(size),
                         timesteps=None if timesteps is None else int(timesteps))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        """Flattened image input (e.g. MNIST csv rows) — a FeedForwardToCnn
        preprocessor will be auto-inserted before the first conv layer."""
        it = InputType.convolutional(height, width, channels)
        return dataclasses.replace(it, kind="convolutional_flat")

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional3d", depth=int(depth), height=int(height),
                         width=int(width), channels=int(channels))

    # -- helpers --
    def flat_size(self) -> int:
        if self.kind == "feedforward" or self.kind == "recurrent":
            return int(self.size)
        if self.kind in ("convolutional", "convolutional_flat"):
            return int(self.height * self.width * self.channels)
        if self.kind == "convolutional3d":
            return int(self.depth * self.height * self.width * self.channels)
        raise ValueError(self.kind)

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)
