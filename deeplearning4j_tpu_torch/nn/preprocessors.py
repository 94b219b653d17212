"""Input preprocessors: shape adapters between layers.

Counterpart of ``deeplearning4j_tpu/nn/preprocessors.py`` (reference
``org.deeplearning4j.nn.conf.preprocessor``): ``CnnToFeedForwardPreProcessor``,
``FeedForwardToCnnPreProcessor``, ``RnnToFeedForwardPreProcessor``,
``FeedForwardToRnnPreProcessor``, ``CnnToRnnPreProcessor`` and
``RnnToCnnPreProcessor``, with the same JSON (``to_dict``/``from_dict``
through a name registry). ``ListBuilder.build()`` inserts them from
``InputType`` mismatches, as in the JAX package.

Each is a reshape of the public layout (NHWC images, (batch, time, size)
sequences), so a flattened image is in (h, w, c) order and a JAX archive's
dense weights line up. A convolution's output is an NHWC view of
channels_last memory, which need not be contiguous: ``reshape`` copies
where a view cannot be taken.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Type

from deeplearning4j_tpu_torch.nn.inputs import InputType

_PREPROC_REGISTRY: Dict[str, Type["InputPreProcessor"]] = {}


def register_preproc(cls):
    _PREPROC_REGISTRY[cls.__name__] = cls
    return cls


@dataclasses.dataclass
class InputPreProcessor:
    def pre_process(self, x, mask=None):
        raise NotImplementedError

    def output_type(self, input_type: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["@type"] = type(self).__name__
        return d

    @staticmethod
    def from_dict(d: dict) -> "InputPreProcessor":
        d = dict(d)
        return _PREPROC_REGISTRY[d.pop("@type")](**d)


@register_preproc
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    """(batch, h, w, c) -> (batch, h * w * c), in (h, w, c) order."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.flat_size())


@register_preproc
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    """(batch, h * w * c) -> (batch, h, w, c); other ranks pass through."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        if x.dim() == 2:
            return x.reshape(x.shape[0], self.height, self.width, self.channels)
        return x

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


@register_preproc
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """(batch, time, size) -> (batch * time, size)."""

    def pre_process(self, x, mask=None):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)


@register_preproc
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """(batch * time, size) -> (batch, time, size) when ``timesteps`` is
    set; other inputs pass through."""

    timesteps: Optional[int] = None

    def pre_process(self, x, mask=None):
        if x.dim() == 2 and self.timesteps:
            return x.reshape(-1, self.timesteps, x.shape[-1])
        return x

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.size, self.timesteps)


@register_preproc
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """(batch, h, w, c) -> (batch, h, w * c): the height is the time axis."""

    def pre_process(self, x, mask=None):
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.width * input_type.channels,
                                   input_type.height)


@register_preproc
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    """(batch, time, h * w * c) -> (batch * time, h, w, c)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        b, t, _ = x.shape
        return x.reshape(b * t, self.height, self.width, self.channels)

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)
