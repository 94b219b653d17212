"""Network configuration builder.

Counterpart of ``deeplearning4j_tpu/nn/config.py`` (reference
``NeuralNetConfiguration`` / ``MultiLayerConfiguration``): the same fluent
builder DSL and the same ``configuration.json`` schema, so one JSON file
builds either package's network. Usage::

    conf = (NeuralNetConfiguration.builder()
            .seed(123)
            .updater(RmsProp(1e-3))
            .list()
            .layer(GravesLSTM(n_out=512, activation="tanh"))
            .layer(RnnOutputLayer(n_out=96, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.recurrent(96))
            .build())

Shape inference and the automatic insertion of input preprocessors happen
at ``build()``, as in the JAX package (``_infer_shapes``,
``_auto_preprocessor``). A layer type that is not ported yet raises an error
that names it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer
from deeplearning4j_tpu_torch.nn.conv_layers import (BatchNormalization, ConvolutionLayer,
                                                     GlobalPoolingLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.core_layers import (ActivationLayer, DenseLayer, DropoutLayer,
                                                     EmbeddingLayer, EmbeddingSequenceLayer)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.preprocessors import (CnnToFeedForwardPreProcessor,
                                                       FeedForwardToCnnPreProcessor,
                                                       InputPreProcessor)
from deeplearning4j_tpu_torch.nn.recurrent_layers import (BaseRecurrentLayer, Bidirectional,
                                                          RnnOutputLayer)
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.runtime.environment import coerce_dtype, dtype_name


_CONV_LAYERS = (ConvolutionLayer, SubsamplingLayer)
_ANY_LAYERS = (BatchNormalization, ActivationLayer, DropoutLayer, GlobalPoolingLayer)


def _expects(layer: Layer) -> Optional[str]:
    """The input kind a layer needs (JAX ``config.py:64-81``, over the
    ported layers); None: it takes any input as it is."""
    if isinstance(layer, _CONV_LAYERS):
        return "convolutional"
    if isinstance(layer, _ANY_LAYERS):
        return None
    if isinstance(layer, (BaseRecurrentLayer, Bidirectional, RnnOutputLayer)):
        return "recurrent"
    if isinstance(layer, (EmbeddingLayer, EmbeddingSequenceLayer)):
        return None  # integer index inputs; no reshape applies
    if isinstance(layer, DenseLayer):
        return "feedforward_or_recurrent"
    return None


def auto_preprocessor(cur: InputType, layer: Layer) -> Optional[InputPreProcessor]:
    """The preprocessor an input of type ``cur`` needs before ``layer``
    (JAX ``MultiLayerConfiguration._auto_preprocessor``): an image into a
    dense layer is flattened, a flattened image into a convolution is
    reshaped. A flat feed-forward input into a convolution has no image
    shape to infer: ``ValueError``."""
    need = _expects(layer)
    if need is None:
        return None
    if need == "convolutional" and cur.kind == "convolutional_flat":
        return FeedForwardToCnnPreProcessor(cur.height, cur.width, cur.channels)
    if need == "feedforward_or_recurrent" and cur.kind in ("convolutional",
                                                           "convolutional3d"):
        return CnnToFeedForwardPreProcessor(cur.height, cur.width, cur.channels)
    if need == "convolutional" and cur.kind == "feedforward":
        raise ValueError(
            "Cannot infer image shape for conv layer from flat feed-forward input; "
            "use InputType.convolutional_flat(h, w, c)")
    return None


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()``."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._g = GlobalConfig()

    def seed(self, s: int) -> "Builder":
        self._g.seed = int(s)
        return self

    def weight_init(self, wi) -> "Builder":
        self._g.weight_init = WeightInit(wi) if not isinstance(wi, WeightInit) else wi
        return self

    def activation(self, a) -> "Builder":
        self._g.activation = a
        return self

    def updater(self, u) -> "Builder":
        self._g.updater = u
        return self

    def l1(self, v: float) -> "Builder":
        self._g.l1 = float(v)
        return self

    def l2(self, v: float) -> "Builder":
        self._g.l2 = float(v)
        return self

    def weight_decay(self, v: float) -> "Builder":
        self._g.weight_decay = float(v)
        return self

    def dropout(self, retain_prob: float) -> "Builder":
        self._g.dropout = float(retain_prob)
        return self

    def bias_init(self, v: float) -> "Builder":
        self._g.bias_init = float(v)
        return self

    def gradient_normalization(self, kind: str, threshold: float = 1.0) -> "Builder":
        self._g.gradient_normalization = kind
        self._g.gradient_normalization_threshold = float(threshold)
        return self

    def optimization_algo(self, algo: str) -> "Builder":
        self._g.optimization_algo = str(algo).upper()
        return self

    def max_num_line_search_iterations(self, n: int) -> "Builder":
        self._g.max_num_line_search_iterations = int(n)
        return self

    def solver_iterations(self, n: int) -> "Builder":
        self._g.solver_iterations = int(n)
        return self

    def dtype(self, dt) -> "Builder":
        self._g.dtype = None if dt is None else coerce_dtype(dt)
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self._g)

    def graph_builder(self):
        from deeplearning4j_tpu_torch.models.computation_graph import GraphBuilder
        return GraphBuilder(self._g)


class ListBuilder:
    def __init__(self, g: GlobalConfig):
        self._g = g
        self._layers: List[Optional[Layer]] = []
        self._input_type: Optional[InputType] = None
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._tbptt_fwd: Optional[int] = None
        self._tbptt_back: Optional[int] = None

    def layer(self, *args) -> "ListBuilder":
        """``layer(l)`` appends; ``layer(i, l)`` sets index i."""
        if len(args) == 1:
            self._layers.append(args[0])
        else:
            i, l = args
            while len(self._layers) <= i:
                self._layers.append(None)
            self._layers[i] = l
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def input_pre_processor(self, index: int, pp: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[int(index)] = pp
        return self

    def tbptt_fwd_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = int(n)
        return self

    def tbptt_back_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = int(n)
        return self

    def build(self) -> "MultiLayerConfiguration":
        layers = [l for l in self._layers if l is not None]
        if not layers:
            raise ValueError("No layers configured")
        conf = MultiLayerConfiguration(
            global_conf=self._g, layers=layers, input_type=self._input_type,
            preprocessors=dict(self._preprocessors),
            tbptt_fwd_length=self._tbptt_fwd, tbptt_back_length=self._tbptt_back)
        conf._infer_shapes()
        return conf


@dataclasses.dataclass
class MultiLayerConfiguration:
    global_conf: GlobalConfig
    layers: List[Layer]
    input_type: Optional[InputType] = None
    preprocessors: Dict[int, InputPreProcessor] = dataclasses.field(default_factory=dict)
    tbptt_fwd_length: Optional[int] = None
    tbptt_back_length: Optional[int] = None
    # computed by _infer_shapes: the input type fed to each layer, after its
    # preprocessor
    layer_input_types: List[Optional[InputType]] = dataclasses.field(default_factory=list)

    def _infer_shapes(self) -> None:
        """Walk the stack once: insert a preprocessor where a layer needs
        one (:func:`auto_preprocessor`) and record each layer's input type
        (JAX ``:211-227``)."""
        self.layer_input_types = []
        cur = self.input_type
        for i, layer in enumerate(self.layers):
            if cur is not None and i not in self.preprocessors:
                pp = auto_preprocessor(cur, layer)
                if pp is not None:
                    self.preprocessors[i] = pp
            if i in self.preprocessors and cur is not None:
                cur = self.preprocessors[i].output_type(cur)
            self.layer_input_types.append(cur)
            if cur is not None:
                cur = layer.output_type(cur)
        self.output_type = cur

    def to_dict(self) -> dict:
        g = {f.name: getattr(self.global_conf, f.name)
             for f in dataclasses.fields(self.global_conf)}
        if g["updater"] is not None and hasattr(g["updater"], "to_dict"):
            g["updater"] = g["updater"].to_dict()
        for k in ("weight_init", "activation"):
            if isinstance(g.get(k), (WeightInit, Activation)):
                g[k] = g[k].value
        if g.get("dtype") is not None:
            g["dtype"] = dtype_name(coerce_dtype(g["dtype"]))
        return {
            "global_conf": g,
            "layers": [l.to_dict() for l in self.layers],
            "input_type": self.input_type.to_dict() if self.input_type else None,
            "preprocessors": {str(k): v.to_dict() for k, v in self.preprocessors.items()},
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        g_d = dict(d["global_conf"])
        if isinstance(g_d.get("updater"), dict):
            from deeplearning4j_tpu_torch.train.updaters import Updater
            g_d["updater"] = Updater.from_dict(g_d["updater"])
        if g_d.get("weight_init"):
            g_d["weight_init"] = WeightInit(g_d["weight_init"])
        if g_d.get("dtype") is not None:
            g_d["dtype"] = coerce_dtype(g_d["dtype"])
        names = {f.name for f in dataclasses.fields(GlobalConfig)}
        conf = MultiLayerConfiguration(
            global_conf=GlobalConfig(**{k: v for k, v in g_d.items() if k in names}),
            layers=[Layer.from_dict(ld) for ld in d["layers"]],
            input_type=InputType.from_dict(d["input_type"]) if d.get("input_type") else None,
            preprocessors={int(k): InputPreProcessor.from_dict(v)
                           for k, v in (d.get("preprocessors") or {}).items()},
            tbptt_fwd_length=d.get("tbptt_fwd_length"),
            tbptt_back_length=d.get("tbptt_back_length"),
        )
        conf._infer_shapes()
        return conf

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))
