"""SqueezeNet v1.1 (reference ``org.deeplearning4j.zoo.model.SqueezeNet``).

Counterpart of ``deeplearning4j_tpu/zoo/squeezenet.py``, with the same
configuration, defaults and node names.

Fire modules: a 1x1 "squeeze" conv feeding parallel 1x1 and 3x3 "expand"
convs whose outputs concatenate on the channel axis (MergeVertex) — the
reference builds the same DAG as a ComputationGraph.
"""

from deeplearning4j_tpu_torch.nn import (ConvolutionLayer, GlobalPoolingLayer, InputType,
                                         LossLayer, PoolingType, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel

# (squeeze, expand) channel plan for fire2..fire9 (v1.1)
_FIRES = [(16, 64), (16, 64), (32, 128), (32, 128),
          (48, 192), (48, 192), (64, 256), (64, 256)]
# maxpool after these fire indices (0-based into _FIRES), v1.1 placement
_POOL_AFTER = {1, 3}


class SqueezeNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 updater=None):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Nesterovs(1e-3, momentum=0.9)

    def _fire(self, g, name: str, inp: str, squeeze: int, expand: int) -> str:
        g.add_layer(f"{name}_sq", ConvolutionLayer(
            n_out=squeeze, kernel_size=(1, 1), activation="relu"), inp)
        g.add_layer(f"{name}_e1", ConvolutionLayer(
            n_out=expand, kernel_size=(1, 1), activation="relu"), f"{name}_sq")
        g.add_layer(f"{name}_e3", ConvolutionLayer(
            n_out=expand, kernel_size=(3, 3), convolution_mode="same",
            activation="relu"), f"{name}_sq")
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_e1", f"{name}_e3")
        return f"{name}_cat"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input"))
        g.add_layer("conv1", ConvolutionLayer(
            n_out=64, kernel_size=(3, 3), stride=(2, 2), activation="relu"),
            "input")
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2)), "conv1")
        prev = "pool1"
        for i, (sq, ex) in enumerate(_FIRES):
            prev = self._fire(g, f"fire{i + 2}", prev, sq, ex)
            if i in _POOL_AFTER:
                g.add_layer(f"pool{i + 2}", SubsamplingLayer(
                    kernel_size=(3, 3), stride=(2, 2)), prev)
                prev = f"pool{i + 2}"
        g.add_layer("conv10", ConvolutionLayer(
            n_out=self.num_classes, kernel_size=(1, 1), activation="relu"), prev)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                    "conv10")
        g.add_layer("out", LossLayer(activation="softmax", loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(
            self.height, self.width, self.channels))
        return g.build()
