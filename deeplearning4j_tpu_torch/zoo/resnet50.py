"""ResNet-50 (reference ``org.deeplearning4j.zoo.model.ResNet50``).

Counterpart of ``deeplearning4j_tpu/zoo/resnet50.py``, with the same node
names, so a JAX archive loads here: a ``ComputationGraph`` with a 7x7/2 stem
and a 3x3/2 max pool, then stages [3, 4, 6, 3] of bottleneck blocks of
widths (64, 64, 256) (128, 128, 512) (256, 256, 1024) (512, 512, 2048),
batch normalization after every convolution, global average pooling and a
softmax head. Each block's ``_c1``/``_b1``, ``_c3``/``_b3`` and (first
block of a stage) ``_sc``/``_sb`` is a plain 1x1 convolution feeding only
its normalization: the 36 pairs that train through the ``conv_stats``
kernel.
"""

from deeplearning4j_tpu_torch.nn import (ActivationLayer, BatchNormalization,
                                         ConvolutionLayer, GlobalPoolingLayer, InputType,
                                         OutputLayer, PoolingType, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel

_STAGES = [(3, 64, 256), (4, 128, 512), (6, 256, 1024), (3, 512, 2048)]


class ResNet50(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 updater=None):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Nesterovs(1e-1, momentum=0.9)

    def _bottleneck(self, g, name: str, inp: str, mid: int, out: int,
                    stride: int, project: bool) -> str:
        """One bottleneck block: 1x1(mid)/s -> 3x3(mid) -> 1x1(out), the
        shortcut (a projecting 1x1/s where the shape changes), add, relu."""
        s = (stride, stride)
        g.add_layer(f"{name}_c1", ConvolutionLayer(
            n_out=mid, kernel_size=(1, 1), stride=s, activation="identity",
            has_bias=False), inp)
        g.add_layer(f"{name}_b1", BatchNormalization(activation="relu"), f"{name}_c1")
        g.add_layer(f"{name}_c2", ConvolutionLayer(
            n_out=mid, kernel_size=(3, 3), convolution_mode="same",
            activation="identity", has_bias=False), f"{name}_b1")
        g.add_layer(f"{name}_b2", BatchNormalization(activation="relu"), f"{name}_c2")
        g.add_layer(f"{name}_c3", ConvolutionLayer(
            n_out=out, kernel_size=(1, 1), activation="identity", has_bias=False),
            f"{name}_b2")
        g.add_layer(f"{name}_b3", BatchNormalization(), f"{name}_c3")
        shortcut = inp
        if project:
            g.add_layer(f"{name}_sc", ConvolutionLayer(
                n_out=out, kernel_size=(1, 1), stride=s, activation="identity",
                has_bias=False), inp)
            g.add_layer(f"{name}_sb", BatchNormalization(), f"{name}_sc")
            shortcut = f"{name}_sb"
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), f"{name}_b3", shortcut)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
        return f"{name}_out"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater)
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input"))
        g.add_layer("stem_conv", ConvolutionLayer(
            n_out=64, kernel_size=(7, 7), stride=(2, 2), convolution_mode="same",
            activation="identity", has_bias=False), "input")
        g.add_layer("stem_bn", BatchNormalization(activation="relu"), "stem_conv")
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"), "stem_bn")
        prev = "stem_pool"
        for stage, (blocks, mid, out) in enumerate(_STAGES):
            for block in range(blocks):
                stride = 2 if (block == 0 and stage > 0) else 1
                prev = self._bottleneck(
                    g, f"s{stage}b{block}", prev, mid, out,
                    stride=stride, project=(block == 0))
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), prev)
        g.add_layer("fc", OutputLayer(n_out=self.num_classes, activation="softmax",
                                      loss="mcxent"), "avgpool")
        g.set_outputs("fc")
        g.set_input_types(InputType.convolutional(self.height, self.width, self.channels))
        return g.build()
