"""InceptionResNetV1 (reference ``org.deeplearning4j.zoo.model.InceptionResNetV1``
— the FaceNet backbone).

Counterpart of ``deeplearning4j_tpu/zoo/inception_resnet.py``, with the same
configuration, defaults and node names.

Stem -> 5x inception-resnet-A -> reduction-A -> 10x inception-resnet-B ->
reduction-B -> 5x inception-resnet-C -> avgpool -> embedding head. Residual
branches are concatenated (MergeVertex), projected with a 1x1 conv, scaled
(ScaleVertex, the reference's residual damping), and added to the shortcut.
Block counts are configurable so tests can build a shallow variant.
"""

from deeplearning4j_tpu_torch.nn import (ActivationLayer, BatchNormalization,
                                         ConvolutionLayer, GlobalPoolingLayer,
                                         InputType, OutputLayer, PoolingType,
                                         SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import (ElementWiseVertex, MergeVertex,
                                                        ScaleVertex)
from deeplearning4j_tpu_torch.train.updaters import RmsProp
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class InceptionResNetV1(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 160, width: int = 160, channels: int = 3,
                 blocks_a: int = 5, blocks_b: int = 10, blocks_c: int = 5):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.blocks_a, self.blocks_b, self.blocks_c = blocks_a, blocks_b, blocks_c

    def _conv(self, g, name, inp, ch, k, stride=1, same=True, act="relu"):
        g.add_layer(name, ConvolutionLayer(
            n_out=ch, kernel_size=(k, k) if isinstance(k, int) else k,
            stride=(stride, stride), convolution_mode="same" if same else "truncate",
            activation="identity", has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(activation=act), name)
        return f"{name}_bn"

    def _residual(self, g, name, inp, branches, project_ch, scale=0.17):
        """Concat branches -> 1x1 project -> scale -> add(inp) -> relu."""
        g.add_vertex(f"{name}_cat", MergeVertex(), *branches)
        g.add_layer(f"{name}_proj", ConvolutionLayer(
            n_out=project_ch, kernel_size=(1, 1), activation="identity"),
            f"{name}_cat")
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_proj")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                     inp, f"{name}_scale")
        g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                    f"{name}_add")
        return f"{name}_relu"

    def _block_a(self, g, name, inp):  # 35x35, 256 ch
        b1 = self._conv(g, f"{name}_b1", inp, 32, 1)
        b2 = self._conv(g, f"{name}_b2b", self._conv(g, f"{name}_b2a", inp, 32, 1), 32, 3)
        b3a = self._conv(g, f"{name}_b3a", inp, 32, 1)
        b3b = self._conv(g, f"{name}_b3b", b3a, 32, 3)
        b3 = self._conv(g, f"{name}_b3c", b3b, 32, 3)
        return self._residual(g, name, inp, [b1, b2, b3], 256, scale=0.17)

    def _block_b(self, g, name, inp):  # 17x17, 896 ch
        b1 = self._conv(g, f"{name}_b1", inp, 128, 1)
        b2a = self._conv(g, f"{name}_b2a", inp, 128, 1)
        b2b = self._conv(g, f"{name}_b2b", b2a, 128, (1, 7))
        b2 = self._conv(g, f"{name}_b2c", b2b, 128, (7, 1))
        return self._residual(g, name, inp, [b1, b2], 896, scale=0.10)

    def _block_c(self, g, name, inp):  # 8x8, 1792 ch
        b1 = self._conv(g, f"{name}_b1", inp, 192, 1)
        b2a = self._conv(g, f"{name}_b2a", inp, 192, 1)
        b2b = self._conv(g, f"{name}_b2b", b2a, 192, (1, 3))
        b2 = self._conv(g, f"{name}_b2c", b2b, 192, (3, 1))
        return self._residual(g, name, inp, [b1, b2], 1792, scale=0.20)

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(RmsProp(0.1, rms_decay=0.96, epsilon=0.001))
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input"))
        # stem: 149x149x32 -> ... -> 35x35x256
        p = self._conv(g, "stem1", "input", 32, 3, stride=2)
        p = self._conv(g, "stem2", p, 32, 3)
        p = self._conv(g, "stem3", p, 64, 3)
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"), p)
        p = self._conv(g, "stem4", "stem_pool", 80, 1)
        p = self._conv(g, "stem5", p, 192, 3)
        p = self._conv(g, "stem6", p, 256, 3, stride=2)
        for i in range(self.blocks_a):
            p = self._block_a(g, f"a{i}", p)
        # reduction-A: 35->17, 256->896
        ra1 = self._conv(g, "ra_b1", p, 384, 3, stride=2)
        ra2a = self._conv(g, "ra_b2a", p, 192, 1)
        ra2b = self._conv(g, "ra_b2b", ra2a, 192, 3)
        ra2 = self._conv(g, "ra_b2c", ra2b, 256, 3, stride=2)
        g.add_layer("ra_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"), p)
        g.add_vertex("ra_cat", MergeVertex(), ra1, ra2, "ra_pool")
        p = "ra_cat"
        for i in range(self.blocks_b):
            p = self._block_b(g, f"b{i}", p)
        # reduction-B: 17->8, 896->1792
        rb1a = self._conv(g, "rb_b1a", p, 256, 1)
        rb1 = self._conv(g, "rb_b1b", rb1a, 384, 3, stride=2)
        rb2a = self._conv(g, "rb_b2a", p, 256, 1)
        rb2 = self._conv(g, "rb_b2b", rb2a, 256, 3, stride=2)
        rb3a = self._conv(g, "rb_b3a", p, 256, 1)
        rb3b = self._conv(g, "rb_b3b", rb3a, 256, 3)
        rb3 = self._conv(g, "rb_b3c", rb3b, 256, 3, stride=2)
        g.add_layer("rb_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"), p)
        g.add_vertex("rb_cat", MergeVertex(), rb1, rb2, rb3, "rb_pool")
        p = "rb_cat"
        for i in range(self.blocks_c):
            p = self._block_c(g, f"c{i}", p)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type=PoolingType.AVG), p)
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(
            self.height, self.width, self.channels))
        return g.build()
