"""TinyYOLO and YOLO2 (reference ``org.deeplearning4j.zoo.model.TinyYOLO`` /
``YOLO2``): Darknet backbones with a ``Yolo2OutputLayer`` detection head.

Counterpart of ``deeplearning4j_tpu/zoo/yolo2.py``, with the same
configuration, defaults and node names.

YOLO2 adds the passthrough route: the 26x26x512 feature map is reorganised
with space-to-depth to 13x13x2048 and concatenated with the deep path before
the final detection conv — a ComputationGraph, as in the reference. Its
1x1 convolutions ``c3b``, ``c4b``, ``c5b``, ``c5d``, ``c6b``, ``c6d`` and
``pt_conv`` are plain (no bias, identity activation) and feed only their
BatchNormalization: the 7 pairs that train through the ``conv_stats``
kernel.
"""

import numpy as np

from deeplearning4j_tpu_torch.nn import (BatchNormalization, ConvolutionLayer, InputType,
                                         NeuralNetConfiguration, SpaceToDepthLayer,
                                         SubsamplingLayer, Yolo2OutputLayer)
from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.darknet19 import _conv_bn as _dn_conv_bn

# default anchor priors (reference uses the VOC-trained priors)
_TINY_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11),
                 (16.62, 10.52))
_YOLO2_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                  (7.88282, 3.52778), (9.77052, 9.16828))


def synthetic_labels(rng, b, h, w, anchors, classes, per_image=(1, 4)):
    """Detection labels in ``Yolo2OutputLayer``'s layout, ``(b, h, w,
    A * (5 + classes))`` float32, drawn from the numpy generator ``rng``:
    ``per_image`` (low, high) objects an image, each in one cell and one
    anchor, ``[tx, ty, tw, th, 1, class one-hot]``; zeros elsewhere."""
    a = len(anchors)
    lab = np.zeros((b, h, w, a, 5 + classes), np.float32)
    for i in range(b):
        for _ in range(rng.integers(per_image[0], per_image[1] + 1)):
            cy, cx, k = rng.integers(0, h), rng.integers(0, w), rng.integers(0, a)
            lab[i, cy, cx, k, 0:2] = rng.random(2)
            lab[i, cy, cx, k, 2:4] = rng.normal(0, 0.5, 2)
            lab[i, cy, cx, k, 4] = 1.0
            lab[i, cy, cx, k, 5 + rng.integers(0, classes)] = 1.0
    return lab.reshape(b, h, w, a * (5 + classes))


def _conv_bn(b, n_out, k=3):
    _dn_conv_bn(b, n_out, k)


class TinyYOLO(ZooModel):
    def __init__(self, num_classes: int = 20, seed: int = 123,
                 height: int = 416, width: int = 416, channels: int = 3,
                 anchors=_TINY_ANCHORS):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.anchors = anchors

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(1e-3, momentum=0.9))
             .list())
        for i, ch in enumerate((16, 32, 64, 128, 256)):
            _conv_bn(b, ch)
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        _conv_bn(b, 512)
        # stride-1 "same" pool (reference keeps 13x13 here)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(1, 1),
                                 convolution_mode="same"))
        _conv_bn(b, 1024)
        _conv_bn(b, 1024)
        n_box = len(self.anchors) * (5 + self.num_classes)
        b.layer(ConvolutionLayer(n_out=n_box, kernel_size=(1, 1),
                                 activation="identity"))
        b.layer(Yolo2OutputLayer(anchors=tuple(self.anchors),
                                 n_classes=self.num_classes))
        return (b.set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())


class YOLO2(ZooModel):
    def __init__(self, num_classes: int = 80, seed: int = 123,
                 height: int = 416, width: int = 416, channels: int = 3,
                 anchors=_YOLO2_ANCHORS):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.anchors = anchors

    def _conv_bn(self, g, name, inp, ch, k=3):
        g.add_layer(name, ConvolutionLayer(
            n_out=ch, kernel_size=(k, k), convolution_mode="same",
            activation="identity", has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(activation="leakyrelu"), name)
        return f"{name}_bn"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(1e-3, momentum=0.9))
             .graph_builder()
             .add_inputs("input"))
        p = self._conv_bn(g, "c1", "input", 32)
        g.add_layer("p1", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)), p)
        p = self._conv_bn(g, "c2", "p1", 64)
        g.add_layer("p2", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)), p)
        for i, ch in ((3, 128), (4, 256)):
            p = self._conv_bn(g, f"c{i}a", f"p{i - 1}", ch)
            p = self._conv_bn(g, f"c{i}b", p, ch // 2, k=1)
            p = self._conv_bn(g, f"c{i}c", p, ch)
            g.add_layer(f"p{i}", SubsamplingLayer(
                kernel_size=(2, 2), stride=(2, 2)), p)
        p = self._conv_bn(g, "c5a", "p4", 512)
        p = self._conv_bn(g, "c5b", p, 256, k=1)
        p = self._conv_bn(g, "c5c", p, 512)
        p = self._conv_bn(g, "c5d", p, 256, k=1)
        route = self._conv_bn(g, "c5e", p, 512)  # 26x26x512 passthrough source
        g.add_layer("p5", SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)),
                    route)
        p = self._conv_bn(g, "c6a", "p5", 1024)
        p = self._conv_bn(g, "c6b", p, 512, k=1)
        p = self._conv_bn(g, "c6c", p, 1024)
        p = self._conv_bn(g, "c6d", p, 512, k=1)
        p = self._conv_bn(g, "c6e", p, 1024)
        p = self._conv_bn(g, "c7a", p, 1024)
        deep = self._conv_bn(g, "c7b", p, 1024)
        # passthrough: 1x1 squeeze then space-to-depth 2x, concat with deep path
        pt = self._conv_bn(g, "pt_conv", route, 64, k=1)
        g.add_layer("pt_s2d", SpaceToDepthLayer(block_size=2), pt)
        g.add_vertex("route_cat", MergeVertex(), "pt_s2d", deep)
        p = self._conv_bn(g, "c8", "route_cat", 1024)
        n_box = len(self.anchors) * (5 + self.num_classes)
        g.add_layer("det_conv", ConvolutionLayer(
            n_out=n_box, kernel_size=(1, 1), activation="identity"), p)
        g.add_layer("yolo", Yolo2OutputLayer(anchors=tuple(self.anchors),
                                             n_classes=self.num_classes),
                    "det_conv")
        g.set_outputs("yolo")
        g.set_input_types(InputType.convolutional(
            self.height, self.width, self.channels))
        return g.build()
