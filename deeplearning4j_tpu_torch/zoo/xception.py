"""Xception (reference ``org.deeplearning4j.zoo.model.Xception``).

Counterpart of ``deeplearning4j_tpu/zoo/xception.py``, with the same
configuration, defaults and node names.

Entry flow (strided separable-conv blocks with 1x1 residual projections),
middle flow (8 identity separable blocks), exit flow — all depthwise-
separable convs, built as a ComputationGraph exactly as the reference does.
"""

from deeplearning4j_tpu_torch.nn import (ActivationLayer, BatchNormalization,
                                         ConvolutionLayer, GlobalPoolingLayer,
                                         InputType, OutputLayer, PoolingType,
                                         SeparableConvolution2D, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import ElementWiseVertex
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class Xception(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 299, width: int = 299, channels: int = 3,
                 middle_blocks: int = 8):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.middle_blocks = middle_blocks

    def _sep_bn(self, g, name, inp, ch, act_first=True):
        """[relu] -> sepconv 3x3 -> bn"""
        src = inp
        if act_first:
            g.add_layer(f"{name}_act", ActivationLayer(activation="relu"), src)
            src = f"{name}_act"
        g.add_layer(f"{name}_sep", SeparableConvolution2D(
            n_out=ch, kernel_size=(3, 3), convolution_mode="same",
            activation="identity", has_bias=False), src)
        g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_sep")
        return f"{name}_bn"

    def _entry_block(self, g, name, inp, ch, first_act=True):
        """Two sep-convs + maxpool, with a strided 1x1 conv residual."""
        a = self._sep_bn(g, f"{name}_1", inp, ch, act_first=first_act)
        b = self._sep_bn(g, f"{name}_2", a, ch)
        g.add_layer(f"{name}_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"), b)
        g.add_layer(f"{name}_res", ConvolutionLayer(
            n_out=ch, kernel_size=(1, 1), stride=(2, 2), activation="identity",
            has_bias=False), inp)
        g.add_layer(f"{name}_resbn", BatchNormalization(), f"{name}_res")
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"),
                     f"{name}_pool", f"{name}_resbn")
        return f"{name}_add"

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(4.5e-2, momentum=0.9))
             .weight_init("relu")
             .graph_builder()
             .add_inputs("input"))
        # stem
        g.add_layer("stem_c1", ConvolutionLayer(
            n_out=32, kernel_size=(3, 3), stride=(2, 2), activation="identity",
            has_bias=False), "input")
        g.add_layer("stem_b1", BatchNormalization(activation="relu"), "stem_c1")
        g.add_layer("stem_c2", ConvolutionLayer(
            n_out=64, kernel_size=(3, 3), activation="identity", has_bias=False),
            "stem_b1")
        g.add_layer("stem_b2", BatchNormalization(activation="relu"), "stem_c2")
        # entry flow
        prev = self._entry_block(g, "entry1", "stem_b2", 128, first_act=False)
        prev = self._entry_block(g, "entry2", prev, 256)
        prev = self._entry_block(g, "entry3", prev, 728)
        # middle flow: identity residual, three sep-convs each
        for i in range(self.middle_blocks):
            name = f"mid{i}"
            a = self._sep_bn(g, f"{name}_1", prev, 728)
            b = self._sep_bn(g, f"{name}_2", a, 728)
            c = self._sep_bn(g, f"{name}_3", b, 728)
            g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, prev)
            prev = f"{name}_add"
        # exit flow
        a = self._sep_bn(g, "exit_1", prev, 728)
        b = self._sep_bn(g, "exit_2", a, 1024)
        g.add_layer("exit_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), convolution_mode="same"), b)
        g.add_layer("exit_res", ConvolutionLayer(
            n_out=1024, kernel_size=(1, 1), stride=(2, 2), activation="identity",
            has_bias=False), prev)
        g.add_layer("exit_resbn", BatchNormalization(), "exit_res")
        g.add_vertex("exit_add", ElementWiseVertex(op="add"),
                     "exit_pool", "exit_resbn")
        c = self._sep_bn(g, "exit_3", "exit_add", 1536, act_first=False)
        g.add_layer("exit_3_relu", ActivationLayer(activation="relu"), c)
        d = self._sep_bn(g, "exit_4", "exit_3_relu", 2048, act_first=False)
        g.add_layer("exit_4_relu", ActivationLayer(activation="relu"), d)
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                    "exit_4_relu")
        g.add_layer("out", OutputLayer(n_out=self.num_classes,
                                       activation="softmax", loss="mcxent"),
                    "avgpool")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(
            self.height, self.width, self.channels))
        return g.build()
