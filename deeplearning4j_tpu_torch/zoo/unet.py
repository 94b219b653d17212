"""UNet (reference ``org.deeplearning4j.zoo.model.UNet``): encoder/decoder
segmentation net with skip connections — exercises Deconvolution2D and
MergeVertex in a ComputationGraph.

Counterpart of ``deeplearning4j_tpu/zoo/unet.py``, with the same
configuration, defaults and node names.
"""

from deeplearning4j_tpu_torch.nn import (ConvolutionLayer, Deconvolution2D, InputType,
                                         LossLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph_vertices import MergeVertex
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class UNet(ZooModel):
    def __init__(self, num_classes: int = 1, seed: int = 123,
                 height: int = 128, width: int = 128, channels: int = 3,
                 base_filters: int = 16, depth: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.base_filters = base_filters
        self.depth = depth

    def conf(self):
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Adam(1e-3))
             .graph_builder()
             .add_inputs("input"))
        prev = "input"
        skips = []
        f = self.base_filters
        for d in range(self.depth):
            g.add_layer(f"enc{d}_c1", ConvolutionLayer(
                n_out=f << d, kernel_size=(3, 3), convolution_mode="same",
                activation="relu"), prev)
            g.add_layer(f"enc{d}_c2", ConvolutionLayer(
                n_out=f << d, kernel_size=(3, 3), convolution_mode="same",
                activation="relu"), f"enc{d}_c1")
            skips.append(f"enc{d}_c2")
            g.add_layer(f"enc{d}_pool", SubsamplingLayer(
                kernel_size=(2, 2), stride=(2, 2)), f"enc{d}_c2")
            prev = f"enc{d}_pool"
        g.add_layer("mid_c1", ConvolutionLayer(
            n_out=f << self.depth, kernel_size=(3, 3), convolution_mode="same",
            activation="relu"), prev)
        prev = "mid_c1"
        for d in reversed(range(self.depth)):
            g.add_layer(f"dec{d}_up", Deconvolution2D(
                n_out=f << d, kernel_size=(2, 2), stride=(2, 2),
                convolution_mode="same", activation="relu"), prev)
            g.add_vertex(f"dec{d}_merge", MergeVertex(), f"dec{d}_up", skips[d])
            g.add_layer(f"dec{d}_c1", ConvolutionLayer(
                n_out=f << d, kernel_size=(3, 3), convolution_mode="same",
                activation="relu"), f"dec{d}_merge")
            prev = f"dec{d}_c1"
        g.add_layer("head", ConvolutionLayer(
            n_out=self.num_classes, kernel_size=(1, 1), activation="identity"), prev)
        g.add_layer("out", LossLayer(loss="xent", activation="sigmoid"), "head")
        g.set_outputs("out")
        g.set_input_types(InputType.convolutional(self.height, self.width, self.channels))
        return g.build()
