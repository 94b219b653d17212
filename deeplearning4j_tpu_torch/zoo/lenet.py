"""LeNet (reference ``org.deeplearning4j.zoo.model.LeNet``).

Counterpart of ``deeplearning4j_tpu/zoo/lenet.py``, BASELINE config #1's
model, with the same configuration, so a JAX archive loads here: conv(20,
5x5, same) -> max-pool 2x2 -> conv(50, 5x5, same) -> max-pool 2x2 ->
dense(500) -> softmax(num_classes), relu between, ``Adam(1e-3)`` by
default, on flattened ``height x width x channels`` images (a
``FeedForwardToCnnPreProcessor`` before the first convolution and a
``CnnToFeedForwardPreProcessor`` before the dense layer are inserted at
build time).
"""

from deeplearning4j_tpu_torch.nn import (ConvolutionLayer, DenseLayer, InputType,
                                         NeuralNetConfiguration, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class LeNet(ZooModel):
    def __init__(self, num_classes: int = 10, seed: int = 123,
                 height: int = 28, width: int = 28, channels: int = 1,
                 updater=None):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels
        self.updater = updater or Adam(1e-3)

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                        activation="relu", convolution_mode="same"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                        activation="relu", convolution_mode="same"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional_flat(
                    self.height, self.width, self.channels))
                .build())
