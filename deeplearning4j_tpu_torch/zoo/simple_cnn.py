"""SimpleCNN (reference ``org.deeplearning4j.zoo.model.SimpleCNN``).

Counterpart of ``deeplearning4j_tpu/zoo/simple_cnn.py``, with the same
configuration, defaults and node names.
"""

from deeplearning4j_tpu_torch.nn import (BatchNormalization, ConvolutionLayer, DenseLayer,
                                         DropoutLayer, InputType, NeuralNetConfiguration,
                                         OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class SimpleCNN(ZooModel):
    def __init__(self, num_classes: int = 10, seed: int = 123,
                 height: int = 48, width: int = 48, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(Adam(1e-3))
                .list()
                .layer(ConvolutionLayer(n_out=16, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu"))
                .layer(BatchNormalization())
                .layer(ConvolutionLayer(n_out=32, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu"))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=64, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu"))
                .layer(BatchNormalization())
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DropoutLayer(dropout=0.5))
                .layer(DenseLayer(n_out=256, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())
