"""AlexNet (reference ``org.deeplearning4j.zoo.model.AlexNet``).

Counterpart of ``deeplearning4j_tpu/zoo/alexnet.py``, with the same
configuration, defaults and node names.
"""

from deeplearning4j_tpu_torch.nn import (ConvolutionLayer, DenseLayer, DropoutLayer, InputType,
                                         LocalResponseNormalization, NeuralNetConfiguration,
                                         OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class AlexNet(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(Nesterovs(1e-2, momentum=0.9))
                .l2(5e-4)
                .list()
                .layer(ConvolutionLayer(n_out=96, kernel_size=(11, 11), stride=(4, 4),
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", activation="relu",
                                        bias_init=1.0))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu"))
                .layer(ConvolutionLayer(n_out=384, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu",
                                        bias_init=1.0))
                .layer(ConvolutionLayer(n_out=256, kernel_size=(3, 3),
                                        convolution_mode="same", activation="relu",
                                        bias_init=1.0))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2)))
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())
