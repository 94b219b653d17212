"""VGG19 (reference ``org.deeplearning4j.zoo.model.VGG19``): VGG16 with
deeper conv blocks (4 convs in blocks 3-5).

Counterpart of ``deeplearning4j_tpu/zoo/vgg19.py``, with the same
configuration, defaults and node names.
"""

from deeplearning4j_tpu_torch.nn import (ConvolutionLayer, DenseLayer, InputType,
                                         NeuralNetConfiguration, OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel

_BLOCKS = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]


class VGG19(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(1e-2, momentum=0.9))
             .list())
        for n_convs, ch in _BLOCKS:
            for _ in range(n_convs):
                b.layer(ConvolutionLayer(n_out=ch, kernel_size=(3, 3),
                                         convolution_mode="same", activation="relu"))
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        return (b.layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(DenseLayer(n_out=4096, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())
