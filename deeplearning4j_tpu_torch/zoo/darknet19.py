"""Darknet19 (reference ``org.deeplearning4j.zoo.model.Darknet19`` — the
YOLO9000 backbone).

Counterpart of ``deeplearning4j_tpu/zoo/darknet19.py``, with the same
configuration, defaults and node names.
"""

from deeplearning4j_tpu_torch.nn import (BatchNormalization, ConvolutionLayer,
                                         GlobalPoolingLayer, InputType,
                                         NeuralNetConfiguration, OutputLayer, PoolingType,
                                         SubsamplingLayer)
from deeplearning4j_tpu_torch.train.updaters import Nesterovs
from deeplearning4j_tpu_torch.zoo.base import ZooModel


def _conv_bn(b, n_out, k):
    b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(k, k),
                             convolution_mode="same", activation="identity",
                             has_bias=False))
    b.layer(BatchNormalization(activation="leakyrelu"))


class Darknet19(ZooModel):
    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3):
        super().__init__(num_classes=num_classes, seed=seed)
        self.height, self.width, self.channels = height, width, channels

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(1e-2, momentum=0.9))
             .list())
        _conv_bn(b, 32, 3)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        _conv_bn(b, 64, 3)
        b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        for ch in (128, 256):
            _conv_bn(b, ch, 3)
            _conv_bn(b, ch // 2, 1)
            _conv_bn(b, ch, 3)
            b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        for ch in (512, 1024):
            _conv_bn(b, ch, 3)
            _conv_bn(b, ch // 2, 1)
            _conv_bn(b, ch, 3)
            _conv_bn(b, ch // 2, 1)
            _conv_bn(b, ch, 3)
            if ch == 512:
                b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        b.layer(ConvolutionLayer(n_out=self.num_classes, kernel_size=(1, 1),
                                 activation="identity"))
        b.layer(GlobalPoolingLayer(pooling_type=PoolingType.AVG))
        b.layer(OutputLayer(n_out=self.num_classes, n_in=self.num_classes,
                            activation="softmax", loss="mcxent", has_bias=False,
                            weight_init="identity"))
        return (b.set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())
