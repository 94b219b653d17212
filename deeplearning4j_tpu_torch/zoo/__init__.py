"""Model zoo (counterpart of ``deeplearning4j_tpu.zoo``)."""

from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.bert import Bert
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.resnet50 import ResNet50
from deeplearning4j_tpu_torch.zoo.textgen_lstm import TextGenerationLSTM

__all__ = ["Bert", "LeNet", "ResNet50", "TextGenerationLSTM", "ZooModel"]
