"""Model zoo (counterpart of ``deeplearning4j_tpu.zoo``): the same 15
models, exported under the same names."""

from deeplearning4j_tpu_torch.zoo.base import ZooModel
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.simple_cnn import SimpleCNN
from deeplearning4j_tpu_torch.zoo.alexnet import AlexNet
from deeplearning4j_tpu_torch.zoo.vgg16 import VGG16
from deeplearning4j_tpu_torch.zoo.resnet50 import ResNet50
from deeplearning4j_tpu_torch.zoo.unet import UNet
from deeplearning4j_tpu_torch.zoo.darknet19 import Darknet19
from deeplearning4j_tpu_torch.zoo.textgen_lstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.zoo.bert import Bert
from deeplearning4j_tpu_torch.zoo.vgg19 import VGG19
from deeplearning4j_tpu_torch.zoo.squeezenet import SqueezeNet
from deeplearning4j_tpu_torch.zoo.xception import Xception
from deeplearning4j_tpu_torch.zoo.inception_resnet import InceptionResNetV1
from deeplearning4j_tpu_torch.zoo.yolo2 import TinyYOLO, YOLO2

__all__ = ["ZooModel", "LeNet", "SimpleCNN", "AlexNet", "VGG16", "VGG19",
           "ResNet50", "UNet", "Darknet19", "TextGenerationLSTM", "Bert",
           "SqueezeNet", "Xception", "InceptionResNetV1", "TinyYOLO", "YOLO2"]
