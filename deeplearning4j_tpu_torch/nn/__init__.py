"""Layers and configuration (counterpart of ``deeplearning4j_tpu.nn``)."""

from deeplearning4j_tpu_torch.nn.attention_layers import (BertEmbeddingLayer, ClsPoolingLayer,
                                                          LearnedPositionalEmbeddingLayer,
                                                          SelfAttentionLayer,
                                                          TransformerEncoderBlock,
                                                          TransformerEncoderStack)
from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer, register_layer
from deeplearning4j_tpu_torch.nn.conv_layers import (BatchNormalization, Convolution1DLayer,
                                                     ConvolutionLayer, Deconvolution2D,
                                                     GlobalPoolingLayer,
                                                     LocalResponseNormalization, PoolingType,
                                                     SeparableConvolution2D, SpaceToDepthLayer,
                                                     SubsamplingLayer, Upsampling2D,
                                                     ZeroPaddingLayer)
from deeplearning4j_tpu_torch.nn.extra_layers import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.config import (MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.constraints import (DropConnect, MaxNormConstraint,
                                                     MinMaxNormConstraint,
                                                     NonNegativeConstraint,
                                                     UnitNormConstraint, WeightNoise)
from deeplearning4j_tpu_torch.nn.core_layers import (ActivationLayer, DenseLayer,
                                                     DropoutLayer, EmbeddingLayer,
                                                     EmbeddingSequenceLayer,
                                                     LossLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.recurrent_layers import (GRU, LSTM, BaseRecurrentLayer,
                                                          Bidirectional, GravesLSTM,
                                                          LastTimeStep, RnnOutputLayer,
                                                          SimpleRnn)

__all__ = [
    "ActivationLayer", "BaseRecurrentLayer", "BatchNormalization", "BertEmbeddingLayer",
    "Bidirectional", "ClsPoolingLayer", "Convolution1DLayer", "ConvolutionLayer",
    "Deconvolution2D", "DenseLayer", "DropConnect", "DropoutLayer", "EmbeddingLayer",
    "EmbeddingSequenceLayer", "GRU", "GlobalConfig", "GlobalPoolingLayer", "GravesLSTM",
    "InputType", "LSTM", "LastTimeStep", "Layer", "LearnedPositionalEmbeddingLayer",
    "LocalResponseNormalization", "LossLayer", "MaxNormConstraint", "MinMaxNormConstraint",
    "MultiLayerConfiguration", "NeuralNetConfiguration", "NonNegativeConstraint",
    "OutputLayer", "PoolingType", "RnnOutputLayer", "SelfAttentionLayer",
    "SeparableConvolution2D", "SimpleRnn", "SpaceToDepthLayer", "SubsamplingLayer",
    "TransformerEncoderBlock", "TransformerEncoderStack", "UnitNormConstraint",
    "Upsampling2D", "WeightNoise", "Yolo2OutputLayer", "ZeroPaddingLayer",
    "register_layer",
]
