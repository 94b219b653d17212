"""Layers and configuration (counterpart of ``deeplearning4j_tpu.nn``)."""

from deeplearning4j_tpu_torch.nn.attention_layers import (BertEmbeddingLayer, ClsPoolingLayer,
                                                          LearnedPositionalEmbeddingLayer,
                                                          SelfAttentionLayer,
                                                          TransformerEncoderBlock,
                                                          TransformerEncoderStack)
from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer, register_layer
from deeplearning4j_tpu_torch.nn.config import (MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.core_layers import (ActivationLayer, DenseLayer,
                                                     DropoutLayer, EmbeddingLayer,
                                                     EmbeddingSequenceLayer,
                                                     LossLayer, OutputLayer)
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.nn.recurrent_layers import (LSTM, BaseRecurrentLayer,
                                                          GravesLSTM,
                                                          RnnOutputLayer)

__all__ = [
    "ActivationLayer", "BaseRecurrentLayer", "BertEmbeddingLayer", "ClsPoolingLayer",
    "DenseLayer", "DropoutLayer", "EmbeddingLayer", "EmbeddingSequenceLayer",
    "GlobalConfig", "GravesLSTM", "InputType", "LSTM", "Layer",
    "LearnedPositionalEmbeddingLayer", "LossLayer", "MultiLayerConfiguration",
    "NeuralNetConfiguration", "OutputLayer", "RnnOutputLayer", "SelfAttentionLayer",
    "TransformerEncoderBlock", "TransformerEncoderStack", "register_layer",
]
