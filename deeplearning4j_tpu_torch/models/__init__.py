"""Networks and archives (counterpart of ``deeplearning4j_tpu.models``)."""

from deeplearning4j_tpu_torch.models.computation_graph import (ComputationGraph,
                                                              ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.models.multi_layer_network import MultiLayerNetwork
from deeplearning4j_tpu_torch.models.serializer import ModelSerializer, params_from_numpy
from deeplearning4j_tpu_torch.models.transfer_learning import (FineTuneConfiguration,
                                                              TransferLearning,
                                                              TransferLearningGraph)

__all__ = ["ComputationGraph", "ComputationGraphConfiguration", "FineTuneConfiguration",
           "ModelSerializer", "MultiLayerNetwork", "TransferLearning", "TransferLearningGraph",
           "params_from_numpy"]
