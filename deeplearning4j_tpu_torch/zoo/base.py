"""ZooModel SPI (counterpart of ``deeplearning4j_tpu/zoo/base.py``)."""

from __future__ import annotations


class ZooModel:
    """Subclasses implement ``conf()``."""

    def __init__(self, num_classes: int = 1000, seed: int = 123, **kwargs):
        self.num_classes = num_classes
        self.seed = seed
        self.kwargs = kwargs

    def conf(self):
        raise NotImplementedError

    def init(self, device=None):
        """Build and initialise the network on ``device`` (``cuda`` unless
        the caller or the environment asks for the CPU): a
        ``ComputationGraph`` for a graph configuration, else a
        ``MultiLayerNetwork``."""
        from deeplearning4j_tpu_torch.models.computation_graph import (
            ComputationGraph, ComputationGraphConfiguration)
        from deeplearning4j_tpu_torch.models.multi_layer_network import MultiLayerNetwork
        conf = self.conf()
        if isinstance(conf, ComputationGraphConfiguration):
            return ComputationGraph(conf, device=device).init()
        return MultiLayerNetwork(conf, device=device).init()
