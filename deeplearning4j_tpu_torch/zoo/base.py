"""ZooModel SPI (counterpart of ``deeplearning4j_tpu/zoo/base.py``)."""

from __future__ import annotations

import json
import os
from typing import Optional


def without_dropout(conf):
    """``conf`` rebuilt through its JSON with every dropout retaining
    everything, for comparing two runs that would draw different masks."""
    def walk(d):
        if isinstance(d, dict):
            return {k: (1.0 if k == "dropout" and v is not None else walk(v))
                    for k, v in d.items()}
        return [walk(v) for v in d] if isinstance(d, list) else d
    return type(conf).from_json(json.dumps(walk(json.loads(conf.to_json()))))


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

    def pretrained_path(self) -> Optional[str]:
        """``<class name lower-cased>.zip`` under ``$DL4J_TPU_ZOO_DIR``
        (default ``~/.deeplearning4j_tpu/zoo``), if it exists."""
        root = os.environ.get("DL4J_TPU_ZOO_DIR",
                              os.path.expanduser("~/.deeplearning4j_tpu/zoo"))
        p = os.path.join(root, f"{type(self).__name__.lower()}.zip")
        return p if os.path.exists(p) else None

    def init_pretrained(self, device=None):
        """The network restored from its local archive (JAX
        ``base.py:39-48``: there is no download mirror), written by either
        package; raises ``FileNotFoundError`` when there is none."""
        path = self.pretrained_path()
        if path is None:
            raise FileNotFoundError(
                f"No pretrained archive for {type(self).__name__}; place a model zip "
                "under $DL4J_TPU_ZOO_DIR (offline environment — no download mirror)")
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        return ModelSerializer.restore_model(path, device=device)
