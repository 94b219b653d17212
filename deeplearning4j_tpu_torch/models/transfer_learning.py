"""Transfer learning.

Counterpart of ``deeplearning4j_tpu/models/transfer_learning.py`` (reference
``org.deeplearning4j.nn.transferlearning.{TransferLearning,
FineTuneConfiguration}``): take a trained network, freeze a prefix,
replace or append head layers, and keep the trained weights of the layers
that stay, with their state (BatchNormalization's running statistics). A
frozen layer keeps its parameters and takes zero updates (``Layer.frozen``:
the ``NoOp`` updater), and its weights take no gradient in the step. The new
network lives on the old one's device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from deeplearning4j_tpu_torch.models.multi_layer_network import MultiLayerNetwork, _layer_key
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.runtime.trees import tree_map


@dataclasses.dataclass
class FineTuneConfiguration:
    """Global overrides for the new network (reference
    ``FineTuneConfiguration``); they act on the global configuration only."""

    updater: object = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout: Optional[float] = None
    seed: Optional[int] = None

    def apply(self, conf) -> None:
        g = conf.global_conf
        if self.updater is not None:
            g.updater = self.updater
        if self.l1 is not None:
            g.l1 = self.l1
        if self.l2 is not None:
            g.l2 = self.l2
        if self.dropout is not None:
            g.dropout = self.dropout
        if self.seed is not None:
            g.seed = self.seed


def _graft(net, old_params, old_state, keys) -> None:
    """Copy the old network's parameters and state of ``keys`` into ``net``
    (copies: the two networks train independently)."""
    for k in keys:
        if k in old_params:
            net._params[k] = tree_map(lambda t: t.detach().clone().to(net.device),
                                      old_params[k])
        if k in old_state:
            net._model_state[k] = tree_map(lambda t: t.detach().clone().to(net.device),
                                           old_state[k])


class TransferLearning:
    """Builder (reference ``TransferLearning.Builder``)::

        net2 = (TransferLearning.builder(net)
                .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-4)))
                .set_feature_extractor(3)        # freeze layers 0..3
                .remove_output_layer()
                .add_layer(OutputLayer(n_out=5, activation="softmax"))
                .build())
    """

    @staticmethod
    def builder(net: MultiLayerNetwork) -> "TransferLearning.Builder":
        return TransferLearning.Builder(net)

    @staticmethod
    def graph_builder(net) -> "TransferLearningGraph.Builder":
        return TransferLearningGraph.Builder(net)

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            self._net = net
            self._conf = MultiLayerConfiguration.from_dict(net.conf.to_dict())
            self._old_params = net.params() or {}
            self._old_state = net._model_state
            self._freeze_until: Optional[int] = None
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._removed_from: Optional[int] = None
            self._added: List = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, layer_index: int):
            """Freeze layers ``0..layer_index`` inclusive."""
            self._freeze_until = int(layer_index)
            return self

        def remove_output_layer(self):
            return self.remove_layers_from_output(1)

        def remove_layers_from_output(self, n: int):
            self._removed_from = len(self._conf.layers) - int(n)
            return self

        def add_layer(self, layer):
            self._added.append(layer)
            return self

        def build(self) -> MultiLayerNetwork:
            conf = self._conf
            if self._fine_tune:
                self._fine_tune.apply(conf)
            keep = conf.layers[: self._removed_from] if self._removed_from is not None \
                else list(conf.layers)
            kept_n = len(keep)
            layers = keep + list(self._added)
            if self._freeze_until is not None:
                for i in range(min(self._freeze_until + 1, len(layers))):
                    layers[i].frozen = True
            conf.layers = layers
            conf.preprocessors = {i: pp for i, pp in conf.preprocessors.items() if i < kept_n}
            conf._infer_shapes()
            net = MultiLayerNetwork(conf, device=self._net.device).init()
            _graft(net, self._old_params, self._old_state,
                   [_layer_key(i, l) for i, l in enumerate(conf.layers[:kept_n])])
            return net


class TransferLearningGraph:
    """Transfer learning on a ComputationGraph (reference
    ``TransferLearning.GraphBuilder``)::

        net2 = (TransferLearning.graph_builder(net)
                .fine_tune_configuration(FineTuneConfiguration(updater=Adam(1e-4)))
                .set_feature_extractor("pool")     # freeze "pool" and its ancestors
                .remove_vertex_and_connections("out")
                .add_layer("out2", OutputLayer(n_out=5, activation="softmax"), "pool")
                .set_outputs("out2")
                .build())
    """

    class Builder:
        def __init__(self, net):
            from deeplearning4j_tpu_torch.models.computation_graph import (
                ComputationGraphConfiguration)
            self._net = net
            self._conf = ComputationGraphConfiguration.from_dict(net.conf.to_dict())
            self._old_params = net.params() or {}
            self._old_state = net._model_state
            self._fine_tune: Optional[FineTuneConfiguration] = None
            self._freeze_at: List[str] = []
            self._removed: set = set()
            self._added_names: List[str] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, *vertex_names: str):
            """Freeze the named vertices and every ancestor."""
            self._freeze_at = list(vertex_names)
            return self

        def remove_vertex_and_connections(self, name: str):
            """Remove a vertex and everything downstream of it."""
            doomed = {name}
            changed = True
            while changed:
                changed = False
                for n in self._conf.nodes:
                    if n.name not in doomed and any(i in doomed for i in n.inputs):
                        doomed.add(n.name)
                        changed = True
            self._removed |= doomed
            return self

        def add_layer(self, name: str, layer, *inputs: str):
            from deeplearning4j_tpu_torch.models.computation_graph import GraphNode
            layer.name = name
            self._conf.nodes.append(GraphNode(name, "layer", layer, list(inputs)))
            self._added_names.append(name)
            return self

        def add_vertex(self, name: str, vertex, *inputs: str):
            from deeplearning4j_tpu_torch.models.computation_graph import GraphNode
            self._conf.nodes.append(GraphNode(name, "vertex", vertex, list(inputs)))
            self._added_names.append(name)
            return self

        def set_outputs(self, *names: str):
            self._conf.outputs = list(names)
            return self

        def _ancestors(self, names: List[str]) -> set:
            by_name = {n.name: n for n in self._conf.nodes}
            seen = set()

            def walk(n):
                if n in seen or n in self._conf.inputs:
                    return
                if n not in by_name:
                    raise ValueError(
                        f"set_feature_extractor target {n!r} is not a graph "
                        f"vertex (typo, or removed by "
                        f"remove_vertex_and_connections)")
                seen.add(n)
                for dep in by_name[n].inputs:
                    walk(dep)

            for n in names:
                walk(n)
            return seen

        def build(self):
            from deeplearning4j_tpu_torch.models.computation_graph import ComputationGraph
            conf = self._conf
            if self._fine_tune:
                self._fine_tune.apply(conf)
            conf.nodes = [n for n in conf.nodes if n.name not in self._removed]
            missing = [o for o in conf.outputs if o in self._removed]
            if missing:
                raise ValueError(f"outputs {missing} were removed; call set_outputs(...)")
            if self._freeze_at:
                for name in self._ancestors(self._freeze_at):
                    node = conf.node(name)
                    if node.kind == "layer":
                        node.obj.frozen = True
            for n in conf.nodes:  # inferred again from the new graph
                n.inputs_preprocessor = None
            conf._toposort_and_infer()
            net = ComputationGraph(conf, device=self._net.device).init()
            _graft(net, self._old_params, self._old_state,
                   [n.name for n in conf.nodes if n.name not in self._added_names])
            return net


__all__ = ["FineTuneConfiguration", "TransferLearning", "TransferLearningGraph"]
