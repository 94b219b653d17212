"""ComputationGraph: a network over a DAG of named layers and vertices.

Counterpart of ``deeplearning4j_tpu/models/computation_graph.py``
(reference ``ComputationGraph`` and ``ComputationGraphConfiguration.
GraphBuilder``): named inputs, layer nodes and vertices, several outputs
whose losses add up, execution in topological order. The configuration's
JSON is the JAX package's (``:174-227``), so one ``configuration.json``
builds either package's graph, and archives cross both ways.

PyTorch runs eagerly: ``fit`` is a plain loop of ``_loss`` ->
``torch.autograd`` -> :class:`~..train.updaters.NetworkOptimizer`, one
iteration and one listener call per batch, and the layers' new state
(``BatchNormalization``'s running statistics) replaces the old after each
step, as the JAX step's ``model_state=new_state`` does. The inference entry
points run under ``torch.inference_mode``.

The fused training path: at :meth:`ComputationGraph.init` the graph finds
each pair of a plain 1x1 ``ConvolutionLayer`` (a 1x1 kernel, no padding, no
dilation, no bias, identity activation, no input dropout, no weight noise)
whose only consumer is a ``BatchNormalization`` whose only input it is. In
training such a pair runs as one step: the ``conv_stats`` kernel forms the
convolution as ``x[:, ::sh, ::sw, :] @ W[0, 0]`` with the normalization's
shifted batch sums in its epilogue, and the normalization takes those sums
(:meth:`~..nn.conv_layers.BatchNormalization.apply_batch_stats`) in place of
a pass of its own over the convolution's output. What the network computes
is what the JAX package computes: the same statistics, from the float32
accumulator. Inference runs every pair unfused (cuDNN, then the
normalization from its running statistics). Which pairs fuse is fixed by
the graph at ``init``: ResNet-50 has 36. Parameters live on one device,
``cuda`` unless the caller asks for the CPU.

A layer whose input needs a preprocessor (an image into a dense layer)
gets one at build time, as in the JAX package (``:146-170``); a
``PreprocessorVertex`` applies one explicitly. The l1/l2 penalties of the
layers are added to the loss (JAX ``_reg_score``). In training a layer with
``weight_noise`` sees its perturbed weights (the loss too), and after each
update the layers' constraints project the parameters (JAX ``:356``,
``:566``). ``fit`` takes ``DataSet``s and ``MultiDataSet``s.

Not ported yet, and raising by name: rematerialized segments, packed and
unrolled steps, ``fit_external``, ``backprop_gradient``, truncated BPTT and
the stateful RNN API (``rnn_time_step``, ``rnn_time_step_external``,
``rnn_get_state``/``rnn_set_state``/``rnn_zero_state``/
``rnn_clear_previous_state``) on a graph.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models._tbptt import is_sequence_array
from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer, cast_floating
from deeplearning4j_tpu_torch.nn.config import auto_preprocessor
from deeplearning4j_tpu_torch.nn.constraints import apply_layer_constraints, apply_weight_noise
from deeplearning4j_tpu_torch.nn.conv_layers import BatchNormalization, ConvolutionLayer
from deeplearning4j_tpu_torch.nn.graph_vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.ops.kernels.conv_stats import conv_stats
from deeplearning4j_tpu_torch.runtime.environment import (coerce_dtype, dtype_name,
                                                          get_environment)
from deeplearning4j_tpu_torch.runtime.rng import RngManager, generator_for
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map, tree_unflatten_like
from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.train.updaters import NetworkOptimizer, reg_score


@dataclasses.dataclass
class GraphNode:
    name: str
    kind: str  # "layer" | "vertex"
    obj: Any  # Layer or GraphVertex
    inputs: List[str]
    # set at build time where a layer's input needs reshaping (not serialized)
    inputs_preprocessor: Any = None


class GraphBuilder:
    """``NeuralNetConfiguration.builder()...graph_builder()``."""

    def __init__(self, g: GlobalConfig):
        self._g = g
        self._inputs: List[str] = []
        self._nodes: List[GraphNode] = []
        self._outputs: List[str] = []
        self._input_types: List[InputType] = []
        self._tbptt_fwd: Optional[int] = None

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: Layer, *inputs: str) -> "GraphBuilder":
        layer.name = name
        self._nodes.append(GraphNode(name, "layer", layer, list(inputs)))
        return self

    def add_vertex(self, name: str, vertex: GraphVertex, *inputs: str) -> "GraphBuilder":
        self._nodes.append(GraphNode(name, "vertex", vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        self._input_types = list(types)
        return self

    def tbptt_fwd_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = int(n)
        return self

    def build(self) -> "ComputationGraphConfiguration":
        conf = ComputationGraphConfiguration(
            global_conf=self._g, inputs=self._inputs, nodes=self._nodes,
            outputs=self._outputs, input_types=self._input_types,
            tbptt_fwd_length=self._tbptt_fwd)
        conf._toposort_and_infer()
        return conf


@dataclasses.dataclass
class ComputationGraphConfiguration:
    global_conf: GlobalConfig
    inputs: List[str]
    nodes: List[GraphNode]
    outputs: List[str]
    input_types: List[InputType] = dataclasses.field(default_factory=list)
    tbptt_fwd_length: Optional[int] = None
    topo_order: List[str] = dataclasses.field(default_factory=list)
    node_input_types: Dict[str, Optional[InputType]] = dataclasses.field(default_factory=dict)

    def node(self, name: str) -> GraphNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def _toposort_and_infer(self) -> None:
        """Depth-first order from the outputs, then any node they do not
        reach (JAX ``:117-172``); then each node's input type, with a
        preprocessor inserted before a layer that needs one."""
        by_name = {n.name: n for n in self.nodes}
        if len(by_name) != len(self.nodes):
            raise ValueError("Duplicate node names in graph")
        visited: Dict[str, int] = {}
        order: List[str] = []

        def visit(name: str):
            if name in self.inputs:
                return
            st = visited.get(name, 0)
            if st == 1:
                raise ValueError(f"Cycle detected at {name!r}")
            if st == 2:
                return
            visited[name] = 1
            for dep in by_name[name].inputs:
                visit(dep)
            visited[name] = 2
            order.append(name)

        for out in self.outputs:
            visit(out)
        for n in self.nodes:
            visit(n.name)
        self.topo_order = order

        types: Dict[str, Optional[InputType]] = {}
        for i, name in enumerate(self.inputs):
            if i < len(self.input_types):
                types[name] = self.input_types[i]
        for name in self.topo_order:
            node = by_name[name]
            in_types = [types.get(i) for i in node.inputs]
            if any(t is None for t in in_types):
                self.node_input_types[name] = None
                types[name] = None
                continue
            if node.kind == "layer":
                pp = auto_preprocessor(in_types[0], node.obj)
                if pp is not None:
                    node.inputs_preprocessor = pp
                    in_types[0] = pp.output_type(in_types[0])
                self.node_input_types[name] = in_types[0]
                types[name] = node.obj.output_type(in_types[0])
            else:
                self.node_input_types[name] = in_types[0]
                types[name] = node.obj.output_type(*in_types)
        self.output_types = [types.get(o) for o in self.outputs]

    # ---- serde: the JAX package's schema
    def to_dict(self) -> dict:
        g = {f.name: getattr(self.global_conf, f.name)
             for f in dataclasses.fields(self.global_conf)}
        if g["updater"] is not None and hasattr(g["updater"], "to_dict"):
            g["updater"] = g["updater"].to_dict()
        for k in ("weight_init", "activation"):
            if isinstance(g.get(k), (WeightInit, Activation)):
                g[k] = g[k].value
        if g.get("dtype") is not None:
            g["dtype"] = dtype_name(coerce_dtype(g["dtype"]))
        return {
            "model_type": "ComputationGraph",
            "global_conf": g,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "input_types": [t.to_dict() for t in self.input_types],
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "nodes": [{"name": n.name, "kind": n.kind, "inputs": n.inputs,
                       "obj": n.obj.to_dict()} for n in self.nodes],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        g_d = dict(d["global_conf"])
        if isinstance(g_d.get("updater"), dict):
            from deeplearning4j_tpu_torch.train.updaters import Updater
            g_d["updater"] = Updater.from_dict(g_d["updater"])
        if g_d.get("weight_init"):
            g_d["weight_init"] = WeightInit(g_d["weight_init"])
        if g_d.get("dtype") is not None:
            g_d["dtype"] = coerce_dtype(g_d["dtype"])
        names = {f.name for f in dataclasses.fields(GlobalConfig)}
        nodes = [GraphNode(nd["name"], nd["kind"],
                           Layer.from_dict(nd["obj"]) if nd["kind"] == "layer"
                           else GraphVertex.from_dict(nd["obj"]), list(nd["inputs"]))
                 for nd in d["nodes"]]
        conf = ComputationGraphConfiguration(
            global_conf=GlobalConfig(**{k: v for k, v in g_d.items() if k in names}),
            inputs=list(d["inputs"]), nodes=nodes, outputs=list(d["outputs"]),
            input_types=[InputType.from_dict(t) for t in d.get("input_types", [])],
            tbptt_fwd_length=d.get("tbptt_fwd_length"))
        conf._toposort_and_infer()
        return conf

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(f"ComputationGraph.{what} is not ported to "
                               "deeplearning4j_tpu_torch yet")


class ComputationGraph:
    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.conf = conf
        self._nodes: Dict[str, GraphNode] = {n.name: n for n in conf.nodes}
        for n in conf.nodes:
            if n.kind == "layer":
                n.obj._g = conf.global_conf
        self.rng = RngManager(conf.global_conf.seed)
        self._requested_device = device
        self.device: Optional[torch.device] = None
        self._params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self._model_state: Dict[str, Dict[str, torch.Tensor]] = {}
        self._optimizer: Optional[NetworkOptimizer] = None
        # updaterState.npz arrays of a restored archive, loaded into the
        # optimizer when it is built
        self._restored_updater_leaves: Optional[List[np.ndarray]] = None
        self._fused: Dict[str, str] = {}  # 1x1 convolution -> its BatchNormalization
        self._listeners: List[TrainingListener] = []
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")

    @property
    def layers(self) -> List[Layer]:
        return [n.obj for n in self.conf.nodes if n.kind == "layer"]

    # ------------------------------------------------------------------ init
    def init(self, params: Optional[Dict] = None) -> "ComputationGraph":
        """Draw the parameters (or take ``params``) and the layers' state on
        the graph's device; each layer draws from a generator folded from the
        config seed and its topological index. Finds the fused pairs."""
        self.device = get_environment().resolve_device(self._requested_device)
        g = self.conf.global_conf
        if g.dtype is None:
            g = dataclasses.replace(g, dtype=get_environment().default_dtype)
        new_params: Dict[str, Dict] = {}
        model_state: Dict[str, Dict] = {}
        for i, name in enumerate(self.conf.topo_order):
            node = self._nodes[name]
            if node.kind != "layer" or (params is not None and not node.obj.has_state):
                continue  # given params: only the layers' state is drawn
            p, s = node.obj.init(generator_for(g.seed, i), self.conf.node_input_types.get(name),
                                 g)
            if p and params is None:
                new_params[name] = p
            if s:
                model_state[name] = s
        self._params = tree_map(lambda t: t.to(self.device),
                                new_params if params is None else params)
        self._model_state = tree_map(lambda t: t.to(self.device), model_state)
        self._optimizer = None  # built at the first fit, on these parameters
        self._restored_updater_leaves = None
        self._fused = self._fused_pairs()
        return self

    def _fused_pairs(self) -> Dict[str, str]:
        """``{convolution: normalization}`` for each plain 1x1 convolution
        whose only consumer is a ``BatchNormalization`` whose only input it
        is (and that is not a graph output)."""
        consumers: Dict[str, List[str]] = {}
        for n in self.conf.nodes:
            for i in n.inputs:
                consumers.setdefault(i, []).append(n.name)
        pairs = {}
        for n in self.conf.nodes:
            cons = consumers.get(n.name, [])
            if (n.kind != "layer" or not isinstance(n.obj, ConvolutionLayer)
                    or not n.obj.is_plain_1x1() or n.name in self.conf.outputs
                    or len(cons) != 1):
                continue
            bn = self._nodes[cons[0]]
            if (bn.kind == "layer" and isinstance(bn.obj, BatchNormalization)
                    and bn.inputs == [n.name]):
                pairs[n.name] = bn.name
        return pairs

    @property
    def fused_pairs(self) -> Dict[str, str]:
        """The pairs that run through ``conv_stats`` in training."""
        return dict(self._fused)

    def _ensure_init(self) -> None:
        if self._params is None:
            self.init()

    def _as_input(self, x) -> torch.Tensor:
        """Tensor on the graph's device; float64 becomes float32, as the JAX
        package (64-bit off) reads it."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if t.dtype == torch.float64:
            t = t.float()
        return t.to(self.device)

    # --------------------------------------------------------------- forward
    def _exec_node(self, name, acts, last_inputs, new_state, pending, params, model_state,
                   *, training, generator, masks, output_set) -> None:
        """Execute one node in topological order (JAX ``:339-382``),
        filling ``acts``, ``last_inputs`` and ``new_state``. In training a
        fused convolution leaves its normalization's sums in ``pending``."""
        node = self._nodes[name]
        ins = [acts[k] for k in node.inputs]
        if node.kind == "vertex":
            acts[name] = node.obj.forward(*ins)
            return
        layer, x = node.obj, ins[0]
        if node.inputs_preprocessor is not None:
            x = node.inputs_preprocessor.pre_process(x)
        p = params.get(name, {})
        if name in output_set and hasattr(layer, "compute_loss"):
            # input dropout once; the loss and the output share the result
            x = layer._apply_input_dropout(x, layer._g, training, generator)
            last_inputs[name] = x
            acts[name] = layer.activate(p, x)
            return
        last_inputs[name] = x
        if training and name in self._fused:
            bn = self._fused[name]
            xs = layer.subsample(x)
            x2d = xs.reshape(-1, xs.shape[-1])
            y2d, s1, s2 = conv_stats(x2d, p["W"][0, 0], model_state[bn]["mean"])
            acts[name] = y2d.view(*xs.shape[:-1], y2d.shape[-1])
            pending[bn] = (s1, s2, x2d.shape[0])
            return
        state = model_state.get(name, {})
        if name in pending:
            s1, s2, n = pending.pop(name)
            y, s_new = layer.apply_batch_stats(p, state, x, s1, s2, n)
        else:
            mask = None if masks is None else masks.get(name)
            y, s_new = layer.forward(p, state, x, training=training, generator=generator,
                                     mask=mask)
        if state:
            new_state[name] = s_new
        acts[name] = y

    def _forward_all(self, params, model_state, inputs: Dict[str, torch.Tensor], *,
                     training: bool, generator=None, masks=None):
        """Execute the DAG; returns ``(acts, last_inputs, new_state)``:
        every node's activation, each output layer's input after its input
        dropout, and the layers' state after the pass."""
        cdt = get_environment().compute_dtype
        params = cast_floating(params, cdt)
        acts: Dict[str, Any] = {}
        for name, x in inputs.items():
            acts[name] = x.to(cdt) if x.is_floating_point() and x.dtype != cdt else x
        last_inputs: Dict[str, Any] = {}
        new_state = dict(model_state)
        pending: Dict[str, Any] = {}
        output_set = set(self.conf.outputs)
        for name in self.conf.topo_order:
            self._exec_node(name, acts, last_inputs, new_state, pending, params, model_state,
                            training=training, generator=generator, masks=masks,
                            output_set=output_set)
        return acts, last_inputs, new_state

    def _loss(self, params, model_state, inputs, labels, generator=None, masks=None,
              training: bool = True):
        """The sum of the output layers' losses (JAX ``:500-543``); returns
        ``(loss, new_state)``. In training the forward and the losses see
        the weights perturbed by the layers' weight noise."""
        if training:
            params = self._perturbed(params, generator)
        acts, last_inputs, new_state = self._forward_all(
            params, model_state, inputs, training=training, generator=generator, masks=masks)
        cdt = get_environment().compute_dtype
        total = None
        for out_name, y in zip(self.conf.outputs, labels):
            layer = self._nodes[out_name].obj
            if not hasattr(layer, "compute_loss"):
                raise ValueError(f"Output node {out_name!r} is not an output layer")
            mask = None if masks is None else masks.get(out_name)
            loss = layer.compute_loss(cast_floating(params.get(out_name, {}), cdt),
                                      last_inputs[out_name], y, mask=mask,
                                      state=model_state.get(out_name, {}))
            total = loss if total is None else total + loss
        reg = reg_score([(n.name, n.obj) for n in self.conf.nodes if n.kind == "layer"],
                        params, self.conf.global_conf)
        if reg is not None:
            total = total + reg
        return total, new_state

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1) -> "ComputationGraph":
        """``fit(iterator)``, ``fit(iterator, epochs=N)`` or ``fit(x, y)``
        (JAX ``:677-742``): ``x``/``y`` one array or tensor each, or lists of
        them for several inputs/outputs, taken as one batch. Tensors already
        on the graph's device are used where they lie."""
        self._ensure_init()
        if labels is not None:
            xs = list(data) if isinstance(data, (list, tuple)) else [data]
            ys = list(labels) if isinstance(labels, (list, tuple)) else [labels]
            batch = ({n: self._as_input(x) for n, x in zip(self.conf.inputs, xs)},
                     [self._as_input(y) for y in ys], None)
            iterator = [batch]
        else:
            iterator = data
        self._fit_epochs(iterator, int(epochs))
        return self

    def _coerce_batch(self, batch):
        """A DataSet or MultiDataSet minibatch, or an already coerced
        ``(inputs, labels, masks)``, as tensors on the device (JAX
        ``:659-675``)."""
        if isinstance(batch, tuple):
            return batch
        if isinstance(batch, MultiDataSet):
            masks = None
            if batch.labels_masks is not None:
                masks = {o: (None if m is None else self._as_input(m))
                         for o, m in zip(self.conf.outputs, batch.labels_masks)}
            return ({n: self._as_input(f) for n, f in zip(self.conf.inputs, batch.features)},
                    [self._as_input(y) for y in batch.labels], masks)
        if not isinstance(batch, DataSet):
            raise NotImplementedError(f"fitting a ComputationGraph on {type(batch).__name__} "
                                      "is not ported to deeplearning4j_tpu_torch yet")
        masks = None
        if batch.labels_mask is not None:
            masks = {self.conf.outputs[0]: self._as_input(batch.labels_mask)}
        return ({self.conf.inputs[0]: self._as_input(batch.features)},
                [self._as_input(batch.labels)], masks)

    def _fit_epochs(self, iterator, epochs: int) -> None:
        if self.conf.global_conf.optimization_algo != "STOCHASTIC_GRADIENT_DESCENT":
            raise NotImplementedError(
                f"optimization_algo={self.conf.global_conf.optimization_algo!r} is not "
                "ported to deeplearning4j_tpu_torch yet")
        for _ in range(epochs):
            for lst in self._listeners:
                lst.on_epoch_start(self, self._epoch)
            if hasattr(iterator, "reset"):
                iterator.reset()  # and again as iteration starts, as JAX's fit does
            for batch in iterator:
                inputs, labels, masks = self._coerce_batch(batch)
                if self.conf.tbptt_fwd_length and any(
                        is_sequence_array(v) for v in inputs.values()):
                    raise _unported("fit with truncated BPTT")
                self._iteration_done(self._train_step(inputs, labels, masks))
            for lst in self._listeners:
                lst.on_epoch_end(self, self._epoch)
            self._epoch += 1

    def _train_step(self, inputs, labels, masks):
        """One step: loss, gradients of the float parameters through the
        compute-dtype cast, the optimizer's update in place, and the layers'
        new state in place of the old. Returns the detached loss."""
        optimizer = self._ensure_optimizer()
        leaves = tree_leaves(self._params)
        trained = [t for t in leaves if t.is_floating_point()]
        for t in trained:
            t.requires_grad_(True)
        try:
            loss, new_state = self._loss(self._params, self._model_state, inputs, labels,
                                         self.rng.next_generator(), masks)
            grads = iter(torch.autograd.grad(loss, trained, allow_unused=True))
        finally:
            for t in trained:
                t.requires_grad_(False)
        per_leaf = []
        for t in leaves:
            g = next(grads) if t.is_floating_point() else None
            per_leaf.append(torch.zeros_like(t) if g is None else g)
        optimizer.step(self._params, tree_unflatten_like(self._params, per_leaf))
        self._apply_constraints()
        self._model_state = tree_map(lambda t: t.detach(), new_state)
        return loss.detach()

    def _perturbed(self, params, generator):
        """``params`` cast to ``compute_dtype``, each layer node that has
        ``weight_noise`` seeing its perturbed weights (JAX ``_exec_node``
        ``:355-359``), drawn from ``generator``; unchanged without one."""
        noisy = [n for n in self.conf.nodes
                 if n.kind == "layer" and n.obj.weight_noise is not None]
        if generator is None or not noisy:
            return params
        out = dict(cast_floating(params, get_environment().compute_dtype))
        for n in noisy:
            if n.name in out:
                out[n.name] = apply_weight_noise(n.obj, out[n.name], generator)
        return out

    def _apply_constraints(self) -> None:
        """Project the parameters by the layers' constraints, in place
        (JAX ``_apply_constraints``, after each update)."""
        with torch.no_grad():
            for n in self.conf.nodes:
                if n.kind != "layer" or n.name not in self._params:
                    continue
                for k, t in apply_layer_constraints(n.obj, self._params[n.name]).items():
                    if t is not self._params[n.name][k]:
                        self._params[n.name][k].copy_(t)

    def _iteration_done(self, loss) -> None:
        self._score = loss
        self._iteration += 1
        for lst in self._listeners:
            lst.iteration_done(self, self._iteration, self._epoch, loss)

    def _ensure_optimizer(self) -> NetworkOptimizer:
        """The optimizer, built at first use (it raises by name on an
        updater or option that is not ported); moments restored from an
        archive are loaded into it then."""
        if self._optimizer is None:
            nodes = [n for n in self.conf.nodes if n.kind == "layer"]
            opt = NetworkOptimizer.for_network([n.obj for n in nodes],
                                               [n.name for n in nodes],
                                               self.conf.global_conf, self._params)
            if self._restored_updater_leaves is not None:
                from deeplearning4j_tpu_torch.models.serializer import load_leaves_like
                opt.state = load_leaves_like(self._restored_updater_leaves, opt.state)
                self._restored_updater_leaves = None
            self._optimizer = opt
        return self._optimizer

    def updater_state(self):
        """The optimizer's state per node name (Nesterovs: ``{param:
        trace}``), in the leaf order of the JAX package's ``opt_state``."""
        self._ensure_init()
        return self._ensure_optimizer().state

    # ------------------------------------------------------------- inference
    def output(self, *xs):
        """Forward pass in inference mode (JAX ``:819-832``): the output for
        one output node, else a list in ``conf.outputs`` order."""
        self._ensure_init()
        with torch.inference_mode():
            inputs = {n: self._as_input(x) for n, x in zip(self.conf.inputs, xs)}
            acts, _, _ = self._forward_all(self._params, self._model_state, inputs,
                                           training=False)
            outs = [acts[o] for o in self.conf.outputs]
        return outs[0] if len(outs) == 1 else outs

    def score(self, dataset=None) -> float:
        """Loss on a DataSet in inference mode, or the last minibatch's loss
        when called with no argument."""
        if dataset is None:
            return float(self._score)
        self._ensure_init()
        with torch.inference_mode():
            inputs, labels, masks = self._coerce_batch(dataset)
            loss, _ = self._loss(self._params, self._model_state, inputs, labels, None, masks,
                                 training=False)
        return float(loss)

    def backprop_gradient(self, inputs, epsilons):
        raise _unported("backprop_gradient")

    def fit_external(self, inputs, epsilons):
        raise _unported("fit_external")

    def rnn_time_step(self, *xs):
        raise _unported("rnn_time_step")

    def rnn_time_step_external(self, *xs, state):
        raise _unported("rnn_time_step_external")

    def rnn_clear_previous_state(self) -> None:
        raise _unported("rnn_clear_previous_state")

    def rnn_get_state(self):
        raise _unported("rnn_get_state")

    def rnn_set_state(self, state) -> None:
        raise _unported("rnn_set_state")

    def rnn_zero_state(self, batch: int, like=None):
        raise _unported("rnn_zero_state")

    def evaluate(self, iterator, output_index: int = 0):
        """Classification evaluation of one output over an iterator of
        DataSets or MultiDataSets (reference ``evaluate(DataSetIterator)``,
        JAX ``:1003-1016``)."""
        from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
        ev = Evaluation()
        iterator.reset()
        for batch in iterator:
            inputs, labels, _ = self._coerce_batch(batch)
            outs = self.output(*[inputs[n] for n in self.conf.inputs])
            if isinstance(outs, list):
                outs = outs[output_index]
            ev.eval(labels[output_index].float().cpu().numpy(), outs.float().cpu().numpy())
        return ev

    # -------------------------------------------------------------- plumbing
    def set_listeners(self, *listeners: TrainingListener) -> None:
        self._listeners = list(listeners)

    def add_listeners(self, *listeners: TrainingListener) -> None:
        self._listeners.extend(listeners)

    def get_listeners(self) -> List[TrainingListener]:
        return list(self._listeners)

    def params(self):
        return self._params

    def set_params(self, params) -> None:
        """Replace the parameters (nested as :meth:`params`), placed on the
        graph's device."""
        if self._params is None:
            self.init(params=params)
        else:
            self._params = tree_map(lambda t: torch.as_tensor(t).to(self.device), params)

    def num_params(self) -> int:
        if self._params is None:
            return 0
        return int(sum(t.numel() for t in tree_leaves(self._params)))

    def clone(self) -> "ComputationGraph":
        """A graph of the same configuration with copies of the parameters
        and the layers' state, on the same device, and a fresh optimizer
        (JAX ``:1027-1036``)."""
        net = ComputationGraph(ComputationGraphConfiguration.from_dict(self.conf.to_dict()),
                               device=self.device or self._requested_device)
        if self._params is not None:
            net.init(params=tree_map(torch.clone, self._params))
            net._model_state = tree_map(torch.clone, self._model_state)
        return net

    def save(self, path: str) -> None:
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        ModelSerializer.write_model(self, path)

    @staticmethod
    def load(path: str, device=None) -> "ComputationGraph":
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        return ModelSerializer.restore_computation_graph(path, device=device)
