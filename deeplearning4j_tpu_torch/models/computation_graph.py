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

Truncated BPTT (``tbptt_fwd_length``), the stateful RNN API
(``rnn_time_step``, ``rnn_time_step_external``, ``rnn_get_state``/
``rnn_set_state``/``rnn_zero_state``/``rnn_clear_previous_state``) and the
external-errors mode (``backprop_gradient``, ``fit_external``) run the
graph's recurrent layers on explicit carries (JAX ``_exec_node``'s
``carries`` path), so a graph LSTM reaches the same kernels as a
``MultiLayerNetwork`` one. With ``get_environment().set_remat(True)`` the
training forward checkpoints each multi-node segment between single-tensor
cut points (JAX ``_remat_segments``/``_forward_remat``) with
``torch.utils.checkpoint``; a recomputed segment replays its forward's
dropout masks (:class:`~..runtime.rng.DrawTape`), keeps the forward's
BatchNormalization statistics, and launches its fused pairs' ``conv_stats``
again.

An ``optimization_algo`` other than SGD (LBFGS, CONJUGATE_GRADIENT,
LINE_GRADIENT_DESCENT) fits each batch with :mod:`~..train.solvers`, as the
JAX package's ``graph_solver_fit_batch`` does; with tBPTT it raises. Not
ported yet, and raising by name: ``fit`` on anything but ``DataSet``s and
``MultiDataSet``s.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
import json
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models._tbptt import carry_dtype, is_sequence_array, slice_time
from deeplearning4j_tpu_torch.nn.base import GlobalConfig, Layer, cast_floating
from deeplearning4j_tpu_torch.nn.config import auto_preprocessor
from deeplearning4j_tpu_torch.nn.constraints import apply_layer_constraints, apply_weight_noise
from deeplearning4j_tpu_torch.nn.conv_layers import BatchNormalization, ConvolutionLayer
from deeplearning4j_tpu_torch.nn.graph_vertices import GraphVertex
from deeplearning4j_tpu_torch.nn.recurrent_layers import BaseRecurrentLayer
from deeplearning4j_tpu_torch.nn.inputs import InputType
from deeplearning4j_tpu_torch.ops.activations import Activation
from deeplearning4j_tpu_torch.ops.initializers import WeightInit
from deeplearning4j_tpu_torch.ops.kernels.conv_stats import conv_stats
from deeplearning4j_tpu_torch.runtime.environment import (coerce_dtype, dtype_name,
                                                          get_environment)
from deeplearning4j_tpu_torch.models.multi_layer_network import (MultiLayerNetwork,
                                                                 leaf_gradients, trained_leaves)
from deeplearning4j_tpu_torch.runtime.rng import RngManager, generator_for, recomputed
from deeplearning4j_tpu_torch.runtime.state_packing import assign_state
from deeplearning4j_tpu_torch.runtime.trees import tree_leaves, tree_map
from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.train.prefetch import as_device_tensor
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


def _cg_group_compatible(a, b) -> bool:
    """Whether two buffered (inputs, labels, generator, masks) tuples may
    share one grouped dispatch: same input/label shapes and mask presence
    (JAX ``:229-246``)."""
    ia, la, _, ma = a
    ib, lb, _, mb = b
    if set(ia) != set(ib) or len(la) != len(lb):
        return False
    if any(ia[n].shape != ib[n].shape for n in ia):
        return False
    if any(x.shape != y.shape for x, y in zip(la, lb)):
        return False
    if (ma is None) != (mb is None):
        return False
    if ma is not None and (set(ma) != set(mb) or any(
            (ma[k] is None) != (mb[k] is None)
            or (ma[k] is not None and ma[k].shape != mb[k].shape) for k in ma)):
        return False
    return True


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
        # the last 16 solver batches' records (train/solvers.py), oldest first
        self._solver_log: Deque[dict] = collections.deque(maxlen=16)
        self._epoch = 0
        self._score = float("nan")
        # the training runtime's per-graph cache (see MultiLayerNetwork)
        self._runtime_cache: Dict[str, Any] = {}
        self._device_gen: Optional[torch.Generator] = None
        self._rnn_carries: Optional[Dict[str, Any]] = None
        self._remat_segs: Optional[List[List[str]]] = None

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
        self._runtime_cache = {}
        self._rnn_carries = None  # stale hidden state must not cross inits
        self._remat_segs = None
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

    def _as_input(self, x, staged: bool = False) -> torch.Tensor:
        """Tensor on the graph's device; float64 becomes float32, as the JAX
        package (64-bit off) reads it (``staged``: see
        :func:`~..train.prefetch.as_device_tensor`)."""
        return as_device_tensor(x, self.device, staged)

    # --------------------------------------------------------------- forward
    def _exec_node(self, name, acts, last_inputs, new_state, pending, params, model_state,
                   *, training, generator, masks, output_set, carries=None) -> None:
        """Execute one node in topological order (JAX ``:339-382``),
        filling ``acts``, ``last_inputs`` and ``new_state``. In training a
        fused convolution leaves its normalization's sums in ``pending``.
        Given ``carries`` (``{node: carry}``), a recurrent layer runs from its
        carry and leaves its new one there."""
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
        if carries is not None and isinstance(layer, BaseRecurrentLayer):
            x = layer._apply_input_dropout(x, layer._g, training, generator)
            acts[name], carries[name] = layer.forward_with_carry(
                p, carries[name], x, training=training, generator=generator,
                mask=None if masks is None else masks.get(name))
            return
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
                     training: bool, generator=None, masks=None, carries=None):
        """Execute the DAG; returns ``(acts, last_inputs, new_state)``:
        every node's activation, each output layer's input after its input
        dropout, and the layers' state after the pass; and the new carries
        as a fourth item when ``carries`` are given (the graph's
        ``rnnTimeStep`` path). A training pass with ``remat_segments`` on,
        no carries and no masks runs :meth:`_forward_remat`."""
        env = get_environment()
        cdt = env.compute_dtype
        params = cast_floating(params, cdt)
        acts: Dict[str, Any] = {}
        for name, x in inputs.items():
            acts[name] = x.to(cdt) if x.is_floating_point() and x.dtype != cdt else x
        last_inputs: Dict[str, Any] = {}
        new_state = dict(model_state)
        pending: Dict[str, Any] = {}
        output_set = set(self.conf.outputs)
        if env.remat_segments and training and carries is None and masks is None:
            self._forward_remat(acts, last_inputs, new_state, pending, params, model_state,
                                generator, output_set)
            return acts, last_inputs, new_state
        if carries is not None:
            carries = dict(carries)
        for name in self.conf.topo_order:
            self._exec_node(name, acts, last_inputs, new_state, pending, params, model_state,
                            training=training, generator=generator, masks=masks,
                            output_set=output_set, carries=carries)
        if carries is not None:
            return acts, last_inputs, new_state, carries
        return acts, last_inputs, new_state

    def _remat_segments(self) -> List[List[str]]:
        """``topo_order`` cut into segments at single-tensor cut points (JAX
        ``:384-418``): after a node whose output is then the only value still
        live. In a ResNet the cuts land on the blocks' outputs, so a
        checkpointed segment keeps one boundary activation instead of every
        tensor inside the block. The tail segment (the output layers and
        their inputs, which the loss reads) is never rematerialized."""
        if self._remat_segs is not None:
            return self._remat_segs
        topo = self.conf.topo_order
        node_inputs = {n: list(self._nodes[n].inputs) for n in topo}
        last_use: Dict[str, int] = {}
        for idx, n in enumerate(topo):
            for t in node_inputs[n]:
                last_use[t] = idx
        inf = len(topo) + 1
        for o in self.conf.outputs:  # the outputs and their inputs feed the loss
            last_use[o] = inf
            for t in node_inputs.get(o, []):
                last_use[t] = inf
        live = {t for t in self.conf.inputs if last_use.get(t, -1) >= 0}
        segs: List[List[str]] = []
        cur: List[str] = []
        for idx, n in enumerate(topo):
            cur.append(n)
            live = {t for t in live if last_use.get(t, -1) > idx}
            if last_use.get(n, -1) > idx:
                live.add(n)
            if live == {n} and idx < len(topo) - 1:
                segs.append(cur)
                cur = []
        if cur:
            segs.append(cur)
        self._remat_segs = segs
        return segs

    def _forward_remat(self, acts, last_inputs, new_state, pending, params, model_state,
                       generator, output_set) -> None:
        """The training forward with each segment of two or more nodes
        (except the tail) run by :func:`~..runtime.rng.recomputed`
        (``torch.utils.checkpoint(use_reentrant=False)``), one call per
        segment (JAX ``_forward_remat``): only the segment's output (and the
        sums of a fused pair cut after its convolution) is kept; the
        backward pass runs the segment again, replaying the forward's random
        draws, and the layers' new state is taken from the first run only.
        A fused pair inside a recomputed segment launches ``conv_stats``
        once more."""
        segs = self._remat_segments()
        for k, seg in enumerate(segs):
            if k == len(segs) - 1 or len(seg) < 2:
                for n in seg:
                    self._exec_node(n, acts, last_inputs, new_state, pending, params,
                                    model_state, training=True, generator=generator,
                                    masks=None, output_set=output_set)
                continue
            seg_set = set(seg)
            ext = sorted({t for n in seg for t in self._nodes[n].inputs if t not in seg_set})
            pend_in = {n: pending.pop(n) for n in seg if n in pending}

            def seg_fn(*ext_acts, _seg=seg, _ext=ext, _pend=pend_in):
                a = dict(zip(_ext, ext_acts))
                li: Dict[str, Any] = {}
                ns: Dict[str, Any] = {}
                pend = dict(_pend)
                for n in _seg:
                    self._exec_node(n, a, li, ns, pend, params, model_state, training=True,
                                    generator=generator, masks=None, output_set=output_set)
                return a[_seg[-1]], ns, pend

            y, seg_state, pend_out = recomputed(seg_fn, *[acts[t] for t in ext])
            acts[seg[-1]] = y
            new_state.update(seg_state)
            pending.update(pend_out)

    def _loss(self, params, model_state, inputs, labels, generator=None, masks=None,
              training: bool = True, carries=None):
        """The sum of the output layers' losses (JAX ``:500-543``); returns
        ``(loss, new_state)``, and the new carries as a third item when
        ``carries`` are given. In training the forward and the losses see
        the weights perturbed by the layers' weight noise."""
        if training:
            params = self._perturbed(params, generator)
        out = self._forward_all(params, model_state, inputs, training=training,
                                generator=generator, masks=masks, carries=carries)
        acts, last_inputs, new_state = out[:3]
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
        if carries is not None:
            return total, new_state, out[3]
        return total, new_state

    # ------------------------------------------------------------------- fit
    def fit(self, data, labels=None, epochs: int = 1, prefetch_buffer: int = 0,
            profiler=None) -> "ComputationGraph":
        """``fit(iterator)``, ``fit(iterator, epochs=N)`` or ``fit(x, y)``
        (JAX ``:677-742``): ``x``/``y`` one array or tensor each, or lists of
        them for several inputs/outputs, taken as one batch. Tensors already
        on the graph's device are used where they lie. ``prefetch_buffer``
        and ``profiler`` as in ``MultiLayerNetwork.fit``."""
        self._ensure_init()
        if labels is not None:
            xs = list(data) if isinstance(data, (list, tuple)) else [data]
            ys = list(labels) if isinstance(labels, (list, tuple)) else [labels]
            batch = ({n: self._as_input(x) for n, x in zip(self.conf.inputs, xs)},
                     [self._as_input(y) for y in ys], None)
            iterator = [batch]
        else:
            iterator = data
        from deeplearning4j_tpu_torch.runtime.state_packing import (GroupedDispatch,
                                                                    PackedStepLoop)
        from deeplearning4j_tpu_torch.train.prefetch import (AsyncLossDelivery,
                                                             stateless_listeners)
        self._seed_device_generator()
        ploop = PackedStepLoop.for_network(self)
        if profiler is not None:
            profiler.start()
        # async loss readback (see MultiLayerNetwork._fit_epochs)
        adel = (AsyncLossDelivery(lambda _n, loss: self._iteration_done(loss),
                                  profiler=profiler)
                if (self._listeners or profiler is not None)
                and stateless_listeners(self) else None)
        sink = adel.submit if adel is not None else (lambda _n, loss: self._iteration_done(loss))
        gd = GroupedDispatch(
            unroll=(get_environment().dispatch_unroll if ploop.enabled else 1),
            compatible=_cg_group_compatible,
            run_single=lambda a: ploop.step(*a)[0],
            run_group=ploop.step_group,
            deliver=lambda args, loss: sink(None, loss))
        try:
            try:
                self._fit_epochs(iterator, int(epochs), ploop, gd,
                                 drain=(adel.flush if adel is not None else (lambda: None)),
                                 prefetch_buffer=int(prefetch_buffer), profiler=profiler)
            finally:
                gd.drain_on_error()
                if adel is not None:
                    adel.shutdown()  # never raises; original errors win
        finally:
            ploop.sync(release=True)
            if profiler is not None:
                profiler.stop()
        if adel is not None:
            adel.raise_pending()
        return self

    def _coerce_batch(self, batch, staged: bool = False):
        """A DataSet or MultiDataSet minibatch, or an already coerced
        ``(inputs, labels, masks)``, as tensors on the device (JAX
        ``:659-675``); ``staged`` as ``MultiLayerNetwork._coerce_batch``."""
        if isinstance(batch, tuple):
            return batch

        def dev(a):
            return self._as_input(a, staged)

        if isinstance(batch, MultiDataSet):
            masks = None
            if batch.labels_masks is not None:
                masks = {o: (None if m is None else dev(m))
                         for o, m in zip(self.conf.outputs, batch.labels_masks)}
            return ({n: dev(f) for n, f in zip(self.conf.inputs, batch.features)},
                    [dev(y) for y in batch.labels], masks)
        if not isinstance(batch, DataSet):
            raise NotImplementedError(f"fitting a ComputationGraph on {type(batch).__name__} "
                                      "is not ported to deeplearning4j_tpu_torch yet")
        masks = None
        if batch.labels_mask is not None:
            masks = {self.conf.outputs[0]: dev(batch.labels_mask)}
        return ({self.conf.inputs[0]: dev(batch.features)}, [dev(batch.labels)], masks)

    def _fit_epochs(self, iterator, epochs: int, ploop, gd, drain=lambda: None,
                    prefetch_buffer: int = 0, profiler=None) -> None:
        from deeplearning4j_tpu_torch.train.prefetch import batch_source
        from deeplearning4j_tpu_torch.train.profiler import submit_timed
        algo = self.conf.global_conf.optimization_algo
        for _ in range(epochs):
            for lst in self._listeners:
                lst.on_epoch_start(self, self._epoch)
            # the source resets, and iterating resets again, as JAX's fit does
            src = batch_source(iterator, self._coerce_batch, prefetch_buffer, profiler,
                               device=self.device,
                               staged_prepare=lambda b: self._coerce_batch(b, staged=True))
            try:
                for inputs, labels, masks in src:
                    if self.conf.tbptt_fwd_length and any(
                            is_sequence_array(v) for v in inputs.values()):
                        if algo != "STOCHASTIC_GRADIENT_DESCENT":
                            raise NotImplementedError(
                                f"tBPTT training with optimization_algo={algo!r} is not "
                                "supported; use SGD or full-sequence BPTT")
                        gd.flush()
                        drain()  # tBPTT notifies listeners inline (ordered)
                        ploop.sync(release=True)
                        self._fit_tbptt(inputs, labels, masks)
                        continue
                    if algo != "STOCHASTIC_GRADIENT_DESCENT":
                        from deeplearning4j_tpu_torch.train.solvers import graph_solver_fit_batch
                        gd.flush()
                        ploop.sync(release=True)  # the solver writes the parameters
                        loss = graph_solver_fit_batch(self, inputs, labels, masks)
                        gd._deliver((inputs, labels, None, masks), loss)  # same bookkeeping
                        continue
                    submit_timed(gd, (inputs, labels, self._step_generator(), masks),
                                 profiler)
            finally:
                src.close()
            gd.flush()
            drain()  # on_epoch_end must observe every iteration_done
            for lst in self._listeners:
                lst.on_epoch_end(self, self._epoch)
            self._epoch += 1

    def _train_step(self, inputs, labels, masks, generator=None, carries=None):
        """One step: loss, gradients of the float parameters (those of
        frozen layers excepted) through the compute-dtype cast, the
        optimizer's update in place, and the layers' new state copied into
        the old (in place, as a captured step needs). Returns the detached
        loss, and the new carries too when ``carries`` are given."""
        optimizer = self._ensure_optimizer()
        leaves = tree_leaves(self._params)
        trained = trained_leaves(self._params, [n.name for n in self.conf.nodes
                                                if n.kind == "layer" and n.obj.frozen])
        for t in trained:
            t.requires_grad_(True)
        try:
            out = self._loss(
                self._params, self._model_state, inputs, labels,
                generator if generator is not None else self.rng.next_generator(), masks,
                carries=carries)
            grads = torch.autograd.grad(out[0], trained, allow_unused=True)
        finally:
            for t in trained:
                t.requires_grad_(False)
        optimizer.step(self._params, leaf_gradients(self._params, leaves, trained, grads))
        self._apply_constraints()
        self._model_state = assign_state(self._model_state, out[1])
        if carries is not None:
            return out[0].detach(), out[2]
        return out[0].detach()

    def _fit_tbptt(self, inputs, labels, masks) -> None:
        """Truncated BPTT on the graph (JAX ``:611-657``): the time axis in
        ``tbptt_fwd_length`` windows, every recurrent layer's carry handed
        from one window to the next with the gradient cut; eager, one step
        and one listener call a window. Labels with a time axis and masks of
        the sequence's length are windowed too."""
        L = int(self.conf.tbptt_fwd_length)
        seqs = [v for v in inputs.values() if is_sequence_array(v)]
        T = max(v.shape[1] for v in seqs)
        first = next(iter(inputs.values()))
        carries = self._zero_carries(first.shape[0],
                                     carry_dtype(first, get_environment().compute_dtype))
        for t0 in range(0, T, L):
            ci = {k: slice_time(v, t0, L) for k, v in inputs.items()}
            cl = [y[:, t0:t0 + L] if y.dim() == 3 else y for y in labels]
            cm = None if masks is None else {
                k: (m[:, t0:t0 + L] if m is not None and m.dim() >= 2 and m.shape[1] == T
                    else m) for k, m in masks.items()}
            loss, carries = self._train_step(ci, cl, cm, generator=self._step_generator(),
                                             carries=carries)
            carries = tree_map(lambda t: t.detach(), carries)
            self._iteration_done(loss)

    # ------------------------------------------------------------- runtime
    def _train_step_fn(self):
        """The step the packed loop dispatches: ``(inputs, labels,
        generator, masks) -> loss``, the state updated in place."""
        fn = self._runtime_cache.get("__step__")
        if fn is None:
            # a weak reference: the network's own cache must not keep it
            # alive in a cycle (its graphs would then die whenever the
            # cyclic collector runs, not when the network is dropped)
            net = weakref.ref(self)

            def fn(inputs, labels, generator, masks):
                return net()._train_step(inputs, labels, masks, generator=generator)
            self._runtime_cache["__step__"] = fn
        return fn

    def _replica_loss(self, params, args, generator):
        """One replica's training loss, for the sharded step of
        ``parallel/sharding.py``: ``args`` are ``(inputs, labels, masks)``
        on the replica's device; returns ``(loss, new_state)``."""
        inputs, labels, masks = args
        return self._loss(params, self._model_state, inputs, labels, generator, masks)

    _state_tree = MultiLayerNetwork._state_tree
    _set_state_tree = MultiLayerNetwork._set_state_tree
    _seed_device_generator = MultiLayerNetwork._seed_device_generator
    _device_generators = MultiLayerNetwork._device_generators
    _step_generator = MultiLayerNetwork._step_generator

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

    def _coerce_inputs(self, inputs) -> Dict[str, torch.Tensor]:
        """A dict by input name, one array (a single-input graph), or a
        list/tuple zipped against ``conf.inputs`` (JAX ``:831-843``), as
        tensors on the graph's device."""
        if isinstance(inputs, dict):
            return {k: self._as_input(v) for k, v in inputs.items()}
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != len(self.conf.inputs):
                raise ValueError(f"graph has {len(self.conf.inputs)} inputs "
                                 f"{self.conf.inputs}; got {len(inputs)} arrays")
            return {n: self._as_input(v) for n, v in zip(self.conf.inputs, inputs)}
        return {self.conf.inputs[0]: self._as_input(inputs)}

    def _external_vjp(self, inputs, epsilons, generator):
        """The training forward of ``inputs`` (dropout and weight noise from
        ``generator``, none without one) and its vjp with ``epsilons`` =
        dL/dOutput per output: ``(param_grads, {input: dL/dInput},
        new_state)``, the gradients nested as the parameters; an input
        that is not floating (token ids) has no gradient."""
        inputs = {k: v.detach() for k, v in self._coerce_inputs(inputs).items()}
        if not isinstance(epsilons, (list, tuple)):
            epsilons = [epsilons]
        leaves = tree_leaves(self._params)
        trained = [t for t in leaves if t.is_floating_point()]
        float_in = [k for k, v in inputs.items() if v.is_floating_point()]
        for t in trained:
            t.requires_grad_(True)
        for k in float_in:
            inputs[k].requires_grad_(True)
        try:
            acts, _, new_state = self._forward_all(
                self._perturbed(self._params, generator), self._model_state, inputs,
                training=True, generator=generator)
            outs = [acts[o] for o in self.conf.outputs]
            eps = [self._as_input(e).to(o.dtype) for e, o in zip(epsilons, outs)]
            wrt = trained + [inputs[k] for k in float_in]
            grads = list(torch.autograd.grad(outs, wrt, grad_outputs=eps, allow_unused=True))
        finally:
            for t in trained:
                t.requires_grad_(False)
        g_in = {k: (g if g is not None else torch.zeros_like(inputs[k])).detach()
                for k, g in zip(float_in, grads[len(trained):])}
        return (leaf_gradients(self._params, leaves, trained, grads[:len(trained)]), g_in,
                new_state)

    def backprop_gradient(self, inputs, epsilons):
        """Reference external-errors mode (JAX ``:845-868``): given
        dL/dOutput for each output, computed outside the graph, the
        ``(param_gradients, {input_name: dL/dInput})`` of a training forward
        without dropout. No update."""
        self._ensure_init()
        gp, g_in, _ = self._external_vjp(inputs, epsilons, None)
        return gp, g_in

    def fit_external(self, inputs, epsilons):
        """An external-errors training step (JAX ``:870-900``): backprop the
        output cotangents through a training forward (dropout, weight noise)
        and apply the configured updater; the layers' new state replaces the
        old. Returns ``{input_name: dL/dInput}``."""
        self._ensure_init()
        optimizer = self._ensure_optimizer()
        gp, g_in, new_state = self._external_vjp(inputs, epsilons, self.rng.next_generator())
        optimizer.step(self._params, gp)
        self._model_state = assign_state(self._model_state,
                                         tree_map(lambda t: t.detach(), new_state))
        self._iteration += 1
        return g_in

    def _zero_carries(self, batch: int, dtype) -> Dict[str, Any]:
        return {n.name: n.obj.init_carry(batch, dtype, self.device)
                for n in self.conf.nodes
                if n.kind == "layer" and isinstance(n.obj, BaseRecurrentLayer)}

    def _rnn_step(self, carries, inputs):
        """One chunk of inference from ``carries``: ``(out, new_carries)``,
        the output as :meth:`output` gives it."""
        with torch.inference_mode():
            acts, _, _, new_carries = self._forward_all(
                self._params, self._model_state, inputs, training=False, carries=carries)
            outs = [acts[o] for o in self.conf.outputs]
        return (outs[0] if len(outs) == 1 else outs), new_carries

    def _stream_inputs(self, xs):
        inputs = {n: self._as_input(x) for n, x in zip(self.conf.inputs, xs)}
        first = next(iter(inputs.values()))
        return inputs, first.shape[0], carry_dtype(first, get_environment().compute_dtype)

    def rnn_time_step(self, *xs):
        """Stateful inference (reference ``ComputationGraph.rnnTimeStep``,
        JAX ``:902-919``): one chunk per input, the recurrent state carried
        across calls until :meth:`rnn_clear_previous_state`."""
        self._ensure_init()
        inputs, batch, dt = self._stream_inputs(xs)
        if self._rnn_carries is None:
            self._rnn_carries = self._zero_carries(batch, dt)
        out, self._rnn_carries = self._rnn_step(self._rnn_carries, inputs)
        return out

    def rnn_time_step_external(self, *xs, state):
        """Pure-functional ``rnnTimeStep``: advance ``state`` (from
        :meth:`rnn_get_state`/:meth:`rnn_zero_state`, or ``None`` for a
        fresh stream) by one chunk without touching the stored state.
        Returns ``(out, new_state)``."""
        self._ensure_init()
        inputs, batch, dt = self._stream_inputs(xs)
        if state is None:
            state = self._zero_carries(batch, dt)
        else:
            state = tree_map(lambda t: torch.as_tensor(t).to(self.device), state)
        return self._rnn_step(state, inputs)

    def rnn_clear_previous_state(self) -> None:
        self._rnn_carries = None

    def rnn_get_state(self):
        """Copy of the stored recurrent state: ``{node: carry}`` of CPU
        tensors in the carries' own dtypes, or ``None``. Round-trips
        exactly through :meth:`rnn_set_state`."""
        if self._rnn_carries is None:
            return None
        return tree_map(lambda t: t.detach().to("cpu", copy=True), self._rnn_carries)

    def rnn_set_state(self, state) -> None:
        """Install a state from :meth:`rnn_get_state` (tensors or numpy
        arrays); ``None`` clears."""
        self._ensure_init()
        self._rnn_carries = (None if state is None else
                             tree_map(lambda t: torch.as_tensor(t).to(self.device), state))

    def rnn_zero_state(self, batch: int, like=None):
        """Fresh zero state for a ``batch``-row stream; ``like`` (an example
        input) pins the carry dtype as the stateful path does."""
        self._ensure_init()
        dt = (get_environment().compute_dtype if like is None else
              carry_dtype(self._as_input(like), get_environment().compute_dtype))
        return self._zero_carries(batch, dt)

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

    def save(self, path: str, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        ModelSerializer.write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path: str, device=None) -> "ComputationGraph":
        from deeplearning4j_tpu_torch.models.serializer import ModelSerializer
        return ModelSerializer.restore_computation_graph(path, device=device)
