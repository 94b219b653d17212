"""TF GraphDef import.

Counterpart of ``deeplearning4j_tpu/imports/tf_import.py`` (upstream
``org.nd4j.imports.graphmapper.tf.TFGraphMapper``): parse a frozen
GraphDef, constant-fold its ``Const`` nodes, map each node onto a registry
op of the port's :class:`~..autodiff.samediff.SameDiff`. The mapping is the
JAX package's, node for node and attr for attr, so both importers give the
same op list: static-attr folding of Const inputs (TF passes shapes and
axes as tensors; they become op attrs at import), inlined
``(Stateful)PartitionedCall`` bodies, functional ``While``/``If`` (and
their ``Stateless`` forms) onto ``sd.while_loop``/``sd.cond`` (the masked
fixed-length form under ``while_max_iterations``), TF1 while frames
(Enter/Merge/Switch/NextIteration/Exit) and TF1 Switch/Merge conditionals
(lazy ``sd.cond`` or the execute-both ``where`` form), then
``graph_optimizer.optimize``.

Where the JAX package parses with tensorflow and decodes tensors with
``MakeNdarray``, the port reads the protobuf itself
(:mod:`.graphdef_proto`), so an import runs where tensorflow is absent (the
card's machine). A ``str`` or ``bytes`` argument is a path; a parsed
GraphDef is the reader's :class:`~.graphdef_proto.Message` or a
tensorflow ``GraphDef`` (read through its ``SerializeToString()``).
Constants and placeholders live on ``device``: the environment's (CUDA
unless the caller asks for the CPU) when it is not given.
``import_saved_model`` freezes a SavedModel with tensorflow, and raises an
``ImportError`` naming it where tensorflow is absent.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.imports.graphdef_proto import (DTYPE_NAMES, Message,
                                                             as_graph_def, make_ndarray,
                                                             tensor_proto)


def _node(name: str, op: str, inputs=(), attr=None) -> Message:
    return Message("NodeDef", name=name, op=op, input=list(inputs), attr=dict(attr or {}))


def _subgraph(library, nodes) -> Message:
    return Message("GraphDef", node=list(nodes), library=library)


class TFGraphMapper:
    @staticmethod
    def import_graph(path_or_graphdef, input_shapes: Optional[Dict[str, tuple]] = None,
                     optimize: bool = True,
                     while_max_iterations: Optional[int] = None,
                     lazy_conditionals: bool = True, device=None) -> SameDiff:
        """Import a frozen .pb file (or a GraphDef proto) into a SameDiff.
        ``optimize`` runs the graph-optimizer fusion passes (layernorm/gelu
        patterns -> fused ops). ``while_max_iterations``: when set, every
        imported While loop (functional or TF1 frames) lowers to
        ``max_iterations`` steps masked by the predicate instead of a
        Python loop to the predicate's end: that form is differentiable,
        so graphs containing loops can be fine-tuned with ``sd.fit`` (the
        open loop is forward-only, as in JAX). ``lazy_conditionals``: TF1
        Switch/Merge conditionals lower onto ``sd.cond`` (only the taken
        branch executes); pass False for the execute-both + where form,
        which keeps the graph free of Python callables — required if the
        imported graph must round-trip ``sd.save()``. ``device``: where
        the constants and placeholders live (the environment's device when
        None)."""
        gd = as_graph_def(path_or_graphdef)
        imp = _GraphImporter(gd, input_shapes or {}, device=device)
        imp.while_max_iterations = while_max_iterations
        imp.lazy_conditionals = lazy_conditionals
        sd = imp.run()
        if optimize:
            from deeplearning4j_tpu_torch.autodiff.graph_optimizer import optimize as _opt
            _opt(sd)
        return sd

    @staticmethod
    def import_saved_model(path: str, signature: str = "serving_default",
                           input_shapes: Optional[Dict[str, tuple]] = None,
                           optimize: bool = True, device=None):
        """Load a TF2 SavedModel, freeze the named signature, import it
        (same pipeline as :meth:`import_graph`, optimizer passes included).
        Returns ``(sd, input_names, output_names)``. Freezing a SavedModel
        runs tensorflow: without it this raises ``ImportError``."""
        try:
            import tensorflow as tf
            from tensorflow.python.framework.convert_to_constants import (
                convert_variables_to_constants_v2)
        except ImportError as e:
            raise ImportError(
                "TFGraphMapper.import_saved_model needs tensorflow to load and freeze "
                "a SavedModel; freeze it where tensorflow is installed and pass the "
                "frozen GraphDef to import_graph") from e
        sm = tf.saved_model.load(path)
        fn = sm.signatures[signature]
        frozen = convert_variables_to_constants_v2(fn)
        gd = frozen.graph.as_graph_def()
        sd = TFGraphMapper.import_graph(gd, input_shapes, optimize=optimize, device=device)
        inputs = [t.name.split(":")[0] for t in frozen.inputs
                  if t.dtype != tf.resource]
        outputs = [t.name.split(":")[0] for t in frozen.outputs]
        return sd, inputs, outputs


def _flatten_ref(ref: str) -> str:
    """FunctionDef input ref ('node:tag:idx', 'node:idx' or 'arg') to
    top-level GraphDef form ('node' / 'node:idx')."""
    ctrl = ref.startswith("^")
    if ctrl:
        ref = ref[1:]
    parts = ref.split(":")
    if len(parts) == 1:
        out = parts[0]
    else:
        idx = parts[-1]
        out = parts[0] if idx == "0" or not idx.isdigit() else f"{parts[0]}:{idx}"
    return ("^" + out) if ctrl else out


class _GraphImporter:
    def __init__(self, graph_def, input_shapes: Dict[str, tuple], device=None):
        self.gd = graph_def
        self.input_shapes = input_shapes
        self.device = device
        self.sd = SameDiff.create(device)
        self.const_values: Dict[str, np.ndarray] = {}
        self.node_by_name = {n.name: n for n in self.gd.node}
        # TF2 function library (While/If bodies, PartitionedCall targets)
        self.functions = {f.signature.name: f
                          for f in graph_def.library.function}
        self._switch_pred: Dict[str, str] = {}   # Switch node -> pred ref
        self._switch_memo: Dict[str, Optional[tuple]] = {}
        self._consumers: Optional[Dict[str, list]] = None  # lazy fwd edges
        # TF1 while frames: nodes consumed by a lowered frame are skipped
        # by the per-node loop (the frame's cond/body are re-imported as
        # standalone subgraphs feeding sd.while_loop)
        self._frame_consumed: set = set()
        # opt-in: lower While loops to fixed-length differentiable scans
        self.while_max_iterations: Optional[int] = None
        # TF1 Switch/Merge conds -> sd.cond (lazy); False = where-select
        # (keeps the graph serializable via sd.save)
        self.lazy_conditionals: bool = True

    # --- helpers ---
    @staticmethod
    def _clean(name: str) -> str:
        name = name.split(":")[0]
        return name[1:] if name.startswith("^") else name

    def _const(self, name: str) -> np.ndarray:
        """Resolve a (possibly Identity-wrapped) constant input's value."""
        name = self._clean(name)
        if name in self.const_values:
            return self.const_values[name]
        node = self.node_by_name.get(name)
        if node is not None and node.op in ("Identity", "Cast", "StopGradient"):
            return self._const(node.input[0])
        raise ValueError(f"Input {name!r} is not a constant (op="
                         f"{node.op if node else '?'}) — cannot fold statically")

    def _attr(self, node, key, default=None):
        if key not in node.attr:
            return default
        a = node.attr[key]
        kind = a.which_oneof()
        if kind == "i":
            return int(a.i)
        if kind == "f":
            return float(a.f)
        if kind == "b":
            return bool(a.b)
        if kind == "s":
            return a.s.decode()
        if kind == "type":
            return DTYPE_NAMES.get(int(a.type), str(a.type))
        if kind == "shape":
            return tuple(d.size for d in a.shape.dim)
        if kind == "list":
            return list(a.list.i) or list(a.list.f) or [s.decode() for s in a.list.s]
        return default

    def _tf_seed(self, node) -> int:
        """Stream seed for a TF random node. Seeded ops keep their (seed,
        seed2) pair; unseeded ops (seed=seed2=0, TF draws nondeterministic)
        get a stable per-node stream from the node name, so two dropout
        sites never share draws while the import stays reproducible. For
        stateless ops the seed/key operand joins the hash when constant."""
        s1 = int(self._attr(node, "seed", 0) or 0)
        s2 = int(self._attr(node, "seed2", 0) or 0)
        if s1 or s2:
            return (s1 * 2654435761 + s2) & 0x7FFFFFFF
        h = zlib.crc32(node.name.encode())
        if node.op.startswith("Stateless") and len(node.input) > 1:
            try:
                h ^= zlib.crc32(np.ascontiguousarray(
                    self._const(node.input[1])).tobytes())
            except ValueError:
                pass
        return h & 0x7FFFFFFF

    def _ensure_var(self, name: str) -> str:
        """Map a TF input ref to an sd variable name (materialising consts)."""
        raw = name[1:] if name.startswith("^") else name
        if raw in self.sd.vars:
            return raw  # exact match, incl. multi-output refs like "while:1"
        name = self._clean(name)
        if name in self.sd.vars:
            return name
        if name in self.const_values:
            arr = self.const_values[name]
            v = self.sd.constant(name, arr)
            # constant() may uniquify; force exact name mapping
            if v.name != name:
                v.rename(name)
            return name
        raise ValueError(f"Unresolved input {name!r}")

    def _emit(self, node, op: str, inputs: List[str], **attrs):
        vars_ = [self.sd.vars[self._ensure_var(i)] for i in inputs]
        out = self.sd._apply(op, vars_, attrs=attrs or None, name=node.name)
        if out.name != node.name:
            out.rename(node.name)
        return out

    # --- main loop ---
    def run(self) -> SameDiff:
        for node in self.gd.node:
            if node.op == "Const":
                self.const_values[node.name] = make_ndarray(node.attr["value"].tensor)
        for node in self.gd.node:
            self._map_node(node)
        return self.sd

    def _inputs(self, node) -> List[str]:
        return [i for i in node.input if not i.startswith("^")]

    def _controlling_switch(self, ref: str) -> Optional[tuple]:
        """Walk ancestors of ``ref`` to the nearest Switch; returns
        (switch_name, taken_output_index) or None."""
        if ref in self._switch_memo:
            return self._switch_memo[ref]
        self._switch_memo[ref] = None  # cycle guard
        ref2 = ref[1:] if ref.startswith("^") else ref
        name, _, idx = ref2.partition(":")
        node = self.node_by_name.get(name)
        res = None
        if node is not None:
            if node.op == "Switch":
                res = (name, int(idx) if idx else 0)
            else:
                for i in self._inputs(node):
                    res = self._controlling_switch(i)
                    if res:
                        break
        self._switch_memo[ref] = res
        return res

    def _name_outputs(self, node, outs) -> None:
        """Rename emitted vars to TF's multi-output convention
        (``name``, ``name:1``, ...)."""
        for i, o in enumerate(outs):
            want = node.name if i == 0 else f"{node.name}:{i}"
            if o.name != want:
                o.rename(want)

    # ---- TF2 function library support ----
    def _inline_call(self, node, fname: str, ins: List[str]) -> None:
        """Inline a (Stateful)PartitionedCall: splice the FunctionDef body
        into this graph under the call node's name prefix (the reference
        inlines function graphs the same way before mapping)."""
        fdef = self.functions.get(fname)
        if fdef is None:
            raise NotImplementedError(f"Call to unknown function {fname!r}")
        prefix = node.name
        arg_map = {arg.name: caller_in
                   for arg, caller_in in zip(fdef.signature.input_arg, ins)}

        def rewrite(ref: str) -> str:
            ctrl = ref.startswith("^")
            flat = _flatten_ref(ref)
            if ctrl:
                flat = flat[1:]
            base, _, idx = flat.partition(":")
            mapped = arg_map.get(base, f"{prefix}/{base}")
            out = mapped if not idx else f"{mapped}:{idx}"
            return ("^" + out) if ctrl else out

        new_nodes = []
        for nd in fdef.node_def:
            cp = nd.copy()
            cp.name = f"{prefix}/{nd.name}"
            cp.input = [rewrite(r) for r in nd.input]
            new_nodes.append(cp)
        for nd in new_nodes:
            self.node_by_name[nd.name] = nd
            if nd.op == "Const":
                self.const_values[nd.name] = make_ndarray(nd.attr["value"].tensor)
        for nd in new_nodes:
            self._map_node(nd)
        # alias the call's outputs to the body's return values
        for j, out_arg in enumerate(fdef.signature.output_arg):
            src = rewrite(fdef.ret[out_arg.name])
            want = node.name if j == 0 else f"{node.name}:{j}"
            self._alias(want, src)

    def _alias(self, want: str, src: str) -> None:
        src = self._clean(src) if ":" not in src or src.split(":")[-1] == "0" \
            else src
        if src in self.const_values and src not in self.sd.vars:
            self.const_values[want] = self.const_values[src]
            return
        v = self.sd._apply("identity", [self.sd.vars[self._ensure_var(src)]],
                           name=want)
        if v.name != want:
            v.rename(want)

    def _function_subgraph(self, fname: str):
        """Materialise a FunctionDef as a standalone GraphDef + import it;
        returns (sub_sd, input_names, output_names)."""
        fdef = self.functions.get(fname)
        if fdef is None:
            raise NotImplementedError(f"Unknown function {fname!r}")
        nodes = []
        input_names = []
        for arg in fdef.signature.input_arg:
            nodes.append(_node(arg.name, "Placeholder",
                               attr={"dtype": Message("AttrValue", type=arg.type)}))
            input_names.append(arg.name)
        for body_node in fdef.node_def:
            cp = body_node.copy()
            cp.input = [_flatten_ref(r) for r in body_node.input]
            nodes.append(cp)
        output_names = [_flatten_ref(fdef.ret[o.name])
                        for o in fdef.signature.output_arg]
        # the library rides along, so nested calls resolve too
        sub_sd = _GraphImporter(_subgraph(self.gd.library, nodes), {}, self.device).run()
        return sub_sd, input_names, output_names

    def _function_callable(self, fname: str):
        """FunctionDef -> Python callable on tensors (feeds sd.while_loop /
        sd.cond). Accepts an optional per-step ``key`` (a generator) so
        stochastic ops INSIDE control-flow bodies (dropout in a While body,
        training=True) stay live during sd.fit: the sub-graph's stochastic
        ops draw from it."""
        sub_sd, in_names, out_names = self._function_subgraph(fname)

        def fn(*arrays, key=None):
            env = dict(sub_sd.arrays)
            env.update(zip(in_names, arrays))
            if key is not None:
                env["__rng__"] = key
            return sub_sd._exec_graph(env, out_names)

        fn._accepts_rng = True
        return fn

    # ---- TF1 lowered tf.cond (Switch/Merge dataflow) → lazy sd.cond ----
    def _forward_reachable(self, roots) -> set:
        """Node names forward-reachable from ``roots`` along data/control
        edges — the region a Switch can gate."""
        if self._consumers is None:
            cons: Dict[str, list] = {}
            for n in self.gd.node:
                for i in n.input:
                    cons.setdefault(self._clean(i), []).append(n.name)
            self._consumers = cons
        seen: set = set()
        stack = list(roots)
        while stack:
            nm = stack.pop()
            if nm in seen:
                continue
            seen.add(nm)
            stack.extend(self._consumers.get(nm, ()))
        return seen

    def _cond_branch_callable(self, root_ref: str, switches: set, reach: set):
        """Backward-slice ONE tf.cond branch from a Merge input and build a
        callable for it: the branch subgraph is re-imported standalone and
        lowered onto ``sd.cond``. Boundaries become Placeholders: a branch
        Switch is fed by its data input (computed unconditionally, as TF's
        Switch inputs run before the branch), and any value produced
        outside the Switch-gated region is fed as-is. Returns ``(fn,
        feed_refs)`` where ``feed_refs[i]`` is the outer-graph ref
        supplying operand i."""
        stops: Dict[str, str] = {}   # canonical boundary ref -> placeholder
        feeds: list = []             # outer feed ref per placeholder
        interior: Dict[str, Any] = {}
        inline_consts: Dict[str, np.ndarray] = {}

        def canon(ref: str):
            """(key, feed) for a boundary ref, or None if interior."""
            base = self._clean(ref)
            if base in switches:
                # both Switch outputs carry the same data value
                return base, self.node_by_name[base].input[0]
            if base not in reach and base not in inline_consts:
                flat = _flatten_ref(ref[1:] if ref.startswith("^") else ref)
                return flat, flat
            return None

        stack = [root_ref]
        while stack:
            ref = stack.pop()
            if ref.startswith("^"):
                continue  # ordering-only edges; graphs here are pure
            base = self._clean(ref)
            if base in switches:
                if base not in stops:
                    stops[base] = f"__cb_{len(stops)}"
                    feeds.append(self.node_by_name[base].input[0])
                continue
            if base not in reach:
                if base in inline_consts:
                    continue
                # Outside-region constants are INLINED into the branch
                # subgraph (not fed as operands): branch ops that
                # static-fold an operand — Mean/Reshape axes, shapes —
                # must still see a Const, not a Placeholder.
                try:
                    inline_consts[base] = self._const(ref)
                    continue
                except ValueError:
                    pass
                flat = _flatten_ref(ref)
                if flat not in stops:
                    stops[flat] = f"__cb_{len(stops)}"
                    feeds.append(flat)
                continue
            if base in interior:
                continue
            node = self.node_by_name.get(base)
            if node is None:
                raise NotImplementedError(
                    f"cond branch references unknown node {base!r}")
            interior[base] = node
            stack.extend(node.input)

        # topo-sort the slice (sub-importer maps in list order); a nested
        # while frame's Merge <- NextIteration back-edge is dropped, as in
        # the frame machinery — the sub-importer re-discovers the loop
        def _deps(n):
            out = []
            for d in (self._clean(i) for i in n.input):
                if d not in interior:
                    continue
                if n.op == "Merge" and \
                        self.node_by_name[d].op == "NextIteration":
                    continue
                out.append(d)
            return out

        deps = {nm: _deps(n) for nm, n in interior.items()}
        done: set = set()
        order: list = []

        def visit(nm, chain=()):
            if nm in done:
                return
            if nm in chain:
                raise NotImplementedError(
                    f"cycle through {nm!r} in cond branch slice")
            for d in deps[nm]:
                visit(d, chain + (nm,))
            done.add(nm)
            order.append(interior[nm])

        for nm in interior:
            visit(nm)

        nodes = [_node(ph, "Placeholder") for ph in stops.values()]
        for cname, cval in inline_consts.items():
            tp = tensor_proto(cval)
            nodes.append(_node(cname, "Const", attr={
                "value": Message("AttrValue", tensor=tp),
                "dtype": Message("AttrValue", type=tp.dtype)}))
        for node in order:
            cp = node.copy()
            cp.input = []
            for ref in node.input:
                if ref.startswith("^"):
                    if self._clean(ref) in interior:
                        cp.input.append(ref)
                    continue
                cb = canon(ref)
                cp.input.append(stops[cb[0]] if cb is not None else ref)
            nodes.append(cp)
        cb = canon(root_ref)
        out_ref = stops[cb[0]] if cb is not None else _flatten_ref(root_ref)
        sub_sd = _GraphImporter(_subgraph(self.gd.library, nodes), {}, self.device).run()
        ph_names = list(stops.values())

        def fn(*arrays, key=None):
            env = dict(sub_sd.arrays)
            env.update(zip(ph_names, arrays))
            if key is not None:
                env["__rng__"] = key
            return sub_sd._exec_graph(env, [out_ref])[0]

        fn._accepts_rng = True
        return fn, feeds

    def _lower_cond_merge(self, node, true_ref: str, false_ref: str,
                          pred_ref: str) -> None:
        """Lower one matched Switch/Merge conditional onto ``sd.cond``:
        only the taken branch executes, unlike the
        execute-both + ``where`` form. The branch nodes eagerly mapped
        before this Merge was reached become dead code — ``_exec_graph``
        is demand-driven and never computes them."""
        sd = self.sd
        pflat = _flatten_ref(pred_ref)
        switches = {s for s, p in self._switch_pred.items()
                    if _flatten_ref(p) == pflat}
        reach = self._forward_reachable(switches)
        tfn, tfeeds = self._cond_branch_callable(true_ref, switches, reach)
        ffn, ffeeds = self._cond_branch_callable(false_ref, switches, reach)
        feeds = list(dict.fromkeys(tfeeds + ffeeds))
        t_idx = [feeds.index(r) for r in tfeeds]
        f_idx = [feeds.index(r) for r in ffeeds]

        def true_fn(*a, key=None):
            return tfn(*[a[i] for i in t_idx], key=key)

        def false_fn(*a, key=None):
            return ffn(*[a[i] for i in f_idx], key=key)

        true_fn._accepts_rng = True
        false_fn._accepts_rng = True
        out = sd.cond(sd.vars[self._ensure_var(pred_ref)], true_fn, false_fn,
                      *[sd.vars[self._ensure_var(r)] for r in feeds],
                      name=node.name)
        if out.name != node.name:
            out.rename(node.name)

    # ---- TF1 while-loop frames (Enter/Merge/Switch/NextIteration/Exit) ----
    def _extract_frame_subgraph(self, roots: List[str], stops: Dict[str, str],
                                frame_nodes: set):
        """Backward-slice the main graph from ``roots``, stopping at names
        in ``stops`` (ref base name -> placeholder name). Returns
        (interior node list in graph order, used stop names)."""
        interior, used, seen = [], set(), set()
        stack = [self._clean(r) for r in roots]
        while stack:
            name = stack.pop()
            if name in seen:
                continue
            seen.add(name)
            if name in stops:
                used.add(name)
                continue
            node = self.node_by_name.get(name)
            if node is None:
                continue
            # Frame ops reached here belong to a NESTED while (the current
            # frame's own Merge/Switch/Enter are stop points): include the
            # whole inner frame in the slice — the sub-importer lowers it
            # recursively when it meets the inner Enter. Same-frame ops
            # reached outside the carry chain are malformed and will hit
            # the sub-importer's orphan-frame-op check.
            interior.append(node)
            frame_nodes.add(name)
            stack.extend(self._clean(i) for i in node.input)
        # TOPO-sort the slice: graphs lowered from functional control flow
        # (convert_variables_to_constants_v2 lowers While to v1 frames) are
        # NOT topologically ordered, and the sub-importer maps nodes in
        # list order
        names = {n.name for n in interior}

        def _deps(n):
            out = []
            for d in (self._clean(i) for i in n.input):
                if d not in names:
                    continue
                # a nested frame's Merge <- NextIteration edge is the
                # loop's back-edge; dropping it makes the slice acyclic
                # (the sub-importer re-discovers the loop structure)
                if n.op == "Merge" and \
                        self.node_by_name[d].op == "NextIteration":
                    continue
                out.append(d)
            return out

        deps = {n.name: _deps(n) for n in interior}
        done, out_order, nodes_by = set(), [], {n.name: n for n in interior}
        def visit(nm, chain=()):
            if nm in done:
                return
            if nm in chain:
                raise NotImplementedError(
                    f"cycle through {nm!r} in frame slice")
            for d in deps[nm]:
                visit(d, chain + (nm,))
            done.add(nm)
            out_order.append(nodes_by[nm])
        for n in interior:
            visit(n.name)
        return out_order, used

    def _frame_subgraph_callable(self, roots: List[str],
                                 stops: Dict[str, str], frame_nodes: set):
        """Build a callable for a frame's cond or body slice: stop points
        become Placeholders fed by the loop carries, interior nodes are
        re-imported as a standalone graph."""
        interior, _ = self._extract_frame_subgraph(roots, stops, frame_nodes)
        nodes = [_node(ph, "Placeholder") for ph in stops.values()]
        for node in interior:
            cp = node.copy()
            cp.input = []
            nodes.append(cp)
            for ref in node.input:
                if ref.startswith("^"):
                    base = self._clean(ref)
                    if base in stops or base not in {n.name for n in interior}:
                        continue  # control dep to outside the slice
                    cp.input.append(ref)
                    continue
                base, _, idx = ref.partition(":")
                if base in stops:
                    cp.input.append(stops[base])
                else:
                    cp.input.append(ref)
        out_refs = []
        for r in roots:
            base, _, idx = r.partition(":")
            out_refs.append(stops.get(base, r) if base in stops else r)
        sub_sd = _GraphImporter(_subgraph(self.gd.library, nodes), {}, self.device).run()
        ph_names = [stops[b] for b in stops]

        def fn(*arrays, key=None):
            env = dict(sub_sd.arrays)
            env.update(zip(ph_names, arrays))
            if key is not None:
                env["__rng__"] = key
            return sub_sd._exec_graph(env, out_refs)

        fn._accepts_rng = True
        return fn, list(stops)

    def _lower_tf1_frame(self, frame: str) -> None:
        """Reconstruct one TF1 while frame and lower it onto
        ``sd.while_loop`` (upstream ``TFGraphMapper`` + SameDiff frame ops;
        SURVEY.md §3.3). Carries = Merge chains; loop-invariant Enters ride
        along as carries the body returns unchanged. The default lowering
        runs to the predicate's end (forward-only, like the functional
        While path); pass ``while_max_iterations`` to ``import_graph`` for
        the differentiable fixed-length form."""
        enters = [n for n in self.gd.node
                  if n.op == "Enter" and self._attr(n, "frame_name") == frame]
        enter_names = {n.name for n in enters}
        merges = {}
        for n in self.gd.node:
            if n.op == "Merge":
                ins = self._inputs(n)
                if ins and any(self._clean(i) in enter_names for i in ins):
                    merges[n.name] = n
        if not merges:
            raise NotImplementedError(
                f"TF1 frame {frame!r}: Enter nodes without Merge carries")
        switches = {}
        loopcond_name = None
        for n in self.gd.node:
            if n.op == "Switch":
                ins = self._inputs(n)
                if len(ins) == 2 and self._clean(ins[0]) in merges:
                    switches[self._clean(ins[0])] = n
                    loopcond_name = self._clean(ins[1])
        if loopcond_name is None:
            raise NotImplementedError(
                f"TF1 frame {frame!r}: no Switch keyed on a LoopCond")
        loopcond = self.node_by_name[loopcond_name]
        frame_nodes = set(enter_names) | set(merges) | {loopcond_name}
        frame_nodes.update(s.name for s in switches.values())

        # per-carry bookkeeping, deterministic order
        carry_names = sorted(merges)
        next_refs, exit_nodes, enter_of = [], [], []
        for mname in carry_names:
            ins = self._inputs(merges[mname])
            e = next(self._clean(i) for i in ins
                     if self._clean(i) in enter_names)
            ni = next(self._clean(i) for i in ins
                      if self._clean(i) not in enter_names)
            ni_node = self.node_by_name.get(ni)
            if ni_node is None or ni_node.op != "NextIteration":
                raise NotImplementedError(
                    f"TF1 frame {frame!r}: Merge {mname!r} second input is "
                    f"{ni!r}, not a NextIteration")
            enter_of.append(e)
            next_refs.append(ni_node.input[0])
            frame_nodes.add(ni)
            sw = switches.get(mname)
            ex = None
            if sw is not None:
                for n in self.gd.node:
                    if n.op == "Exit" and \
                            self._clean(self._inputs(n)[0]) == sw.name:
                        ex = n
                        frame_nodes.add(n.name)
                        break
            exit_nodes.append(ex)
        invariants = sorted(enter_names - set(enter_of))

        # cond slice: placeholders at the Merges (+ invariant Enters)
        stops_c = {m: f"__c_{i}" for i, m in enumerate(carry_names)}
        stops_c.update({e: f"__ci_{i}" for i, e in enumerate(invariants)})
        cond_fn, cond_stop_order = self._frame_subgraph_callable(
            [loopcond.input[0]], stops_c, frame_nodes)
        # body slice: placeholders at the Switches' taken side (:1)
        stops_b = {switches[m].name if m in switches else m:
                   f"__b_{i}" for i, m in enumerate(carry_names)}
        stops_b.update({e: f"__bi_{i}" for i, e in enumerate(invariants)})
        body_fn, body_stop_order = self._frame_subgraph_callable(
            list(next_refs), stops_b, frame_nodes)

        n_carry = len(carry_names)
        n_total = n_carry + len(invariants)

        # stop-dict iteration order == insertion order == carries then
        # invariants, so positional zip in the callables lines up with the
        # init list below
        def cond(*args, key=None):
            return cond_fn(*args, key=key)[0]

        def body(*args, key=None):
            outs = body_fn(*args[:], key=key)
            return tuple(outs) + tuple(args[n_carry:])

        cond._accepts_rng = True
        body._accepts_rng = True

        init_refs = [self.node_by_name[e].input[0] for e in enter_of] + \
            [self.node_by_name[e].input[0] for e in invariants]
        outs = self.sd.while_loop(
            cond, body, *[self.sd.vars[self._ensure_var(r)]
                          for r in init_refs],
            name=f"{frame.replace('/', '_')}_while",
            max_iterations=self.while_max_iterations)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for i, ex in enumerate(exit_nodes):
            if ex is not None:
                self._alias(ex.name, outs[i].name)
        self._frame_consumed |= frame_nodes
        # Dead-limb sweep: nested frames leave unreferenced frame ops
        # outside every slice (e.g. an inner loop-counter's Exit that
        # nothing consumes). Any frame op whose data inputs are all
        # consumed is part of the lowered region — absorb it, repeatedly.
        frame_op_kinds = ("Enter", "Exit", "NextIteration", "LoopCond",
                          "Merge", "Switch")
        changed = True
        while changed:
            changed = False
            for n in self.gd.node:
                if n.op not in frame_op_kinds or \
                        n.name in self._frame_consumed:
                    continue
                ins_ = [self._clean(i) for i in n.input]
                if ins_ and all(i in self._frame_consumed for i in ins_):
                    self._frame_consumed.add(n.name)
                    changed = True

    def _map_node(self, node) -> None:
        if node.name in self._frame_consumed:
            return
        op = node.op
        ins = self._inputs(node)
        sd = self.sd

        if op == "Const":
            return  # materialised lazily on first use
        if op in ("Placeholder", "PlaceholderWithDefault"):
            shape = self.input_shapes.get(node.name) or self._attr(node, "shape")
            if shape is not None:
                shape = tuple(None if s in (-1, 0) else s for s in shape)
            v = sd.placeholder(node.name, shape)
            if v.name != node.name:
                v.rename(node.name)
            return
        if op in ("Identity", "StopGradient", "PreventGradient", "CheckNumerics",
                  "NoOp", "IdentityN"):
            if not ins:
                return
            src = self._clean(ins[0])
            if src in self.const_values and src not in sd.vars:
                self.const_values[node.name] = self.const_values[src]
                return
            self._emit(node, "identity", [ins[0]])
            return
        if op == "VariableV2" or op == "VarHandleOp":
            raise ValueError("Graph contains un-frozen variables; freeze it first "
                             "(reference requires frozen graphs too)")

        simple = {
            "Add": "add", "AddV2": "add", "Sub": "sub", "Mul": "mul",
            "RealDiv": "div", "Div": "div", "Maximum": "maximum",
            "Minimum": "minimum", "Pow": "pow", "SquaredDifference": "squared_difference",
            "FloorDiv": "floordiv", "FloorMod": "mod",
            "Sqrt": "sqrt", "Rsqrt": "rsqrt", "Square": "square", "Exp": "exp",
            "Log": "log", "Log1p": "log1p", "Neg": "neg", "Abs": "abs", "Sign": "sign",
            "Floor": "floor", "Ceil": "ceil", "Round": "round", "Erf": "erf",
            "Tanh": "tanh", "Sigmoid": "sigmoid", "Relu": "relu", "Relu6": "relu6",
            "Elu": "elu", "Selu": "selu", "Softplus": "softplus", "Softsign": "softsign",
            "Sin": "sin", "Cos": "cos", "Tan": "tan",
            "Asin": "asin", "Acos": "acos", "Atan": "atan",
            "Sinh": "sinh", "Cosh": "cosh", "Atan2": "atan2",
            "Asinh": "asinh", "Acosh": "acosh", "Atanh": "atanh",
            "Expm1": "expm1", "Erfc": "erfc", "Lgamma": "gammaln",
            "Digamma": "digamma", "Rint": "rint", "Xlogy": "xlogy",
            "Xdivy": "xdivy", "DivNoNan": "div_no_nan",
            "MulNoNan": "multiply_no_nan", "TruncateDiv": "truncate_div",
            "TruncateMod": "truncate_mod", "Inv": "reciprocal",
            "InvertPermutation": "invert_permutation",
            "Cholesky": "cholesky",
            "MatrixDeterminant": "matrix_determinant",
            "Greater": "gt", "GreaterEqual": "gte", "Less": "lt", "LessEqual": "lte",
            "Equal": "eq", "NotEqual": "neq", "LogicalAnd": "logical_and",
            "LogicalOr": "logical_or", "LogicalNot": "logical_not",
            "Softmax": "softmax", "LogSoftmax": "log_softmax",
            "BiasAdd": "bias_add", "Reciprocal": "reciprocal",
            "ZerosLike": "zeros_like", "OnesLike": "ones_like",
            "L2Loss": "l2_loss", "Tile": None, "Select": "where", "SelectV2": "where",
        }
        if op in simple and simple[op]:
            self._emit(node, simple[op], ins)
            return

        if op == "MatMul":
            self._emit(node, "matmul", ins,
                       transpose_a=self._attr(node, "transpose_a", False),
                       transpose_b=self._attr(node, "transpose_b", False))
            return
        if op in ("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3"):
            self._emit(node, "batch_matmul", ins,
                       transpose_a=self._attr(node, "adj_x", False),
                       transpose_b=self._attr(node, "adj_y", False))
            return
        if op == "Reshape":
            try:
                shape = self._const(ins[1]).astype(np.int64)
            except ValueError:
                # computed shape operand: defer to trace time — shape_of
                # chains stay concrete there, so the reshape is still
                # static for statically-shaped graphs
                self._emit(node, "reshape_dynamic", ins[:2])
                return
            self._emit(node, "reshape", ins[:1], shape=[int(s) for s in shape])
            return
        if op == "Transpose":
            perm = [int(p) for p in self._const(ins[1])]
            self._emit(node, "transpose", ins[:1], perm=perm)
            return
        if op == "ExpandDims":
            axis = int(self._const(ins[1]))
            self._emit(node, "expand_dims", ins[:1], axis=axis)
            return
        if op == "Squeeze":
            dims = self._attr(node, "squeeze_dims") or None
            self._emit(node, "squeeze", ins,
                       axis=tuple(dims) if dims else None)
            return
        if op in ("ConcatV2", "Concat"):
            if op == "ConcatV2":
                axis = int(self._const(ins[-1]))
                data = ins[:-1]
            else:
                axis = int(self._const(ins[0]))
                data = ins[1:]
            self._emit(node, "concat", data, axis=axis)
            return
        if op == "Pack":
            self._emit(node, "stack", ins, axis=self._attr(node, "axis", 0))
            return
        if op == "Unpack":
            n = self._attr(node, "num")
            vars_ = [sd.vars[self._ensure_var(ins[0])]]
            outs = sd._apply("unstack", vars_,
                             attrs={"axis": self._attr(node, "axis", 0), "num": n},
                             name=node.name, n_outputs=n)
            outs = outs if isinstance(outs, tuple) else (outs,)
            for i, o in enumerate(outs):
                want = node.name if i == 0 else f"{node.name}:{i}"
                if o.name != want:
                    o.rename(want)
            return
        if op == "Split":
            n = self._attr(node, "num_split")
            axis = int(self._const(ins[0]))
            vars_ = [sd.vars[self._ensure_var(ins[1])]]
            outs = sd._apply("split", vars_, attrs={"num_splits": n, "axis": axis},
                             name=node.name, n_outputs=n)
            outs = outs if isinstance(outs, tuple) else (outs,)
            for i, o in enumerate(outs):
                want = node.name if i == 0 else f"{node.name}:{i}"
                if o.name != want:
                    o.rename(want)
            return
        if op == "Tile":
            mult = [int(m) for m in self._const(ins[1])]
            self._emit(node, "tile", ins[:1], multiples=mult)
            return
        if op == "Slice":
            begin = [int(b) for b in self._const(ins[1])]
            size = [int(s) for s in self._const(ins[2])]
            self._emit(node, "slice", ins[:1], begin=begin, size=size)
            return
        if op == "StridedSlice":
            self._emit(node, "strided_slice", ins[:1],
                       begin=[int(b) for b in self._const(ins[1])],
                       end=[int(e) for e in self._const(ins[2])],
                       strides=[int(s) for s in self._const(ins[3])],
                       begin_mask=self._attr(node, "begin_mask", 0),
                       end_mask=self._attr(node, "end_mask", 0),
                       shrink_axis_mask=self._attr(node, "shrink_axis_mask", 0),
                       new_axis_mask=self._attr(node, "new_axis_mask", 0),
                       ellipsis_mask=self._attr(node, "ellipsis_mask", 0))
            return
        if op in ("GatherV2", "Gather"):
            axis = int(self._const(ins[2])) if len(ins) > 2 else 0
            self._emit(node, "gather", ins[:2], axis=axis)
            return
        if op == "GatherNd":
            self._emit(node, "gather_nd", ins[:2])
            return
        if op == "OneHot":
            depth = int(self._const(ins[1]))
            on = float(self._const(ins[2])) if len(ins) > 2 else 1.0
            off = float(self._const(ins[3])) if len(ins) > 3 else 0.0
            self._emit(node, "one_hot", ins[:1], depth=depth, on_value=on,
                       off_value=off, axis=self._attr(node, "axis", -1))
            return
        if op == "Cast":
            self._emit(node, "cast", ins, dtype=_np_dtype(self._attr(node, "DstT")))
            return
        if op in ("Mean", "Sum", "Max", "Min", "Prod"):
            axis = self._const(ins[1])
            axis = [int(a) for a in np.atleast_1d(axis)]
            red = {"Mean": "reduce_mean", "Sum": "reduce_sum", "Max": "reduce_max",
                   "Min": "reduce_min", "Prod": "reduce_prod"}[op]
            self._emit(node, red, ins[:1], axis=axis,
                       keepdims=self._attr(node, "keep_dims", False))
            return
        if op in ("ArgMax", "ArgMin"):
            axis = int(self._const(ins[1])) if len(ins) > 1 else -1
            self._emit(node, "argmax" if op == "ArgMax" else "argmin", ins[:1], axis=axis)
            return
        if op == "Pad" or op == "PadV2":
            pads = [[int(a), int(b)] for a, b in self._const(ins[1])]
            cv = float(self._const(ins[2])) if op == "PadV2" else 0.0
            self._emit(node, "pad", ins[:1], paddings=pads, constant_value=cv)
            return
        if op == "Shape":
            # static fold if the producer's shape is known at import time
            self._emit(node, "shape_of", ins[:1])
            return
        if op == "Fill":
            shape = [int(s) for s in self._const(ins[0])]
            value = float(self._const(ins[1]))
            arr = np.full(shape, value, np.float32)
            self.const_values[node.name] = arr
            return
        if op == "Range":
            start, limit, delta = (self._const(i) for i in ins[:3])
            self.const_values[node.name] = np.arange(start, limit, delta)
            return
        if op == "Conv2D":
            strides = self._attr(node, "strides", [1, 1, 1, 1])
            dil = self._attr(node, "dilations", [1, 1, 1, 1])
            self._emit(node, "conv2d", ins[:2],
                       stride=[int(strides[1]), int(strides[2])],
                       padding=self._attr(node, "padding", "SAME"),
                       dilation=[int(dil[1]), int(dil[2])])
            return
        if op == "DepthwiseConv2dNative":
            strides = self._attr(node, "strides", [1, 1, 1, 1])
            dil = self._attr(node, "dilations", [1, 1, 1, 1])
            if any(int(d) != 1 for d in dil):
                raise NotImplementedError(
                    f"DepthwiseConv2dNative {node.name!r} with dilation {dil}")
            self._emit(node, "depthwise_conv2d", ins[:2],
                       stride=[int(strides[1]), int(strides[2])],
                       padding=self._attr(node, "padding", "SAME"))
            return
        if op == "Conv2DBackpropInput":
            # (output_sizes, filter, out_backprop) -> deconvolution; Keras
            # Conv2DTranspose layers export as this op
            dil = self._attr(node, "dilations", [1, 1, 1, 1])
            if any(int(d) != 1 for d in dil):
                raise NotImplementedError(
                    f"Conv2DBackpropInput {node.name!r} with dilation {dil}")
            try:
                out_shape = [int(s) for s in self._const(ins[0])]
            except ValueError:
                out_shape = None  # computed sizes: registry op validates shape
            strides = self._attr(node, "strides", [1, 1, 1, 1])
            self._emit(node, "conv2d_transpose", [ins[2], ins[1]],
                       stride=[int(strides[1]), int(strides[2])],
                       padding=self._attr(node, "padding", "SAME"),
                       output_shape=out_shape)
            return
        if op == "Einsum":
            self._emit(node, "einsum", ins,
                       equation=self._attr(node, "equation"))
            return
        if op == "LeakyRelu":
            self._emit(node, "leaky_relu", ins,
                       alpha=self._attr(node, "alpha", 0.2))
            return
        if op in ("Cumsum", "Cumprod"):
            if self._attr(node, "exclusive", False) \
                    or self._attr(node, "reverse", False):
                raise NotImplementedError(
                    f"{op} {node.name!r} with exclusive/reverse")
            axis = int(self._const(ins[1]))
            self._emit(node, op.lower(), ins[:1], axis=axis)
            return
        if op in ("DepthToSpace", "SpaceToDepth"):
            if self._attr(node, "data_format", "NHWC") != "NHWC":
                raise NotImplementedError(
                    f"{op} {node.name!r} with data_format != NHWC")
            self._emit(node,
                       "depth_to_space" if op == "DepthToSpace"
                       else "space_to_depth",
                       ins[:1], block_size=self._attr(node, "block_size", 2))
            return
        if op == "MatrixBandPart":
            self._emit(node, "matrix_band_part", ins[:1],
                       num_lower=int(self._const(ins[1])),
                       num_upper=int(self._const(ins[2])))
            return
        if op in ("MatrixDiag", "MatrixDiagV2", "MatrixDiagV3"):
            if len(ins) > 1:  # V2/V3 carry (k, num_rows, num_cols, padding)
                k = int(np.atleast_1d(self._const(ins[1]))[0])
                extras = [int(np.atleast_1d(self._const(i))[0])
                          for i in ins[2:4] if i]
                if k != 0 or any(e not in (-1,) for e in extras):
                    raise NotImplementedError(
                        f"{op} {node.name!r} with k={k}/explicit dims")
            self._emit(node, "matrix_diag", ins[:1])
            return
        if op in ("MatrixDiagPart", "MatrixDiagPartV2", "MatrixDiagPartV3"):
            if len(ins) > 1:
                k = int(np.atleast_1d(self._const(ins[1]))[0])
                if k != 0:
                    raise NotImplementedError(
                        f"{op} {node.name!r} with k={k}")
            self._emit(node, "matrix_diag_part", ins[:1])
            return
        if op == "MatrixInverse":
            if self._attr(node, "adjoint", False):
                raise NotImplementedError(
                    f"MatrixInverse {node.name!r} with adjoint=True")
            self._emit(node, "matrix_inverse", ins[:1])
            return
        if op == "ReverseV2":
            axes = [int(a) for a in np.atleast_1d(self._const(ins[1]))]
            self._emit(node, "reverse", ins[:1], axis=axes)
            return
        if op == "TopKV2":
            k = int(self._const(ins[1]))
            vars_ = [sd.vars[self._ensure_var(ins[0])]]
            outs = sd._apply("top_k", vars_, attrs={"k": k},
                             name=node.name, n_outputs=2)
            self._name_outputs(node, outs if isinstance(outs, tuple) else (outs,))
            return
        if op == "AddN":
            self._emit(node, "add_n", ins)
            return
        if op in ("ResizeBilinear", "ResizeNearestNeighbor"):
            size = [int(s) for s in self._const(ins[1])]
            if self._attr(node, "align_corners", False):
                raise NotImplementedError(
                    f"{op} {node.name!r} with align_corners=True; re-export "
                    "with tf.image.resize (half-pixel centers)")
            if op == "ResizeBilinear" and not self._attr(
                    node, "half_pixel_centers", False):
                raise NotImplementedError(
                    f"ResizeBilinear {node.name!r} uses the legacy TF1 "
                    "corner-aligned-origin sampling (half_pixel_centers="
                    "False); re-export with tf.image.resize")
            if op == "ResizeBilinear":
                self._emit(node, "resize_bilinear", ins[:1],
                           height=size[0], width=size[1])
            else:
                self._emit(node, "resize_nearest", ins[:1],
                           height=size[0], width=size[1],
                           half_pixel_centers=self._attr(
                               node, "half_pixel_centers", False))
            return
        if op in ("MaxPool", "AvgPool"):
            k = self._attr(node, "ksize", [1, 2, 2, 1])
            s = self._attr(node, "strides", [1, 2, 2, 1])
            self._emit(node, "max_pool2d" if op == "MaxPool" else "avg_pool2d",
                       ins[:1], kernel=[int(k[1]), int(k[2])],
                       stride=[int(s[1]), int(s[2])],
                       padding=self._attr(node, "padding", "VALID"))
            return
        if op in ("RandomUniform", "RandomStandardNormal", "TruncatedNormal",
                  "StatelessRandomUniform", "StatelessRandomUniformV2",
                  "StatelessRandomNormal", "StatelessRandomNormalV2",
                  "StatelessTruncatedNormal", "StatelessTruncatedNormalV2"):
            # Stochastic nodes (Keras training=True dropout exports these):
            # the static `seed` names the stream; sd.fit's executor folds a
            # per-step key into it so draws are fresh every training
            # iteration (reference: stateful NativeRandom redraws per step).
            reg = {"RandomUniform": "random_uniform",
                   "StatelessRandomUniform": "random_uniform",
                   "StatelessRandomUniformV2": "random_uniform",
                   "RandomStandardNormal": "random_normal",
                   "StatelessRandomNormal": "random_normal",
                   "StatelessRandomNormalV2": "random_normal",
                   "TruncatedNormal": "truncated_normal",
                   "StatelessTruncatedNormal": "truncated_normal",
                   "StatelessTruncatedNormalV2": "truncated_normal"}[op]
            try:
                shape = [int(s) for s in self._const(ins[0])]
                self._emit(node, reg, [], shape=shape, seed=self._tf_seed(node))
            except ValueError:
                # computed shape (tf.shape(x), the Keras dropout form): the
                # shape_of chain stays concrete at trace time, so the draw
                # is still statically shaped
                self._emit(node, reg, ins[:1], seed=self._tf_seed(node))
            return
        if op == "Multinomial":
            num = int(self._const(ins[1]))
            self._emit(node, "random_categorical", ins[:1],
                       num_samples=num, seed=self._tf_seed(node))
            return
        if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            # inference form: (x, gamma, beta, mean, var)
            x, gamma, beta, mean, var = ins[:5]
            self._emit(node, "batch_norm", [x, mean, var, gamma, beta],
                       eps=self._attr(node, "epsilon", 1e-3))
            return

        # ---- TF1-style lowered conditionals (Switch/Merge dataflow) ----
        # Merge lowers onto sd.cond: each branch is backward-
        # sliced into a standalone subgraph and only the taken one
        # executes, matching the reference's lazy Switch/Merge frame
        # semantics. Unmatched Merges fall back to execute-both + select
        # (the graph is pure, so that form is numerically exact).
        if op == "Switch":
            # outputs: :0 = false branch, :1 = true branch; both carry data
            data_v = sd.vars[self._ensure_var(ins[0])]
            self._switch_pred[node.name] = ins[1]
            o0 = sd._apply("identity", [data_v], name=node.name)
            if o0.name != node.name:
                o0.rename(node.name)
            o1 = sd._apply("identity", [data_v], name=f"{node.name}:1")
            if o1.name != f"{node.name}:1":
                o1.rename(f"{node.name}:1")
            return
        if op == "Merge":
            picks = [self._controlling_switch(i) for i in ins]
            true_refs = [r for r, p in zip(ins, picks) if p and p[1] == 1]
            false_refs = [r for r, p in zip(ins, picks) if p and p[1] == 0]
            if not true_refs or not false_refs:
                raise NotImplementedError(
                    f"Merge {node.name!r}: cannot associate its inputs with "
                    "a controlling Switch true/false pair. TF1 while-loop "
                    "frames ARE supported (Enter-rooted frames lower onto "
                    "sd.while_loop); this Merge is outside any frame and "
                    "has no matched Switch — likely a malformed or "
                    "hand-edited frozen graph")
            pred_ref = self._switch_pred[next(p for p in picks if p)[0]]
            lowered = False
            if self.lazy_conditionals:
                try:
                    # lazy branch-select: only the taken branch executes
                    self._lower_cond_merge(node, true_refs[0], false_refs[0],
                                           pred_ref)
                    lowered = True
                # The where-form is numerically exact, so ANY failure to
                # build the lazy slice falls back rather than failing the
                # import: NotImplementedError from the slice machinery,
                # ValueError from a branch op that static-folds a Const
                # the slice turned into a Placeholder, RecursionError from
                # a pathologically deep branch topo-sort.
                except (NotImplementedError, ValueError, RecursionError):
                    pass
            if not lowered:
                # execute-both + select fallback (numerically identical,
                # up to 2x the work of the taken branch)
                pred_v = sd.vars[self._ensure_var(pred_ref)]
                tv = sd.vars[self._ensure_var(true_refs[0])]
                fv = sd.vars[self._ensure_var(false_refs[0])]
                out = sd._apply("where", [pred_v, tv, fv], name=node.name)
                if out.name != node.name:
                    out.rename(node.name)
            # second output (value_index) is rarely consumed; emit if needed
            return
        if op == "Enter":
            # First frame op in topo order: lower the WHOLE frame now
            # (reference: TFGraphMapper maps Enter/Exit/NextIteration/
            # LoopCond frames into SameDiff's loop frames; here the frame
            # is reconstructed and lowered onto sd.while_loop)
            self._lower_tf1_frame(self._attr(node, "frame_name"))
            return
        if op in ("Exit", "NextIteration", "LoopCond"):
            raise NotImplementedError(
                f"Orphan TF1 frame op {op!r} (node {node.name!r}) with no "
                "Enter — malformed frozen graph")

        # ---- TF2 function graphs + structured control flow ----
        if op in ("PartitionedCall", "StatefulPartitionedCall"):
            self._inline_call(node, node.attr["f"].func.name, ins)
            return
        if op in ("While", "StatelessWhile"):
            cond_f = self._function_callable(node.attr["cond"].func.name)
            body_f = self._function_callable(node.attr["body"].func.name)
            n = len(ins)
            vars_ = [sd.vars[self._ensure_var(i)] for i in ins]

            def cond_w(*c, key=None):
                return cond_f(*c, key=key)[0]

            def body_w(*c, key=None):
                return tuple(body_f(*c, key=key))

            # keep the per-step rng threading through the wrappers (dropout
            # inside a While body stays live during sd.fit)
            cond_w._accepts_rng = True
            body_w._accepts_rng = True
            outs = sd.while_loop(
                cond_w, body_w,
                *vars_, name=node.name,
                max_iterations=self.while_max_iterations)
            outs = outs if isinstance(outs, tuple) else (outs,)
            self._name_outputs(node, outs)
            return
        if op in ("If", "StatelessIf"):
            then_f = self._function_callable(node.attr["then_branch"].func.name)
            else_f = self._function_callable(node.attr["else_branch"].func.name)
            nout = len(node.attr["Tout"].list.type) or 1
            pred_v = sd.vars[self._ensure_var(ins[0])]
            arg_vs = [sd.vars[self._ensure_var(i)] for i in ins[1:]]
            if nout == 1:
                def tf_fn(*xs, key=None):
                    return then_f(*xs, key=key)[0]

                def ef_fn(*xs, key=None):
                    return else_f(*xs, key=key)[0]
            else:
                def tf_fn(*xs, key=None):
                    return tuple(then_f(*xs, key=key))

                def ef_fn(*xs, key=None):
                    return tuple(else_f(*xs, key=key))
            tf_fn._accepts_rng = True
            ef_fn._accepts_rng = True
            outs = sd.cond(pred_v, tf_fn, ef_fn, *arg_vs, name=node.name,
                           n_outputs=nout)
            outs = outs if isinstance(outs, tuple) else (outs,)
            self._name_outputs(node, outs)
            return

        raise NotImplementedError(
            f"TF op {op!r} (node {node.name!r}) is not mapped; "
            f"extend deeplearning4j_tpu_torch/imports/tf_import.py")


def _np_dtype(tf_name: str) -> str:
    return {"float": "float32", "double": "float64", "int32": "int32",
            "int64": "int32", "bool": "bool", "half": "float16",
            "bfloat16": "bfloat16"}.get(tf_name, tf_name or "float32")
