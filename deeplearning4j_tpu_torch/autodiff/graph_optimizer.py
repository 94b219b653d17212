"""Graph optimization passes over a SameDiff op graph.

Counterpart of ``deeplearning4j_tpu/autodiff/graph_optimizer.py``, pass for
pass: the pattern fusions of an imported TF graph (``fuse_layer_norm``,
``fuse_gelu_erf``, ``fuse_attention`` with its proof that a bias is the
key-padding pattern), shape and shape-value inference, ``fold_shape_chains``
and the layout passes (``fold_2d_matmuls``, ``sink_reshapes``,
``collapse_reshapes``), so that :func:`optimize` rewrites a graph into the
same op sequence as the JAX package's does. In the port the fusions choose
the kernels: a fused ``scaled_dot_product_attention`` with a proven padding
bias runs the flash-attention kernels, ``layer_norm`` and ``gelu`` the fused
registry ops.

Passes are conservative: a match is rewritten only when every interior
value has no other consumer, so observable outputs never change. Shape
inference evaluates each op on ``meta`` tensors (shapes and dtypes, no
data), and on real CPU tensors where every input's value is known (shape
arithmetic).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from deeplearning4j_tpu_torch.autodiff.samediff import OpNode, SameDiff, VariableType


def _producers(sd: SameDiff) -> Dict[str, OpNode]:
    return {o: n for n in sd.ops for o in n.outputs}


def _use_counts(sd: SameDiff) -> Dict[str, int]:
    uses: Dict[str, int] = {}
    for n in sd.ops:
        for i in n.inputs:
            uses[i] = uses.get(i, 0) + 1
    for name in sd.loss_variables:
        uses[name] = uses.get(name, 0) + 1
    return uses


def _const_scalar(sd: SameDiff, name: str) -> Optional[float]:
    v = sd.vars.get(name)
    if v is None or v.vtype not in (VariableType.CONSTANT,):
        return None
    a = sd.arrays.get(name)
    if a is None or a.numel() != 1:
        return None
    return float(a.reshape(()).item())


def _is_last_axis(axis) -> bool:
    """True only for a last-axis reduction (layer_norm normalizes axis=-1;
    TF Mean(axis=[1,2]) spellings are group/instance norm — different op).
    The importer can't know the rank here, so only the unambiguous -1 form
    qualifies."""
    if axis is None:
        return False
    if isinstance(axis, (list, tuple)):
        return len(axis) == 1 and int(axis[0]) == -1
    return int(axis) == -1


def _binary(node: OpNode, op: str) -> Optional[Tuple[str, str]]:
    if node.op != op or len(node.inputs) != 2:
        return None
    return node.inputs[0], node.inputs[1]


def _replace(sd: SameDiff, dead: List[OpNode], new_node: OpNode) -> None:
    """Swap `dead` (whose last element produces new_node's output) for the
    fused node, preserving topological position."""
    idx = sd.ops.index(dead[-1])
    sd.ops[idx] = new_node
    for n in dead[:-1]:
        sd.ops.remove(n)


def fuse_layer_norm(sd: SameDiff) -> int:
    """(x - mean(x)) * rsqrt(var(x) + eps) * gamma + beta  ->  layer_norm.

    Matches the TF-emitted shape: Mean / SquaredDifference / Mean / Add(eps)
    / Rsqrt / Sub / Mul / Mul(gamma) / Add(beta), all reducing the LAST axis
    with keepdims."""
    fused = 0
    while True:
        prod = _producers(sd)
        uses = _use_counts(sd)

        def sole(name):  # interior value consumed exactly once, not a loss
            return uses.get(name, 0) == 1 and name not in sd.loss_variables

        match = None
        for out_node in sd.ops:
            b = _binary(out_node, "add")
            if not b:
                continue
            # out = add(scaled, beta) — beta is a leaf (const/variable)
            for scaled_name, beta in (b, b[::-1]):
                scaled = prod.get(scaled_name)
                # need: scaled produced by an op, beta a leaf (const/var)
                if scaled is None or prod.get(beta) is not None:
                    continue
                m2 = _binary(scaled, "mul")
                if not m2 or not sole(scaled_name):
                    continue
                for normed_name, gamma in (m2, m2[::-1]):
                    if prod.get(gamma) is not None:
                        continue
                    normed = prod.get(normed_name)
                    if normed is None or not sole(normed_name):
                        continue
                    m1 = _binary(normed, "mul")
                    if not m1:
                        continue
                    for centered_name, r_name in (m1, m1[::-1]):
                        centered = prod.get(centered_name)
                        r = prod.get(r_name)
                        if (centered is None or r is None
                                or centered.op != "sub" or r.op != "rsqrt"
                                or not sole(centered_name) or not sole(r_name)):
                            continue
                        x_name, mean_name = centered.inputs
                        mean_node = prod.get(mean_name)
                        if (mean_node is None or mean_node.op != "reduce_mean"
                                or mean_node.inputs[0] != x_name
                                or not mean_node.attrs.get("keepdims")
                                or not _is_last_axis(mean_node.attrs.get("axis"))):
                            continue
                        veps = prod.get(r.inputs[0])
                        if veps is None or veps.op != "add" or not sole(r.inputs[0]):
                            continue
                        vb = _binary(veps, "add")
                        for var_name, eps_name in (vb, vb[::-1]):
                            eps = _const_scalar(sd, eps_name)
                            var_node = prod.get(var_name)
                            if (eps is None or var_node is None
                                    or var_node.op != "reduce_mean"
                                    or not var_node.attrs.get("keepdims")
                                    or not _is_last_axis(var_node.attrs.get("axis"))
                                    or not sole(var_name)):
                                continue
                            sq = prod.get(var_node.inputs[0])
                            if (sq is None or sq.op != "squared_difference"
                                    or not sole(var_node.inputs[0])):
                                continue
                            sq_in = set(sq.inputs)
                            if sq_in != {x_name, mean_name}:
                                continue
                            # mean consumed by sub and squared_difference only
                            if uses.get(mean_name, 0) != 2:
                                continue
                            match = (out_node, scaled, normed, centered, r,
                                     veps, var_node, sq, mean_node,
                                     x_name, gamma, beta, eps)
                            break
                        if match:
                            break
                    if match:
                        break
                if match:
                    break
            if match:
                break
        if not match:
            return fused
        (out_node, scaled, normed, centered, r, veps, var_node, sq,
         mean_node, x_name, gamma, beta, eps) = match
        dead = [mean_node, sq, var_node, veps, r, centered, normed, scaled,
                out_node]
        _replace(sd, dead, OpNode(
            op="layer_norm", inputs=[x_name, gamma, beta],
            outputs=list(out_node.outputs), attrs={"axis": -1, "eps": eps}))
        fused += 1


def fuse_gelu_erf(sd: SameDiff) -> int:
    """0.5 * y * (1 + erf(y / sqrt(2)))  ->  gelu(y, approximate=False).

    Matches both association orders TF emits for the double product."""
    fused = 0
    while True:
        prod = _producers(sd)
        uses = _use_counts(sd)

        def sole(name):
            return uses.get(name, 0) == 1 and name not in sd.loss_variables

        def is_half(name):
            c = _const_scalar(sd, name)
            return c is not None and abs(c - 0.5) < 1e-12

        def one_plus_erf(name):
            """-> y_name if `name` is add(1, erf(y / sqrt2))."""
            n = prod.get(name)
            if n is None or n.op != "add" or not sole(name):
                return None
            for one_name, e_name in (n.inputs, n.inputs[::-1]):
                c = _const_scalar(sd, one_name)
                if c is None or abs(c - 1.0) > 1e-12:
                    continue
                e = prod.get(e_name)
                if e is None or e.op != "erf" or not sole(e_name):
                    continue
                d = prod.get(e.inputs[0])
                if d is None or not sole(e.inputs[0]):
                    continue
                if d.op == "div":
                    y, c2 = d.inputs
                    cv = _const_scalar(sd, c2)
                    if cv is not None and abs(cv - np.sqrt(2.0)) < 1e-4:
                        return y, [d, e, n]
                if d.op == "mul":
                    for y, c2 in (d.inputs, d.inputs[::-1]):
                        cv = _const_scalar(sd, c2)
                        if cv is not None and abs(cv - 1 / np.sqrt(2.0)) < 1e-4:
                            return y, [d, e, n]
            return None

        match = None
        for out_node in sd.ops:
            m = _binary(out_node, "mul")
            if not m:
                continue
            for a_name, b_name in (m, m[::-1]):
                # form A: mul(mul(0.5, y), 1+erf)   form B: mul(0.5, mul(y, 1+erf))
                res = one_plus_erf(b_name)
                if res is not None:
                    y, dead_tail = res
                    inner = prod.get(a_name)
                    if inner is not None and sole(a_name):
                        mi = _binary(inner, "mul")
                        if mi:
                            for h, yy in (mi, mi[::-1]):
                                if is_half(h) and yy == y:
                                    match = (y, dead_tail + [inner, out_node])
                                    break
                if match:
                    break
                if is_half(a_name):
                    inner = prod.get(b_name)
                    if inner is not None and sole(b_name):
                        mi = _binary(inner, "mul")
                        if mi:
                            for yy, oe_name in (mi, mi[::-1]):
                                res2 = one_plus_erf(oe_name)
                                if res2 is not None and res2[0] == yy:
                                    match = (yy, res2[1] + [inner, out_node])
                                    break
                if match:
                    break
            if match:
                break
        if not match:
            return fused
        y, dead = match
        # dead nodes may be discovered out of graph order; keep stable order
        dead = sorted(set(map(id, dead)), key=[id(n) for n in sd.ops].index)
        dead_nodes = [n for n in sd.ops if id(n) in dead]
        out_node = dead_nodes[-1]
        _replace(sd, dead_nodes, OpNode(
            op="gelu", inputs=[y], outputs=list(out_node.outputs),
            attrs={"approximate": False}))
        fused += 1


def optimize(sd: SameDiff) -> Dict[str, int]:
    """Run all passes to fixpoint; returns per-pass fusion counts."""
    stats = {"layer_norm": fuse_layer_norm(sd), "gelu_erf": fuse_gelu_erf(sd),
             "attention": fuse_attention(sd)}
    folded, shapes = _fold_shape_chains(sd)
    stats["shape_folds"] = folded
    stats.update(optimize_layout(sd, shapes=shapes))
    return stats


# --------------------------------------------------------- layout passes
#
# TF exporters spell batched matmuls as reshape-to-2D round trips
# (reshape(x,(B*T,H)) @ W, then reshape back), and thread bias-adds and
# activations through the 2-D form. XLA assigns the 2-D dot outputs
# column-major-style layouts that clash with the 3-D consumers', and the
# resulting layout-conversion copies measured 4.6 GB/step on the imported
# BERT-base (vs 0.45 GB in the hand-built model; see BASELINE.md round 3).
# These passes restore the 3-D form the hand-built layers use: fold the
# reshape into the matmul, sink the compensating reshape down through
# elementwise ops until it meets another reshape, and collapse the pair.

_SINK_UNARY = {"gelu", "tanh", "relu", "sigmoid", "identity", "erf", "neg",
               "rsqrt", "exp", "log", "softplus", "swish"}
_SINK_BINARY = {"add", "sub", "mul", "div", "bias_add", "maximum", "minimum",
                "squared_difference"}


def _shape_rule(op: str, specs):
    """Output shapes of the ops whose implementation runs only on real
    tensors (the fused attention reaches the flash kernels' wrappers):
    ``(shape, dtype)`` per output, or None."""
    if op == "scaled_dot_product_attention":
        q, v = specs[0], specs[2]
        return [(tuple(q[0][:-1]) + (v[0][-1],), q[1])]
    return None


def _infer(sd: SameDiff, lead: Optional[int] = None):
    """Incremental per-op shape + shape-VALUE propagation (JAX ``_infer``).

    Walks the (topologically ordered) op list once. For each op, inputs
    with statically known VALUES (constants; shape_of of a known shape;
    arithmetic thereon) are passed as real CPU tensors, so shape chains
    evaluate to real integers, while the rest enter as ``meta`` tensors
    (shape and dtype only); an op whose every input is known is evaluated
    for real. An op that cannot be evaluated only blanks ITS outputs;
    downstream ops that don't depend on them still resolve.

    Every placeholder dim recorded as None is filled with ``lead`` (default:
    the most common known leading dim). Such dims are GUESSES: rewrite
    passes must never bake inferred leading dims into emitted attrs (they
    use -1 / original attrs; see fold_shape_chains for the two-run taint
    check).

    Returns ``(shapes, values)`` dicts keyed by variable name."""
    from deeplearning4j_tpu_torch.autodiff.ops_registry import get_op
    from deeplearning4j_tpu_torch.autodiff.samediff import as_tensor

    if lead is None:
        known_lead = [v.shape[0] for v in sd.vars.values()
                      if v.vtype == VariableType.PLACEHOLDER and v.shape
                      and v.shape[0] is not None]
        lead = max(set(known_lead), key=known_lead.count) if known_lead else 2

    shapes: Dict[str, Tuple[int, ...]] = {}
    dtypes: Dict[str, Any] = {}
    values: Dict[str, np.ndarray] = {}
    for name, a in sd.arrays.items():
        shapes[name] = tuple(a.shape)
        dtypes[name] = a.dtype
        if sd.vars[name].vtype == VariableType.CONSTANT and a.numel() <= 64 \
                and not a.is_floating_point() and not a.is_complex() and a.dtype != torch.bool:
            values[name] = a.detach().cpu().numpy()
    for name, v in sd.vars.items():
        if name in shapes or v.vtype != VariableType.PLACEHOLDER \
                or v.shape is None:
            continue
        shapes[name] = tuple(lead if d is None else int(d) for d in v.shape)
        dtypes[name] = v.dtype or torch.float32

    with torch.no_grad():
        for n in sd.ops:
            if any(i not in shapes for i in n.inputs):
                continue
            if n.op == "shape_of":
                out = n.outputs[0]
                values[out] = np.asarray(shapes[n.inputs[0]], np.int64)
                shapes[out] = values[out].shape
                dtypes[out] = torch.int32
                continue
            try:
                fn = n.attrs["fn"] if n.op == "__callable__" else get_op(n.op)
                attrs = {} if n.op == "__callable__" else n.attrs
                conc = {j: values[i] for j, i in enumerate(n.inputs) if i in values}
                if conc and len(conc) == len(n.inputs):
                    # fully concrete: evaluate for real, so shape ARITHMETIC
                    # (slice/stack/mul of shape_of) stays a value
                    res = fn(*[as_tensor(conc[j], "cpu") for j in range(len(n.inputs))],
                             **attrs)
                    res_t = res if isinstance(res, (tuple, list)) else (res,)
                    for o, r in zip(n.outputs, res_t):
                        arr = r.detach().cpu().numpy() if isinstance(r, torch.Tensor) \
                            else np.asarray(r)
                        shapes[o] = arr.shape
                        dtypes[o] = as_tensor(arr, "cpu").dtype
                        if arr.dtype.kind in "iu" and arr.size <= 64:
                            values[o] = arr
                    continue
                rule = _shape_rule(n.op, [(shapes[i], dtypes[i]) for i in n.inputs])
                if rule is not None:
                    for o, (shp, dt) in zip(n.outputs, rule):
                        shapes[o], dtypes[o] = shp, dt
                    continue
                meta = [torch.empty(shapes[i], dtype=dtypes[i], device="meta")
                        for i in n.inputs]
                try:  # known values as CPU tensors (a shape operand is read)
                    res = fn(*[as_tensor(conc[j], "cpu") if j in conc else meta[j]
                               for j in range(len(n.inputs))], **attrs)
                except Exception:  # else every input as a meta tensor
                    res = fn(*meta, **attrs)
                res_t = res if isinstance(res, (tuple, list)) else (res,)
                for o, r in zip(n.outputs, res_t):
                    shapes[o] = tuple(r.shape)
                    dtypes[o] = r.dtype
            except Exception:
                continue
    return shapes, values


def infer_shapes(sd: SameDiff, lead: Optional[int] = None
                 ) -> Optional[Dict[str, Tuple[int, ...]]]:
    """Shapes-only view of :func:`_infer`. Returns None — with a warning,
    since the layout passes then silently lose their measured win — when
    not a single op output could be resolved."""
    shapes, _ = _infer(sd, lead)
    if sd.ops and not any(o in shapes for n in sd.ops for o in n.outputs):
        import warnings
        warnings.warn(
            "graph_optimizer: shape inference resolved no op outputs; "
            "layout passes skipped — imported 2-D matmul round trips will "
            "keep their layout-conversion copies", stacklevel=2)
        return None
    return shapes or None


def fold_shape_chains(sd: SameDiff) -> int:
    """Public wrapper of :func:`_fold_shape_chains` (count only)."""
    return _fold_shape_chains(sd)[0]


def _fold_shape_chains(sd: SameDiff):
    """Rewrite ``reshape_dynamic`` (tensor shape operand, emitted by the TF
    importer for computed shapes) into static ``reshape`` attrs using the
    propagated shape VALUES from :func:`_infer`.

    Dims that depend on a dynamic (None) placeholder dim are detected by
    inferring twice with two different substituted leading dims: entries
    whose value CHANGES between the runs become -1 in the rewritten attr
    (reshape resolves one -1; chains needing more stay dynamic).

    Returns ``(folded_count, shapes_or_None)`` — the first run's shapes are
    handed back so optimize() can feed the layout passes without a third
    full graph walk (the rewrite preserves every output's shape)."""
    if not any(n.op == "reshape_dynamic" for n in sd.ops):
        return 0, None
    has_none = any(v.vtype == VariableType.PLACEHOLDER and v.shape
                   and any(d is None for d in v.shape)
                   for v in sd.vars.values())
    known_lead = [v.shape[0] for v in sd.vars.values()
                  if v.vtype == VariableType.PLACEHOLDER and v.shape
                  and v.shape[0] is not None]
    lead = max(set(known_lead), key=known_lead.count) if known_lead else 2
    s1, v1 = _infer(sd, lead=lead)
    # the second run MUST use a different substituted dim or batch-dependent
    # entries would match across runs and get baked as static ints
    v2 = _infer(sd, lead=lead + 1)[1] if has_none else v1
    folded = 0
    for n in sd.ops:
        if n.op != "reshape_dynamic":
            continue
        sname = n.inputs[1]
        a, b = v1.get(sname), v2.get(sname)
        if a is None or b is None or a.shape != b.shape or a.ndim != 1:
            continue
        target = [int(x) if int(x) == int(y) else -1 for x, y in zip(a, b)]
        if sum(1 for t in target if t == -1) > 1:
            continue
        n.op = "reshape"
        n.inputs = n.inputs[:1]
        n.attrs = {"shape": target}
        folded += 1
    return folded, s1


def _new_array_var(sd: SameDiff, base: str) -> str:
    from deeplearning4j_tpu_torch.autodiff.samediff import SDVariable
    name = sd._unique(base)
    sd.vars[name] = SDVariable(sd, name, VariableType.ARRAY)
    return name


def fold_2d_matmuls(sd: SameDiff, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """matmul(reshape(x, (M, K)), W) -> reshape(matmul(x, W), (M, N)) for
    rank>=3 x — the matmul runs batched in x's natural layout; the
    compensating reshape sinks/collapses in the companion passes."""
    changed = 0
    prod = _producers(sd)
    uses = _use_counts(sd)
    for mm in list(sd.ops):
        if mm.op != "matmul" or mm.attrs.get("transpose_a") \
                or mm.attrs.get("transpose_b"):
            continue
        a_name, w_name = mm.inputs
        r = prod.get(a_name)
        if r is None or r.op != "reshape":
            continue
        x = r.inputs[0]
        xs, ws, a2 = shapes.get(x), shapes.get(w_name), shapes.get(a_name)
        if xs is None or ws is None or a2 is None:
            continue
        if len(a2) != 2 or len(xs) < 3 or len(ws) != 2:
            continue
        src, src_shape = x, xs
        if xs[-1] != a2[-1]:
            # The flattening reshape also MERGES trailing dims — the
            # attention output projection's (B,T,H,dk) -> (B·T, H·dk).
            # A trailing-dim merge is contiguity-preserving (a bitcast on
            # TPU), so fold to: cheap pre-reshape (B,T,H·dk) + batched 3-D
            # matmul. Without this the projection ran 2-D and its
            # (B·T, d) output materialized in a layout the surrounding
            # 3-D ops then copy-converted (~1.4 ms/step on imported
            # BERT-base).
            k_dim = a2[-1]
            p, j = 1, len(xs)
            while j > 0 and p < k_dim:
                j -= 1
                p *= xs[j]
            if p != k_dim or j < 2:
                continue
            pre = _new_array_var(sd, a_name + "/merged")
            sd.ops.insert(sd.ops.index(mm), OpNode(
                op="reshape", inputs=[x], outputs=[pre],
                attrs={"shape": [-1] + [int(d) for d in xs[1:j]]
                       + [int(k_dim)]}))
            shapes[pre] = tuple(xs[:j]) + (k_dim,)
            src, src_shape = pre, shapes[pre]
        old_out = mm.outputs[0]
        mid = _new_array_var(sd, old_out + "/3d")
        mm.inputs = [src, w_name]
        mm.outputs = [mid]
        shapes[mid] = tuple(src_shape[:-1]) + (ws[-1],)
        # -1 leading dim: inferred dims may be guesses for dynamic-batch
        # placeholders, so never bake them into emitted attrs
        sd.ops.insert(sd.ops.index(mm) + 1, OpNode(
            op="reshape", inputs=[mid], outputs=[old_out],
            attrs={"shape": [-1, int(ws[-1])]}))
        if uses.get(a_name, 0) == 1 and a_name not in sd.loss_variables:
            sd.ops.remove(r)
        changed += 1
        prod = _producers(sd)
        uses = _use_counts(sd)
    return changed


def sink_reshapes(sd: SameDiff, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """reshape-then-elementwise -> elementwise-then-reshape, when the other
    operand (if any) is rank<=1 and the reshape preserves the trailing axis
    (so broadcasting is unaffected). Run to fixpoint with collapse."""
    changed = 0
    while True:
        prod = _producers(sd)
        uses = _use_counts(sd)
        found = False
        for node in list(sd.ops):
            if node.op in _SINK_UNARY:
                r_idx = 0
            elif node.op in _SINK_BINARY and len(node.inputs) == 2:
                r_idx = None
                for i in (0, 1):
                    cand = prod.get(node.inputs[i])
                    other = shapes.get(node.inputs[1 - i])
                    if (cand is not None and cand.op == "reshape"
                            and other is not None and len(other) <= 1):
                        r_idx = i
                        break
                if r_idx is None:
                    continue
            else:
                continue
            r_name = node.inputs[r_idx]
            r = prod.get(r_name)
            if r is None or r.op != "reshape":
                continue
            if uses.get(r_name, 0) != 1 or r_name in sd.loss_variables:
                continue
            x = r.inputs[0]
            xs, tgt = shapes.get(x), shapes.get(r_name)
            if xs is None or tgt is None or not xs or not tgt \
                    or xs[-1] != tgt[-1]:
                continue
            # the inserted reshape reuses the ORIGINAL node's target attr
            # (elementwise with a rank<=1 operand preserves shape), keeping
            # any -1 dynamic dims; 0-dims (copy-dim) are positional w.r.t.
            # the input, which changes here — skip those
            orig_tgt = list(r.attrs.get("shape", ()))
            if not orig_tgt or any(int(d) == 0 for d in orig_tgt):
                continue
            old_out = node.outputs[0]
            mid = _new_array_var(sd, old_out + "/sunk")
            node.inputs[r_idx] = x
            node.outputs = [mid]
            shapes[mid] = xs
            sd.ops.insert(sd.ops.index(node) + 1, OpNode(
                op="reshape", inputs=[mid], outputs=[old_out],
                attrs={"shape": orig_tgt}))
            sd.ops.remove(r)
            changed += 1
            found = True
            break
        if not found:
            return changed


def collapse_reshapes(sd: SameDiff, shapes: Dict[str, Tuple[int, ...]]) -> int:
    """reshape(reshape(x)) -> reshape(x) (the inner one dies when sole)."""
    changed = 0
    while True:
        prod = _producers(sd)
        uses = _use_counts(sd)
        found = False
        for r2 in sd.ops:
            if r2.op != "reshape":
                continue
            # 0-dims (copy-dim) are positional w.r.t. the input, which this
            # rewrite changes — leave such reshapes alone
            if any(int(d) == 0 for d in r2.attrs.get("shape", ())):
                continue
            inner_name = r2.inputs[0]
            r1 = prod.get(inner_name)
            if r1 is None or r1.op != "reshape":
                continue
            r2.inputs[0] = r1.inputs[0]
            if uses.get(inner_name, 0) == 1 \
                    and inner_name not in sd.loss_variables:
                sd.ops.remove(r1)
            changed += 1
            found = True
            break
        if not found:
            return changed


def optimize_layout(sd: SameDiff,
                    shapes: Optional[Dict[str, Tuple[int, ...]]] = None
                    ) -> Dict[str, int]:
    """Run the 2-D-matmul folding + reshape sinking/collapsing to fixpoint.
    ``shapes`` may be handed in from an earlier _infer walk this round."""
    if shapes is None:
        shapes = infer_shapes(sd)
    if shapes is None:
        return {"layout_folds": 0}
    total = {"layout_folds": 0, "reshape_sinks": 0, "reshape_collapses": 0}
    for _ in range(50):
        a = fold_2d_matmuls(sd, shapes)
        b = sink_reshapes(sd, shapes)
        c = collapse_reshapes(sd, shapes)
        total["layout_folds"] += a
        total["reshape_sinks"] += b
        total["reshape_collapses"] += c
        if a + b + c == 0:
            break
    return total


def _is_padding_bias(sd: SameDiff, prod, name: str) -> bool:
    """True when `name` provably computes the additive key-padding pattern
    ((1 - float(mask)) * -LARGE, possibly reshaped): values are exactly 0 or
    -LARGE, so converting to a boolean mask preserves softmax outputs."""
    node = prod.get(name)
    if node is None:
        return False
    if node.op in ("reshape", "expand_dims", "identity"):
        return _is_padding_bias(sd, prod, node.inputs[0])
    if node.op != "mul" or len(node.inputs) != 2:
        return False
    for a, b in (node.inputs, node.inputs[::-1]):
        c = _const_scalar(sd, b)
        if c is None or c > -1e3:  # the -10000-style masking constant
            continue
        sub = prod.get(a)
        if sub is None or sub.op != "sub":
            continue
        one = _const_scalar(sd, sub.inputs[0])
        if one is not None and abs(one - 1.0) < 1e-12:
            src = prod.get(sub.inputs[1])
            # (1 - cast(mask)) where mask is a graph INPUT (placeholder):
            # the importer's key-padding contract is a 0/1-valued mask
            # feed. A cast of a COMPUTED tensor (e.g. a relative-position
            # score) is not provably {0,1} and must stay additive.
            if src is not None and src.op == "cast":
                cast_in = src.inputs[0]
                through = prod.get(cast_in)
                while through is not None and through.op in (
                        "reshape", "expand_dims", "identity"):
                    cast_in = through.inputs[0]
                    through = prod.get(cast_in)
                v = sd.vars.get(cast_in)
                if v is not None and v.vtype == VariableType.PLACEHOLDER:
                    return True
    return False


def fuse_attention(sd: SameDiff) -> int:
    """batch_matmul(q, k, T) * scale [+ bias] -> softmax -> batch_matmul(v)
    collapses to scaled_dot_product_attention. When the bias is the proven
    key-padding pattern, the fused op routes through dot_product_attention
    (Pallas flash kernel for eligible shapes)."""
    fused = 0
    while True:
        prod = _producers(sd)
        uses = _use_counts(sd)

        def sole(name):
            return uses.get(name, 0) == 1 and name not in sd.loss_variables

        match = None
        for bm2 in sd.ops:
            if bm2.op != "batch_matmul" or bm2.attrs.get("transpose_a") \
                    or bm2.attrs.get("transpose_b"):
                continue
            p_name, v_name = bm2.inputs
            sm = prod.get(p_name)
            if sm is None or sm.op != "softmax" or not sole(p_name):
                continue
            if sm.attrs.get("axis", -1) != -1:
                continue  # fused op normalizes the LAST axis only
            scores_name = sm.inputs[0]
            scores = prod.get(scores_name)
            if scores is None or not sole(scores_name):
                continue
            def resolve_scaled(node):
                """-> (qk_name, scale, bm1) for div/mul-by-const of a
                transpose_b batch_matmul, else None. Checks BOTH operand
                orders for mul (exporters emit mul(const, qk) too; div's
                constant is always the divisor)."""
                orders = [(node.inputs[0], node.inputs[1])]
                if node.op == "mul":
                    orders.append((node.inputs[1], node.inputs[0]))
                for qk_name, c_name in orders:
                    c = _const_scalar(sd, c_name)
                    if c is None:
                        continue
                    bm1 = prod.get(qk_name)
                    if (bm1 is None or bm1.op != "batch_matmul"
                            or not bm1.attrs.get("transpose_b")
                            or bm1.attrs.get("transpose_a")
                            or not sole(qk_name)):
                        continue
                    return qk_name, (1.0 / c) if node.op == "div" else c, bm1
                return None

            bias_name = None
            resolved = None
            scale_node = None
            if scores.op == "add":
                sa, sb = scores.inputs
                # one side is the scaled qk product, the other the bias;
                # try BOTH pairings fully (the bias itself may be a mul)
                for cand, other in ((sa, sb), (sb, sa)):
                    cn = prod.get(cand)
                    if cn is None or cn.op not in ("div", "mul") \
                            or not sole(cand):
                        continue
                    resolved = resolve_scaled(cn)
                    if resolved is not None:
                        bias_name = other
                        scale_node = cn
                        break
            elif scores.op in ("div", "mul"):
                resolved = resolve_scaled(scores)
                scale_node = scores
            if resolved is None:
                continue
            qk_name, scale, bm1 = resolved
            q_name, k_name = bm1.inputs
            boolean_bias = (bias_name is not None
                            and _is_padding_bias(sd, prod, bias_name))
            dead = [bm1, scale_node] \
                + ([scores] if scores is not scale_node else []) + [sm, bm2]
            inputs = [q_name, k_name, v_name] + (
                [bias_name] if bias_name is not None else [])
            match = (dead, inputs, scale, boolean_bias, bm2)
            break
        if not match:
            return fused
        dead, inputs, scale, boolean_bias, bm2 = match
        _replace(sd, dead, OpNode(
            op="scaled_dot_product_attention", inputs=inputs,
            outputs=list(bm2.outputs),
            attrs={"scale": scale, "boolean_bias": boolean_bias}))
        fused += 1
