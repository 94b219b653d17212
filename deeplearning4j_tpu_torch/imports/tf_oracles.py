"""The imported-BERT fine-tuning workload, with or without TensorFlow.

Counterpart of ``deeplearning4j_tpu/imports/tf_oracles.py``. The JAX
package builds a frozen BERT encoder GraphDef with TensorFlow
(``build_bert_graphdef``) and imports it with ``TFGraphMapper``. The port
takes that route too (:class:`~.tf_import.TFGraphMapper` reads the protobuf
itself), but the card's machine has no tensorflow to build the graph: a
GraphDef made on a machine that has it is committed with its weight
matrices stripped (``tests/data/bert_base_b64_t128.pb``, 80 KB in place of
440 MB), and :func:`refill_bert_graphdef` refills them from
:func:`bert_weights`, which draws what ``build_bert_graphdef`` draws (the
same ``default_rng(seed)`` stream in the same order, JAX ``:43-66``).

:func:`build_bert_samediff` emits, through the port's SameDiff API, the op
graph the import of that GraphDef yields before ``optimize()``: the same
ops in the same order, with the same attrs and the same variable names
(TF's node names: ``MatMul_5``, its weight ``MatMul_5/b``, ...).
:func:`bert_synthetic_batch` and :func:`graft_classifier` are the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def bert_weights(seq_len: int, hidden: int, layers: int, intermediate: int, vocab: int,
                 type_vocab: int = 2, seed: int = 0) -> Dict[str, np.ndarray]:
    """``build_bert_graphdef``'s weights by logical name, drawn as it draws
    them (normal(0, 0.02) float32 matrices in one ``default_rng(seed)``
    stream; zero biases; LayerNorm gains one, offsets zero)."""
    rng = np.random.default_rng(seed)
    W: Dict[str, np.ndarray] = {}

    def mk(name, shape, scale=0.02):
        W[name] = rng.normal(0.0, scale, shape).astype(np.float32)

    mk("word_emb", (vocab, hidden))
    mk("pos_emb", (seq_len, hidden))
    mk("type_emb", (type_vocab, hidden))
    W["emb_ln_g"] = np.ones(hidden, np.float32)
    W["emb_ln_b"] = np.zeros(hidden, np.float32)
    for i in range(layers):
        for nm, shape in (("q", (hidden, hidden)), ("k", (hidden, hidden)),
                          ("v", (hidden, hidden)), ("ao", (hidden, hidden)),
                          ("ff1", (hidden, intermediate)),
                          ("ff2", (intermediate, hidden))):
            mk(f"l{i}_{nm}_w", shape)
            W[f"l{i}_{nm}_b"] = np.zeros(shape[1], np.float32)
        for nm in ("attn_ln", "out_ln"):
            W[f"l{i}_{nm}_g"] = np.ones(hidden, np.float32)
            W[f"l{i}_{nm}_b"] = np.zeros(hidden, np.float32)
    mk("pool_w", (hidden, hidden))
    W["pool_b"] = np.zeros(hidden, np.float32)
    return W


def refill_bert_graphdef(graph_def, refill: Dict[str, str],
                         weights: Dict[str, np.ndarray]) -> None:
    """Write ``weights[key]`` into the Const node of each ``node: key`` of
    ``refill`` (the reader's GraphDef, in place); each node's stripped fill
    must have the weight's shape."""
    from deeplearning4j_tpu_torch.imports.graphdef_proto import Message, tensor_proto
    nodes = {n.name: n for n in graph_def.node}
    for name, key in refill.items():
        node, arr = nodes[name], weights[key]
        shape = tuple(int(d.size) for d in node.attr["value"].tensor.tensor_shape.dim)
        if node.op != "Const" or shape != arr.shape:
            raise ValueError(f"fixture node {name!r} ({node.op}, {shape}) cannot hold "
                             f"{key!r} {arr.shape}")
        node.attr["value"] = Message("AttrValue", tensor=tensor_proto(arr))


def _tf_name(kind: str, k: int) -> str:
    """TF's k-th node of a kind: ``MatMul``, ``MatMul_1``, ..."""
    return kind if k == 0 else f"{kind}_{k}"


class _Emitter:
    """Emits ops as the importer maps GraphDef nodes: a Const input becomes
    a CONSTANT of its node's name at its first use, then the op, named as
    its node."""

    def __init__(self, sd):
        self.sd = sd

    def const(self, name: str, value) -> str:
        if name not in self.sd.vars:
            self.sd.constant(name, value)
        return name

    def op(self, op: str, name: str, inputs: List[str], **attrs) -> str:
        self.sd._apply(op, [self.sd.vars[i] for i in inputs], attrs=attrs or None, name=name)
        return name


def build_bert_samediff(batch: int = 2, seq_len: int = 128, hidden: int = 768,
                        layers: int = 12, heads: int = 12, intermediate: int = 3072,
                        vocab: int = 30522, type_vocab: int = 2, seed: int = 0,
                        device=None) -> Tuple[object, List[str], List[str],
                                              Dict[str, np.ndarray]]:
    """The graph ``TFGraphMapper.import_graph(build_bert_graphdef(...),
    optimize=False)`` gives, built directly (original google-research/bert:
    post-LN, gelu through erf, an additive attention mask, a tanh pooler on
    [CLS]). Returns ``(sd, input_names, output_names, weights)`` as
    ``build_bert_graphdef`` returns ``(graph_def, ...)``: the inputs
    ``input_ids``, ``token_type_ids``, ``input_mask`` and the outputs
    ``Identity`` (= ``sequence_output``) and ``Identity_1`` (=
    ``pooled_output``). The arrays live on ``device``."""
    from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
    W = bert_weights(seq_len, hidden, layers, intermediate, vocab, type_vocab, seed)
    dk = hidden // heads
    B, T, H = batch, seq_len, hidden
    sd = SameDiff(device)
    for name in ("input_ids", "input_mask", "token_type_ids"):  # GraphDef order
        sd.placeholder(name, (B, T))
    e = _Emitter(sd)
    eps = np.float32(1e-12)

    def layer_norm(x, means, sq, sub, rsqrt, muls, adds, g, b):
        """``(x - mean) * rsqrt(var + eps) * g + b`` in the GraphDef's order."""
        mean = e.op("reduce_mean", _tf_name("Mean", means[0]), [x], axis=[-1], keepdims=True)
        centered = e.op("sub", _tf_name("sub", sub), [x, mean])
        sqd = e.op("squared_difference", _tf_name("SquaredDifference", sq), [x, mean])
        var = e.op("reduce_mean", _tf_name("Mean", means[1]), [sqd], axis=[-1], keepdims=True)
        a_eps = _tf_name("add", adds[0])
        v_eps = e.op("add", a_eps, [var, e.const(a_eps + "/y", eps)])
        r = e.op("rsqrt", _tf_name("Rsqrt", rsqrt), [v_eps])
        normed = e.op("mul", _tf_name("mul", muls[0]), [centered, r])
        m_g = _tf_name("mul", muls[1])
        scaled = e.op("mul", m_g, [normed, e.const(m_g + "/y", g)])
        a_b = _tf_name("add", adds[1])
        return e.op("add", a_b, [scaled, e.const(a_b + "/y", b)])

    def dense(x, m, a, w, b):
        """``matmul(x, w) + b``: MatMul_m with its weight ``MatMul_m/b``."""
        mm = _tf_name("MatMul", m)
        y = e.op("matmul", mm, [x, e.const(mm + "/b", w)], transpose_a=False,
                 transpose_b=False)
        ad = _tf_name("add", a)
        return e.op("add", ad, [y, e.const(ad + "/y", b)])

    def heads_of(x, r, m, a, t, w, b):
        """A projection split into heads: (B*T, H) -> (B, heads, T, dk)."""
        flat = e.op("reshape", _tf_name("Reshape", r), [x], shape=[B * T, H])
        h = dense(flat, m, a, w, b)
        h = e.op("reshape", _tf_name("Reshape", r + 1), [h], shape=[B, T, heads, dk])
        return e.op("transpose", _tf_name("transpose", t), [h], perm=[0, 2, 1, 3])

    x = e.op("gather", "GatherV2", [e.const("GatherV2/params", W["word_emb"]), "input_ids"],
             axis=0)
    x = e.op("add", "add", [x, e.const("add/y", W["pos_emb"])])
    ty = e.op("gather", "GatherV2_1", [e.const("GatherV2_1/params", W["type_emb"]),
                                       "token_type_ids"], axis=0)
    x = e.op("add", "add_1", [x, ty])
    x = layer_norm(x, (0, 1), 0, 0, 0, (0, 1), (2, 3), W["emb_ln_g"], W["emb_ln_b"])
    adder = None
    for i in range(layers):
        r0, m0, a0, t0 = 1 + 10 * i, 8 * i, 4 + 14 * i, 4 * i
        q = heads_of(x, r0, m0, a0, t0, W[f"l{i}_q_w"], W[f"l{i}_q_b"])
        k = heads_of(x, r0 + 2, m0 + 1, a0 + 1, t0 + 1, W[f"l{i}_k_w"], W[f"l{i}_k_b"])
        s = e.op("batch_matmul", _tf_name("MatMul", m0 + 3), [q, k], transpose_a=False,
                 transpose_b=True)
        td = _tf_name("truediv", 2 * i)
        s = e.op("div", td, [s, e.const(td + "/y", np.float32(np.sqrt(dk)))])
        if adder is None:
            # additive mask (B, 1, 1, T): 0 to keep, -10000 for padding
            c = e.op("cast", "Cast", ["input_mask"], dtype="float32")
            c = e.op("sub", "sub_1", [e.const("sub_1/x", np.float32(1.0)), c])
            c = e.op("mul", "mul_2", [c, e.const("mul_2/y", np.float32(-10000.0))])
            adder = e.op("reshape", "Reshape", [c], shape=[B, 1, 1, T])
        s = e.op("add", _tf_name("add", a0 + 3), [s, adder])
        p = e.op("softmax", _tf_name("Softmax", i), [s])
        v = heads_of(x, r0 + 4, m0 + 2, a0 + 2, t0 + 2, W[f"l{i}_v_w"], W[f"l{i}_v_b"])
        ctx = e.op("batch_matmul", _tf_name("MatMul", m0 + 4), [p, v], transpose_a=False,
                   transpose_b=False)
        ctx = e.op("transpose", _tf_name("transpose", t0 + 3), [ctx], perm=[0, 2, 1, 3])
        ctx = e.op("reshape", _tf_name("Reshape", r0 + 6), [ctx], shape=[B * T, H])
        a = dense(ctx, m0 + 5, a0 + 4, W[f"l{i}_ao_w"], W[f"l{i}_ao_b"])
        a = e.op("reshape", _tf_name("Reshape", r0 + 7), [a], shape=[B, T, H])
        a = e.op("add", _tf_name("add", a0 + 5), [a, x])
        x = layer_norm(a, (2 + 4 * i, 3 + 4 * i), 1 + 2 * i, 2 + 2 * i, 1 + 2 * i,
                       (3 + 6 * i, 4 + 6 * i), (a0 + 6, a0 + 7),
                       W[f"l{i}_attn_ln_g"], W[f"l{i}_attn_ln_b"])
        flat = e.op("reshape", _tf_name("Reshape", r0 + 8), [x], shape=[B * T, H])
        h = dense(flat, m0 + 6, a0 + 8, W[f"l{i}_ff1_w"], W[f"l{i}_ff1_b"])
        # gelu: 0.5 * h * (1 + erf(h / sqrt(2)))
        half = _tf_name("mul", 5 + 6 * i)
        g = e.op("mul", half, [e.const(half + "/x", np.float32(0.5)), h])
        td = _tf_name("truediv", 2 * i + 1)
        z = e.op("div", td, [h, e.const(td + "/y", np.float32(np.sqrt(2.0)))])
        z = e.op("erf", _tf_name("Erf", i), [z])
        one = _tf_name("add", a0 + 9)
        z = e.op("add", one, [e.const(one + "/x", np.float32(1.0)), z])
        h = e.op("mul", _tf_name("mul", 6 + 6 * i), [g, z])
        h = dense(h, m0 + 7, a0 + 10, W[f"l{i}_ff2_w"], W[f"l{i}_ff2_b"])
        h = e.op("reshape", _tf_name("Reshape", r0 + 9), [h], shape=[B, T, H])
        h = e.op("add", _tf_name("add", a0 + 11), [h, x])
        x = layer_norm(h, (4 + 4 * i, 5 + 4 * i), 2 + 2 * i, 3 + 2 * i, 2 + 2 * i,
                       (7 + 6 * i, 8 + 6 * i), (a0 + 12, a0 + 13),
                       W[f"l{i}_out_ln_g"], W[f"l{i}_out_ln_b"])
    seq = e.op("identity", "sequence_output", [x])
    e.op("identity", "Identity", [seq])
    cls = e.op("strided_slice", "strided_slice", [x], begin=[0, 0, 0], end=[0, 1, 0],
               strides=[1, 1, 1], begin_mask=5, end_mask=5, shrink_axis_mask=2,
               new_axis_mask=0, ellipsis_mask=0)
    pooled = dense(cls, 8 * layers, 4 + 14 * layers, W["pool_w"], W["pool_b"])
    pooled = e.op("tanh", "Tanh", [pooled])
    pooled = e.op("identity", "pooled_output", [pooled])
    e.op("identity", "Identity_1", [pooled])
    return sd, ["input_ids", "token_type_ids", "input_mask"], ["Identity", "Identity_1"], W


def bert_synthetic_batch(batch, seq_len, vocab, n_classes=2, seed=0):
    """SST-2-shaped synthetic batch: ids, types, mask (ragged lengths),
    one-hot labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq_len)).astype(np.int32)
    types = np.zeros((batch, seq_len), np.int32)
    lens = rng.integers(seq_len // 2, seq_len + 1, batch)
    mask = (np.arange(seq_len)[None, :] < lens[:, None]).astype(np.int32)
    labels = np.eye(n_classes, dtype=np.float32)[rng.integers(0, n_classes, batch)]
    return ids, types, mask, labels


def graft_classifier(sd, pooled_name: str, hidden: int, n_classes: int = 2, seed: int = 0):
    """Graft a classification head and its loss onto an imported encoder
    (the reference fine-tune recipe: importGraph -> add head vars ->
    sd.fit). Returns ``(logits_var, loss_var)``; adds the placeholder
    ``labels``."""
    rng = np.random.default_rng(seed)
    w = sd.var("cls_w", array=rng.normal(0, 0.02, (hidden, n_classes)).astype(np.float32))
    b = sd.var("cls_b", array=np.zeros(n_classes, np.float32))
    pooled = sd.vars[pooled_name]
    logits = sd.invoke("linear", pooled, w, b, name="cls_logits")
    labels = sd.placeholder("labels", (None, n_classes))
    loss = sd.loss.softmax_cross_entropy("finetune_loss", labels, logits)
    return logits, loss
