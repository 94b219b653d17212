"""The BERT-base GraphDef fixture of the port's ``tf import`` phase.

``chip_smoke.py`` imports config #4's frozen BERT-base GraphDef (B=64,
T=128, vocab 30522, as ``bench.py`` builds it) on the card, where there is
no tensorflow to build it. The graph with its 110M weights is some 440 MB;
the committed fixture is the same GraphDef with every constant that holds
one value written as a one-value fill (lossless: ``MakeNdarray`` repeats
the value over the shape) and every random weight matrix written as a fill
of zeros, beside a JSON sidecar naming each such node's
``bert_weights`` key. ``tf_oracles.refill_bert_graphdef`` refills the
matrices from ``bert_weights`` (the same ``default_rng(seed)`` draws
``build_bert_graphdef`` makes).

Rebuild the committed files (tensorflow and the JAX package's
``tf_oracles`` needed)::

    python tests/_torch_bert_fixture.py

``strip`` is shared with the tests, which apply it at a tiny width.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
PB = os.path.join(DATA, "bert_base_b64_t128.pb")
SIDECAR = os.path.join(DATA, "bert_base_b64_t128.json")
CONFIG = dict(batch=64, seq_len=128, hidden=768, layers=12, heads=12, intermediate=3072,
              vocab=30522, type_vocab=2, seed=0)

_FIELDS = {np.dtype(np.float32): "float_val", np.dtype(np.float64): "double_val",
           np.dtype(np.int32): "int_val", np.dtype(np.int64): "int64_val",
           np.dtype(np.bool_): "bool_val"}


def strip(graph_def, weights):
    """``(stripped GraphDef, {node name: weights key})``: one-value
    constants as one-value fills, the weight matrices (non-uniform arrays
    of ``weights``) as fills of zeros."""
    import tensorflow as tf
    from tensorflow.core.framework import tensor_pb2
    from tensorflow.python.framework import tensor_util
    by_bytes = {}
    for key, arr in weights.items():
        by_bytes.setdefault((arr.shape, arr.tobytes()), key)
    out = tf.compat.v1.GraphDef()
    out.CopyFrom(graph_def)
    refill = {}
    for node in out.node:
        if node.op != "Const":
            continue
        tensor = node.attr["value"].tensor
        arr = tensor_util.MakeNdarray(tensor)
        if arr.dtype not in _FIELDS or arr.size <= 1:
            continue
        uniform = bool(np.all(arr == arr.flat[0]))
        key = None if uniform else by_bytes.get((arr.shape, arr.tobytes()))
        if not uniform and key is None:
            continue
        value = arr.flat[0] if uniform else np.zeros((), arr.dtype)
        fill = tensor_pb2.TensorProto(dtype=tensor.dtype)
        fill.tensor_shape.CopyFrom(tensor.tensor_shape)
        getattr(fill, _FIELDS[arr.dtype]).append(value.item())
        tensor.CopyFrom(fill)
        if key is not None:
            refill[node.name] = key
    return out, refill


def build(config=CONFIG):
    """The fixture's bytes and sidecar for ``config``."""
    sys.path.insert(0, os.path.dirname(HERE))
    from deeplearning4j_tpu.imports.tf_oracles import build_bert_graphdef
    gd, inputs, outputs, weights = build_bert_graphdef(**config)
    stripped, refill = strip(gd, weights)
    sidecar = {"built_by": "deeplearning4j_tpu.imports.tf_oracles.build_bert_graphdef",
               "config": config, "inputs": inputs, "outputs": outputs, "refill": refill}
    return stripped.SerializeToString(deterministic=True), sidecar


def main():
    os.makedirs(DATA, exist_ok=True)
    data, sidecar = build()
    with open(PB, "wb") as f:
        f.write(data)
    with open(SIDECAR, "w") as f:
        json.dump(sidecar, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{PB}: {len(data)} bytes; {len(sidecar['refill'])} weight matrices to refill")


if __name__ == "__main__":
    main()
