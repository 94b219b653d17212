"""The port's GraphDef reader against tensorflow's own parse.

Every GraphDef the importer tests build (``_torch_tf_graphs``: frozen
graphs, a function library with While/If/PartitionedCall bodies, TF1
frames) and the tiny BERT's is serialized by tensorflow and read back by
``graphdef_proto``: every field the reader's schema holds equals
tensorflow's (messages, maps, repeated and oneof fields, recursively), and
every TensorProto decodes to ``tensor_util.MakeNdarray``'s array (same
dtype, shape and bits). TensorProtos in the forms tensorflow writes for
small constants: one value filling the shape, a shorter list repeating its
last value, float16 and bfloat16 in ``half_val``, and the bool, string,
int64, int32, uint8 and double fields, negative varints included, and
``tensor_content`` of each dtype. Fields the reader does not know
(``experimental_debug_info``, a full type) are skipped. Exact equality.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import _torch_tf_graphs as graphs  # noqa: E402
from tensorflow.python.framework import tensor_util  # noqa: E402

from deeplearning4j_tpu.imports.tf_oracles import build_bert_graphdef  # noqa: E402
from deeplearning4j_tpu_torch.imports import graphdef_proto as gp  # noqa: E402


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype == object:
        assert a.tolist() == b.tolist()
    else:
        assert a.tobytes() == b.tobytes()


def assert_same_message(pb, msg, path="", counts=None):
    """Every field of tensorflow's message ``pb`` that the reader's schema
    names equals the reader's; a TensorProto also decodes alike."""
    known = gp._BY_NAME[msg._schema]
    for fd, value in pb.ListFields():
        where = f"{path}.{fd.name}"
        if fd.name not in known:
            continue
        assert msg.has_field(fd.name), where
        mine = getattr(msg, fd.name)
        if fd.message_type is not None and fd.message_type.GetOptions().map_entry:
            assert sorted(mine) == sorted(value), where
            for k in value:
                if isinstance(value[k], str):
                    assert mine[k] == value[k], f"{where}[{k}]"
                else:
                    assert_same_message(value[k], mine[k], f"{where}[{k}]", counts)
        elif fd.message_type is not None:
            if fd.is_repeated:
                assert len(mine) == len(value), where
                for i, (p, m) in enumerate(zip(value, mine)):
                    assert_same_message(p, m, f"{where}[{i}]", counts)
            else:
                assert_same_message(value, mine, where, counts)
        elif fd.is_repeated:
            assert list(mine) == list(value), where
        else:
            assert mine == value, (where, mine, value)
    if msg._schema == "AttrValue":
        assert msg.which_oneof() == pb.WhichOneof("value"), path
    if msg._schema == "TensorProto":
        _same_array(gp.make_ndarray(msg), tensor_util.MakeNdarray(pb))
        if counts is not None:
            counts["tensors"] += 1


def _check_graph(gd):
    mine = gp.parse_graph_def(gd.SerializeToString())
    counts = {"tensors": 0}
    assert_same_message(gd, mine, "GraphDef", counts)
    assert len(mine.node) == len(gd.node)
    assert len(mine.library.function) == len(gd.library.function)
    return counts["tensors"]


@pytest.mark.parametrize("name", sorted(graphs.BUILDERS))
def test_reader_matches_tensorflow_on_the_import_graphs(name):
    assert _check_graph(graphs.build(name)["gd"]) > 0


def test_reader_matches_tensorflow_on_the_tiny_bert():
    gd = build_bert_graphdef(batch=2, seq_len=16, hidden=32, layers=2, heads=4, intermediate=64,
                             vocab=50)[0]
    assert _check_graph(gd) > 20


def _proto(dtype, shape, **vals):
    t = tf.make_tensor_proto(np.zeros(0, dtype.as_numpy_dtype))
    t.ClearField("tensor_content")
    t.dtype = dtype.as_datatype_enum
    t.tensor_shape.CopyFrom(tf.TensorShape(shape).as_proto())
    for field, v in vals.items():
        getattr(t, field).extend(v)
    return t


def _bits(v, dtype):
    return int(np.array(v, dtype=dtype.as_numpy_dtype).view(np.uint16))


TENSORS = {
    "fill": _proto(tf.float32, (3, 4), float_val=[0.25]),
    "repeat-last": _proto(tf.float32, (2, 3), float_val=[1.0, -2.0, 3.5]),
    "empty-values": _proto(tf.float32, (2, 2)),
    "half": _proto(tf.float16, (2, 3), half_val=[_bits(1.5, tf.float16),
                                                  _bits(-0.25, tf.float16)]),
    "bfloat16": _proto(tf.bfloat16, (4,), half_val=[_bits(3.0, tf.bfloat16)]),
    "bool": _proto(tf.bool, (2, 2), bool_val=[True, False, True]),
    "string": _proto(tf.string, (3,), string_val=[b"ab", b"c"]),
    "int64-negative": _proto(tf.int64, (4,), int64_val=[-1, 2 ** 40, -(2 ** 62), 7]),
    "int32-negative": _proto(tf.int32, (2, 2), int_val=[-5, 3]),
    "uint8": _proto(tf.uint8, (3,), int_val=[255, 0, 7]),
    "double": _proto(tf.float64, (2,), double_val=[1e-300, -2.5]),
    "scalar": _proto(tf.int32, (), int_val=[-7]),
}
for _dt in (np.float32, np.float64, np.int32, np.int64, np.float16, np.bool_, np.uint8):
    TENSORS[f"content-{np.dtype(_dt).name}"] = tf.make_tensor_proto(
        (np.arange(-6, 6).reshape(3, 4) * 1.75).astype(_dt))


@pytest.mark.parametrize("name", sorted(TENSORS))
def test_tensor_proto_decodes_as_make_ndarray(name):
    pb = TENSORS[name]
    mine = gp.parse("TensorProto", pb.SerializeToString())
    assert_same_message(pb, mine, name)


def test_unknown_fields_are_skipped():
    gd = tf.compat.v1.GraphDef()
    n = gd.node.add()
    n.name, n.op = "c", "Const"
    n.attr["value"].tensor.CopyFrom(tf.make_tensor_proto(np.float32(2.0)))
    n.experimental_debug_info.original_node_names.append("orig")
    n.experimental_type.type_id = 3
    gd.versions.producer = 1234
    mine = gp.parse_graph_def(gd.SerializeToString())
    assert [(m.name, m.op) for m in mine.node] == [("c", "Const")]
    assert mine.versions.producer == 1234
    assert gp.make_ndarray(mine.node[0].attr["value"].tensor) == np.float32(2.0)


def test_tensor_proto_round_trips_through_the_reader():
    """The importer's inline constants (``tensor_proto``) decode to the
    arrays they were made from."""
    for a in (np.arange(6, dtype=np.int64).reshape(2, 3), np.float32(1.5),
              np.linspace(0, 1, 5).astype(np.float64), np.array([True, False])):
        _same_array(gp.make_ndarray(gp.tensor_proto(a)), np.asarray(a))
