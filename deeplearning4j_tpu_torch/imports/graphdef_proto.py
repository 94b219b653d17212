"""A TensorFlow GraphDef reader with no tensorflow.

The JAX package parses a frozen GraphDef with tensorflow's generated protobuf
classes (``tf_import.py:48-53``) and turns its TensorProtos into arrays with
``tensor_util.MakeNdarray`` (``:211-216``). The card's machine has no
tensorflow, so the port reads the protobuf wire format itself, as the JAX
package's ONNX reader does (``imports/onnx_proto.py``): a varint /
fixed32 / fixed64 / length-delimited decoder and a schema table per message.

The field numbers are those of tensorflow's own descriptors
(``tensorflow/core/framework/{graph,node_def,attr_value,tensor,
tensor_shape,function,op_def,versions}.proto``). Covered: ``GraphDef``,
``NodeDef``, ``AttrValue`` (``list``, ``shape``, ``tensor``, ``type``,
``func`` and the scalars), ``TensorProto``, ``TensorShapeProto``,
``FunctionDefLibrary``, ``FunctionDef``, ``OpDef`` and ``VersionDef``.
Unknown fields (debug info, full types, resource handles) are skipped.

A parsed message is a :class:`Message`: its fields read as attributes with
proto3 defaults (``""``, ``0``, ``False``, an empty list, an empty message)
and a map field reads as a dict, so ``node.attr["value"].tensor`` and
``fdef.signature.input_arg`` read as they do on tensorflow's classes.
:func:`make_ndarray` decodes a TensorProto as ``MakeNdarray`` does.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

# ---------------------------------------------------------------- wire format

_VARINT, _FIXED64, _LEN, _FIXED32 = 0, 1, 2, 5


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip(buf, pos: int, wire: int) -> int:
    if wire == _VARINT:
        return _read_varint(buf, pos)[1]
    if wire == _FIXED64:
        return pos + 8
    if wire == _LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire == _FIXED32:
        return pos + 4
    raise ValueError(f"unsupported protobuf wire type {wire}")


def _signed(v: int) -> int:
    """A varint read as int64/int32 (negative values are sign-extended to
    ten bytes on the wire)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ------------------------------------------------------------------- schemas
# field number -> (name, kind, repeated). Kinds: "int" (signed varint),
# "uint" (unsigned varint), "bool", "enum", "float" (fixed32), "double"
# (fixed64), "str", "bytes", "msg:<Schema>", "map:<Schema>" (string key ->
# message), "smap" (string key -> string).

_SCHEMAS: Dict[str, Dict[int, Tuple[str, str, bool]]] = {
    "GraphDef": {
        1: ("node", "msg:NodeDef", True),
        2: ("library", "msg:FunctionDefLibrary", False),
        3: ("version", "int", False),
        4: ("versions", "msg:VersionDef", False),
    },
    "VersionDef": {
        1: ("producer", "int", False),
        2: ("min_consumer", "int", False),
        3: ("bad_consumers", "int", True),
    },
    "NodeDef": {
        1: ("name", "str", False),
        2: ("op", "str", False),
        3: ("input", "str", True),
        4: ("device", "str", False),
        5: ("attr", "map:AttrValue", False),
    },
    "AttrValue": {  # one of these is set (oneof "value")
        1: ("list", "msg:ListValue", False),
        2: ("s", "bytes", False),
        3: ("i", "int", False),
        4: ("f", "float", False),
        5: ("b", "bool", False),
        6: ("type", "enum", False),
        7: ("shape", "msg:TensorShapeProto", False),
        8: ("tensor", "msg:TensorProto", False),
        9: ("placeholder", "str", False),
        10: ("func", "msg:NameAttrList", False),
    },
    "ListValue": {
        2: ("s", "bytes", True),
        3: ("i", "int", True),
        4: ("f", "float", True),
        5: ("b", "bool", True),
        6: ("type", "enum", True),
        7: ("shape", "msg:TensorShapeProto", True),
        8: ("tensor", "msg:TensorProto", True),
        9: ("func", "msg:NameAttrList", True),
    },
    "NameAttrList": {
        1: ("name", "str", False),
        2: ("attr", "map:AttrValue", False),
    },
    "TensorShapeProto": {
        2: ("dim", "msg:Dim", True),
        3: ("unknown_rank", "bool", False),
    },
    "Dim": {
        1: ("size", "int", False),
        2: ("name", "str", False),
    },
    "TensorProto": {
        1: ("dtype", "enum", False),
        2: ("tensor_shape", "msg:TensorShapeProto", False),
        3: ("version_number", "int", False),
        4: ("tensor_content", "bytes", False),
        5: ("float_val", "float", True),
        6: ("double_val", "double", True),
        7: ("int_val", "int", True),
        8: ("string_val", "bytes", True),
        9: ("scomplex_val", "float", True),
        10: ("int64_val", "int", True),
        11: ("bool_val", "bool", True),
        12: ("dcomplex_val", "double", True),
        13: ("half_val", "int", True),
        16: ("uint32_val", "uint", True),
        17: ("uint64_val", "uint", True),
        18: ("float8_val", "bytes", False),
    },
    "FunctionDefLibrary": {
        1: ("function", "msg:FunctionDef", True),
    },
    "FunctionDef": {
        1: ("signature", "msg:OpDef", False),
        3: ("node_def", "msg:NodeDef", True),
        4: ("ret", "smap", False),
        5: ("attr", "map:AttrValue", False),
        6: ("control_ret", "smap", False),
    },
    "OpDef": {
        1: ("name", "str", False),
        2: ("input_arg", "msg:ArgDef", True),
        3: ("output_arg", "msg:ArgDef", True),
        4: ("attr", "msg:AttrDef", True),
        5: ("summary", "str", False),
        6: ("description", "str", False),
        16: ("is_aggregate", "bool", False),
        17: ("is_stateful", "bool", False),
        18: ("is_commutative", "bool", False),
        19: ("allows_uninitialized_input", "bool", False),
        20: ("control_output", "str", True),
    },
    "ArgDef": {
        1: ("name", "str", False),
        2: ("description", "str", False),
        3: ("type", "enum", False),
        4: ("type_attr", "str", False),
        5: ("number_attr", "str", False),
        6: ("type_list_attr", "str", False),
        16: ("is_ref", "bool", False),
    },
    "AttrDef": {
        1: ("name", "str", False),
        2: ("type", "str", False),
        3: ("default_value", "msg:AttrValue", False),
        4: ("description", "str", False),
        5: ("has_minimum", "bool", False),
        6: ("minimum", "int", False),
        7: ("allowed_values", "msg:AttrValue", False),
    },
}

# name -> (kind, repeated) per schema
_BY_NAME = {s: {name: (kind, rep) for name, kind, rep in f.values()}
            for s, f in _SCHEMAS.items()}
_SCALAR_DEFAULTS = {"int": 0, "uint": 0, "enum": 0, "bool": False, "float": 0.0,
                    "double": 0.0, "str": "", "bytes": b""}


class Message:
    """A parsed message: set fields in ``_fields``, unset ones read as their
    proto3 default. ``Message("NodeDef", name=..., op=...)`` builds one."""

    __slots__ = ("_schema", "_fields")

    def __init__(self, schema: str, **fields):
        object.__setattr__(self, "_schema", schema)
        object.__setattr__(self, "_fields", {})
        for k, v in fields.items():
            setattr(self, k, v)

    def __getattr__(self, name):
        fields = object.__getattribute__(self, "_fields")
        if name in fields:
            return fields[name]
        schema = object.__getattribute__(self, "_schema")
        try:
            kind, rep = _BY_NAME[schema][name]
        except KeyError:
            raise AttributeError(f"{schema} has no field {name!r}") from None
        if rep:  # stored, so that appends persist
            fields[name] = []
            return fields[name]
        if kind.startswith("map:") or kind == "smap":
            fields[name] = {}
            return fields[name]
        if kind.startswith("msg:"):
            return Message(kind[4:])  # an empty message, not stored
        return _SCALAR_DEFAULTS[kind]

    def __setattr__(self, name, value):
        if name not in _BY_NAME[self._schema]:
            raise AttributeError(f"{self._schema} has no field {name!r}")
        self._fields[name] = value

    def has_field(self, name: str) -> bool:
        return name in self._fields

    def which_oneof(self) -> str:
        """The set member of an ``AttrValue``'s ``value`` oneof (or None)."""
        for name, _, _ in _SCHEMAS[self._schema].values():
            if name in self._fields:
                return name
        return None

    def copy(self) -> "Message":
        """A copy whose lists and maps are new (their messages shared)."""
        out = Message(self._schema)
        for k, v in self._fields.items():
            out._fields[k] = list(v) if isinstance(v, list) else \
                dict(v) if isinstance(v, dict) else v
        return out


# ------------------------------------------------------------------- decoding


def _scalar(kind: str, wire: int, buf, pos: int):
    if wire == _VARINT:
        v, pos = _read_varint(buf, pos)
        if kind == "int":
            v = _signed(v)
        elif kind == "bool":
            v = bool(v)
        return v, pos
    if wire == _FIXED32:
        if kind != "float":
            raise ValueError(f"fixed32 wire type for a {kind} field")
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if wire == _FIXED64:
        if kind != "double":
            raise ValueError(f"fixed64 wire type for a {kind} field")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    raise ValueError(f"wire type {wire} for a {kind} field")


def _packed(kind: str, buf, pos: int, end: int) -> list:
    if kind == "float":
        n = (end - pos) // 4
        return list(struct.unpack_from(f"<{n}f", buf, pos))
    if kind == "double":
        n = (end - pos) // 8
        return list(struct.unpack_from(f"<{n}d", buf, pos))
    out = []
    while pos < end:
        v, pos = _scalar(kind, _VARINT, buf, pos)
        out.append(v)
    return out


def _map_entry(buf, pos: int, end: int, value_kind: str):
    key, value = "", (Message(value_kind[4:]) if value_kind.startswith("map:") else "")
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field in (1, 2) and wire == _LEN:
            n, pos = _read_varint(buf, pos)
            if field == 1:
                key = bytes(buf[pos:pos + n]).decode()
            elif value_kind.startswith("map:"):
                value = _decode(value_kind[4:], buf, pos, pos + n)
            else:
                value = bytes(buf[pos:pos + n]).decode()
            pos += n
        else:
            pos = _skip(buf, pos, wire)
    return key, value


def _decode(schema: str, buf, pos: int, end: int) -> Message:
    table = _SCHEMAS[schema]
    msg = Message(schema)
    fields = msg._fields
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        spec = table.get(field)
        if spec is None:
            pos = _skip(buf, pos, wire)
            continue
        name, kind, rep = spec
        if kind.startswith("map:") or kind == "smap":
            n, pos = _read_varint(buf, pos)
            k, v = _map_entry(buf, pos, pos + n, kind)
            fields.setdefault(name, {})[k] = v
            pos += n
        elif kind.startswith("msg:"):
            n, pos = _read_varint(buf, pos)
            sub = _decode(kind[4:], buf, pos, pos + n)
            pos += n
            if rep:
                fields.setdefault(name, []).append(sub)
            else:
                fields[name] = sub
        elif kind in ("str", "bytes"):
            n, pos = _read_varint(buf, pos)
            raw = bytes(buf[pos:pos + n])
            pos += n
            v = raw.decode() if kind == "str" else raw
            if rep:
                fields.setdefault(name, []).append(v)
            else:
                fields[name] = v
        elif rep and wire == _LEN:  # packed scalars
            n, pos = _read_varint(buf, pos)
            fields.setdefault(name, []).extend(_packed(kind, buf, pos, pos + n))
            pos += n
        else:
            v, pos = _scalar(kind, wire, buf, pos)
            if rep:
                fields.setdefault(name, []).append(v)
            else:
                fields[name] = v
    return msg


def parse(schema: str, data) -> Message:
    """Decode one serialized message of ``schema`` (``"GraphDef"``, ...)."""
    buf = memoryview(data) if not isinstance(data, memoryview) else data
    return _decode(schema, buf, 0, len(buf))


def parse_graph_def(data) -> Message:
    """A serialized ``GraphDef`` (the bytes of a frozen ``.pb``)."""
    return parse("GraphDef", data)


def read_graph_def(path: str) -> Message:
    with open(path, "rb") as f:
        return parse_graph_def(f.read())


# ------------------------------------------------------------------- tensors

# TF DataType enum -> numpy dtype (``types.proto``)
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8, DT_STRING = 1, 2, 3, 4, 5, 6, 7
DT_COMPLEX64, DT_INT64, DT_BOOL, DT_BFLOAT16, DT_UINT16, DT_COMPLEX128 = 8, 9, 10, 14, 17, 18
DT_HALF, DT_UINT32, DT_UINT64 = 19, 22, 23

_NUMPY = {DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
          DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8, DT_STRING: object,
          DT_COMPLEX64: np.complex64, DT_INT64: np.int64, DT_BOOL: np.bool_,
          DT_UINT16: np.uint16, DT_COMPLEX128: np.complex128, DT_HALF: np.float16,
          DT_UINT32: np.uint32, DT_UINT64: np.uint64}

# TF dtype names (``tf.dtypes.as_dtype(enum).name``), as the importer's
# ``Cast`` mapping reads them
DTYPE_NAMES = {DT_FLOAT: "float32", DT_DOUBLE: "float64", DT_INT32: "int32",
               DT_UINT8: "uint8", DT_INT16: "int16", DT_INT8: "int8", DT_STRING: "string",
               DT_COMPLEX64: "complex64", DT_INT64: "int64", DT_BOOL: "bool",
               DT_BFLOAT16: "bfloat16", DT_UINT16: "uint16", DT_COMPLEX128: "complex128",
               DT_HALF: "float16", DT_UINT32: "uint32", DT_UINT64: "uint64"}


def _bfloat16():
    import ml_dtypes  # numpy has no bfloat16; tensorflow's is ml_dtypes'
    return ml_dtypes.bfloat16


def numpy_dtype(dt: int):
    if dt == DT_BFLOAT16:
        return np.dtype(_bfloat16())
    if dt not in _NUMPY:
        raise TypeError(f"unsupported TensorProto dtype {dt}")
    return np.dtype(_NUMPY[dt])


def make_ndarray(tensor: Message) -> np.ndarray:
    """A TensorProto as numpy, as ``tensor_util.MakeNdarray`` decodes it:
    ``tensor_content`` little-endian; otherwise the typed ``*_val`` field,
    a shorter list repeating its last value over the shape (one value
    fills it), no values giving zeros; ``half_val`` holds float16 and
    bfloat16 as their integer bits."""
    shape = [int(d.size) for d in tensor.tensor_shape.dim]
    num = int(np.prod(shape, dtype=np.int64))
    dt = int(tensor.dtype)
    dtype = numpy_dtype(dt)
    if tensor.tensor_content:
        return np.frombuffer(tensor.tensor_content,
                             dtype=dtype.newbyteorder("<")).astype(dtype).reshape(shape)
    if dt == DT_STRING:
        values = list(tensor.string_val)
        if num > len(values):
            values.extend([values[-1] if values else b""] * (num - len(values)))
        return np.array(values, dtype=object).reshape(shape)
    if dt in (DT_HALF, DT_BFLOAT16):
        values = np.array(tensor.half_val, dtype=np.int64).astype(np.uint16).view(dtype)
    elif dt == DT_FLOAT:
        values = np.array(tensor.float_val, dtype=np.float32)
    elif dt == DT_DOUBLE:
        values = np.array(tensor.double_val, dtype=np.float64)
    elif dt in (DT_INT32, DT_UINT8, DT_UINT16, DT_INT16, DT_INT8):
        values = np.array(tensor.int_val, dtype=np.int64).astype(dtype)
    elif dt == DT_INT64:
        values = np.array(tensor.int64_val, dtype=np.int64)
    elif dt == DT_UINT32:
        values = np.array(tensor.uint32_val, dtype=np.uint32)
    elif dt == DT_UINT64:
        values = np.array(tensor.uint64_val, dtype=np.uint64)
    elif dt in (DT_COMPLEX64, DT_COMPLEX128):
        flat = tensor.scomplex_val if dt == DT_COMPLEX64 else tensor.dcomplex_val
        values = np.array([complex(a, b) for a, b in zip(flat[0::2], flat[1::2])], dtype=dtype)
    elif dt == DT_BOOL:
        values = np.array(tensor.bool_val, dtype=np.bool_)
    else:
        raise TypeError(f"unsupported TensorProto dtype {dt}")
    if values.size == 0:
        return np.zeros(shape, dtype)
    if values.size != num:
        values = np.pad(values, (0, num - values.size), "edge")
    return values.reshape(shape)


_ENUM = {np.dtype(v): k for k, v in _NUMPY.items() if v is not object}


def tensor_proto(value) -> Message:
    """A numpy array (or scalar) as a TensorProto with ``tensor_content``
    (the importer's inline constants, a fixture's refilled weights)."""
    a = np.asarray(value)
    if a.dtype == np.float64 and not isinstance(value, np.ndarray):
        a = a.astype(np.float32)  # a Python float, as tf.make_tensor_proto
    if a.dtype.name == "bfloat16":
        dt = DT_BFLOAT16
    elif a.dtype in _ENUM:
        dt = _ENUM[a.dtype]
    else:
        raise TypeError(f"no TensorProto dtype for {a.dtype}")
    shape = Message("TensorShapeProto", dim=[Message("Dim", size=int(s)) for s in a.shape])
    return Message("TensorProto", dtype=dt, tensor_shape=shape,
                   tensor_content=np.ascontiguousarray(a).astype(a.dtype.newbyteorder("<"),
                                                                 copy=False).tobytes())


def as_graph_def(graph_def) -> Message:
    """The reader's ``GraphDef`` for a path (``str`` or ``bytes``, as the
    JAX importer reads them), a parsed :class:`Message`, or any object with
    ``SerializeToString()`` (a tensorflow ``GraphDef``)."""
    if isinstance(graph_def, Message):
        return graph_def
    if isinstance(graph_def, (str, bytes)):
        return read_graph_def(graph_def)
    if hasattr(graph_def, "SerializeToString"):
        return parse_graph_def(graph_def.SerializeToString())
    raise TypeError(f"not a GraphDef: {type(graph_def).__name__}")


__all__ = ["Message", "as_graph_def", "make_ndarray", "numpy_dtype",
           "parse", "parse_graph_def", "read_graph_def", "tensor_proto"]
