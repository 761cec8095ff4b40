"""The port's own copy of `frenetix_tpu/models/onnx_lite.py` (stdlib and
NumPy only; `tests/test_torch_copies.py` holds `load_onnx` equal to the
original's on a written file).

Minimal ONNX reader: protobuf wire format → graph structure + weights.

The environment ships no `onnx`/`onnxruntime` package, so this module decodes
the ONNX ModelProto directly from the protobuf wire format (stdlib only) —
just enough to port small inference graphs (like the reference's 456 KB
Wale-Net, wale_net_lite/wale-net.onnx) into PyTorch.

Field numbers follow onnx.proto3:
  ModelProto:  7 graph
  GraphProto:  1 node*, 5 initializer*, 11 input*, 12 output*
  NodeProto:   1 input*, 2 output*, 3 name, 4 op_type, 5 attribute*
  TensorProto: 1 dims*, 2 data_type, 4 float_data*, 7 int64_data*, 8 name,
               9 raw_data
  AttributeProto: 1 name, 2 f, 3 i, 4 s, 5 t, 7 floats*, 8 ints*, 20 type
  ValueInfoProto: 1 name
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

__all__ = ["OnnxGraph", "OnnxNode", "load_onnx"]

_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
           9: np.bool_, 10: np.float16, 11: np.float64}


def _decode_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for one protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wtype == 1:  # 64-bit
            val = buf[i : i + 8]
            i += 8
        elif wtype == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wtype == 5:  # 32-bit
            val = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _read_varint(buf: bytes, i: int):
    shift = 0
    out = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _packed_varints(buf: bytes):
    out = []
    i = 0
    while i < len(buf):
        v, i = _read_varint(buf, i)
        out.append(v)
    return out


@dataclass
class OnnxNode:
    op_type: str = ""
    name: str = ""
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: list = field(default_factory=list)
    initializers: dict = field(default_factory=dict)  # name -> np.ndarray
    inputs: list = field(default_factory=list)
    outputs: list = field(default_factory=list)


def _parse_tensor(buf: bytes):
    dims, name, raw = [], "", b""
    dtype = np.float32
    float_data, int_data = [], []
    for fnum, wtype, val in _decode_fields(buf):
        if fnum == 1:
            if wtype == 0:
                dims.append(val)
            else:
                dims.extend(_packed_varints(val))
        elif fnum == 2:
            dtype = _DTYPES.get(val, np.float32)
        elif fnum == 4:
            if wtype == 2:
                float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif fnum == 7:
            if wtype == 2:
                int_data.extend(_packed_varints(val))
            else:
                int_data.append(val)
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif int_data:
        arr = np.asarray(int_data, dtype=dtype)
    else:
        arr = np.zeros(0, dtype)
    # dims == [] on a one-element tensor means an ONNX *scalar* (shape ())
    arr = arr.reshape(dims if dims else ())
    return name, arr


def _parse_attr(buf: bytes):
    name = ""
    out = None
    floats, ints = [], []
    for fnum, wtype, val in _decode_fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:
            out = struct.unpack("<f", val)[0]
        elif fnum == 3:
            out = val if val < (1 << 63) else val - (1 << 64)
        elif fnum == 4:
            out = val.decode() if isinstance(val, bytes) else val
        elif fnum == 5:
            out = _parse_tensor(val)[1]
        elif fnum == 7:
            if wtype == 2 and len(val) % 4 == 0:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wtype == 2:
                ints.extend(_packed_varints(val))
            else:
                ints.append(val)
    if floats:
        out = floats
    if ints:
        out = ints
    return name, out


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode()
    for fnum, _, val in _decode_fields(buf):
        if fnum == 1:
            node.inputs.append(val.decode())
        elif fnum == 2:
            node.outputs.append(val.decode())
        elif fnum == 3:
            node.name = val.decode()
        elif fnum == 4:
            node.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _value_info_name(buf: bytes) -> str:
    for fnum, _, val in _decode_fields(buf):
        if fnum == 1:
            return val.decode()
    return ""


def _parse_graph(buf: bytes) -> OnnxGraph:
    g = OnnxGraph()
    for fnum, _, val in _decode_fields(buf):
        if fnum == 1:
            g.nodes.append(_parse_node(val))
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            g.initializers[name] = arr
        elif fnum == 11:
            g.inputs.append(_value_info_name(val))
        elif fnum == 12:
            g.outputs.append(_value_info_name(val))
    return g


def load_onnx(path: str) -> OnnxGraph:
    with open(path, "rb") as f:
        buf = f.read()
    for fnum, _, val in _decode_fields(buf):
        if fnum == 7:
            return _parse_graph(val)
    raise ValueError("no graph found in ONNX file")
