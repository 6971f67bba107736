"""Self-contained ONNX protobuf writer and reader (no onnx package): the
port's own copy of ``pqdet_tpu/exporters/onnx_proto.py``.

It implements the wire format directly: a minimal protobuf encoder and
decoder for the subset of onnx.proto3 messages the exporters emit
(ModelProto / GraphProto / NodeProto / TensorProto / ValueInfoProto /
AttributeProto / TypeProto / TensorShapeProto / OperatorSetIdProto). Field
numbers follow the public ONNX schema, so emitted files load in stock
onnx/onnxruntime. It stays numpy and ``struct``: these are bytes, not
tensors, and the port's files must be the JAX package's bytes.

Messages are plain dict/list/str/int/bytes trees; ``encode_model`` /
``decode_model`` convert to/from serialized bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# ---------------------------------------------------------------- constants

# TensorProto.DataType
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = \
    1, 2, 3, 4, 5, 6, 7, 8, 9
DOUBLE = 11

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float64): DOUBLE,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8

# ------------------------------------------------------------ wire encoding

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # two's complement for negative int64
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _packed_floats(field: int, values) -> bytes:
    return _len_field(field, struct.pack(f'<{len(values)}f', *values))


def _packed_varints(field: int, values) -> bytes:
    return _len_field(field, b''.join(_varint(v) for v in values))


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def done(self) -> bool:
        return self.pos >= len(self.buf)

    def varint(self) -> int:
        shift = result = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def field(self) -> Tuple[int, int, Any]:
        """-> (field_number, wire_type, value) where value is int (wire 0),
        bytes (wire 2), or raw 4/8 bytes (wire 5/1)."""
        key = self.varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            return field, wire, self.varint()
        if wire == 2:
            ln = self.varint()
            val = self.buf[self.pos:self.pos + ln]
            self.pos += ln
            return field, wire, val
        if wire == 5:
            val = self.buf[self.pos:self.pos + 4]
            self.pos += 4
            return field, wire, val
        if wire == 1:
            val = self.buf[self.pos:self.pos + 8]
            self.pos += 8
            return field, wire, val
        raise ValueError(f'unsupported wire type {wire}')


def _signed64(n: int) -> int:
    return n - (1 << 64) if n >= (1 << 63) else n


# ------------------------------------------------------------------ tensors

def tensor(name: str, array: np.ndarray) -> Dict:
    """TensorProto dict from a numpy array (raw_data encoding)."""
    array = np.ascontiguousarray(array)
    return {'name': name, 'dims': list(array.shape),
            'data_type': NP_TO_ONNX[array.dtype],
            'raw_data': array.tobytes()}


def tensor_to_numpy(t: Dict) -> np.ndarray:
    dtype = ONNX_TO_NP[t['data_type']]
    if t.get('raw_data') is not None:
        arr = np.frombuffer(t['raw_data'], dtype=dtype)
    elif t.get('float_data'):
        arr = np.array(t['float_data'], np.float32).astype(dtype)
    elif t.get('int64_data'):
        arr = np.array(t['int64_data'], np.int64).astype(dtype)
    elif t.get('int32_data'):
        arr = np.array(t['int32_data'], np.int32).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return arr.reshape(t.get('dims', []))


def _encode_tensor(t: Dict) -> bytes:
    out = bytearray()
    for d in t.get('dims', []):
        out += _varint_field(1, d)
    out += _varint_field(2, t['data_type'])
    if t.get('raw_data') is not None:
        out += _len_field(9, t['raw_data'])
    if t.get('name'):
        out += _len_field(8, t['name'].encode())
    return bytes(out)


def _decode_tensor(buf: bytes) -> Dict:
    r = _Reader(buf)
    t: Dict[str, Any] = {'dims': [], 'data_type': 0, 'raw_data': None}
    while not r.done():
        f, w, v = r.field()
        if f == 1:
            t['dims'].append(_signed64(v))
        elif f == 2:
            t['data_type'] = v
        elif f == 8:
            t['name'] = v.decode()
        elif f == 9:
            t['raw_data'] = v
        elif f == 4 and w == 2:  # packed float_data
            t['float_data'] = list(struct.unpack(f'<{len(v) // 4}f', v))
        elif f == 7 and w == 2:  # packed int64_data
            rr = _Reader(v)
            t['int64_data'] = []
            while not rr.done():
                t['int64_data'].append(_signed64(rr.varint()))
    return t


# --------------------------------------------------------------- attributes

def attr(name: str, value) -> Dict:
    """AttributeProto dict with python-typed value."""
    if isinstance(value, float):
        return {'name': name, 'type': ATTR_FLOAT, 'f': value}
    if isinstance(value, bool):
        return {'name': name, 'type': ATTR_INT, 'i': int(value)}
    if isinstance(value, int):
        return {'name': name, 'type': ATTR_INT, 'i': value}
    if isinstance(value, str):
        return {'name': name, 'type': ATTR_STRING, 's': value.encode()}
    if isinstance(value, bytes):
        return {'name': name, 'type': ATTR_STRING, 's': value}
    if isinstance(value, np.ndarray):
        return {'name': name, 'type': ATTR_TENSOR, 't': tensor('', value)}
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            return {'name': name, 'type': ATTR_INTS, 'ints': [int(v) for v in value]}
        if all(isinstance(v, str) for v in value):
            return {'name': name, 'type': ATTR_STRINGS,
                    'strings': [v.encode() for v in value]}
        return {'name': name, 'type': ATTR_FLOATS,
                'floats': [float(v) for v in value]}
    raise TypeError(f'attribute {name}: {type(value)}')


def attr_value(a: Dict):
    t = a['type']
    if t == ATTR_FLOAT:
        return a['f']
    if t == ATTR_INT:
        return a['i']
    if t == ATTR_STRING:
        return a['s'].decode()
    if t == ATTR_TENSOR:
        return tensor_to_numpy(a['t'])
    if t == ATTR_FLOATS:
        return a['floats']
    if t == ATTR_INTS:
        return a['ints']
    if t == ATTR_STRINGS:
        return [s.decode() for s in a['strings']]
    raise ValueError(f'attribute type {t}')


def _encode_attr(a: Dict) -> bytes:
    out = bytearray(_len_field(1, a['name'].encode()))
    t = a['type']
    if t == ATTR_FLOAT:
        out += _tag(2, 5) + struct.pack('<f', a['f'])
    elif t == ATTR_INT:
        out += _varint_field(3, a['i'] & ((1 << 64) - 1))
    elif t == ATTR_STRING:
        out += _len_field(4, a['s'])
    elif t == ATTR_TENSOR:
        out += _len_field(5, _encode_tensor(a['t']))
    elif t == ATTR_FLOATS:
        out += _packed_floats(7, a['floats'])
    elif t == ATTR_INTS:
        out += _packed_varints(8, [v & ((1 << 64) - 1) for v in a['ints']])
    elif t == ATTR_STRINGS:
        for s in a['strings']:
            out += _len_field(9, s)
    else:
        raise ValueError(f'attribute type {t}')
    out += _varint_field(20, t)
    return bytes(out)


def _decode_attr(buf: bytes) -> Dict:
    r = _Reader(buf)
    a: Dict[str, Any] = {'floats': [], 'ints': [], 'strings': []}
    while not r.done():
        f, w, v = r.field()
        if f == 1:
            a['name'] = v.decode()
        elif f == 2:
            a['f'] = struct.unpack('<f', v)[0]
        elif f == 3:
            a['i'] = _signed64(v)
        elif f == 4:
            a['s'] = v
        elif f == 5:
            a['t'] = _decode_tensor(v)
        elif f == 7:
            if w == 2:
                a['floats'] += list(struct.unpack(f'<{len(v) // 4}f', v))
            else:
                a['floats'].append(struct.unpack('<f', v)[0])
        elif f == 8:
            if w == 2:
                rr = _Reader(v)
                while not rr.done():
                    a['ints'].append(_signed64(rr.varint()))
            else:
                a['ints'].append(_signed64(v))
        elif f == 9:
            a['strings'].append(v)
        elif f == 20:
            a['type'] = v
    return a


# -------------------------------------------------------------------- nodes

def node(op_type: str, inputs: List[str], outputs: List[str],
         name: str = '', **attrs) -> Dict:
    return {'op_type': op_type, 'input': list(inputs),
            'output': list(outputs), 'name': name,
            'attribute': [attr(k, v) for k, v in attrs.items()]}


def node_attrs(n: Dict) -> Dict[str, Any]:
    return {a['name']: attr_value(a) for a in n.get('attribute', [])}


def _encode_node(n: Dict) -> bytes:
    out = bytearray()
    for s in n['input']:
        out += _len_field(1, s.encode())
    for s in n['output']:
        out += _len_field(2, s.encode())
    if n.get('name'):
        out += _len_field(3, n['name'].encode())
    out += _len_field(4, n['op_type'].encode())
    for a in n.get('attribute', []):
        out += _len_field(5, _encode_attr(a))
    return bytes(out)


def _decode_node(buf: bytes) -> Dict:
    r = _Reader(buf)
    n: Dict[str, Any] = {'input': [], 'output': [], 'attribute': [],
                         'name': '', 'op_type': ''}
    while not r.done():
        f, _, v = r.field()
        if f == 1:
            n['input'].append(v.decode())
        elif f == 2:
            n['output'].append(v.decode())
        elif f == 3:
            n['name'] = v.decode()
        elif f == 4:
            n['op_type'] = v.decode()
        elif f == 5:
            n['attribute'].append(_decode_attr(v))
    return n


# -------------------------------------------------------------- value infos

def value_info(name: str, elem_type: int, shape: List[Optional[int]]) -> Dict:
    return {'name': name, 'elem_type': elem_type, 'shape': list(shape)}


def _encode_value_info(vi: Dict) -> bytes:
    shape = bytearray()
    for d in vi['shape']:
        if d is None:
            dim = _len_field(2, b'N')          # dim_param
        else:
            dim = _varint_field(1, d)          # dim_value
        shape += _len_field(1, dim)
    tensor_type = _varint_field(1, vi['elem_type']) + _len_field(2, bytes(shape))
    type_proto = _len_field(1, bytes(tensor_type))
    return _len_field(1, vi['name'].encode()) + _len_field(2, type_proto)


def _decode_value_info(buf: bytes) -> Dict:
    r = _Reader(buf)
    vi: Dict[str, Any] = {'name': '', 'elem_type': 0, 'shape': []}
    while not r.done():
        f, _, v = r.field()
        if f == 1:
            vi['name'] = v.decode()
        elif f == 2:  # TypeProto
            rt = _Reader(v)
            while not rt.done():
                ft, _, vt = rt.field()
                if ft == 1:  # tensor_type
                    rtt = _Reader(vt)
                    while not rtt.done():
                        f2, _, v2 = rtt.field()
                        if f2 == 1:
                            vi['elem_type'] = v2
                        elif f2 == 2:  # shape
                            rs = _Reader(v2)
                            while not rs.done():
                                f3, _, v3 = rs.field()
                                if f3 == 1:  # Dimension
                                    rd = _Reader(v3)
                                    dim = None
                                    while not rd.done():
                                        f4, _, v4 = rd.field()
                                        if f4 == 1:
                                            dim = _signed64(v4)
                                    vi['shape'].append(dim)
    return vi


# -------------------------------------------------------------------- model

# the JAX package's producer name: the port writes its bytes
def model(graph_name: str, nodes: List[Dict], inputs: List[Dict],
          outputs: List[Dict], initializers: List[Dict],
          opset: int = 13, producer: str = 'pqdet_tpu',
          doc: str = '') -> Dict:
    return {'ir_version': 8,
            'producer_name': producer,
            'opset': opset,
            'doc_string': doc,
            'graph': {'name': graph_name, 'node': nodes, 'input': inputs,
                      'output': outputs, 'initializer': initializers}}


def _encode_graph(g: Dict) -> bytes:
    out = bytearray()
    for n in g['node']:
        out += _len_field(1, _encode_node(n))
    if g.get('name'):
        out += _len_field(2, g['name'].encode())
    for t in g.get('initializer', []):
        out += _len_field(5, _encode_tensor(t))
    for vi in g.get('input', []):
        out += _len_field(11, _encode_value_info(vi))
    for vi in g.get('output', []):
        out += _len_field(12, _encode_value_info(vi))
    return bytes(out)


def _decode_graph(buf: bytes) -> Dict:
    r = _Reader(buf)
    g: Dict[str, Any] = {'name': '', 'node': [], 'initializer': [],
                         'input': [], 'output': []}
    while not r.done():
        f, _, v = r.field()
        if f == 1:
            g['node'].append(_decode_node(v))
        elif f == 2:
            g['name'] = v.decode()
        elif f == 5:
            g['initializer'].append(_decode_tensor(v))
        elif f == 11:
            g['input'].append(_decode_value_info(v))
        elif f == 12:
            g['output'].append(_decode_value_info(v))
    return g


def encode_model(m: Dict) -> bytes:
    out = bytearray()
    out += _varint_field(1, m.get('ir_version', 8))
    # opset_import: OperatorSetIdProto {domain=1, version=2}
    out += _len_field(8, _varint_field(2, m.get('opset', 13)))
    out += _len_field(2, m.get('producer_name', 'pqdet_tpu').encode())
    if m.get('doc_string'):
        out += _len_field(6, m['doc_string'].encode())
    out += _len_field(7, _encode_graph(m['graph']))
    return bytes(out)


def decode_model(buf: bytes) -> Dict:
    r = _Reader(buf)
    m: Dict[str, Any] = {'opset': None}
    while not r.done():
        f, _, v = r.field()
        if f == 1:
            m['ir_version'] = v
        elif f == 2:
            m['producer_name'] = v.decode()
        elif f == 6:
            m['doc_string'] = v.decode()
        elif f == 7:
            m['graph'] = _decode_graph(v)
        elif f == 8:
            rr = _Reader(v)
            while not rr.done():
                f2, _, v2 = rr.field()
                if f2 == 2:
                    m['opset'] = v2
    return m


def check_model(m: Dict):
    """Structural validation (the reference runs onnx.checker.check_model,
    test.py:29): every node input must be a graph input, an initializer, or
    a prior node output; every graph output must be produced."""
    g = m['graph']
    known = {vi['name'] for vi in g['input']}
    known |= {t['name'] for t in g['initializer']}
    for n in g['node']:
        for i in n['input']:
            if i and i not in known:
                raise ValueError(f'node {n["name"] or n["op_type"]}: '
                                 f'undefined input {i!r}')
        known.update(n['output'])
    for vi in g['output']:
        if vi['name'] not in known:
            raise ValueError(f'graph output {vi["name"]!r} never produced')
