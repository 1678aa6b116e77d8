"""ONNX export of Q/DQ compiler graphs with d-Matrix BFP custom ops.

Port of ``dmx_compressor_tpu/transform/onnx_export.py``.  Cast sites lower
to ``com.microsoft::QuantizeBFP`` / ``DequantizeBFP`` custom-op pairs
carrying the frozen ``bfp_type`` enum (``numerics/onnx_ids.py``), for
:class:`~.qdq.DmxGraph` graphs.  The contract is with the downstream
compiler, so for the same module, state and graph the bytes are the JAX
package's, ``producer_name`` (``dmx_compressor_tpu``) included.

No ``onnx`` package is needed: the ONNX protobuf wire format is encoded
directly (varints + length-delimited submessages).  The emitted bytes are a
valid ``ModelProto``, loadable by stock ``onnx`` / onnxruntime elsewhere,
and :func:`parse_onnx` decodes the same subset for round trips.
Initializers are read from the module's tensors wherever they live (a card
tensor is copied to the host first).

Node mapping:

- ``dmx.quantize``/``dmx.dequantize`` edges with a BFP/MXINT format ->
  ``QuantizeBFP`` (3 outputs) + ``DequantizeBFP`` (``bfp_type_i``,
  ``dtype_i=1``);
- SAME-format edges -> ``Identity``;
- any other format -> ``Identity`` annotated with ``dmx_format_s`` (the
  shorthand), keeping the cast site visible to the downstream compiler;
- functional targets -> standard ONNX ops (Gemm/MatMul/Conv/Add/Mul/
  Softmax/LayerNormalization/...), unknown ones -> a namespaced
  ``dmx.<name>`` custom op.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..numerics.format import BlockFloatingPoint, Format, Same
from .qdq import DmxGraph, Node, _resolve_attr, _resolve_cast

# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------


def _varint(v: int) -> bytes:
    out = b""
    v &= (1 << 64) - 1  # two's complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _str(field: int, s: str) -> bytes:
    return _len_delim(field, s.encode())


def _int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


# ---------------------------------------------------------------------------
# ONNX message encoders (field numbers per onnx/onnx.proto, IR version 8)
# ---------------------------------------------------------------------------

_ATTR_INT = 2  # AttributeProto.AttributeType.INT
_ATTR_STRING = 3
_DT_FLOAT = 1
_DT_UINT8 = 2
_DT_INT8 = 3
_DT_INT64 = 7


def _attribute(name: str, *, i: Optional[int] = None, s: Optional[str] = None) -> bytes:
    body = _str(1, name)
    if i is not None:
        body += _int(3, i) + _int(20, _ATTR_INT)
    elif s is not None:
        body += _len_delim(4, s.encode()) + _int(20, _ATTR_STRING)
    return body


def _node(
    op_type: str,
    inputs: List[str],
    outputs: List[str],
    name: str,
    domain: str = "",
    attrs: Tuple[bytes, ...] = (),
) -> bytes:
    body = b"".join(_str(1, x) for x in inputs)
    body += b"".join(_str(2, x) for x in outputs)
    body += _str(3, name) + _str(4, op_type)
    body += b"".join(_len_delim(5, a) for a in attrs)
    if domain:
        body += _str(7, domain)
    return body


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dt = {_np: code for _np, code in (
        (np.float32, _DT_FLOAT), (np.int8, _DT_INT8),
        (np.uint8, _DT_UINT8), (np.int64, _DT_INT64),
    )}.get(arr.dtype.type)
    if dt is None:
        arr = arr.astype(np.float32)
        dt = _DT_FLOAT
    body = b"".join(_int(1, d) for d in arr.shape)
    body += _int(2, dt)
    body += _str(8, name)
    body += _len_delim(9, arr.tobytes())
    return body


def _value_info(name: str, elem_type: int = _DT_FLOAT) -> bytes:
    shape = b""  # unknown rank: empty TensorShapeProto omitted
    ttype = _int(1, elem_type) + _len_delim(2, shape)
    tp = _len_delim(1, ttype)  # TypeProto.tensor_type
    return _str(1, name) + _len_delim(2, tp)


def _graph(
    nodes: List[bytes],
    name: str,
    inputs: List[bytes],
    outputs: List[bytes],
    initializers: List[bytes],
) -> bytes:
    body = b"".join(_len_delim(1, n) for n in nodes)
    body += _str(2, name)
    body += b"".join(_len_delim(5, t) for t in initializers)
    body += b"".join(_len_delim(11, v) for v in inputs)
    body += b"".join(_len_delim(12, v) for v in outputs)
    return body


def _model(graph: bytes) -> bytes:
    body = _int(1, 8)  # ir_version
    body += _str(2, "dmx_compressor_tpu")
    body += _len_delim(7, graph)
    for domain, version in (("", 17), ("com.microsoft", 1), ("dmx", 1)):
        opset = (_str(1, domain) if domain else b"") + _int(2, version)
        body += _len_delim(8, opset)
    return body


# ---------------------------------------------------------------------------
# DmxGraph -> ONNX
# ---------------------------------------------------------------------------

_ONNX_OP = {
    "matmul": ("MatMul", ""),
    "res_add": ("Add", ""),
    "_add": ("Add", ""),
    "elem_mul": ("Mul", ""),
    "_mul": ("Mul", ""),
    "softmax": ("Softmax", ""),
    "_identity": ("Identity", ""),
    "layer_norm": ("LayerNormalization", ""),
    "rms_norm": ("SimplifiedLayerNormalization", "com.microsoft"),
    "embed_lookup": ("Gather", ""),
    "conv": ("Conv", ""),
    "_swap_kt": ("Transpose", ""),
}


def dmx_graph_to_onnx(graph: DmxGraph, module, graph_name: str = "dmx") -> bytes:
    """Serialize one module's Q/DQ :class:`DmxGraph` to ONNX ``ModelProto``
    bytes.  ``module`` supplies weights (as initializers) and cast formats."""
    nodes: List[bytes] = []
    inputs: List[bytes] = []
    outputs: List[bytes] = []
    inits: List[bytes] = []
    sym: Dict[str, str] = {}  # DmxGraph node name -> ONNX tensor name

    def emit_qdq(n: Node, src_name: str) -> str:
        fmt = _resolve_cast(module, n.cast_name).format
        out_name = n.name
        if isinstance(fmt, Same):
            nodes.append(_node("Identity", [src_name], [out_name], n.name))
        elif isinstance(fmt, BlockFloatingPoint):
            bfp_id = fmt.bfp_id
            q_outs = [f"{n.name}_data", f"{n.name}_shape", f"{n.name}_strides"]
            nodes.append(
                _node(
                    "QuantizeBFP",
                    [src_name],
                    q_outs,
                    f"{n.name}_q",
                    domain="com.microsoft",
                    attrs=(_attribute("bfp_type", i=bfp_id),),
                )
            )
            nodes.append(
                _node(
                    "DequantizeBFP",
                    q_outs,
                    [out_name],
                    f"{n.name}_dq",
                    domain="com.microsoft",
                    attrs=(
                        _attribute("bfp_type", i=bfp_id),
                        _attribute("dtype", i=_DT_FLOAT),
                    ),
                )
            )
        else:
            nodes.append(
                _node(
                    "Identity",
                    [src_name],
                    [out_name],
                    n.name,
                    attrs=(_attribute("dmx_format", s=repr(fmt)),),
                )
            )
        return out_name

    last = None
    for n in graph.nodes:
        if n.op == "placeholder":
            inputs.append(_value_info(n.name))
            sym[n.name] = n.name
        elif n.op == "get_attr":
            val = _resolve_attr(module, n.target).detach().cpu().numpy()
            inits.append(_tensor(n.name, val))
            sym[n.name] = n.name
        elif n.op == "call_function":
            if n.target == "dmx.quantize":
                # Q and DQ are emitted together at the DQ node
                sym[n.name] = sym[n.args[0].name]
            elif n.target == "dmx.dequantize":
                sym[n.name] = emit_qdq(n, sym[n.args[0].name])
            else:
                fname = getattr(n.target, "__name__", str(n.target))
                op_type, domain = _ONNX_OP.get(fname, (fname, "dmx"))
                in_names = [
                    sym[a.name] if isinstance(a, Node) else str(a) for a in n.args
                ]
                nodes.append(_node(op_type, in_names, [n.name], n.name, domain))
                sym[n.name] = n.name
            last = sym[n.name]
        elif n.op == "output":
            src = n.args[0]
            out = sym[src.name] if isinstance(src, Node) else str(src)
            outputs.append(_value_info(out))
    if not outputs and last is not None:
        outputs.append(_value_info(last))
    return _model(_graph(nodes, graph_name, inputs, outputs, inits))


def export_onnx(model, path: Optional[str] = None) -> Dict[str, bytes]:
    """Export every DmxModule's compiler graph as a standalone ONNX model.

    Returns ``{module_name: model_proto_bytes}``; with ``path`` set, each is
    also written to ``<path>/<module_name>.onnx``.  Skipped modules propagate
    from :func:`make_compiler_graph` (never silent)."""
    import os

    from .qdq import make_compiler_graph
    from .substitute import named_dmx_modules

    mods = dict(named_dmx_modules(model))
    graphs = make_compiler_graph(model)
    out: Dict[str, bytes] = {}
    for name, g in graphs.items():
        out[name] = dmx_graph_to_onnx(g, mods[name], graph_name=name)
        if path is not None:
            os.makedirs(path, exist_ok=True)
            fname = os.path.join(path, name.replace("/", ".") + ".onnx")
            with open(fname, "wb") as f:
                f.write(out[name])
    return out


# ---------------------------------------------------------------------------
# decoder (round-trip testing without the onnx package)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[i]
        v |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return v, i
        shift += 7


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i : i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack("<I", buf[i : i + 4])[0]
            i += 4
        elif wire == 1:
            v = struct.unpack("<Q", buf[i : i + 8])[0]
            i += 8
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")
        yield field, v


def parse_onnx(data: bytes) -> Dict[str, Any]:
    """Decode the subset of ModelProto this module emits: node list with
    op_type/domain/attrs, graph inputs/outputs, initializer names."""
    model: Dict[str, Any] = {"nodes": [], "inputs": [], "outputs": [],
                             "initializers": [], "opsets": []}
    for field, v in _fields(data):
        if field == 7:  # graph
            for gf, gv in _fields(v):
                if gf == 1:  # node
                    node = {"inputs": [], "outputs": [], "attrs": {},
                            "domain": "", "op_type": "", "name": ""}
                    for nf, nv in _fields(gv):
                        if nf == 1:
                            node["inputs"].append(nv.decode())
                        elif nf == 2:
                            node["outputs"].append(nv.decode())
                        elif nf == 3:
                            node["name"] = nv.decode()
                        elif nf == 4:
                            node["op_type"] = nv.decode()
                        elif nf == 7:
                            node["domain"] = nv.decode()
                        elif nf == 5:
                            attr = {}
                            for af, av in _fields(nv):
                                if af == 1:
                                    attr["name"] = av.decode()
                                elif af == 3:
                                    # two's-complement back to signed
                                    attr["i"] = av - (1 << 64) if av >> 63 else av
                                elif af == 4:
                                    attr["s"] = av.decode()
                            node["attrs"][attr["name"]] = attr.get(
                                "i", attr.get("s")
                            )
                    model["nodes"].append(node)
                elif gf == 5:
                    for tf, tv in _fields(gv):
                        if tf == 8:
                            model["initializers"].append(tv.decode())
                elif gf in (11, 12):
                    for vf, vv in _fields(gv):
                        if vf == 1:
                            model[
                                "inputs" if gf == 11 else "outputs"
                            ].append(vv.decode())
        elif field == 8:
            dom, ver = "", 0
            for of, ov in _fields(v):
                if of == 1:
                    dom = ov.decode()
                elif of == 2:
                    ver = ov
            model["opsets"].append((dom, ver))
    return model
