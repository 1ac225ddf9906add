"""ONNX export without the onnx package: a hand-rolled protobuf writer.

This package's copy of robosat_tpu/utils/onnx.py: the same writer, with the
same defaults (producer "robosat_tpu", opset 13, IR version 8, graph
"robosat_tpu_unet"), so that `export --format onnx` writes the JAX
package's bytes for the same checkpoint (tests/test_torch_port_export.py).
The reference ships its model as ONNX (robosat/tools/export.py:38-40,
torch.onnx.export); here the ModelProto is encoded directly in protobuf
wire format from the public onnx.proto3 schema (field numbers, wire types,
enums), with no onnx package.

Scope: the inference ("logits") graph of the U-Net at a static shape,
NCHW float32 as the reference's export, built from standard ops
(Conv/Relu/MaxPool/Add/Concat/Resize) over the BN-folded tree as numpy
arrays (HWIO kernels, as the port keeps them). The `predict` graph, with
its fused margin head, is `export --format pt2`'s.
"""

import struct

import numpy as np

from robosat_tpu_torch.models.resnet import RESNET50_STAGES

# --- protobuf wire-format primitives ---------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _varint(v):
    out = bytearray()
    v &= (1 << 64) - 1  # two's complement for negative int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire):
    return _varint((field << 3) | wire)


def vfield(field, v):
    """Varint-typed field (int64/enum/bool)."""
    return _tag(field, _VARINT) + _varint(int(v))


def lfield(field, payload):
    """Length-delimited field (string/bytes/message/packed)."""
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    return _tag(field, _LEN) + _varint(len(payload)) + payload


def ffield(field, v):
    """32-bit float field."""
    return _tag(field, _I32) + struct.pack("<f", float(v))


def decode_fields(data):
    """Decode one message level: yields (field, wire, value) — value is an
    int for varints, bytes for length-delimited, raw 4/8 bytes for fixed."""
    i, n = 0, len(data)
    while i < n:
        key = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, v
        elif wire == _LEN:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, data[i : i + ln]
            i += ln
        elif wire == _I64:
            yield field, wire, data[i : i + 8]
            i += 8
        elif wire == _I32:
            yield field, wire, data[i : i + 4]
            i += 4
        else:
            raise ValueError("unsupported wire type {}".format(wire))


def field_map(data):
    """{field: [values]} for one message level."""
    out = {}
    for field, _, value in decode_fields(data):
        out.setdefault(field, []).append(value)
    return out


# --- ONNX schema subset (public onnx.proto3 field numbers) ------------------

# TensorProto.DataType
FLOAT, UINT8, INT8, INT32, INT64 = 1, 2, 3, 6, 7
# AttributeProto.AttributeType
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_TENSOR = 1, 2, 3, 4
_AT_FLOATS, _AT_INTS, _AT_STRINGS = 6, 7, 8


def tensor(name, arr):
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    arr = np.ascontiguousarray(arr)
    dtypes = {np.float32: FLOAT, np.int64: INT64, np.int32: INT32, np.uint8: UINT8, np.int8: INT8}
    dt = dtypes[arr.dtype.type]
    msg = b"".join(vfield(1, d) for d in arr.shape)
    msg += vfield(2, dt)
    msg += lfield(8, name)
    msg += lfield(9, arr.tobytes())
    return msg


def attribute(name, value):
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20."""
    msg = lfield(1, name)
    if isinstance(value, bool):
        raise TypeError("ambiguous bool attribute")
    if isinstance(value, int):
        msg += vfield(3, value) + vfield(20, _AT_INT)
    elif isinstance(value, float):
        msg += ffield(2, value) + vfield(20, _AT_FLOAT)
    elif isinstance(value, (str, bytes)):
        msg += lfield(4, value) + vfield(20, _AT_STRING)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        msg += b"".join(vfield(8, v) for v in value) + vfield(20, _AT_INTS)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, float) for v in value):
        msg += b"".join(ffield(7, v) for v in value) + vfield(20, _AT_FLOATS)
    elif isinstance(value, np.ndarray):
        msg += lfield(5, tensor("", value)) + vfield(20, _AT_TENSOR)
    else:
        raise TypeError("unsupported attribute {}={!r}".format(name, value))
    return msg


def node(op_type, inputs, outputs, name="", **attrs):
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    msg = b"".join(lfield(1, i) for i in inputs)
    msg += b"".join(lfield(2, o) for o in outputs)
    if name:
        msg += lfield(3, name)
    msg += lfield(4, op_type)
    msg += b"".join(lfield(5, attribute(k, v)) for k, v in sorted(attrs.items()))
    return msg


def value_info(name, elem_type, shape):
    """ValueInfoProto: name=1, type=2; TypeProto.tensor_type=1
    {elem_type=1, shape=2 {dim=1 {dim_value=1}}}."""
    dims = b"".join(lfield(1, vfield(1, d)) for d in shape)
    tensor_type = vfield(1, elem_type) + lfield(2, dims)
    return lfield(1, name) + lfield(2, lfield(1, tensor_type))


def graph(nodes, name, initializers, inputs, outputs):
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    msg = b"".join(lfield(1, n) for n in nodes)
    msg += lfield(2, name)
    msg += b"".join(lfield(5, t) for t in initializers)
    msg += b"".join(lfield(11, vi) for vi in inputs)
    msg += b"".join(lfield(12, vi) for vi in outputs)
    return msg


def model(graph_msg, opset=13, ir_version=8, producer="robosat_tpu"):
    """ModelProto: ir_version=1, producer_name=2, graph=7, opset_import=8
    {domain=1, version=2}."""
    opset_id = lfield(1, "") + vfield(2, opset)
    return (
        vfield(1, ir_version)
        + lfield(2, producer)
        + lfield(7, graph_msg)
        + lfield(8, opset_id)
    )


# --- U-Net graph builder -----------------------------------------------------


def _oihw(w):
    """HWIO float kernel -> OIHW float32 (ONNX Conv weight layout)."""
    return np.ascontiguousarray(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))


class _Builder:
    def __init__(self):
        self.nodes = []
        self.inits = []
        self.n = 0

    def name(self, op):
        self.n += 1
        return "{}_{}".format(op, self.n)

    def init_tensor(self, name, arr):
        self.inits.append(tensor(name, arr))
        return name

    def conv(self, x, folded_node, stride=1, pads=1, prefix="conv", out=None):
        """Conv(+ optional bias) from a folded {"w" HWIO[, "b"]} node."""
        out = out or self.name(prefix)
        wname = self.init_tensor(out + "_w", _oihw(folded_node["w"]))
        inputs = [x, wname]
        if "b" in folded_node:
            inputs.append(self.init_tensor(out + "_b", np.asarray(folded_node["b"], np.float32)))
        kh, kw = np.asarray(folded_node["w"]).shape[:2]
        p = (pads, pads) if isinstance(pads, int) else pads
        self.nodes.append(
            node(
                "Conv", inputs, [out], name=out,
                dilations=[1, 1], group=1, kernel_shape=[int(kh), int(kw)],
                pads=[p[0], p[1], p[0], p[1]], strides=[stride, stride],
            )
        )
        return out

    def relu(self, x):
        out = self.name("relu")
        self.nodes.append(node("Relu", [x], [out], name=out))
        return out

    def maxpool(self, x, kernel, stride, pad):
        out = self.name("maxpool")
        self.nodes.append(
            node(
                "MaxPool", [x], [out], name=out,
                kernel_shape=[kernel, kernel], pads=[pad] * 4, strides=[stride, stride],
            )
        )
        return out

    def add(self, a, b):
        out = self.name("add")
        self.nodes.append(node("Add", [a, b], [out], name=out))
        return out

    def concat(self, xs):
        out = self.name("concat")
        self.nodes.append(node("Concat", xs, [out], name=out, axis=1))
        return out

    def upsample2x(self, x):
        """Nearest-neighbor 2x: Resize(mode=nearest, asymmetric, floor) ==
        pixel repetition (layers.upsample_nearest_2x)."""
        out = self.name("resize")
        scales = self.init_tensor(out + "_scales", np.asarray([1.0, 1.0, 2.0, 2.0], np.float32))
        self.nodes.append(
            node(
                "Resize", [x, "", scales], [out], name=out,
                coordinate_transformation_mode=b"asymmetric",
                mode=b"nearest", nearest_mode=b"floor",
            )
        )
        return out


def export_unet_onnx(folded, num_classes, image_size=512, batch_size=1):
    """BN-folded U-Net params -> ONNX ModelProto bytes (NCHW float32 logits
    graph, the reference's export surface: robosat/tools/export.py:38-40).

    The graph mirrors unet.apply_folded op for op: folded-encoder convs
    carry biases (BN folded), decoder blocks are Resize(nearest 2x) + 3x3
    Conv + Relu (the UNFUSED form — ONNX consumers re-fuse as they see fit),
    final 1x1 Conv + bias yields `logits`.
    """
    b = _Builder()
    x = "input"

    enc = folded["encoder"]
    out = b.relu(b.conv(x, enc["conv1"], stride=2, pads=3, prefix="stem"))
    out = b.maxpool(out, kernel=3, stride=2, pad=1)

    skips = []
    for si, (blocks, _) in enumerate(RESNET50_STAGES):
        stage = enc["layer{}".format(si + 1)]
        for bi in range(blocks):
            fb = stage[bi]
            stride = 2 if (bi == 0 and si > 0) else 1
            inner = b.relu(b.conv(out, fb["conv1"], pads=0))
            inner = b.relu(b.conv(inner, fb["conv2"], stride=stride, pads=1))
            inner = b.conv(inner, fb["conv3"], pads=0)
            shortcut = b.conv(out, fb["down_conv"], stride=stride, pads=0) if "down_conv" in fb else out
            out = b.relu(b.add(inner, shortcut))
        skips.append(out)
    enc1, enc2, enc3, enc4 = skips

    def dec_block(name, xin):
        return b.relu(b.conv(b.upsample2x(xin), folded[name], pads=1, prefix=name))

    center = dec_block("center", b.maxpool(enc4, kernel=2, stride=2, pad=0))
    dec0 = dec_block("dec0", b.concat([enc4, center]))
    dec1 = dec_block("dec1", b.concat([enc3, dec0]))
    dec2 = dec_block("dec2", b.concat([enc2, dec1]))
    dec3 = dec_block("dec3", b.concat([enc1, dec2]))
    dec4 = dec_block("dec4", dec3)
    dec5 = b.relu(b.conv(dec4, folded["dec5"], pads=1, prefix="dec5"))

    b.conv(dec5, folded["final"], pads=0, prefix="final", out="logits")

    g = graph(
        b.nodes,
        "robosat_tpu_unet",
        b.inits,
        inputs=[value_info("input", FLOAT, (batch_size, 3, image_size, image_size))],
        outputs=[value_info("logits", FLOAT, (batch_size, num_classes, image_size, image_size))],
    )
    return model(g)
