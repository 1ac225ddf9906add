"""One dense int8 conv with its epilogue: the CUDA kernel rs_int8_conv and its plain version.

The JAX package runs the fast family's dense convs as XLA's int8
convolution (robosat_tpu/models/int8.py `_int8_conv`, called from
robosat_tpu/models/fastnet.py `_walk48_sites`), followed by relu, or by
the residual add of the conv's own input and relu. `int8_conv` computes,
bit for bit,

    y = _int8_conv(node, x, s, stride, padding, dilation)     # bf16
    y                      epilogue "linear"
    relu(y)                epilogue "relu"
    relu(y + x)            epilogue "residual_relu": the bf16 operands added in f32, rounded once

for any k x k kernel, stride 1 or 2, dilation and padding ("SAME" as XLA
pads it, so (0, 1) at stride 2 on an even grid, or explicit pairs). On a
CUDA tensor it launches csrc/qconv.cu, csrc/int8_conv_sm90.cuh's
conv_kernel with a bf16 input, the weights packed by
`qenc.packed_weights` and the scale product ws * s cached per site
(`site_operands`); on a CPU tensor it runs `int8_conv_plain`.
Activations are bf16 NHWC, channel counts multiples of 16.
"""

import numpy as np
import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _act_inv, _int8_conv, scaled_ws
from robosat_tpu_torch.models.layers import _same_pads
from robosat_tpu_torch.models.qenc import packed_weights

EPILOGUES = {"linear": 0, "relu": 1, "residual_relu": 2}  # rs::Epilogue


def int8_conv_plain(x, node, scale, stride=1, dilation=1, padding="SAME", epilogue="relu"):
    """The conv and its epilogue as separate plain ops (any device)."""
    y = _int8_conv(node, x, scale, stride=stride, padding=padding, dilation=dilation)
    if epilogue == "linear":
        return y
    if epilogue == "relu":
        return torch.relu(y)
    return torch.relu(y.float() + x.float()).to(x.dtype)


def conv_geometry(x_shape, node, stride, dilation, padding):
    """((pad_top, pad_left), (ho, wo)) of a conv of `node`'s kernel over an
    (N, H, W, C) input: XLA's "SAME" pads, or explicit ((top, bottom),
    (left, right))."""
    _, h, w, _ = x_shape
    k = node["wq"].shape[0]
    if padding == "SAME":
        padding = (_same_pads(h, k, stride, dilation), _same_pads(w, k, stride, dilation))
    (pt, pb), (pl, pr) = padding
    span = dilation * (k - 1) + 1
    return (pt, pl), ((h + pt + pb - span) // stride + 1, (w + pl + pr - span) // stride + 1)


def site_operands(node, scale):
    """(packed weights, ws * s, 1 / s) of a site, cached on the node for
    its scale: the tree is quantized once and every batch reuses them."""
    key = float(np.float32(scale))
    cached = node.get("site")
    if cached is None or cached[0] != key:
        cached = node["site"] = (key, packed_weights(node), scaled_ws(node, scale).contiguous(), _act_inv(scale))
    return cached[1:]


def _check(x, node, stride, dilation, epilogue):
    kh, kw, cin, cout = node["wq"].shape
    if kh != kw or x.shape[-1] != cin:
        raise ValueError("a square kernel over the input's {} channels (got {})".format(
            x.shape[-1], tuple(node["wq"].shape)))
    if epilogue not in EPILOGUES:
        raise ValueError("epilogue must be one of {} (got {!r})".format(sorted(EPILOGUES), epilogue))
    if stride not in (1, 2) or dilation < 1:
        raise ValueError("stride 1 or 2 and a dilation of at least 1 (got {}, {})".format(stride, dilation))
    return kh, cin, cout


def _launch(x, node, scale, stride, dilation, padding, epilogue):
    kernels.check_cuda(x, "x", torch.bfloat16)
    k, cin, cout = _check(x, node, stride, dilation, epilogue)
    if cin % 16 or cout % 16:
        raise ValueError("the int8 kernels need channel counts that are multiples of 16")
    n, h, w, _ = x.shape
    (pt, pl), (ho, wo) = conv_geometry(x.shape, node, stride, dilation, padding)
    if epilogue == "residual_relu" and (cin != cout or (ho, wo) != (h, w)):
        raise ValueError("the residual is the conv's input: Cin == Cout and an output grid of the input's size")
    wp, e, inv = site_operands(node, scale)
    kernels.check_cuda(wp, "wp", torch.int8, (k * k * -(-cin // 64), -(-cout // 128) * 128 * 64))
    kernels.check_cuda(e, "e", torch.float32, (cout,))
    b = node.get("b")
    if b is not None:
        b = kernels.check_cuda(b, "b", torch.float32, (cout,))
    out = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16, device=x.device)
    p = kernels.ptr
    kernels.launch("rs_int8_conv", p(x), p(wp), p(e), p(b), inv, p(out), n, h, w, cin, cout, k, stride, dilation,
                   pt, pl, ho, wo, EPILOGUES[epilogue])
    return out


def int8_conv(x, node, scale, stride=1, dilation=1, padding="SAME", epilogue="relu"):
    """int8 conv of bf16 x (N, H, W, Cin) with the quantized tree entry
    `node` ({"wq": (k, k, Cin, Cout) int8, "ws": (Cout,) f32[, "b"]}) at the
    site's static activation scale, then `epilogue` -> bf16 (N, Ho, Wo, Cout)."""
    if x.device.type == "cpu":
        _check(x, node, stride, dilation, epilogue)
        return int8_conv_plain(x, node, scale, stride, dilation, padding, epilogue)
    out = _launch(x, node, scale, stride, dilation, padding, epilogue)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
