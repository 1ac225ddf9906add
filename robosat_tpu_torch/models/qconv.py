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
CUDA tensor it launches csrc/qconv.cu, which takes one of two kernels of
csrc/int8_conv_sm90.cuh by a fixed rule (`route`): a stride-1 3x3 conv of
dilation 1 or 2 runs halo_conv_kernel (one halo per 8 x 8-pixel output
tile and 64-channel chunk, weights packed by `packed_tap_slabs`; its tiles
are `halo_plan`'s), every other conv conv_kernel with a bf16 input
(weights packed by `qenc.packed_weights`). The packing and the scale
product ws * s (for a per-channel vector scale, the "pc" calibrations:
ws, and the reciprocal vector on the card) are cached per site
(`site_operands`). On a CPU tensor it runs `int8_conv_plain`. Activations
are bf16 NHWC, channel counts multiples of 16.
"""

from collections import namedtuple

import numpy as np
import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _int8_conv, is_vector, kernel_inv, scaled_ws
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


def route(k, stride, dilation):
    """The kernel csrc/qconv.cu runs a k x k conv on: "halo" for stride 1,
    k = 3 and dilation 1 or 2, else "conv_kernel" (the same rule in C)."""
    return "halo" if stride == 1 and k == 3 and dilation in (1, 2) else "conv_kernel"


def halo_bn(cout):
    """Output channels per tile of halo_conv_kernel: 64 up to Cout 64, else 128."""
    return 64 if cout <= 64 else 128


def packed_tap_slabs(node):
    """A node's 3x3 int8 kernel packed for csrc/int8_conv_sm90.cuh's
    halo_conv_kernel, cached on the node: (tiles_n * chunks * 2 * 9,
    bn * 32) int8 with bn = halo_bn(Cout), row ((tile_n * chunks + chunk)
    * 2 + half) * 9 + tap the slab of output channels [bn tile_n, +bn),
    input channels [64 chunk + 32 half, +32) of wq[tap // 3, tap % 3], in
    the wgmma core-matrix order: byte (row, k) at
    ((row // 8) * 2 + k // 16) * 128 + (row % 8) * 16 + k % 16. Cin pads to
    a multiple of 64 and Cout to one of bn with zeros; the nine slabs of one
    (tile_n, chunk, half), a weight stage of the kernel, are contiguous."""
    wpt = node.get("wpt")
    if wpt is None:
        wq = node["wq"]
        kh, kw, cin, cout = wq.shape
        taps, bn = kh * kw, halo_bn(cout)
        chunks, tiles_n = -(-cin // 64), -(-cout // bn)
        padded = torch.zeros((taps, chunks * 64, tiles_n * bn), dtype=torch.int8, device=wq.device)
        padded[:, :cin, :cout] = wq.reshape(taps, cin, cout)
        # (tap, chunk, half, k // 16, k % 16, tile_n, row // 8, row % 8)
        # -> (tile_n, chunk, half, tap, row // 8, k // 16, row % 8, k % 16)
        slabs = padded.reshape(taps, chunks, 2, 2, 16, tiles_n, bn // 8, 8).permute(5, 1, 2, 0, 6, 3, 7, 4)
        wpt = node["wpt"] = slabs.reshape(tiles_n * chunks * 2 * taps, bn * 32).contiguous()
    return wpt


HaloPlan = namedtuple("HaloPlan", "side tiles_y tiles_x n_tiles items bn")


def halo_plan(x_shape, cout, dilation, out_hw):
    """halo_conv_kernel's tiling of a conv of an (N, H, W, Cin) input to an
    (Ho, Wo) grid: the halo side 8 + 2 dilation, 8 x 8-pixel output tiles
    (tiles_y x tiles_x an image, n_tiles in all), items of two spatial tiles
    by one bn-wide output-channel tile."""
    n, ho, wo = x_shape[0], out_hw[0], out_hw[1]
    tiles_y, tiles_x, bn = -(-ho // 8), -(-wo // 8), halo_bn(cout)
    n_tiles = n * tiles_y * tiles_x
    return HaloPlan(8 + 2 * dilation, tiles_y, tiles_x, n_tiles, -(-n_tiles // 2) * -(-cout // bn), bn)


def halo_origin(plan, tile, pads):
    """(image, first input row, first input column) of the halo of output
    tile `tile`: its (8 x 8) corner less the padding before the grid."""
    img, rem = divmod(tile, plan.tiles_y * plan.tiles_x)
    ty, tx = divmod(rem, plan.tiles_x)
    return img, 8 * ty - pads[0], 8 * tx - pads[1]


def site_operands(node, scale, stride=1, dilation=1):
    """(packed weights for the conv's route, ws * s, 1 / s) of a site, or
    for a per-channel vector scale (packed weights, ws, the reciprocal
    vector on the card), cached on the node for the last scale given (a
    vector keyed by its bytes, so no other scale reuses its operands): the
    tree is quantized once and every batch reuses them."""
    key = ("pc", np.asarray(scale, np.float32).tobytes()) if is_vector(scale) else float(np.float32(scale))
    cached = node.get("site")
    if cached is None or cached[0] != key:
        inv, inv_v = kernel_inv(node, scale, node["wq"].device, node["wq"].shape[2])
        cached = node["site"] = (key, scaled_ws(node, scale).contiguous(), inv if inv_v is None else inv_v)
    packer = packed_tap_slabs if route(node["wq"].shape[0], stride, dilation) == "halo" else packed_weights
    return (packer(node),) + cached[1:]


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
    wp, e, inv = site_operands(node, scale, stride, dilation)
    inv, inv_v = (0.0, inv) if torch.is_tensor(inv) else (inv, None)
    if route(k, stride, dilation) == "halo":
        bn = halo_bn(cout)
        kernels.check_cuda(wp, "wp", torch.int8, (-(-cout // bn) * -(-cin // 64) * 18, bn * 32))
    else:
        kernels.check_cuda(wp, "wp", torch.int8, (k * k * -(-cin // 64), -(-cout // 128) * 128 * 64))
    kernels.check_cuda(e, "e", torch.float32, (cout,))
    b = node.get("b")
    if b is not None:
        b = kernels.check_cuda(b, "b", torch.float32, (cout,))
    out = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16, device=x.device)
    p = kernels.ptr
    kernels.launch("rs_int8_conv", p(x), p(wp), p(e), p(b), inv, p(inv_v), p(out), n, h, w, cin, cout, k, stride,
                   dilation, pt, pl, ho, wo, EPILOGUES[epilogue])
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
    int8_conv.by_route[route(node["wq"].shape[0], stride, dilation)] += 1
    return out


int8_conv.launches = 0
int8_conv.by_route = {"halo": 0, "conv_kernel": 0}  # launches by route, counted with `launches`
