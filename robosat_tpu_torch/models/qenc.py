"""int8 ResNet bottleneck blocks: CUDA kernels K3/K4 and their plain versions.

Counterpart of robosat_tpu/models/qenc.py. `bottleneck_block` (stride 1)
and `bottleneck_block_s2` (stride 2, torch-style (1, 1) padding on conv2,
stride-2 projection) compute, bit for bit,

    inner = relu(_int8_conv(conv1, x, s1))
    inner = relu(_int8_conv(conv2, inner, s2, stride, padding=((d, d), (d, d)), dilation=d))
    inner = _int8_conv(conv3, inner, s3)
    shortcut = _int8_conv(down_conv, x, sd, stride) if down_conv else x
    relu(inner + shortcut)      # f32 add of the bf16 operands, one rounding

with d = 1, or for a stride-1 block a dilation d (DeepLab's layer4: d = 2).
The scales s1, s2, s3, sd are all per-tensor floats or all per-channel
vectors (the "pc" calibrations). On a CUDA tensor they launch one C entry
(csrc/qenc.cu) that runs the block as 3-4 launches of the pipelined wgmma
conv of csrc/int8_conv_sm90.cuh, with weights packed by `packed_weights`
and h1 and h2 in int8; the stride-2 block's conv2 and projection gather
every other input pixel; per-channel scales go to the card as reciprocal
vectors (`int8.device_inv`). On a CPU tensor they run the plain PyTorch
version above. Activations are bf16 NHWC.
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _int8_conv, check_one_kind, kernel_inv, scaled_ws
from robosat_tpu_torch.models.qtail import conv_weights


def packed_weights(node):
    """A node's int8 kernel packed for csrc/int8_conv_sm90.cuh's conv_kernel,
    cached on the node: (taps * chunks, cout_pad * 64), one slab per K step
    (tap, 64-input-channel chunk), each slab the step's (cout_pad, 64)
    weight tile in the wgmma core-matrix order, byte (row, k) at
    ((row // 8) * 4 + k // 16) * 128 + (row % 8) * 16 + k % 16. Cin pads to
    a multiple of 64 and Cout to a multiple of 128 with zeros; any 64- or
    128-row tile of a slab is one contiguous copy."""
    wp = node.get("wp")
    if wp is None:
        wk = conv_weights(node)
        cout, taps, cin = wk.shape
        chunks, cout_pad = -(-cin // 64), -(-cout // 128) * 128
        padded = torch.zeros((cout_pad, taps, chunks * 64), dtype=torch.int8, device=wk.device)
        padded[:cout, :, :cin] = wk
        tiles = padded.reshape(cout_pad // 8, 8, taps, chunks, 4, 16).permute(2, 3, 0, 4, 1, 5)
        wp = node["wp"] = tiles.reshape(taps * chunks, cout_pad * 64).contiguous()
    return wp


def bottleneck_block_plain(x, qb, s1, s2, s3, sd=None, stride=1, dilation=1):
    """The block as separate plain int8 convs (any device)."""
    _check_geometry(stride, dilation)
    d = dilation
    inner = torch.relu(_int8_conv(qb["conv1"], x, s1))
    inner = torch.relu(_int8_conv(qb["conv2"], inner, s2, stride=stride, padding=((d, d), (d, d)), dilation=d))
    inner = _int8_conv(qb["conv3"], inner, s3)
    shortcut = _int8_conv(qb["down_conv"], x, sd, stride=stride) if "down_conv" in qb else x
    return torch.relu(inner.float() + shortcut.float()).to(x.dtype)


def bottleneck_block_s2_plain(x, qb, s1, s2, s3, sd):
    return bottleneck_block_plain(x, qb, s1, s2, s3, sd, stride=2)


def _check_geometry(stride, dilation):
    """Stride 1 at any dilation of at least 1, or stride 2 at dilation 1."""
    if stride not in (1, 2) or dilation < 1 or (stride == 2 and dilation != 1):
        raise ValueError("a block of stride 1 at a dilation >= 1, or of stride 2 at dilation 1 (got stride {}, "
                         "dilation {})".format(stride, dilation))


def _site_args(node, scale, name, cin, cout, taps):
    wk = kernels.check_cuda(packed_weights(node), name + ".wp", torch.int8,
                            (taps * -(-cin // 64), -(-cout // 128) * 128 * 64))
    e = kernels.check_cuda(scaled_ws(node, scale).contiguous(), name + ".ws", torch.float32, (cout,))
    b = node.get("b")
    if b is not None:
        b = kernels.check_cuda(b, name + ".b", torch.float32, (cout,))
    return wk, e, b


def _block_dims(x, qb, sd, stride):
    """Validate a block's operands; returns (n, h, w, cin, cmid, cout)."""
    n, h, w, cin = x.shape
    has_down = "down_conv" in qb
    if has_down != (sd is not None):
        raise ValueError("down_conv and its scale travel together")
    cmid = qb["conv1"]["wq"].shape[-1]
    cout = qb["conv3"]["wq"].shape[-1]
    if not has_down and (cin != cout or stride != 1):
        raise ValueError("an identity residual needs stride 1 and Cin == Cout")
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError("the stride-2 block needs even spatial dims")
    return n, h, w, cin, cmid, cout


def _launch_block(x, qb, s1, s2, s3, sd, stride, dilation=1):
    kernels.check_cuda(x, "x", torch.bfloat16)
    _check_geometry(stride, dilation)
    n, h, w, cin, cmid, cout = _block_dims(x, qb, sd, stride)
    has_down = sd is not None
    if cin % 16 or cmid % 16 or cout % 16:
        raise ValueError("the int8 kernels need channel counts that are multiples of 16")
    check_one_kind((s1, s2, s3, sd))
    ho, wo = h // stride, w // stride

    w1, e1, b1 = _site_args(qb["conv1"], s1, "conv1", cin, cmid, 1)
    w2, e2, b2 = _site_args(qb["conv2"], s2, "conv2", cmid, cmid, 9)
    w3, e3, b3 = _site_args(qb["conv3"], s3, "conv3", cmid, cout, 1)
    inv1, v1 = kernel_inv(qb["conv1"], s1, x.device, cin)
    inv2, v2 = kernel_inv(qb["conv2"], s2, x.device, cmid)
    inv3, v3 = kernel_inv(qb["conv3"], s3, x.device, cmid)
    wd = ed = bd = sc = vd = None
    invd = 0.0
    if has_down:
        wd, ed, bd = _site_args(qb["down_conv"], sd, "down_conv", cin, cout, 1)
        invd, vd = kernel_inv(qb["down_conv"], sd, x.device, cin)
        sc = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16, device=x.device)
    h1 = torch.empty((n, h, w, cmid), dtype=torch.int8, device=x.device)
    h2 = torch.empty((n, ho, wo, cmid), dtype=torch.int8, device=x.device)
    out = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16, device=x.device)
    p = kernels.ptr
    kernels.launch("rs_bottleneck_block", p(x), p(w1), p(e1), p(b1), p(w2), p(e2), p(b2), p(w3), p(e3), p(b3),
                   p(wd), p(ed), p(bd), inv1, inv2, inv3, invd, p(v1), p(v2), p(v3), p(vd), p(h1), p(h2), p(sc),
                   p(out), n, h, w, cin, cmid, cout, stride, dilation)
    return out


def bottleneck_block(x, qb, s1, s2, s3, sd=None, dilation=1):
    """One stride-1 int8 bottleneck block, its 3x3 conv dilated by
    `dilation`: (N, H, W, Cin) -> (N, H, W, Cout)."""
    if x.device.type == "cpu":
        _block_dims(x, qb, sd, 1)
        return bottleneck_block_plain(x, qb, s1, s2, s3, sd, dilation=dilation)
    out = _launch_block(x, qb, s1, s2, s3, sd, stride=1, dilation=dilation)
    bottleneck_block.launches += 1
    return out


bottleneck_block.launches = 0


def bottleneck_block_s2(x, qb, s1, s2, s3, sd):
    """One stride-2 int8 bottleneck block (always projecting):
    (N, H, W, Cin) -> (N, H/2, W/2, Cout)."""
    if x.device.type == "cpu":
        _block_dims(x, qb, sd, 2)
        return bottleneck_block_s2_plain(x, qb, s1, s2, s3, sd)
    out = _launch_block(x, qb, s1, s2, s3, sd, stride=2)
    bottleneck_block_s2.launches += 1
    return out


bottleneck_block_s2.launches = 0


def apply_stage_blocks(x, stage, scales, first_stride=1, plain=False, dilation=1):
    """A whole stage, block by block; `scales` is the flat per-site list in
    walk order (conv1, conv2, conv3, down_conv when present). With
    `first_stride=2` block 0 is the stride-2 block (layers 2-4); otherwise
    every block is a stride-1 block whose 3x3 conv dilates by `dilation`
    (DeepLab's layer4: 2). `plain` runs the plain versions on any device."""
    if first_stride == 2 and dilation != 1:
        raise ValueError("a stage opened by a stride-2 block runs at dilation 1")
    it = iter(scales)
    out = x
    for bi, qb in enumerate(stage):
        s1, s2, s3 = next(it), next(it), next(it)
        sd = next(it) if "down_conv" in qb else None
        if bi == 0 and first_stride == 2:
            fn = bottleneck_block_s2_plain if plain else bottleneck_block_s2
            out = fn(out, qb, s1, s2, s3, sd)
        else:
            fn = bottleneck_block_plain if plain else bottleneck_block
            out = fn(out, qb, s1, s2, s3, sd, dilation=dilation)
    return out
