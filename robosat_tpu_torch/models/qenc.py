"""int8 ResNet bottleneck blocks: CUDA kernels K3/K4 and their plain versions.

Counterpart of robosat_tpu/models/qenc.py. `bottleneck_block` (stride 1)
and `bottleneck_block_s2` (stride 2, torch-style (1, 1) padding on conv2,
stride-2 projection) compute, bit for bit,

    inner = relu(_int8_conv(conv1, x, s1))
    inner = relu(_int8_conv(conv2, inner, s2, stride, padding=((1, 1), (1, 1))))
    inner = _int8_conv(conv3, inner, s3)
    shortcut = _int8_conv(down_conv, x, sd, stride) if down_conv else x
    relu(inner + shortcut)      # f32 add of the bf16 operands, one rounding

On a CUDA tensor they launch csrc/qenc.cu (one call of the C entry runs
the block as 3-4 launches of the shared int8 conv); on a CPU tensor they
run the plain PyTorch version above. Activations are bf16 NHWC.
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _act_inv, _int8_conv, scaled_ws
from robosat_tpu_torch.models.qtail import conv_weights


def bottleneck_block_plain(x, qb, s1, s2, s3, sd=None, stride=1):
    """The block as separate plain int8 convs (any device)."""
    inner = torch.relu(_int8_conv(qb["conv1"], x, s1))
    inner = torch.relu(_int8_conv(qb["conv2"], inner, s2, stride=stride, padding=((1, 1), (1, 1))))
    inner = _int8_conv(qb["conv3"], inner, s3)
    shortcut = _int8_conv(qb["down_conv"], x, sd, stride=stride) if "down_conv" in qb else x
    return torch.relu(inner.float() + shortcut.float()).to(x.dtype)


def bottleneck_block_s2_plain(x, qb, s1, s2, s3, sd):
    return bottleneck_block_plain(x, qb, s1, s2, s3, sd, stride=2)


def _site_args(node, scale, name, cin, cout, taps):
    wk = kernels.check_cuda(conv_weights(node), name + ".wq", torch.int8, (cout, taps, cin))
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


def _launch_block(x, qb, s1, s2, s3, sd, stride):
    kernels.check_cuda(x, "x", torch.bfloat16)
    n, h, w, cin, cmid, cout = _block_dims(x, qb, sd, stride)
    has_down = sd is not None
    if cin % 16 or cmid % 16 or cout % 16:
        raise ValueError("the int8 kernels need channel counts that are multiples of 16")
    ho, wo = h // stride, w // stride

    w1, e1, b1 = _site_args(qb["conv1"], s1, "conv1", cin, cmid, 1)
    w2, e2, b2 = _site_args(qb["conv2"], s2, "conv2", cmid, cmid, 9)
    w3, e3, b3 = _site_args(qb["conv3"], s3, "conv3", cmid, cout, 1)
    wd = ed = bd = sc = None
    invd = 0.0
    if has_down:
        wd, ed, bd = _site_args(qb["down_conv"], sd, "down_conv", cin, cout, 1)
        invd = _act_inv(sd)
        sc = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16, device=x.device)
    h1 = torch.empty((n, h, w, cmid), dtype=torch.bfloat16, device=x.device)
    h2 = torch.empty((n, ho, wo, cmid), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((n, ho, wo, cout), dtype=torch.bfloat16, device=x.device)
    p = kernels.ptr
    kernels.launch(
        "rs_bottleneck_block",
        p(x), p(w1), p(e1), p(b1), p(w2), p(e2), p(b2), p(w3), p(e3), p(b3), p(wd), p(ed), p(bd),
        _act_inv(s1), _act_inv(s2), _act_inv(s3), invd,
        p(h1), p(h2), p(sc), p(out),
        n, h, w, cin, cmid, cout, stride,
    )
    return out


def bottleneck_block(x, qb, s1, s2, s3, sd=None):
    """One stride-1 int8 bottleneck block: (N, H, W, Cin) -> (N, H, W, Cout)."""
    if x.device.type == "cpu":
        _block_dims(x, qb, sd, 1)
        return bottleneck_block_plain(x, qb, s1, s2, s3, sd)
    out = _launch_block(x, qb, s1, s2, s3, sd, stride=1)
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


def apply_stage_blocks(x, stage, scales, first_stride=1, plain=False):
    """A whole stage, block by block; `scales` is the flat per-site list in
    walk order (conv1, conv2, conv3, down_conv when present). With
    `first_stride=2` block 0 is the stride-2 block (layers 2-4). `plain`
    runs the plain versions on any device."""
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
            out = fn(out, qb, s1, s2, s3, sd)
    return out
