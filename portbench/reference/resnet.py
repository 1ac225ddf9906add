"""ResNet-50 (He et al., arXiv:1512.03385) for the reference: the parameter
layout, the float forward with batch norm, the fold, and the walks of the
int8 predict path (float32 calibration and int8 inference).

Layout: NHWC activations and HWIO kernels; the tree of the system under
test ({"conv1", "bn1", "layer1".."layer4": [blocks]}, a block {"conv1",
"bn1", "conv2", "bn2", "conv3", "bn3"[, "down_conv", "down_bn"]}), so that
one set of weights made from the seed feeds both sides. The stride-2 3x3
conv pads (1, 1) as torchvision's does. With `dilate_last_stage` (DeepLab's
output stride 16) layer4 runs at stride 1 with its 3x3 convs dilated by 2.
"""

import torch

from portbench.reference import int8 as q8
from portbench.reference.layers import conv_bias_apply, fold_conv_bn, max_pool

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
EXPANSION = 4


def spec(in_channels=3):
    """(params, state) trees of ("conv", shape), ("ones", n), ("zeros", n)."""

    def bn(c):
        return {"scale": ("ones", c), "bias": ("zeros", c)}, {"mean": ("zeros", c), "var": ("ones", c)}

    params, state = {"conv1": {"w": ("conv", (7, 7, in_channels, 64))}}, {}
    params["bn1"], state["bn1"] = bn(64)
    cin = 64
    for si, (blocks, mid) in enumerate(STAGES):
        ps, ss = [], []
        for bi in range(blocks):
            cout = mid * EXPANSION
            p, s = {}, {}
            p["conv1"] = {"w": ("conv", (1, 1, cin, mid))}
            p["bn1"], s["bn1"] = bn(mid)
            p["conv2"] = {"w": ("conv", (3, 3, mid, mid))}
            p["bn2"], s["bn2"] = bn(mid)
            p["conv3"] = {"w": ("conv", (1, 1, mid, cout))}
            p["bn3"], s["bn3"] = bn(cout)
            if bi == 0:
                p["down_conv"] = {"w": ("conv", (1, 1, cin, cout))}
                p["down_bn"], s["down_bn"] = bn(cout)
            ps.append(p)
            ss.append(s)
            cin = cout
        params["layer{}".format(si + 1)] = ps
        state["layer{}".format(si + 1)] = ss
    return params, state


def geometry(si, bi, dilate_last_stage):
    """(stride, dilation) of block `bi` of stage `si`."""
    if dilate_last_stage and si == len(STAGES) - 1:
        return 1, 2
    return (2 if (bi == 0 and si > 0) else 1), 1


def forward(ops, params, state, x, dilate_last_stage=False):
    """The float forward on normalized x; `ops` supplies conv(x, w, stride,
    padding, dilation) and bn(x, params, state) -> y (batch norm in the mode
    and precision of the caller). Returns the four stage outputs."""
    out = ops.conv(x, params["conv1"]["w"], 2, ((3, 3), (3, 3)), 1)
    out = max_pool(torch.relu(ops.bn(out, params["bn1"], state["bn1"])), 3, 2, 1)
    skips = []
    for si, (blocks, _) in enumerate(STAGES):
        name = "layer{}".format(si + 1)
        for bi in range(blocks):
            p, s = params[name][bi], state[name][bi]
            stride, d = geometry(si, bi, dilate_last_stage)
            inner = torch.relu(ops.bn(ops.conv(out, p["conv1"]["w"], 1, "SAME", 1), p["bn1"], s["bn1"]))
            inner = torch.relu(ops.bn(ops.conv(inner, p["conv2"]["w"], stride, ((d, d), (d, d)), d), p["bn2"],
                                      s["bn2"]))
            inner = ops.bn(ops.conv(inner, p["conv3"]["w"], 1, "SAME", 1), p["bn3"], s["bn3"])
            if "down_conv" in p:
                shortcut = ops.bn(ops.conv(out, p["down_conv"]["w"], stride, "SAME", 1), p["down_bn"], s["down_bn"])
            else:
                shortcut = out
            out = torch.relu(inner + shortcut)
        skips.append(out)
    return tuple(skips)


def fold(params, state):
    folded = {"conv1": fold_conv_bn(params["conv1"], params["bn1"], state["bn1"])}
    for si, (blocks, _) in enumerate(STAGES):
        name = "layer{}".format(si + 1)
        stage = []
        for bi in range(blocks):
            p, s = params[name][bi], state[name][bi]
            fb = {k: fold_conv_bn(p[k], p[b], s[b]) for k, b in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"))}
            if "down_conv" in p:
                fb["down_conv"] = fold_conv_bn(p["down_conv"], p["down_bn"], s["down_bn"])
            stage.append(fb)
        folded[name] = stage
    return folded


def quantize(quant, folded):
    """The four stages quantized (conv1, conv2, conv3, down_conv per block);
    the stem stays float."""
    q = {"conv1": dict(folded["conv1"])}
    for si in range(len(STAGES)):
        name = "layer{}".format(si + 1)
        q[name] = [{k: quant.node(node) for k, node in fb.items()} for fb in folded[name]]
    return q


def calibrate_stages(folded, out, taps, dilate_last_stage=False):
    """The float32 folded stages on a pooled stem output, appending each
    conv site's input amax to `taps` in walk order (conv1, conv2, conv3,
    down_conv per block)."""
    skips = []
    for si, (blocks, _) in enumerate(STAGES):
        name = "layer{}".format(si + 1)
        for bi in range(blocks):
            fb = folded[name][bi]
            stride, d = geometry(si, bi, dilate_last_stage)

            def conv(node, xx, stride=1, padding="SAME", dilation=1):
                taps.append(xx.detach().float().abs().amax())
                return conv_bias_apply(node, xx, stride=stride, padding=padding, dilation=dilation)

            inner = torch.relu(conv(fb["conv1"], out))
            inner = torch.relu(conv(fb["conv2"], inner, stride, ((d, d), (d, d)), d))
            inner = conv(fb["conv3"], inner)
            shortcut = conv(fb["down_conv"], out, stride) if "down_conv" in fb else out
            out = torch.relu(inner + shortcut)
        skips.append(out)
    return tuple(skips)


def int8_stages(quant, q, out, scales, dilate_last_stage=False):
    """The int8 stages on a bf16 pooled stem output, consuming `scales`
    (an iterator) in walk order."""
    skips = []
    for si, (blocks, _) in enumerate(STAGES):
        name = "layer{}".format(si + 1)
        for bi in range(blocks):
            qb = q[name][bi]
            stride, d = geometry(si, bi, dilate_last_stage)
            block_scales = [next(scales) for _ in range(3 + ("down_conv" in qb))]
            out = q8.bottleneck(quant, out, qb, block_scales, stride=stride, dilation=d)
        skips.append(out)
    return tuple(skips)
