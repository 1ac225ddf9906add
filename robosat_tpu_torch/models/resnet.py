"""ResNet-50 encoder parameters, BN fold and the blocked stem.

Counterpart of robosat_tpu/models/resnet.py for the int8 predict walk: the
parameter tree (same structure and HWIO layout as the JAX package), its
inference fold, and the 4x4 space-to-depth stem, which stays a bf16 torch
conv as the JAX package left it to XLA.
"""

import torch

from robosat_tpu_torch.models.layers import conv_nhwc, fold_conv_bn, pool3s2_from_parity, stem_s2d4_kernel

# (blocks, mid_channels) per stage; expansion 4 => stage outputs 256/512/1024/2048.
RESNET50_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
EXPANSION = 4


def he_normal(gen, shape):
    """Kaiming normal (fan_out, as torchvision's ResNet) on the host."""
    kh, kw, cin, cout = shape
    std = (2.0 / (kh * kw * cout)) ** 0.5
    return torch.randn(shape, generator=gen) * std


def bn_init(channels):
    return (
        {"scale": torch.ones(channels), "bias": torch.zeros(channels)},
        {"mean": torch.zeros(channels), "var": torch.ones(channels)},
    )


def _bottleneck_init(gen, cin, mid, stride):
    cout = mid * EXPANSION
    params, state = {}, {}
    params["conv1"] = {"w": he_normal(gen, (1, 1, cin, mid))}
    params["bn1"], state["bn1"] = bn_init(mid)
    params["conv2"] = {"w": he_normal(gen, (3, 3, mid, mid))}
    params["bn2"], state["bn2"] = bn_init(mid)
    params["conv3"] = {"w": he_normal(gen, (1, 1, mid, cout))}
    params["bn3"], state["bn3"] = bn_init(cout)
    if stride != 1 or cin != cout:
        params["down_conv"] = {"w": he_normal(gen, (1, 1, cin, cout))}
        params["down_bn"], state["down_bn"] = bn_init(cout)
    return params, state


def init(gen, in_channels=3):
    """ResNet-50 encoder (params, state) drawn from the torch.Generator `gen`."""
    params, state = {"conv1": {"w": he_normal(gen, (7, 7, in_channels, 64))}}, {}
    params["bn1"], state["bn1"] = bn_init(64)
    cin = 64
    for si, (blocks, mid) in enumerate(RESNET50_STAGES):
        stage_p, stage_s = [], []
        for bi in range(blocks):
            bp, bs = _bottleneck_init(gen, cin, mid, 2 if (bi == 0 and si > 0) else 1)
            stage_p.append(bp)
            stage_s.append(bs)
            cin = mid * EXPANSION
        params["layer{}".format(si + 1)] = stage_p
        state["layer{}".format(si + 1)] = stage_s
    return params, state


def fold(params, state):
    """Fold every BN into its conv for inference; returns folded params."""
    folded = {"conv1": fold_conv_bn(params["conv1"], params["bn1"], state["bn1"])}
    for si, (blocks, _) in enumerate(RESNET50_STAGES):
        name = "layer{}".format(si + 1)
        stage = []
        for bi in range(blocks):
            bp, bs = params[name][bi], state[name][bi]
            fb = {
                "conv1": fold_conv_bn(bp["conv1"], bp["bn1"], bs["bn1"]),
                "conv2": fold_conv_bn(bp["conv2"], bp["bn2"], bs["bn2"]),
                "conv3": fold_conv_bn(bp["conv3"], bp["bn3"], bs["bn3"]),
            }
            if "down_conv" in bp:
                fb["down_conv"] = fold_conv_bn(bp["down_conv"], bp["down_bn"], bs["down_bn"])
            stage.append(fb)
        folded[name] = stage
    return folded


def stem_folded_s2d4(folded_conv1, x48):
    """The folded stem (conv7x7/s2 + bias + relu + maxpool3/s2) on 4x4
    space-to-depth input x48 (N, H/4, W/4, 48): one 3x3 conv emitting the
    four stride-2 output parities, pooled in parity space. Runs in x48's
    dtype; the bias is cast to it before the add, as in the JAX package."""
    w = folded_conv1["w"]
    out = conv_nhwc(x48, stem_s2d4_kernel(w), padding="SAME")
    b4 = folded_conv1["b"].repeat(4).to(out.dtype)
    return pool3s2_from_parity(torch.relu(out + b4), w.shape[-1])
