"""ResNet-50 encoder: parameters, the train/eval forward, BN fold and the
folded float forward.

Counterpart of robosat_tpu/models/resnet.py: the parameter tree (same
structure and HWIO layout as the JAX package), the unfolded forward with
batch norm in training or eval mode (`apply`, what training runs), the
inference fold, and the folded forward (fine stem or 4x4 space-to-depth
stem, then the four bottleneck stages). With `dilate_last_stage` (DeepLab's
output stride 16) layer4 keeps stride 1 and dilates its 3x3 convs by 2;
its first block's projection then runs at stride 1, so the same weights
load. Each runs in the compute dtype of
its input as torch (cuDNN) convolutions, as the JAX package leaves them to
XLA; parameters stay float32 and are cast at each conv.
"""

import torch

from robosat_tpu_torch.models.layers import (
    bn_apply,
    conv_bias_apply,
    conv_nhwc,
    fold_conv_bn,
    max_pool,
    pool3s2_from_parity,
    stem_s2d4_kernel,
)

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


def _stage_geometry(si, bi, dilate_last_stage):
    """(stride, dilation) of block `bi` of stage `si`: stride 2 opens layers
    2-4, except layer4 under `dilate_last_stage`, whose blocks dilate by 2."""
    if dilate_last_stage and si == len(RESNET50_STAGES) - 1:
        return 1, 2
    return (2 if (bi == 0 and si > 0) else 1), 1


def _bottleneck_apply(params, state, x, stride, train, dilation=1):
    """One bottleneck block with batch norm in training or eval mode;
    returns (output, the block's new BN state)."""
    new_state = {}
    out = conv_nhwc(x, params["conv1"]["w"])
    out, new_state["bn1"] = bn_apply(params["bn1"], state["bn1"], out, train)
    out = torch.relu(out)
    # Torch-style symmetric padding (SAME would pad (0, 1) at stride 2).
    out = conv_nhwc(out, params["conv2"]["w"], stride=stride, padding=((dilation, dilation),) * 2, dilation=dilation)
    out, new_state["bn2"] = bn_apply(params["bn2"], state["bn2"], out, train)
    out = torch.relu(out)
    out = conv_nhwc(out, params["conv3"]["w"])
    out, new_state["bn3"] = bn_apply(params["bn3"], state["bn3"], out, train)

    if "down_conv" in params:
        shortcut = conv_nhwc(x, params["down_conv"]["w"], stride=stride)
        shortcut, new_state["down_bn"] = bn_apply(params["down_bn"], state["down_bn"], shortcut, train)
    else:
        shortcut = x
    return torch.relu(out + shortcut), new_state


def apply(params, state, x, train=False, dilate_last_stage=False):
    """The encoder on normalized x (N, H, W, 3); returns ((enc1, enc2, enc3,
    enc4), new_state): the four stage outputs (256/512/1024/2048 channels at
    1/4..1/32 resolution, enc4 at 1/16 with `dilate_last_stage`), the
    U-Net's skips, and the BN state (the batch statistics' running update
    in training mode, `state` in eval mode)."""
    new_state = {}
    out = conv_nhwc(x, params["conv1"]["w"], stride=2, padding=((3, 3), (3, 3)))
    out, new_state["bn1"] = bn_apply(params["bn1"], state["bn1"], out, train)
    out = max_pool(torch.relu(out), window=3, stride=2, padding=1)

    skips = []
    for si, (blocks, _) in enumerate(RESNET50_STAGES):
        name = "layer{}".format(si + 1)
        stage_state = []
        for bi in range(blocks):
            stride, dilation = _stage_geometry(si, bi, dilate_last_stage)
            out, bs = _bottleneck_apply(params[name][bi], state[name][bi], out, stride, train, dilation)
            stage_state.append(bs)
        new_state[name] = stage_state
        skips.append(out)
    return tuple(skips), new_state


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


def walk_stages(enc, out, conv, dilate_last_stage=False):
    """The four bottleneck stages on a pooled stem output with a pluggable
    conv(node, x, stride=1, padding="SAME", dilation=1); site order per
    block: conv1, conv2, conv3, down_conv. Returns (enc1..enc4)."""
    skips = []
    for si, (blocks, _) in enumerate(RESNET50_STAGES):
        name = "layer{}".format(si + 1)
        for bi in range(blocks):
            qb = enc[name][bi]
            stride, d = _stage_geometry(si, bi, dilate_last_stage)
            inner = torch.relu(conv(qb["conv1"], out))
            # Torch-style symmetric padding (SAME would pad (0, 1) at stride 2).
            inner = torch.relu(conv(qb["conv2"], inner, stride=stride, padding=((d, d), (d, d)), dilation=d))
            inner = conv(qb["conv3"], inner)
            shortcut = conv(qb["down_conv"], out, stride=stride) if "down_conv" in qb else out
            out = torch.relu(inner + shortcut)
        skips.append(out)
    return tuple(skips)


def apply_folded_stages(folded, out, dilate_last_stage=False):
    """The four folded bottleneck stages on a pooled stem output."""
    return walk_stages(folded, out, conv_bias_apply, dilate_last_stage)


def stem_folded(folded_conv1, x):
    """The folded stem on fine input x (N, H, W, 3): conv 7x7/s2 (pad 3) +
    bias + relu, then maxpool 3/s2 (pad 1)."""
    out = torch.relu(conv_bias_apply(folded_conv1, x, stride=2, padding=((3, 3), (3, 3))))
    return max_pool(out, window=3, stride=2, padding=1)


def apply_folded(folded, x, dilate_last_stage=False):
    """Inference forward over BN-folded params on fine input x (N, H, W, 3):
    the stem, then the stages."""
    return apply_folded_stages(folded, stem_folded(folded["conv1"], x), dilate_last_stage)


def apply_folded_s2d4(folded, x48, dilate_last_stage=False):
    """`apply_folded` on 4x4 space-to-depth (host-blocked) input (N, H/4, W/4, 48)."""
    return apply_folded_stages(folded, stem_folded_s2d4(folded["conv1"], x48), dilate_last_stage)
