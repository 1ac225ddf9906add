"""U-Net with a ResNet-50 encoder: parameters, the train/eval forward,
inference fold, float forward.

Counterpart of robosat_tpu/models/unet.py. Channel math matches the
reference robosat U-Net: center DecoderBlock(2048->256) on a 2x2-pooled
enc4, dec0(2048+256->256), dec1(1024+256->256), dec2(512+256->64),
dec3(256+64->128), dec4(128->32), dec5 ConvRelu(32->32), final 1x1 conv.

The unfolded forward (`apply_features`, `apply`, and `apply_s2d` with the
space-to-depth tail, which training runs) takes the params as they train:
the encoder's batch norms in training or eval mode, float32 parameters cast
to the activations' dtype at each conv (not torch.autocast, which rounds in
other places). The decoder has no batch norm. The folded float forward
(`apply_features_folded*`, and `apply_folded` to the logits) runs in the
dtype of its input (float32 or bfloat16). Both run as torch convolutions,
as the JAX package leaves them to XLA; each decoder block is one
transposed conv with the 4x4 parity-combined kernel (`FUSED_DECODER`). The
int8 forward is the hybrid walk in robosat_tpu_torch/models/int8.py, and
QAT trains through its fake-quant mode (`apply_logits_fake_quant`).
"""

import torch

from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import resnet
from robosat_tpu_torch.models.layers import (
    conv_nhwc,
    depth_to_space2,
    fused_upsample_conv3x3,
    max_pool,
    s2d_conv3x3_kernel,
    s2d_up_conv3x3_kernel,
)

NUM_FILTERS = 32
FUSED_DECODER = True  # the only decoder form the port has


def init(seed, num_classes=2, num_filters=NUM_FILTERS, in_channels=3):
    """U-Net (params, state) from an int seed, drawn with a torch.Generator
    on the host (the values differ from the JAX package's init)."""
    gen = torch.Generator().manual_seed(int(seed))
    enc_params, enc_state = resnet.init(gen, in_channels=in_channels)
    nf = num_filters

    def conv3(cin, cout):
        return {"w": resnet.he_normal(gen, (3, 3, cin, cout))}

    params = {
        "encoder": enc_params,
        "center": conv3(2048, nf * 8),
        "dec0": conv3(2048 + nf * 8, nf * 8),
        "dec1": conv3(1024 + nf * 8, nf * 8),
        "dec2": conv3(512 + nf * 8, nf * 2),
        "dec3": conv3(256 + nf * 2, nf * 2 * 2),
        "dec4": conv3(nf * 2 * 2, nf),
        "dec5": conv3(nf, nf),
        "final": {"w": resnet.he_normal(gen, (1, 1, nf, num_classes)), "b": torch.zeros(num_classes)},
    }
    return params, {"encoder": enc_state}


def fold(params, state):
    """Inference-folded params: encoder BNs folded into their convs; the
    decoder has no BN, so its params pass through unchanged."""
    folded = dict(params)
    folded["encoder"] = resnet.fold(params["encoder"], state["encoder"])
    return folded


def _decoder_apply(node, x):
    """Nearest-2x upsample + 3x3 conv + relu, as one transposed conv."""
    return torch.relu(fused_upsample_conv3x3(node, x))


def _convrelu_apply(node, x):
    return torch.relu(conv_nhwc(x, node["w"]))


def _check_side(x):
    assert x.shape[1] % 32 == 0 and x.shape[2] % 32 == 0, "image resolution has to be divisible by 32 for resnet"


def _center(node, enc4):
    """The center block on a 2x2 max pool of enc4. At a 32-px input enc4 is
    1 x 1 and its pool empty; the JAX package's lhs-dilated conv then reads
    one pixel of zero padding, so its center is relu(0) = 0 at 1 x 1, and
    the center's weights get no gradient."""
    if enc4.shape[1] == 1 and enc4.shape[2] == 1:
        return enc4.new_zeros(enc4.shape[:3] + (node["w"].shape[-1],))
    return _decoder_apply(node, max_pool(enc4, window=2, stride=2, padding=0))


def _decode_to_dec3(folded, skips):
    enc1, enc2, enc3, enc4 = skips
    center = _center(folded["center"], enc4)
    dec0 = _decoder_apply(folded["dec0"], torch.cat([enc4, center], dim=-1))
    dec1 = _decoder_apply(folded["dec1"], torch.cat([enc3, dec0], dim=-1))
    dec2 = _decoder_apply(folded["dec2"], torch.cat([enc2, dec1], dim=-1))
    return _decoder_apply(folded["dec3"], torch.cat([enc1, dec2], dim=-1))


def apply_features(params, state, x, train=False):
    """Encoder (batch norm in training or eval mode) and decoder up to dec5
    on normalized x (N, H, W, 3); returns (features (N, H, W, 32),
    new_state)."""
    _check_side(x)
    skips, enc_state = resnet.apply(params["encoder"], state["encoder"], x, train)
    dec5 = _convrelu_apply(params["dec5"], _decoder_apply(params["dec4"], _decode_to_dec3(params, skips)))
    return dec5, {"encoder": enc_state}


def apply(params, state, x, train=False):
    """Forward pass on normalized x (N, H, W, 3); returns (logits, new_state)."""
    dec5, new_state = apply_features(params, state, x, train)
    return final_logits(params["final"], dec5), new_state


def _head_s2d(final, feats):
    """The final 1x1 conv per parity on blocked features (N, H/2, W/2,
    4 * 32), then one depth-to-space: fine logits in the features' dtype."""
    nb, hb, wb, _ = feats.shape
    wf = final["w"].reshape(NUM_FILTERS, -1).to(feats.dtype)  # (32, C)
    blocked = torch.matmul(feats.reshape(nb, hb, wb, 4, NUM_FILTERS), wf)
    logits = depth_to_space2(blocked.reshape(nb, hb, wb, -1))
    return logits + final["b"].to(logits.dtype)


def apply_s2d(params, state, x, train=False):
    """The forward with the space-to-depth decoder tail (the JAX package's
    training forward); returns (fine logits, new_state), the math of
    `apply` up to float summation order. dec4 and dec5 run at half
    resolution on parity-blocked channels (`decode_s2d`); the final 1x1
    conv applies per parity, and one depth-to-space gives the fine logits.
    Gradients flow through the rearranged kernels to the ordinary params."""
    _check_side(x)
    skips, enc_state = resnet.apply(params["encoder"], state["encoder"], x, train)
    feats = decode_s2d(params, skips)  # (N, H/2, W/2, 4 * 32) parity-major
    return _head_s2d(params["final"], feats), {"encoder": enc_state}


def apply_logits_fake_quant(params, state, scales, x):
    """The QAT training forward on normalized x (N, H, W, 3): batch norm
    folded in the graph at the running statistics (gradients reach the
    ordinary params through `fold`), the int8 walk in its fake-quant mode
    with the static per-site `scales` (the float stem, then every site's
    input and kernel on the grids the int8 predict uses), and the float 1x1
    head per parity on the blocked dec5 features; returns fine logits in
    x's dtype."""
    _check_side(x)
    folded = fold(params, state)
    sites = q8._Sites(scales=list(scales))
    feats = q8._walk(folded, x, sites, float_mode=True, fake_quant=True)
    return _head_s2d(folded["final"], feats)


def apply_features_folded(folded, x):
    """Fine-grid inference forward on normalized x (N, H, W, 3) up to the
    dec5 features (N, H, W, 32)."""
    _check_side(x)
    dec3 = _decode_to_dec3(folded, resnet.apply_folded(folded["encoder"], x))
    return _convrelu_apply(folded["dec5"], _decoder_apply(folded["dec4"], dec3))


def final_logits(final, features):
    """The final 1x1 conv plus bias on features (N, H, W, 32), in their
    dtype -> logits (N, H, W, classes)."""
    return conv_nhwc(features, final["w"]) + final["b"].to(features.dtype)


def apply_folded(folded, x):
    """BN-free inference forward on normalized x (N, H, W, 3) -> logits."""
    return final_logits(folded["final"], apply_features_folded(folded, x))


def decode_s2d(folded, skips):
    """Decoder over the encoder skips with the space-to-depth tail: dec4
    and dec5 at half resolution on parity-blocked channels. Returns
    (N, H/2, W/2, 4 * 32) features, parity p = 2 di + dj in channels
    [32 p, 32 p + 32)."""
    dec3 = _decode_to_dec3(folded, skips)
    dec4 = torch.relu(conv_nhwc(dec3, s2d_up_conv3x3_kernel(folded["dec4"]["w"])))
    return torch.relu(conv_nhwc(dec4, s2d_conv3x3_kernel(folded["dec5"]["w"])))


def apply_features_folded_s2d(folded, x):
    """Fine input (N, H, W, 3), fine stem, then `decode_s2d`."""
    _check_side(x)
    return decode_s2d(folded, resnet.apply_folded(folded["encoder"], x))


def apply_features_folded_s2d_from48(folded, x48):
    """4x4 host-blocked normalized input (N, H/4, W/4, 48): blocked stem,
    stages, `decode_s2d`."""
    return decode_s2d(folded, resnet.apply_folded_s2d4(folded["encoder"], x48))
