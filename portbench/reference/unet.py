"""The U-Net of mapbox/robosat v1.2.0 (robosat/unet.py) on ResNet-50, for
the reference.

Decoder: center = DecoderBlock(2048 -> 256) on a 2x2 max pool of enc4; dec0
(2048 + 256 -> 256), dec1 (1024 + 256 -> 256), dec2 (512 + 256 -> 64), dec3
(256 + 64 -> 128), dec4 (128 -> 32), each a nearest-2x upsample, a 3x3 conv
and a relu; dec5 = ConvRelu(32 -> 32); the final 1x1 conv to 2 classes.
Bias-free decoder convs, as the system's parameter tree has them.

- `forward`: the float training forward, through `ops` (float32, or the
  fp8 control), each up-block one transposed conv with the 4x4
  parity-combined kernel (the same function as the upsample then the 3x3
  conv, without the 4x larger upsampled input in memory).
- `calibrate`, `quantize`, `predict_int8`: the hybrid int8 predict on 4x4
  host-blocked input with blocked output, in the forms whose weights the
  int8 grid quantizes (the 4x4 parity-combined kernels of center..dec3,
  the space-to-depth kernels of dec4 and dec5), frozen copies of the
  system's plain versions: the blocked bf16 stem, every int8 site exact,
  the blocked head.
"""

import torch

from portbench.reference import int8 as q8
from portbench.reference import resnet
from portbench.reference.layers import (
    conv_nhwc,
    fused_k4,
    max_pool,
    s2d_conv3x3_kernel,
    s2d_up_conv3x3_kernel,
    stem_folded_s2d4,
    upsample_conv_k4,
)

NF = 32
DECODER = (("center", 2048, NF * 8), ("dec0", 2048 + NF * 8, NF * 8), ("dec1", 1024 + NF * 8, NF * 8),
           ("dec2", 512 + NF * 8, NF * 2), ("dec3", 256 + NF * 2, NF * 4), ("dec4", NF * 4, NF), ("dec5", NF, NF))


def spec():
    params, state = resnet.spec()
    params = {"encoder": params}
    for name, cin, cout in DECODER:
        params[name] = {"w": ("conv", (3, 3, cin, cout))}
    params["final"] = {"w": ("conv", (1, 1, NF, 2)), "b": ("zeros", 2)}
    return params, {"encoder": state}


def features(ops, params, state, x):
    """Fine normalized x (N, H, W, 3) -> dec5 features (N, H, W, 32)."""
    enc1, enc2, enc3, enc4 = resnet.forward(ops, params["encoder"], state["encoder"], x)

    def up(name, xx):
        return torch.relu(ops.up_conv(xx, params[name]["w"]))

    center = up("center", max_pool(enc4, 2, 2, 0))
    dec0 = up("dec0", torch.cat([enc4, center], -1))
    dec1 = up("dec1", torch.cat([enc3, dec0], -1))
    dec2 = up("dec2", torch.cat([enc2, dec1], -1))
    dec3 = up("dec3", torch.cat([enc1, dec2], -1))
    dec4 = up("dec4", dec3)
    return torch.relu(ops.conv(dec4, params["dec5"]["w"], 1, "SAME", 1))


def forward(ops, params, state, x):
    """Fine logits (N, H, W, 2)."""
    feats = features(ops, params, state, x)
    return ops.conv(feats, params["final"]["w"], 1, "SAME", 1) + params["final"]["b"]


def head_input(ops, params, state, x):
    """(features, the final conv's node): what the binary head takes."""
    return features(ops, params, state, x), params["final"]


def fold(params, state):
    folded = dict(params)
    folded["encoder"] = resnet.fold(params["encoder"], state["encoder"])
    return folded


def _decoder_convs(folded):
    """The decoder's sites in walk order with the kernels the int8 grid
    quantizes: the 4x4 parity-combined kernels, then dec4's and dec5's
    space-to-depth kernels."""
    ks = [(name, fused_k4(folded[name]["w"].float())) for name in ("center", "dec0", "dec1", "dec2", "dec3")]
    return ks + [("dec4", s2d_up_conv3x3_kernel(folded["dec4"]["w"].float())),
                 ("dec5", s2d_conv3x3_kernel(folded["dec5"]["w"].float()))]


def calibrate(folded, x48):
    """Per-site input amaxes (host float32 vector, walk order) from one
    float32 walk over the normalized 4x4-blocked batch."""
    taps = []
    with torch.no_grad():
        out = stem_folded_s2d4(folded["encoder"]["conv1"], x48.float())
        enc1, enc2, enc3, enc4 = resnet.calibrate_stages(folded["encoder"], out, taps)
        kernels = dict(_decoder_convs(folded))

        def up(name, xx):
            taps.append(xx.abs().amax())
            return torch.relu(upsample_conv_k4(kernels[name], xx))

        center = up("center", max_pool(enc4, 2, 2, 0))
        dec0 = up("dec0", torch.cat([enc4, center], -1))
        dec1 = up("dec1", torch.cat([enc3, dec0], -1))
        dec2 = up("dec2", torch.cat([enc2, dec1], -1))
        dec3 = up("dec3", torch.cat([enc1, dec2], -1))
        taps.append(dec3.abs().amax())
        dec4 = torch.relu(conv_nhwc(dec3, kernels["dec4"]))
        taps.append(dec4.abs().amax())
    return torch.stack(taps).float().cpu().numpy()


def quantize(quant, folded):
    q = {"encoder": resnet.quantize(quant, folded["encoder"])}
    for name, k in _decoder_convs(folded):
        q[name] = quant.weight(k)
    q["final"] = dict(folded["final"])
    return q


def predict_int8(quant, q, scales, x48, overlap):
    """Normalized bf16 4x4-blocked x48 -> blocked bins (N, H/2 - overlap,
    W/2 - overlap, 4)."""
    it = iter(scales)
    with torch.no_grad():
        out = stem_folded_s2d4(q["encoder"]["conv1"], x48)
        enc1, enc2, enc3, enc4 = resnet.int8_stages(quant, q["encoder"], out, it)
        center = q8.up_block(quant, max_pool(enc4, 2, 2, 0), q["center"], next(it))
        dec0 = q8.up_block(quant, torch.cat([enc4, center], -1), q["dec0"], next(it))
        dec1 = q8.up_block(quant, torch.cat([enc3, dec0], -1), q["dec1"], next(it))
        dec2 = q8.up_block(quant, torch.cat([enc2, dec1], -1), q["dec2"], next(it))
        dec3 = q8.up_block(quant, torch.cat([enc1, dec2], -1), q["dec3"], next(it))
        y4 = torch.relu(q8.int8_conv(quant, q["dec4"], dec3, next(it)))
        y5 = torch.relu(q8.int8_conv(quant, q["dec5"], y4, next(it)))
        return q8.blocked_head(y5, q["final"], overlap)
