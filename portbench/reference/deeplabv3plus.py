"""DeepLabv3+ (Chen et al., arXiv:1802.02611) on ResNet-50, for the reference.

Output stride 16 (layer4 at stride 1, dilation 2); ASPP on enc4: a 1x1
conv, three 3x3 convs at rates 6, 12 and 18, and the image-pool branch,
each 256 channels with batch norm and relu, concatenated (1280) and
projected to 256; the decoder resizes that to enc1's grid (bilinear),
concatenates the 48 channels projected from enc1, runs two 3x3 convs at
256 and the 1x1 classifier, and resizes the logits to the input. Bias-free
convs with batch norm, as the system's parameter tree has them.

- `forward`: the float training forward through `ops` (float32, or the
  fp8 control), resizes bilinear with half-pixel centers
  (jax.image.resize's weights, as F.interpolate's for upsampling).
- `calibrate`, `quantize`, `predict_int8`: the hybrid int8 predict on 4x4
  host-blocked input, frozen copies of the system's plain versions: the
  blocked bf16 stem, the 52 encoder sites and ASPP's four convs, its
  projection and the decoder's two convs int8; the pool branch, the
  low-level projection, the resizes (jax.image.resize's weights) and the
  margin head in float; fine bins out.
"""

import torch

from portbench.reference import int8 as q8
from portbench.reference import resnet
from portbench.reference.layers import conv_bias_apply, fold_conv_bn, resize_bilinear, stem_folded_s2d4

RATES = (6, 12, 18)
CH = 256
LOW = 48
# (name, kernel, input channels, output channels, dilation); int8 unless float.
CBR = (("aspp1", 1, 2048, CH, 1),) + tuple(("aspp_d{}".format(i), 3, 2048, CH, r) for i, r in enumerate(RATES)) + (
    ("aspp_pool", 1, 2048, CH, 1), ("aspp_proj", 1, CH * 5, CH, 1), ("lowlevel", 1, 256, LOW, 1),
    ("dec1", 3, CH + LOW, CH, 1), ("dec2", 3, CH, CH, 1))
FLOAT = ("aspp_pool", "lowlevel")
DILATION = {name: d for name, _, _, _, d in CBR}


def spec():
    params, state = resnet.spec()
    params, state = {"encoder": params}, {"encoder": state}
    for name, k, cin, cout, _ in CBR:
        params[name] = {"conv": {"w": ("conv", (k, k, cin, cout))}, "bn": {"scale": ("ones", cout),
                                                                           "bias": ("zeros", cout)}}
        state[name] = {"bn": {"mean": ("zeros", cout), "var": ("ones", cout)}}
    params["final"] = {"w": ("conv", (1, 1, CH, 2)), "b": ("zeros", 2)}
    return params, state


def _trunk(enc1, enc4, cbr):
    """ASPP and the decoder; cbr(name, x) -> relu'd output of that conv."""
    branches = [cbr("aspp1", enc4)] + [cbr("aspp_d{}".format(i), enc4) for i in range(len(RATES))]
    pooled = cbr("aspp_pool", enc4.float().mean(dim=(1, 2), keepdim=True).to(enc4.dtype))
    branches.append(pooled.to(branches[0].dtype).expand(branches[0].shape))
    aspp = cbr("aspp_proj", torch.cat(branches, dim=-1))
    low = cbr("lowlevel", enc1)
    return aspp, low


def features(ops, params, state, x):
    """Fine normalized x -> pre-classifier features at 1/4 resolution."""
    enc1, _, _, enc4 = resnet.forward(ops, params["encoder"], state["encoder"], x, dilate_last_stage=True)

    def cbr(name, xx):
        d = DILATION[name]
        out = ops.conv(xx, params[name]["conv"]["w"], 1, "SAME", d)
        return torch.relu(ops.bn(out, params[name]["bn"], state[name]["bn"]))

    aspp, low = _trunk(enc1, enc4, cbr)
    out = cbr("dec1", torch.cat([resize_bilinear(aspp, low.shape[1], low.shape[2]), low], dim=-1))
    return cbr("dec2", out)


def forward(ops, params, state, x):
    """Full-resolution logits (N, H, W, 2)."""
    feats = features(ops, params, state, x)
    logits = ops.conv(feats, params["final"]["w"], 1, "SAME", 1) + params["final"]["b"]
    return resize_bilinear(logits, x.shape[1], x.shape[2])


def head_input(ops, params, state, x):
    return features(ops, params, state, x), params["final"]


def fold(params, state):
    folded = {"encoder": resnet.fold(params["encoder"], state["encoder"])}
    for name, *_ in CBR:
        folded[name] = fold_conv_bn(params[name]["conv"], params[name]["bn"], state[name]["bn"])
    folded["final"] = dict(params["final"])
    return folded


def _walk(q, x48, encoder, dense):
    """The stem, `encoder` (the stages), then ASPP and the decoder with the
    int8 sites through `dense(name, x)` and the float ones as torch convs,
    to the pre-classifier features."""
    enc1, _, _, enc4 = encoder(stem_folded_s2d4(q["encoder"]["conv1"], x48))

    def cbr(name, xx):
        if name in FLOAT:
            return torch.relu(conv_bias_apply(q[name], xx))
        return dense(name, xx)

    aspp, low = _trunk(enc1, enc4, cbr)
    up = resize_bilinear(aspp, low.shape[1], low.shape[2]).to(low.dtype)
    out = cbr("dec1", torch.cat([up, low], dim=-1))
    return cbr("dec2", out)


def calibrate(folded, x48):
    taps = []
    with torch.no_grad():
        def encoder(out):
            return resnet.calibrate_stages(folded["encoder"], out, taps, dilate_last_stage=True)

        def dense(name, xx):
            taps.append(xx.abs().amax())
            return torch.relu(conv_bias_apply(folded[name], xx, dilation=DILATION[name]))

        _walk(folded, x48.float(), encoder, dense)
    return torch.stack(taps).float().cpu().numpy()


def quantize(quant, folded):
    q = {"encoder": resnet.quantize(quant, folded["encoder"])}
    for name, *_ in CBR:
        q[name] = dict(folded[name]) if name in FLOAT else quant.node(folded[name])
    q["final"] = dict(folded["final"])
    return q


def predict_int8(quant, q, scales, x48, overlap):
    """Normalized bf16 4x4-blocked x48 (N, H/4, W/4, 48) -> fine bins
    (N, H - 2 overlap, W - 2 overlap)."""
    it = iter(scales)
    h, w = 4 * x48.shape[1], 4 * x48.shape[2]
    with torch.no_grad():
        def encoder(out):
            return resnet.int8_stages(quant, q["encoder"], out, it, dilate_last_stage=True)

        def dense(name, xx):
            return torch.relu(q8.int8_conv(quant, q[name], xx, next(it), dilation=DILATION[name]))

        return q8.resized_head(_walk(q, x48, encoder, dense), q["final"], h, w, overlap)
