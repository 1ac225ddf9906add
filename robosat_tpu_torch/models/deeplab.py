"""DeepLabv3+ on the ResNet-50 encoder: parameters, train/eval forward,
fold, float and int8 predict.

Counterpart of robosat_tpu/models/deeplab.py, with its names, parameter
tree and conv-site order (`model = 'deeplabv3plus'`). The encoder runs at
output stride 16 (layer4 at stride 1, its 3x3 convs dilated by 2); ASPP
takes enc4 (2048 channels) through a 1x1 conv, three 3x3 convs dilated 6,
12 and 18, and the image-pool branch, concatenated (1280) and projected to
256; the decoder upsamples that 4x to enc1's grid, concatenates the 48
channels projected from enc1 (304 in all), runs two 3x3 convs at 256 and
the 1x1 classifier, and upsamples the logits 4x to the input. Every conv
is bias-free with batch norm and relu. Sizes at 576-px predict input:
enc1 144 x 144, enc4 and ASPP 36 x 36.

The float forwards run as torch (cuDNN) convolutions. The int8 walk
(`predict_quantized_int8`, the JAX package's `_walk_int8`) keeps the stem,
the pool branch, the low-level projection, both resizes and the head's
256 -> 1 margin as torch ops, as the JAX package leaves them to XLA, and
runs its 59 int8 sites on hand-written CUDA kernels on the GPU: the 16
bottleneck blocks through K3/K4 (qenc; layer4's three blocks K3 at
dilation 2) and ASPP's four convs, its projection and the decoder's two
convs through rs_int8_conv (qconv: aspp1, aspp_d0-2 and aspp_proj on
conv_kernel, dec1 and dec2 on halo_conv_kernel). `plain=True` runs their
plain versions on any device. The binary head takes the margin w1 - w0 at
1/4 resolution and upsamples that one channel (resize is linear), then
the sigmoid and the 256-bin digitize (`ops/head.resized_margin_head`, SegFormer's head
too). Weights differ from the JAX
package's init for the same seed (a torch.Generator draws them); the
tests carry the JAX package's weights across.
"""

import torch

from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qconv, qenc, resnet
from robosat_tpu_torch.models.layers import _resize_bilinear, bn_apply, conv_bias_apply, conv_nhwc, fold_conv_bn
from robosat_tpu_torch.ops import head as heads

ASPP_RATES = (6, 12, 18)
ASPP_CH = 256
LOWLEVEL_CH = 48

# The int8 sites after the encoder's 52, in walk order, with the dilation
# each runs at (qconv.route: the 3x3 dec1 and dec2 take the halo kernel).
DENSE_SITES = (("aspp1", 1),) + tuple(("aspp_d{}".format(i), r) for i, r in enumerate(ASPP_RATES)) + (
    ("aspp_proj", 1), ("dec1", 1), ("dec2", 1))


def _cbr_init(gen, k, cin, cout):
    bn_p, bn_s = resnet.bn_init(cout)
    return {"conv": {"w": resnet.he_normal(gen, (k, k, cin, cout))}, "bn": bn_p}, {"bn": bn_s}


def init(seed, num_classes=2, in_channels=3):
    """DeepLabv3+ (params, state) from an int seed, drawn with a
    torch.Generator on the host in the JAX package's order."""
    gen = torch.Generator().manual_seed(int(seed))
    enc_params, enc_state = resnet.init(gen, in_channels=in_channels)
    params, state = {"encoder": enc_params}, {"encoder": enc_state}
    params["aspp1"], state["aspp1"] = _cbr_init(gen, 1, 2048, ASPP_CH)
    for i, _ in enumerate(ASPP_RATES):
        params["aspp_d{}".format(i)], state["aspp_d{}".format(i)] = _cbr_init(gen, 3, 2048, ASPP_CH)
    params["aspp_pool"], state["aspp_pool"] = _cbr_init(gen, 1, 2048, ASPP_CH)
    params["aspp_proj"], state["aspp_proj"] = _cbr_init(gen, 1, ASPP_CH * (2 + len(ASPP_RATES)), ASPP_CH)
    params["lowlevel"], state["lowlevel"] = _cbr_init(gen, 1, 256, LOWLEVEL_CH)
    params["dec1"], state["dec1"] = _cbr_init(gen, 3, ASPP_CH + LOWLEVEL_CH, ASPP_CH)
    params["dec2"], state["dec2"] = _cbr_init(gen, 3, ASPP_CH, ASPP_CH)
    params["final"] = {"w": resnet.he_normal(gen, (1, 1, ASPP_CH, num_classes)), "b": torch.zeros(num_classes)}
    return params, state


def _check_side(h, w):
    assert h % 16 == 0 and w % 16 == 0, "image resolution has to be divisible by 16"


def _pooled(enc4):
    """ASPP's image-pool input: the mean of enc4 over space, summed in
    float32 and cast back (jnp.mean's upcast of bf16)."""
    return enc4.float().mean(dim=(1, 2), keepdim=True).to(enc4.dtype)


def _aspp_and_decoder(enc1, enc4, cbr, dense):
    """ASPP and the decoder to the pre-classifier 256-channel features at
    enc1's grid. `dense(name, x, dilation=1)` returns an int8 site's (or a
    float conv's) relu'd output; `cbr(name, x)` that of a conv that stays
    float (the pool branch and the low-level projection). Float, folded,
    calibration and int8 walks share it, so their sites come in one order."""
    branches = [dense("aspp1", enc4)]
    for i, rate in enumerate(ASPP_RATES):
        branches.append(dense("aspp_d{}".format(i), enc4, dilation=rate))
    pooled = cbr("aspp_pool", _pooled(enc4))
    branches.append(pooled.to(branches[0].dtype).expand(branches[0].shape))
    aspp = dense("aspp_proj", torch.cat(branches, dim=-1))
    low = cbr("lowlevel", enc1)
    up = _resize_bilinear(aspp, low.shape[1], low.shape[2]).to(low.dtype)
    out = dense("dec1", torch.cat([up, low], dim=-1))
    return dense("dec2", out)


def apply(params, state, x, train=False):
    """Training/eval forward on fine normalized x (N, H, W, 3), batch norm
    in training or eval mode; returns (logits (N, H, W, classes) in x's
    dtype, new_state)."""
    n, h, w, _ = x.shape
    _check_side(h, w)
    new_state = {}
    (enc1, _, _, enc4), new_state["encoder"] = resnet.apply(params["encoder"], state["encoder"], x, train,
                                                             dilate_last_stage=True)

    def cbr(name, xx, dilation=1):
        out = conv_nhwc(xx, params[name]["conv"]["w"], dilation=dilation)
        out, bn_s = bn_apply(params[name]["bn"], state[name]["bn"], out, train)
        new_state[name] = {"bn": bn_s}
        return torch.relu(out)

    out = _aspp_and_decoder(enc1, enc4, cbr, cbr)
    logits = conv_nhwc(out, params["final"]["w"]) + params["final"]["b"].to(out.dtype)
    return _resize_bilinear(logits, h, w), new_state


def fold(params, state):
    """Fold every batch norm into its conv for inference (conv + bias); the
    classifier passes through."""
    folded = {"encoder": resnet.fold(params["encoder"], state["encoder"])}
    for key in params:
        if key not in ("encoder", "final"):
            folded[key] = fold_conv_bn(params[key]["conv"], params[key]["bn"], state[key]["bn"])
    folded["final"] = dict(params["final"])
    return folded


def _cbr_folded(node, x, dilation=1):
    return torch.relu(conv_bias_apply(node, x, dilation=dilation))


def _decoder_folded(folded, x):
    """The folded trunk on fine x to the pre-classifier 256-channel
    features at 1/4 resolution."""
    enc1, _, _, enc4 = resnet.apply_folded(folded["encoder"], x, dilate_last_stage=True)

    def cbr(name, xx, dilation=1):
        return _cbr_folded(folded[name], xx, dilation)

    return _aspp_and_decoder(enc1, enc4, cbr, cbr)


def apply_folded(folded, x):
    """BN-free inference forward on fine normalized x -> full-resolution
    logits in x's dtype."""
    n, h, w, _ = x.shape
    out = _decoder_folded(folded, x)
    logits = conv_nhwc(out, folded["final"]["w"]) + folded["final"]["b"].to(out.dtype)
    return _resize_bilinear(logits, h, w)


def predict_quantized_folded(folded, x, overlap=0):
    """The float predict: fine normalized x -> quantized foreground uint8
    (N, H - 2o, W - 2o)."""
    n, h, w, _ = x.shape
    return heads.resized_margin_head(folded["final"], _decoder_folded(folded, x), h, w, overlap)


def quantize_folded_int8(folded, act_amaxes=None):
    """Folded tree -> int8 tree: the bottleneck stages, ASPP's convs and
    projection and the decoder's two convs per-output-channel int8; the
    stem, the pool branch, the low-level projection and the classifier stay
    float. With `act_amaxes` (the "pc" calibration: one per-input-channel
    range vector per site, in the walk's order) each site's balanced scales
    fold into its kernel (int8.ScaleCursor) and the function returns
    (qtree, scale vectors)."""
    cursor = q8.ScaleCursor(act_amaxes)
    q = {"encoder": q8.quantize_encoder_stages(folded["encoder"], cursor)}
    for name, _ in DENSE_SITES:
        q[name] = q8._qconv_pc(folded[name], cursor)
    cursor.assert_done()
    for name in ("aspp_pool", "lowlevel", "final"):
        q[name] = dict(folded[name])
    if act_amaxes is not None:
        return q, cursor.out_scales
    return q


def _walk_int8(q, x, sites, float_mode=False, blocked=False, plain=False):
    """The walk to the pre-classifier features, consuming one scale per
    int8 site in the JAX package's order (52 encoder sites, then
    DENSE_SITES): the stem (fine, or with `blocked` its 4x4 space-to-depth
    form), the stages at output stride 16, ASPP and the decoder. In float
    mode (calibration) `q` is the folded float tree and every site runs as
    a float conv; otherwise the encoder runs through K3/K4 and the dense
    sites through `qconv.int8_conv` with a relu epilogue (`plain`: their
    plain versions)."""
    stem = resnet.stem_folded_s2d4 if blocked else resnet.stem_folded
    out = stem(q["encoder"]["conv1"], x)

    def cbr(name, xx):
        return _cbr_folded(q[name], xx)

    if float_mode:

        def conv(node, xx, stride=1, padding="SAME", dilation=1):
            sites.next_scale(xx)
            return conv_bias_apply(node, xx, stride=stride, padding=padding, dilation=dilation)

        enc1, _, _, enc4 = resnet.walk_stages(q["encoder"], out, conv, dilate_last_stage=True)

        def dense(name, xx, dilation=1):
            return torch.relu(conv(q[name], xx, dilation=dilation))
    else:
        enc1, _, _, enc4 = q8.walk_stages_int8(q["encoder"], out, sites, plain=plain, dilate_last_stage=True)
        conv8 = qconv.int8_conv_plain if plain else qconv.int8_conv

        def dense(name, xx, dilation=1):
            return conv8(xx, q[name], sites.next_scale(xx), dilation=dilation, epilogue="relu")

    return _aspp_and_decoder(enc1, enc4, cbr, dense)


def prepare_int8(qtree, scales):
    """Pack every int8 site's weights for its kernel once, when a predict
    step is built, rather than at its first launch: the bottleneck convs
    for K3/K4 (`qenc.packed_weights`), the dense sites for their route with
    their scale products ws * s (`qconv.site_operands`)."""
    for si in range(len(resnet.RESNET50_STAGES)):
        for qb in qtree["encoder"]["layer{}".format(si + 1)]:
            for node in qb.values():
                qenc.packed_weights(node)
    for (name, dilation), scale in zip(DENSE_SITES, list(scales)[-len(DENSE_SITES):]):
        qconv.site_operands(qtree[name], scale, 1, dilation)


def calibration_amaxes_int8(folded, x, blocked=False, percentile=None):
    """Per-site input amaxes (or |x| percentiles, or grid clips) from one
    float32 forward over normalized x, fine (N, H, W, 3) or with `blocked`
    4x4 space-to-depth (N, H/4, W/4, 48); a float32 vector of 59 on the
    host in site order, or for a per-channel spec a list of 59 vectors."""
    sites = q8._Sites(scales=None, percentile=percentile)
    with torch.no_grad():
        _walk_int8(folded, x.float(), sites, float_mode=True, blocked=blocked)
    return q8.site_taps(sites, percentile)


def predict_quantized_int8(qtree, scales, x, overlap=0, blocked=False, plain=False):
    """The int8 predict on normalized bf16 x, 4x4 host-blocked (N, H/4,
    W/4, 48) with `blocked`, else fine (N, H, W, 3) -> fine uint8 (N,
    H - 2 overlap, W - 2 overlap). `plain` runs the kernels' plain
    versions."""
    scales = list(scales)
    h, w = (4 * x.shape[1], 4 * x.shape[2]) if blocked else (x.shape[1], x.shape[2])
    sites = q8._Sites(scales=scales)
    feats = _walk_int8(qtree, x, sites, blocked=blocked, plain=plain)
    assert sites.idx == len(scales), "conv-site count mismatch with calibration"
    return heads.resized_margin_head(qtree["final"], feats, h, w, overlap)
