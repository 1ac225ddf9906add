"""FastNet, the compact `fast` family: parameters, train/eval forward, fold,
float and int8 predict, QAT forward.

Counterpart of robosat_tpu/models/fastnet.py, with its names, parameter
tree and conv-site order. The input is consumed 4x4 space-to-depth (48
channels at 1/4 resolution; `rs predict` blocks it on the host), every
activation has 128 or 256 channels, and the head is a learned 4x sub-pixel
classifier: a 1x1 conv from 128 features to 16 positions x classes, so the
fine grid exists only in the train logits (`subpixel_to_fine`). Layer map
at 576-px buffered predict input (144/72/36/18 coarse grids):

  stem  48->128 @144    b1 128->128 @144 (+res)
  down2 128->128 @72/s2 b2 128->128 @72 (+res)
  down3 128->256 @36/s2 b3 256->256 @36 (+res)
  down4 256->256 @18/s2 b4a 256->256 @18 (+res)  b4b dil2 256->256 @18 (+res)
  u3 up 256->128 @36    d3 [e3|u3] 384->128 @36
  u2 up 128->128 @72    d2 [e2|u2] 256->128 @72
  u1 up 128->128 @144   d1 [e1|u1] 256->128 @144
  head 1x1 128 -> 16 * classes

Encoder convs carry batch norm (folded for inference); the decoder's
up-convs are nearest-2x upsample + 3x3 conv (the transposed conv of the
4x4 parity-combined kernel) and have no batch norm. The stride-2 convs pad
XLA's "SAME" way, (0, 1) on an even grid; b4b dilates by 2.

The float forwards run as torch (cuDNN) convolutions. The int8 walk
(`predict_quantized_int8`) runs every dense conv with its relu or
residual relu through `qconv.int8_conv` (the CUDA kernel rs_int8_conv) and
the three up-convs through `qdec.parity_up_conv` (K5) on the GPU; the
sub-pixel head stays float (ops/head.py). `plain=True` runs their plain
versions on any device. Weights differ from the JAX package's init for the
same seed (a torch.Generator draws them); the tests carry the JAX
package's weights across.
"""

import torch

from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qconv, qdec
from robosat_tpu_torch.models.layers import (
    bn_apply,
    conv_bias_apply,
    conv_nhwc,
    fold_conv_bn,
    fused_k4,
    fused_upsample_conv3x3,
    space_to_depth4,
    upsample_conv_k4,
)
from robosat_tpu_torch.models.resnet import bn_init, he_normal
from robosat_tpu_torch.ops import head as heads

# Encoder conv sites (conv + BN + relu, optional residual), in walk order.
_ENC = ("stem", "b1", "down2", "b2", "down3", "b3", "down4", "b4a", "b4b")
# Decoder conv sites (no BN), in walk order.
_DEC = ("u3", "d3", "u2", "d2", "u1", "d1")
# (stride, dilation) of each dense conv site as `_walk48` calls it: the
# route of its int8 conv (qconv.route) and so the packing it needs.
DENSE_SITES = {"stem": (1, 1), "b1": (1, 1), "down2": (2, 1), "b2": (1, 1), "down3": (2, 1), "b3": (1, 1),
               "down4": (2, 1), "b4a": (1, 1), "b4b": (1, 2), "d3": (1, 1), "d2": (1, 1), "d1": (1, 1)}

# The int8 predict emits 4x4-blocked uint8 (16 channels) for the host writer.
INT8_BLOCKED_OUT = True
# The input side must survive /4 (the stem's space-to-depth), then three /2 stages.
SIDE_MULTIPLE = 32

BLOCK = 4  # sub-pixel head block: output pixels per coarse cell side


def init(seed, num_classes=2, in_channels=3):
    """FastNet (params, state) from an int seed, drawn with a
    torch.Generator on the host in the JAX package's order."""
    gen = torch.Generator().manual_seed(int(seed))
    params, state = {}, {}

    def cbn(name, cin, cout):
        params[name] = {"w": he_normal(gen, (3, 3, cin, cout))}
        params[name + "_bn"], state[name + "_bn"] = bn_init(cout)

    cbn("stem", 16 * in_channels, 128)
    cbn("b1", 128, 128)
    cbn("down2", 128, 128)
    cbn("b2", 128, 128)
    cbn("down3", 128, 256)
    cbn("b3", 256, 256)
    cbn("down4", 256, 256)
    cbn("b4a", 256, 256)
    cbn("b4b", 256, 256)
    for name, cin in (("u3", 256), ("d3", 256 + 128), ("u2", 128), ("d2", 128 + 128), ("u1", 128),
                      ("d1", 128 + 128)):
        params[name] = {"w": he_normal(gen, (3, 3, cin, 128))}
    classes = BLOCK * BLOCK * num_classes
    params["final"] = {"w": he_normal(gen, (1, 1, 128, classes)), "b": torch.zeros(classes)}
    return params, state


def subpixel_to_fine(head, num_classes):
    """(N, h, w, 16 C) sub-pixel head output -> fine logits (N, 4h, 4w, C):
    channel ((2a + b) * 4 + 2u + v) * C + cls is class cls of fine pixel
    (4i + 2a + u, 4j + 2b + v), the predict writer's two depth-to-space
    passes."""
    n, h, w, c16 = head.shape
    c = c16 // (BLOCK * BLOCK)
    assert c == num_classes
    x = head.reshape(n, h, w, 2, 2, 2, 2, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(n, BLOCK * h, BLOCK * w, c)


def _walk48(x48, block, up):
    """The layer walk on 4x4-blocked input. `block(name, x, stride=1,
    dilation=1, residual=False)` returns the site's activation, relu(conv(x))
    or with `residual` relu(conv(x) + x); `up(name, x)` the relu'd fused
    upsample + conv. Float, folded, fake-quant and int8 walks share it, so
    their conv sites come in one order."""
    t = block("stem", x48)
    e1 = block("b1", t, residual=True)
    t = block("down2", e1, stride=2)
    e2 = block("b2", t, residual=True)
    t = block("down3", e2, stride=2)
    e3 = block("b3", t, residual=True)
    t = block("down4", e3, stride=2)
    t = block("b4a", t, residual=True)
    e4 = block("b4b", t, dilation=2, residual=True)

    d = up("u3", e4)
    d = block("d3", torch.cat([e3, d], dim=-1))
    d = up("u2", d)
    d = block("d2", torch.cat([e2, d], dim=-1))
    d = up("u1", d)
    return block("d1", torch.cat([e1, d], dim=-1))


def _blocks(conv):
    """`_walk48`'s block from a pre-activation conv(name, x, stride,
    dilation); the residual adds in the activations' dtype."""

    def block(name, x, stride=1, dilation=1, residual=False):
        y = conv(name, x, stride, dilation)
        return torch.relu(y + x if residual else y)

    return block


def _check_side(h, w):
    assert h % SIDE_MULTIPLE == 0 and w % SIDE_MULTIPLE == 0, (
        "fastnet needs image sides divisible by {}".format(SIDE_MULTIPLE))


def _head(final, feats):
    """The 1x1 sub-pixel head in the features' dtype, then the fine logits."""
    head = conv_nhwc(feats, final["w"]) + final["b"].to(feats.dtype)
    return subpixel_to_fine(head, final["b"].shape[0] // (BLOCK * BLOCK))


def apply(params, state, x, train=False):
    """Training/eval forward on fine normalized x (N, H, W, 3), batch norm
    in training or eval mode; returns (fine logits, new_state). Parameters
    stay float32 and are cast to x's dtype at each conv."""
    _check_side(x.shape[1], x.shape[2])
    new_state = {}

    def conv(name, xx, stride, dilation):
        y = conv_nhwc(xx, params[name]["w"], stride=stride, dilation=dilation)
        if name + "_bn" in params:
            y, new_state[name + "_bn"] = bn_apply(params[name + "_bn"], state[name + "_bn"], y, train)
        return y

    feats = _walk48(space_to_depth4(x), _blocks(conv), lambda name, xx: torch.relu(
        fused_upsample_conv3x3(params[name], xx)))
    return _head(params["final"], feats), new_state


def fold(params, state):
    """Inference params: the encoder's batch norms folded into their convs
    (conv + bias); the decoder and the head pass through."""
    folded = {name: fold_conv_bn(params[name], params[name + "_bn"], state[name + "_bn"]) for name in _ENC}
    for name in _DEC + ("final",):
        folded[name] = dict(params[name])
    return folded


def _walk48_folded(folded, x48):
    def conv(name, xx, stride, dilation):
        node = folded[name]
        if "b" in node:
            return conv_bias_apply(node, xx, stride=stride, dilation=dilation)
        return conv_nhwc(xx, node["w"], stride=stride, dilation=dilation)

    return _walk48(x48, _blocks(conv), lambda name, xx: torch.relu(fused_upsample_conv3x3(folded[name], xx)))


def apply_folded(folded, x):
    """BN-free inference forward on fine normalized x -> fine logits, in
    x's dtype."""
    _check_side(x.shape[1], x.shape[2])
    return _head(folded["final"], _walk48_folded(folded, space_to_depth4(x)))


def predict_quantized_folded(folded, x, overlap=0):
    """The float predict: fine input -> quantized foreground uint8, fine and
    cropped (N, H - 2o, W - 2o): the sub-pixel head on the coarse grid, then
    the interleave."""
    _check_side(x.shape[1], x.shape[2])
    feats = _walk48_folded(folded, space_to_depth4(x))
    blocked = heads.fused_prediction_head_subpixel(feats, folded["final"]["w"], folded["final"]["b"], overlap=0)
    return heads._crop(heads.interleave_subpixel_u8(blocked), overlap)


def quantize_folded_int8(folded, act_amaxes=None):
    """Folded tree -> int8 tree: per-output-channel int8 kernels, the
    up-convs in their 4x4 parity-combined form (K5's weights), the head
    float. With `act_amaxes` (the "pc" calibration: one per-input-channel
    range vector per site, _ENC then _DEC) each site's balanced scales fold
    into its kernel (int8.ScaleCursor) and the function returns (qtree,
    scale vectors)."""
    cursor = q8.ScaleCursor(act_amaxes)
    q = {name: q8._qconv_pc(folded[name], cursor) for name in _ENC}
    for name in _DEC:
        if name.startswith("u"):
            q[name] = q8._qkernel_pc(fused_k4(folded[name]["w"].float()), cursor)
        else:
            q[name] = q8._qconv_pc(folded[name], cursor)
    cursor.assert_done()
    q["final"] = dict(folded["final"])
    if act_amaxes is not None:
        return q, cursor.out_scales
    return q


def _site_padding(dilation):
    """The JAX walk's padding: (d, d) for a dilated conv, else XLA's SAME."""
    return ((dilation, dilation),) * 2 if dilation > 1 else "SAME"


def _walk48_sites(tree, x48, sites, float_mode, fake_quant=False, plain=False):
    """The walk consuming one scale per conv site, in `_walk48`'s order.

    In float mode (calibration) `tree` is the folded float tree; with
    `fake_quant` (QAT) every site also quantize-dequantizes its input with
    the site scale (`int8.fake_quant_act`) and its kernel with live
    per-output-channel scales (`int8.fake_quant_weight`; the up-convs their
    rewritten 4x4 kernel, which predict quantizes). Otherwise `tree` is the
    int8 tree and every site runs int8: the dense convs with their relu or
    residual relu through `qconv.int8_conv`, the up-convs through
    `qdec.parity_up_conv` (K5), or their plain versions with `plain`."""

    def float_conv(name, xx, stride, dilation):
        scale = sites.next_scale(xx)
        node = tree[name]
        if fake_quant:
            fq = {"w": q8.fake_quant_weight(node["w"].float()).to(xx.dtype)}
            if "b" in node:
                fq["b"] = node["b"]
            node, xx = fq, q8.fake_quant_act(xx, scale)
        padding = _site_padding(dilation)
        if "b" in node:
            return conv_bias_apply(node, xx, stride=stride, dilation=dilation, padding=padding)
        return conv_nhwc(xx, node["w"], stride=stride, dilation=dilation, padding=padding)

    def float_up(name, xx):
        scale = sites.next_scale(xx)
        if fake_quant:
            k4 = q8.fake_quant_weight(fused_k4(tree[name]["w"].float()))
            return torch.relu(upsample_conv_k4(k4, q8.fake_quant_act(xx, scale)))
        return torch.relu(fused_upsample_conv3x3(tree[name], xx))

    if float_mode:
        return _walk48(x48, _blocks(float_conv), float_up)

    conv = qconv.int8_conv_plain if plain else qconv.int8_conv
    up_conv = qdec.parity_up_conv_plain if plain else qdec.parity_up_conv

    def block(name, xx, stride=1, dilation=1, residual=False):
        return conv(xx, tree[name], sites.next_scale(xx), stride=stride, dilation=dilation,
                    padding=_site_padding(dilation), epilogue="residual_relu" if residual else "relu")

    def up(name, xx):
        return up_conv(xx, tree[name], sites.next_scale(xx))

    return _walk48(x48, block, up)


def prepare_int8(qtree, scales):
    """Pack every site's weights and compute its scale products ws * s once,
    when a predict step is built, rather than at its first launch."""
    for name, scale in zip(_ENC + _DEC, scales):
        if name.startswith("u"):
            qdec.packed_parity_weights(qtree[name])
        else:
            qconv.site_operands(qtree[name], scale, *DENSE_SITES[name])


def apply_logits_fake_quant(params, state, scales, x):
    """The QAT training forward on fine normalized x: batch norm folded in
    the graph at the running statistics (gradients reach the ordinary
    params through `fold`), the walk in its fake-quant mode with the static
    per-site `scales`, then the float sub-pixel head; fine logits in x's
    dtype."""
    _check_side(x.shape[1], x.shape[2])
    folded = fold(params, state)
    sites = q8._Sites(scales=list(scales))
    feats = _walk48_sites(folded, space_to_depth4(x), sites, float_mode=True, fake_quant=True)
    return _head(folded["final"], feats)


def calibration_amaxes_int8(folded, x, blocked=False, percentile=None):
    """Per-conv-site input amaxes (or |x| percentiles, or grid clips) from
    one float32 forward over normalized x, fine (N, H, W, 3) or with
    `blocked` 4x4 space-to-depth (N, H/4, W/4, 48); a float32 vector of 15
    on the host in conv-site order, or for a per-channel spec a list of one
    vector per site."""
    x48 = x if blocked else space_to_depth4(x)
    sites = q8._Sites(scales=None, percentile=percentile)
    with torch.no_grad():
        _walk48_sites(folded, x48.float(), sites, float_mode=True)
    return q8.site_taps(sites, percentile)


def predict_quantized_int8(qtree, scales, x, overlap=0, blocked=False, plain=False):
    """The int8 predict on normalized bf16 x: 4x4 host-blocked (N, H/4,
    W/4, 48) with `blocked`, else fine. Returns 4x4-blocked uint8
    (N, (H - 2 overlap) / 4, (W - 2 overlap) / 4, 16) when `blocked` and the
    overlap crops whole coarse pixels (INT8_BLOCKED_OUT: the host writer
    interleaves), otherwise fine uint8 (N, H - 2 overlap, W - 2 overlap).
    `plain` runs the kernels' plain versions."""
    scales = list(scales)
    x48 = x if blocked else space_to_depth4(x)
    sites = q8._Sites(scales=scales)
    feats = _walk48_sites(qtree, x48, sites, float_mode=False, plain=plain)
    assert sites.idx == len(scales), "conv-site count mismatch with calibration"
    w, b = qtree["final"]["w"], qtree["final"]["b"]
    if blocked and overlap % BLOCK == 0:
        return heads.fused_prediction_head_subpixel(feats, w, b, overlap=overlap)
    fine = heads.interleave_subpixel_u8(heads.fused_prediction_head_subpixel(feats, w, b, overlap=0))
    return heads._crop(fine, overlap)
