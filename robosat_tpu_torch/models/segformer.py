"""SegFormer (MiT-B0 encoder, all-MLP decoder): parameters, train/eval
forward, fold, float and int8 predict.

Counterpart of robosat_tpu/models/segformer.py, with its names, parameter
tree and int8-site order (`model = 'segformer'`). Four Mix Transformer
stages (widths 32, 64, 160, 256, two blocks each, 1, 2, 5 and 8 heads of
32 channels): an overlapped patch embed (7x7 stride 4, then 3x3 stride 2)
and its LayerNorm, pre-LN blocks of efficient self-attention (keys and
values from a grid reduced by a kernel = stride conv of ratio 8, 4, 2, 1)
and a Mix-FFN (dense 4x, depthwise 3x3, exact GELU, dense), and a
LayerNorm per stage; the decoder projects each stage to 256 channels,
resizes them to the 1/4 grid, concatenates them, fuses them with a 1x1
conv, batch norm and relu, and classifies with a 1x1 conv whose logits are
resized to the input. The fuse's batch norm is the model's only state.

The float forwards run as torch ops: convolutions through cuDNN,
LayerNorm, softmax and GELU as the JAX package computes them in its
dtype (`_ln`, `_attention`, `_gelu`), attention as two `torch.matmul`s
around a float32 softmax (not scaled_dot_product_attention, which fuses
the softmax and drops the rounding of its bf16 output).

The int8 walk (`predict_quantized_int8`, the JAX package's `_walk_int8`)
keeps the stage-0 patch embed (fine, or on 4x4 host-blocked input its
2x2 form over the blocked grid), the LayerNorms, attention, the depthwise
convs, GELU, the residuals, the resizes and the margin head as torch ops,
and runs its 54 int8 sites on hand-written CUDA kernels on the GPU
(`plain=True`: their plain versions on any device):

- the 40 block dense layers (q, kv, proj, fc1, fc2 of 8 blocks), the 4
  decoder projections and the fuse (a 1x1 conv with the batch norm folded
  in: a dense over pixels) through `int8_mm.int8_dense`: the activation
  quantize kernel, then K2 with its dequant-and-bias epilogue;
- the 6 spatial-reduction convs (kernel = stride = r, 8, 4 and 2, no
  padding) through the same route: the quantize kernel writes the r x r
  space-to-depth of the quantized input, and K2 takes the weight as an
  (r r C, C) dense, whose int32 sums are the conv's;
- the 3 stride-2 patch embeds of stages 1-3 through rs_int8_conv
  (`qconv.int8_conv`, conv_kernel, linear epilogue).

That is 51 K2 launches and 3 rs_int8_conv launches a batch. Weights differ
from the JAX package's init for the same seed (a torch.Generator draws
them); the tests carry the JAX package's weights across.
"""

import numpy as np
import torch

from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qconv
from robosat_tpu_torch.models.layers import _resize_bilinear, bn_apply, conv_nhwc, fold_conv_bn
from robosat_tpu_torch.models.resnet import bn_init, he_normal
from robosat_tpu_torch.ops import head as heads
from robosat_tpu_torch.ops import int8_mm

# Input sides must survive /4 (patch embed) then three /2 stages (and the
# host-blocked int8 path's 4x4 space-to-depth).
SIDE_MULTIPLE = 32

EMBED_DIMS = (32, 64, 160, 256)
DEPTHS = (2, 2, 2, 2)
NUM_HEADS = (1, 2, 5, 8)
SR_RATIOS = (8, 4, 2, 1)
MLP_RATIO = 4
DECODER_DIM = 256
LN_EPS = 1e-6
# The dense layers of a block, in walk order (the SR conv runs between q and kv).
BLOCK_DENSE = ("q", "kv", "proj", "fc1", "fc2")


def _dense_init(gen, cin, cout):
    scale = float(np.sqrt(2.0 / (cin + cout)))
    return {"w": torch.randn((cin, cout), generator=gen) * scale, "b": torch.zeros(cout)}


def _ln_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _block_init(gen, dim, sr_ratio):
    hidden = MLP_RATIO * dim
    p = {"ln1": _ln_init(dim), "q": _dense_init(gen, dim, dim), "kv": _dense_init(gen, dim, 2 * dim),
         "proj": _dense_init(gen, dim, dim), "ln2": _ln_init(dim), "fc1": _dense_init(gen, dim, hidden),
         "dw": {"w": he_normal(gen, (3, 3, 1, hidden)), "b": torch.zeros(hidden)},
         "fc2": _dense_init(gen, hidden, dim)}
    if sr_ratio > 1:
        p["sr"] = {"w": he_normal(gen, (sr_ratio, sr_ratio, dim, dim)), "b": torch.zeros(dim)}
        p["sr_ln"] = _ln_init(dim)
    return p


def init(seed, num_classes=2, in_channels=3):
    """SegFormer-B0 (params, state) from an int seed, drawn with a
    torch.Generator on the host in the JAX package's order."""
    gen = torch.Generator().manual_seed(int(seed))
    params = {"stages": []}
    cin = in_channels
    for si, dim in enumerate(EMBED_DIMS):
        k = 7 if si == 0 else 3
        params["stages"].append({
            "patch": {"w": he_normal(gen, (k, k, cin, dim)), "b": torch.zeros(dim)},
            "patch_ln": _ln_init(dim),
            "blocks": [_block_init(gen, dim, SR_RATIOS[si]) for _ in range(DEPTHS[si])],
            "ln": _ln_init(dim),
        })
        cin = dim
    params["proj"] = [_dense_init(gen, dim, DECODER_DIM) for dim in EMBED_DIMS]
    params["fuse"] = {"w": he_normal(gen, (1, 1, 4 * DECODER_DIM, DECODER_DIM))}
    params["fuse_bn"], fuse_bn_state = bn_init(DECODER_DIM)
    params["final"] = {"w": he_normal(gen, (1, 1, DECODER_DIM, num_classes)), "b": torch.zeros(num_classes)}
    return params, {"fuse_bn": fuse_bn_state}


def _ln(params, x):
    """LayerNorm over the channels in x's dtype, as XLA compiles the JAX
    package's: the mean and the mean of the centred square (the square
    kept in float32) each a float32 sum times the float32 reciprocal of the
    width (jnp.mean upcasts bf16), rounded to x's dtype; var + eps, its
    rsqrt, the centring, the scaling and the affine, each rounded to x's
    dtype."""
    inv_c = float(np.float32(1.0) / np.float32(x.shape[-1]))
    mean = (x.float().sum(dim=-1, keepdim=True) * inv_c).to(x.dtype)
    d = x - mean
    var = ((d.float() * d.float()).sum(dim=-1, keepdim=True) * inv_c).to(x.dtype)
    out = d * torch.rsqrt(var + LN_EPS)
    return out * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


def _dense(params, x):
    return x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)


def _conv(params, x, stride=1, padding="SAME", groups=1):
    y = conv_nhwc(x, params["w"], stride=stride, padding=padding, groups=groups)
    return y + params["b"].to(x.dtype) if "b" in params else y


def _attention(q, k, v):
    """softmax(q kᵀ / sqrt(hd)) v of (N, L, heads, hd) queries over (N, S,
    heads, hd) keys and values -> (N, L, heads, hd) in q's dtype: the
    products in q's dtype, the scaling in float32 (the JAX package's
    1 / np.sqrt(hd) promotes a bf16 product to float32), the softmax in
    float32, cast back before the product with v."""
    scale = float(np.float32(1.0 / np.sqrt(q.shape[-1])))
    logits = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1))  # (N, heads, L, S)
    attn = torch.softmax(logits.float() * scale, dim=-1).to(q.dtype)
    return torch.matmul(attn, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)


def _gelu(x):
    """Exact GELU, (0.5 x) erfc(-x sqrt(1/2)), as XLA compiles the JAX
    package's jax.nn.gelu(approximate=False): the constant rounded to x's
    dtype, the argument of erfc kept in float32, erfc rounded to x's dtype,
    0.5 x and the product in x's dtype."""
    sqrt_half = float(torch.tensor(np.sqrt(0.5), dtype=x.dtype))
    return (0.5 * x) * torch.special.erfc(-x.float() * sqrt_half).to(x.dtype)


def _block_walk(p, x, heads, sr_ratio, dense, conv):
    """One MiT block on NHWC x with pluggable `dense(node, x)` and
    `conv(node, x, stride=, groups=)` (float, calibration and int8 walks
    share it, so their sites come in one order: q, sr, kv, proj, fc1, fc2);
    pre-LN attention and Mix-FFN residuals."""
    n, h, w, c = x.shape
    hd = c // heads
    y = _ln(p["ln1"], x)
    q = dense(p["q"], y).reshape(n, h * w, heads, hd)
    if sr_ratio > 1:
        red = _ln(p["sr_ln"], conv(p["sr"], y, stride=sr_ratio))
        kv_in = red.reshape(n, -1, c)
    else:
        kv_in = y.reshape(n, h * w, c)
    kv = dense(p["kv"], kv_in).reshape(n, -1, 2, heads, hd)
    out = _attention(q, kv[:, :, 0], kv[:, :, 1]).reshape(n, h, w, c)
    x = x + dense(p["proj"], out)
    y = dense(p["fc1"], _ln(p["ln2"], x))
    y = _gelu(conv(p["dw"], y, groups=y.shape[-1]))
    return x + dense(p["fc2"], y)


def _encode(params, x):
    """The four MiT stages on fine NHWC x; returns the per-stage features."""
    feats = []
    out = x
    for si, stage in enumerate(params["stages"]):
        k, s = (7, 4) if si == 0 else (3, 2)
        out = _conv(stage["patch"], out, stride=s, padding=((k // 2, k // 2), (k // 2, k // 2)))
        out = _ln(stage["patch_ln"], out)
        for block in stage["blocks"]:
            out = _block_walk(block, out, NUM_HEADS[si], SR_RATIOS[si], _dense, _conv)
        out = _ln(stage["ln"], out)
        feats.append(out)
    return feats


def _decode(proj, feats, dense):
    """The projections of every stage to DECODER_DIM at the 1/4 grid,
    concatenated in stage order."""
    h4, w4 = feats[0].shape[1], feats[0].shape[2]
    fused = []
    for feat, node in zip(feats, proj):
        y = dense(node, feat)
        fused.append(y if y.shape[1] == h4 else _resize_bilinear(y, h4, w4))
    return torch.cat(fused, dim=-1)


def _check_side(h, w):
    assert h % 32 == 0 and w % 32 == 0, "image resolution has to be divisible by 32"


def _features(params, state, x, train):
    """The fused decoder features (post batch norm and relu) at 1/4
    resolution and the new state."""
    cat = _decode(params["proj"], _encode(params, x), _dense)
    out, bn_s = bn_apply(params["fuse_bn"], state["fuse_bn"], _conv({"w": params["fuse"]["w"]}, cat), train)
    return torch.relu(out), {"fuse_bn": bn_s}


def apply(params, state, x, train=False):
    """Training/eval forward on fine normalized x (N, H, W, 3), the fuse's
    batch norm in training or eval mode; returns (logits (N, H, W, classes)
    in x's dtype, new_state)."""
    n, h, w, _ = x.shape
    _check_side(h, w)
    out, new_state = _features(params, state, x, train)
    return _resize_bilinear(_conv(params["final"], out), h, w), new_state


def fold(params, state):
    """SegFormer has one batch norm (the decoder's fuse): the "folded" tree
    is (params, state) as they are, as in the JAX package, and the float
    predict applies the batch norm in eval mode."""
    return (params, state)


def predict_quantized_folded(folded, x, overlap=0):
    """The float predict: fine normalized x -> quantized foreground uint8
    (N, H - 2o, W - 2o) through the margin-then-resize head."""
    params, state = folded
    n, h, w, _ = x.shape
    out, _ = _features(params, state, x, train=False)
    return heads.resized_margin_head(params["final"], out, h, w, overlap)


# ---------------------------------------------------------------------------
# The hybrid int8 walk (the model-owned protocol of the JAX package).
# ---------------------------------------------------------------------------


def _patch0_s2d4_kernel(w7):
    """Stage-0 patch kernel (7, 7, Cin, C) -> its 4x4 space-to-depth form
    (2, 2, 16 Cin, C): the stride-4 pad-3 fine conv becomes a stride-1 conv
    over the blocked grid reading blocks {I - 1, I} (fine tap t = 4 (B - I)
    + er + 3, kept when 0 <= t <= 6), padded ((1, 0), (1, 0))."""
    kh, kw, cin, cout = w7.shape
    assert kh == 7 and kw == 7, "rewrite is specific to the 7x7/s4 patch embed"
    w7p = torch.nn.functional.pad(w7, (0, 0, 0, 0, 0, 1, 0, 1))  # index 7 reads zeros
    t_map = np.full((2, 2, 16), 7)
    s_map = np.full((2, 2, 16), 7)
    for bi, boff in enumerate((-1, 0)):
        for bj, coff in enumerate((-1, 0)):
            for er in range(4):
                for ec in range(4):
                    t, s = 4 * boff + er + 3, 4 * coff + ec + 3
                    if 0 <= t <= 6 and 0 <= s <= 6:
                        t_map[bi, bj, er * 4 + ec] = t
                        s_map[bi, bj, er * 4 + ec] = s
    return w7p[torch.from_numpy(t_map), torch.from_numpy(s_map)].reshape(2, 2, 16 * cin, cout)


def _patch0_apply(patch, x, blocked):
    """The float stage-0 patch embed, fine or on 4x4 host-blocked input."""
    if not blocked:
        return _conv(patch, x, stride=4, padding=((3, 3), (3, 3)))
    return conv_nhwc(x, _patch0_s2d4_kernel(patch["w"]), padding=((1, 0), (1, 0))) + patch["b"].to(x.dtype)


def _qdense(node):
    """Float dense {"w": (Cin, Cout), "b"} -> int8 {"wq", "ws", "b"},
    per-output-channel weight scales."""
    wq, ws = q8._quantize_weight(node["w"][None, None])
    return {"wq": wq[0, 0], "ws": ws, "b": node["b"].float()}


def quantize_folded_int8(folded):
    """(params, state) -> the int8 tree: the stage 1-3 patch convs, the SR
    convs and every dense layer per-output-channel int8, the fuse with its
    batch norm folded in; the stage-0 patch, the depthwise convs, the
    LayerNorms and the classifier stay float. Per-tensor activation scales
    only: as in the JAX package it takes no `act_amaxes`, so the predict
    step refuses the per-channel ("pc") calibrations with a ValueError."""
    params, state = folded
    q = {"stages": []}
    for si, stage in enumerate(params["stages"]):
        qs = {"patch": dict(stage["patch"]) if si == 0 else q8._qconv(stage["patch"]),
              "patch_ln": dict(stage["patch_ln"]), "ln": dict(stage["ln"]), "blocks": []}
        for block in stage["blocks"]:
            qb = {"ln1": dict(block["ln1"]), "ln2": dict(block["ln2"]), "dw": dict(block["dw"])}
            for name in BLOCK_DENSE:
                qb[name] = _qdense(block[name])
            if "sr" in block:
                qb["sr"] = q8._qconv(block["sr"])
                qb["sr_ln"] = dict(block["sr_ln"])
            qs["blocks"].append(qb)
        q["stages"].append(qs)
    q["proj"] = [_qdense(p) for p in params["proj"]]
    q["fuse"] = q8._qconv(fold_conv_bn({"w": params["fuse"]["w"]}, params["fuse_bn"], state["fuse_bn"]))
    q["final"] = dict(params["final"])
    return q


def sites(qtree):
    """The 54 int8 sites in walk order as (name, node, route, stride):
    route "dense" (K2 after the quantize kernel, stride = the SR conv's
    space-to-depth factor, 1 for a dense or the fuse) or "conv" (the patch
    embeds on rs_int8_conv, stride 2)."""
    out = []
    for si, stage in enumerate(qtree["stages"]):
        if si:
            out.append(("stage{}.patch".format(si), stage["patch"], "conv", 2))
        for bi, block in enumerate(stage["blocks"]):
            prefix = "stage{}.{}.".format(si, bi)
            out.append((prefix + "q", block["q"], "dense", 1))
            if "sr" in block:
                out.append((prefix + "sr", block["sr"], "dense", SR_RATIOS[si]))
            out.extend((prefix + name, block[name], "dense", 1) for name in BLOCK_DENSE[1:])
    out.extend(("proj{}".format(i), node, "dense", 1) for i, node in enumerate(qtree["proj"]))
    out.append(("fuse", qtree["fuse"], "dense", 1))
    return out


def _walk_int8(tree, x, sites_, float_mode=False, blocked=False, plain=False):
    """The walk to the pre-classifier features (post fuse conv and relu, 1/4
    resolution), consuming one scale per int8 site in the JAX package's
    order. In float mode (calibration) `tree` is the flat float tree of
    `_float_tree_for_calibration` and every site runs in float; otherwise
    the dense sites and the SR convs run `int8_mm.int8_dense` (an SR conv
    of kernel = stride = r as a dense over its r x r space-to-depth), the
    patch embeds `qconv.int8_conv` (`plain`: their plain versions)."""
    if float_mode:

        def dense(node, xx):
            sites_.next_scale(xx)
            return _dense(node, xx)

        def conv(node, xx, stride=1, padding="SAME", groups=1):
            if groups == 1:
                sites_.next_scale(xx)
            return _conv(node, xx, stride=stride, padding=padding, groups=groups)
    else:
        dense8 = int8_mm.int8_dense_plain if plain else int8_mm.int8_dense
        conv8 = qconv.int8_conv_plain if plain else qconv.int8_conv

        def dense(node, xx):
            return dense8(xx, node, sites_.next_scale(xx))

        def conv(node, xx, stride=1, padding="SAME", groups=1):
            if groups > 1:  # the depthwise Mix-FFN conv: float, no site
                return _conv(node, xx, stride=stride, padding=padding, groups=groups)
            scale = sites_.next_scale(xx)
            if node["wq"].shape[0] == stride:  # kernel = stride, no padding: a dense over the space-to-depth
                return dense8(xx, node, scale, stride)
            return conv8(xx, node, scale, stride=stride, padding=padding, epilogue="linear")

    feats = []
    out = x
    for si, stage in enumerate(tree["stages"]):
        if si == 0:
            out = _patch0_apply(stage["patch"], out, blocked)
        else:
            out = conv(stage["patch"], out, stride=2, padding=((1, 1), (1, 1)))
        out = _ln(stage["patch_ln"], out)
        for block in stage["blocks"]:
            out = _block_walk(block, out, NUM_HEADS[si], SR_RATIOS[si], dense, conv)
        out = _ln(stage["ln"], out)
        feats.append(out)
    return torch.relu(conv(tree["fuse"], _decode(tree["proj"], feats, dense)))


def _float_tree_for_calibration(folded):
    """(params, state) -> the float tree with the fuse's batch norm folded,
    shaped like quantize_folded_int8's, so both walks visit the same sites."""
    params, state = folded
    return {"stages": params["stages"], "proj": params["proj"],
            "fuse": fold_conv_bn({"w": params["fuse"]["w"]}, params["fuse_bn"], state["fuse_bn"]),
            "final": params["final"]}


def prepare_int8(qtree, scales):
    """Make every int8 site's kernel operands once, when a predict step is
    built, rather than at its first launch: the dense and SR sites' 2-D
    weights, scale products ws * s and biases (`int8_mm.dense_operands`),
    the patch embeds' packed weights (`qconv.site_operands`)."""
    for (_, node, route, stride), scale in zip(sites(qtree), list(scales)):
        if route == "dense":
            int8_mm.dense_operands(node, scale)
        else:
            qconv.site_operands(node, scale, stride)


def calibration_amaxes_int8(folded, x, blocked=False, percentile=None):
    """Per-site input amaxes (or |x| percentiles, or grid clips) from one
    float32 forward over normalized x, fine (N, H, W, 3) or with `blocked`
    4x4 space-to-depth (N, H/4, W/4, 48); a float32 vector of 54 on the
    host in site order. The per-channel specs ("pc...") raise a ValueError,
    as the JAX package's predict step does for this model."""
    if q8.is_per_channel(percentile):
        raise ValueError("{} does not support per-channel ('pc...') calibration; use a percentile".format(__name__))
    sites_ = q8._Sites(scales=None, percentile=percentile)
    with torch.no_grad():
        _walk_int8(_float_tree_for_calibration(folded), x.float(), sites_, float_mode=True, blocked=blocked)
    return torch.stack(sites_.taps).float().cpu()


def predict_quantized_int8(qtree, scales, x, overlap=0, blocked=False, plain=False):
    """The int8 predict on normalized bf16 x, 4x4 host-blocked (N, H/4,
    W/4, 48) with `blocked`, else fine (N, H, W, 3) -> fine uint8 (N,
    H - 2 overlap, W - 2 overlap). `plain` runs the kernels' plain
    versions."""
    scales = list(scales)
    h, w = (4 * x.shape[1], 4 * x.shape[2]) if blocked else (x.shape[1], x.shape[2])
    sites_ = q8._Sites(scales=scales)
    feats = _walk_int8(qtree, x, sites_, blocked=blocked, plain=plain)
    assert sites_.idx == len(scales), "int8-site count mismatch with calibration"
    return heads.resized_margin_head(qtree["final"], feats, h, w, overlap)
