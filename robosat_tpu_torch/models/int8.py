"""Hybrid int8 inference datapath of the U-Net: bf16 stem, int8 elsewhere.

Counterpart of robosat_tpu/models/int8.py in its per-tensor modes:

- weights: symmetric per-output-channel int8, quantized once at load, the
  decoder in its rewritten forms (4x4 parity-combined kernels for
  center..dec3, the s2d kernels for dec4/dec5);
- activations: symmetric per-tensor int8 with static scales from a
  one-batch float calibration (amax or a percentile of |x| per site);
- every int8 site runs through a hand-written CUDA kernel on the GPU:
  the bottleneck blocks (qenc, K3/K4), the up-blocks (qdec, K5) and
  dec4 + dec5 + head (qtail, K6). On CPU tensors the kernels' plain
  PyTorch versions run instead, and `plain=True` runs those on any device.

`_int8_conv` is the plain version every kernel is held against: quantize
with the host-f32 reciprocal of the scale, an exact int32 accumulation
(a float64 conv over the int8 values: |acc| < 2**53), then the f32
epilogue acc * (ws * s) + b as separate roundings and the cast to bf16.

`calibration_amaxes` and the int8 walk visit conv sites in the same order,
so the amax vector indexes sites positionally.
"""

import numpy as np
import torch

from robosat_tpu_torch.models.layers import (
    conv_bias_apply,
    conv_nhwc,
    fused_upsample_conv3x3,
    max_pool,
    s2d_conv3x3_kernel,
    s2d_up_conv3x3_kernel,
)
from robosat_tpu_torch.models.layers import fused_k4 as _fused_k4  # the 4x4 parity-combined kernel
from robosat_tpu_torch.models.resnet import RESNET50_STAGES, stem_folded_s2d4

_PER_CHANNEL = "per-channel int8 calibration ('pc' modes) is not ported yet (ROADMAP Queue 1, item 5)"
_GRID = "the 'mse'/'mae' calibration grids are not ported yet (ROADMAP Queue 1, item 5)"
_QAT = "fake quantization (QAT training) is not ported yet (ROADMAP Queue 1, item 9)"

# XLA rewrites `amax / 127.0` into a multiply by the f32 reciprocal; the
# port does the same so weight scales agree bit for bit.
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize_weight(w, act_scale=None):
    """HWIO float kernel -> (int8 kernel, float32 per-output-channel scale)."""
    if act_scale is not None:
        raise NotImplementedError(_PER_CHANNEL)
    w = w.float()
    scale = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12) * _RECIP_127
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale


def _qconv(node):
    wq, ws = _quantize_weight(node["w"])
    out = {"wq": wq, "ws": ws}
    if "b" in node:
        out["b"] = node["b"].float()
    return out


def _qkernel(k):
    """Pre-rewritten float kernel -> {"wq", "ws"} (per-output-channel)."""
    wq, ws = _quantize_weight(k)
    return {"wq": wq, "ws": ws}


def quantize_encoder_stages(enc):
    """The four bottleneck stages quantized (conv1, conv2, conv3, down_conv
    per block); the stem stays float."""
    qenc = {"conv1": dict(enc["conv1"])}
    for si, (blocks, _) in enumerate(RESNET50_STAGES):
        name = "layer{}".format(si + 1)
        stage = []
        for bi in range(blocks):
            fb = enc[name][bi]
            qb = {k: _qconv(fb[k]) for k in ("conv1", "conv2", "conv3")}
            if "down_conv" in fb:
                qb["down_conv"] = _qconv(fb["down_conv"])
            stage.append(qb)
        qenc[name] = stage
    return qenc


def quantize_unet_folded(folded, act_amaxes=None):
    """BN-folded U-Net params -> hybrid tree: bottleneck stages and decoder
    int8 (the decoder in its rewritten kernel forms), stem and head float."""
    if act_amaxes is not None:
        raise NotImplementedError(_PER_CHANNEL)
    q = {"encoder": quantize_encoder_stages(folded["encoder"])}
    for name in ("center", "dec0", "dec1", "dec2", "dec3"):
        q[name] = _qkernel(_fused_k4(folded[name]["w"].float()))
    q["dec4"] = _qkernel(s2d_up_conv3x3_kernel(folded["dec4"]["w"].float()))
    q["dec5"] = _qkernel(s2d_conv3x3_kernel(folded["dec5"]["w"].float()))
    q["final"] = dict(folded["final"])
    return q


def _act_inv(scale):
    """The host-f32 reciprocal every quantizer multiplies by (division is
    reciprocal-approximated differently per backend; this is not)."""
    if isinstance(scale, np.ndarray) and scale.ndim == 1:
        raise NotImplementedError(_PER_CHANNEL)
    return float(np.float32(1.0) / np.float32(scale))


def _quantize_act(x, scale):
    return torch.clamp(torch.round(x.float() * _act_inv(scale)), -127, 127).to(torch.int8)


def scaled_ws(node, scale):
    """The dequant scale ws * f32(s), rounded once in f32."""
    return node["ws"] * float(np.float32(scale))


def _int8_acc(xq, wq, stride=1, padding="SAME"):
    """Exact int32 conv accumulator of int8 NHWC `xq` with HWIO int8 `wq`
    (float64 conv: every partial sum is an integer below 2**53)."""
    return conv_nhwc(xq.double(), wq.double(), stride=stride, padding=padding).to(torch.int32)


def _int8_conv(node, x, scale, stride=1, padding="SAME", compute_dtype=torch.bfloat16):
    """Quantize x with the static `scale`, int8 conv, dequant (+ bias), cast."""
    acc = _int8_acc(_quantize_act(x, scale), node["wq"], stride=stride, padding=padding)
    y = acc.float() * scaled_ws(node, scale)
    if "b" in node:
        y = y + node["b"]
    return y.to(compute_dtype)


def fake_quant_act(x, scale):
    raise NotImplementedError(_QAT)


def fake_quant_weight(w):
    raise NotImplementedError(_QAT)


class _Sites:
    """Positional conv-site cursor shared by calibration and inference."""

    def __init__(self, scales=None, percentile=None):
        if percentile in ("mse", "mae"):
            raise NotImplementedError(_GRID)
        if isinstance(percentile, str):
            raise NotImplementedError(_PER_CHANNEL)
        self.scales = scales
        self.percentile = percentile
        self.taps = []
        self.idx = 0

    def next_scale(self, x):
        if self.scales is None:
            a = x.detach().float().abs()
            if self.percentile is None:
                self.taps.append(a.amax())
            else:
                self.taps.append(_percentile(a.reshape(-1), self.percentile))
            return 1.0  # calibration runs in float; the scale is unused
        s = self.scales[self.idx]
        self.idx += 1
        return float(s)


def _percentile(flat, percentile):
    """jnp.percentile's linear interpolation, its index arithmetic in f32 as
    the JAX package computes it; the order statistics come from kthvalue
    (torch.quantile refuses inputs above 2**24 elements)."""
    f32 = np.float32
    n = flat.numel()
    pos = (f32(percentile) / f32(100.0)) * (f32(n) - f32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hw = f32(pos - low)
    lw = f32(f32(1.0) - hw)
    lo = flat.kthvalue(int(min(max(low, 0), n - 1)) + 1).values
    hi = flat.kthvalue(int(min(max(high, 0), n - 1)) + 1).values
    return lo * float(lw) + hi * float(hw)


def walk_encoder(q_enc, out, conv):
    """The four float bottleneck stages with a pluggable conv (calibration);
    site order per block: conv1, conv2, conv3, down_conv. Returns enc1..4."""
    skips = []
    for si, (blocks, _) in enumerate(RESNET50_STAGES):
        name = "layer{}".format(si + 1)
        for bi in range(blocks):
            qb = q_enc[name][bi]
            stride = 2 if (bi == 0 and si > 0) else 1
            inner = torch.relu(conv(qb["conv1"], out))
            # Torch-style symmetric padding (SAME would pad (0, 1) at stride 2).
            inner = torch.relu(conv(qb["conv2"], inner, stride=stride, padding=((1, 1), (1, 1))))
            inner = conv(qb["conv3"], inner)
            shortcut = conv(qb["down_conv"], out, stride=stride) if "down_conv" in qb else out
            out = torch.relu(inner + shortcut)
        skips.append(out)
    return tuple(skips)


def _walk(q, x, sites, float_mode=False, stop_at=None, plain=False):
    """Blocked stem on 4x4 space-to-depth input, then `_walk_from_stem`."""
    return _walk_from_stem(q, stem_folded_s2d4(q["encoder"]["conv1"], x), sites, float_mode, stop_at, plain)


def _walk_from_stem(q, out, sites, float_mode=False, stop_at=None, plain=False):
    """Bottleneck stacks and decoder from the stem output, visiting conv
    sites in a fixed order; mirrors the JAX package's `_walk`.

    In float_mode (calibration) `q` is the folded float tree and every site
    runs in float through the rewrites the int8 kernels were built from,
    to the dec5 features. Otherwise every int8 site runs through its kernel
    (`plain=True`: the kernels' plain versions) and the walk stops at dec3,
    leaving dec4, dec5 and the head to the fused tail (qtail.fused_tail).
    """
    from robosat_tpu_torch.models import qdec, qenc

    if float_mode:

        def conv(node, xx, stride=1, padding="SAME"):
            sites.next_scale(xx)
            return conv_bias_apply(node, xx, stride=stride, padding=padding)

        enc1, enc2, enc3, enc4 = walk_encoder(q["encoder"], out, conv)
    else:
        skips = []
        for si, (blocks, _) in enumerate(RESNET50_STAGES):
            stage = q["encoder"]["layer{}".format(si + 1)]
            n_sites = sum(3 + ("down_conv" in qb) for qb in stage)
            stage_scales = [sites.next_scale(out) for _ in range(n_sites)]
            out = qenc.apply_stage_blocks(out, stage, stage_scales, first_stride=2 if si else 1, plain=plain)
            skips.append(out)
        enc1, enc2, enc3, enc4 = skips

    up = qdec.parity_up_conv_plain if plain else qdec.parity_up_conv

    def up_block(name, xx):
        scale = sites.next_scale(xx)
        if float_mode:
            return torch.relu(fused_upsample_conv3x3(q[name], xx))
        return up(xx, q[name], scale)

    center = up_block("center", max_pool(enc4, window=2, stride=2, padding=0))
    dec0 = up_block("dec0", torch.cat([enc4, center], dim=-1))
    dec1 = up_block("dec1", torch.cat([enc3, dec0], dim=-1))
    dec2 = up_block("dec2", torch.cat([enc2, dec1], dim=-1))
    dec3 = up_block("dec3", torch.cat([enc1, dec2], dim=-1))
    if not float_mode:
        if stop_at != "dec3":
            raise NotImplementedError("the int8 walk ends at dec3; dec4, dec5 and the head run in qtail.fused_tail")
        return dec3

    def s2d_block(name, kernel_fn, xx):
        sites.next_scale(xx)
        return torch.relu(conv_nhwc(xx, kernel_fn(q[name]["w"].float()), padding="SAME"))

    dec4 = s2d_block("dec4", s2d_up_conv3x3_kernel, dec3)
    return s2d_block("dec5", s2d_conv3x3_kernel, dec4)


def calibration_amaxes(folded, x, percentile=None):
    """Per-conv-site input amaxes (or |activation| percentiles) from one
    float32 forward over the normalized 4x4-blocked batch `x`; a float32
    vector on the host in conv-site order."""
    sites = _Sites(scales=None, percentile=percentile)
    with torch.no_grad():
        _walk(folded, x.float(), sites, float_mode=True)
    return torch.stack(sites.taps).float().cpu()


def apply_features_int8_to_dec3(qtree, scales, x, plain=False):
    """The int8 walk stopped at dec3: returns (dec3 activations, s4, s5),
    the last two site scales left for the fused tail."""
    scales = list(scales)
    sites = _Sites(scales=scales)
    dec3 = _walk(qtree, x, sites, stop_at="dec3", plain=plain)
    assert sites.idx == len(scales) - 2, "dec4/dec5 scales must remain for the fused tail"
    return dec3, scales[-2], scales[-1]


def scales_from_amaxes(amaxes, margin=1.0):
    """amax vector -> per-site static quantization scales (per-tensor)."""
    amaxes = np.asarray(amaxes, np.float64)
    return np.maximum(amaxes * margin, 1e-12) / 127.0
