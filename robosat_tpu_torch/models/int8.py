"""Hybrid int8 inference datapath of the U-Net: bf16 stem, int8 elsewhere.

Counterpart of robosat_tpu/models/int8.py:

- weights: symmetric per-output-channel int8, quantized once at load, the
  decoder in its rewritten forms (4x4 parity-combined kernels for
  center..dec3, the s2d kernels for dec4/dec5);
- activations: symmetric int8 with static scales from a one-batch float
  calibration. Per tensor, a site's scale is its amax, a percentile of |x|,
  or the clip of a grid of amax fractions that minimizes the mean squared
  ("mse") or absolute ("mae") quantize-dequantize error, over 127. Per
  channel ("pc", "pcamax": the amax of each input channel; "pc<p>": its
  p-th percentile), `ScaleCursor` balances each channel's activation range
  against the kernel's weight range on that input channel, folds the
  resulting scale vector s into the kernel before its weights are
  quantized (W[..., c, :] * s_c), and the site quantizes x_c with 1 / s_c
  and dequantizes with the weight scale alone;
- the stem stays bf16: the fine 7x7/s2 conv and max pool, or on 4x4
  host-blocked input (`blocked`) their space-to-depth form;
- every int8 site runs through a hand-written CUDA kernel on the GPU:
  the bottleneck blocks (qenc, K3/K4), the up-blocks (qdec, K5, or K8 for
  a parity-separated dec3) and dec4 + dec5 (qtail: K6 with the head, K7
  and K9 without). On CPU tensors the kernels' plain PyTorch versions run
  instead, and `plain=True` runs those on any device.

`_int8_conv` is the plain version every kernel is held against: quantize
with the host-f32 reciprocal of the scale, an exact int32 accumulation
(a float64 conv over the int8 values: |acc| < 2**53) with the JAX
package's stride, padding, dilation and lhs dilation, then the f32
epilogue acc * (ws * s) + b as separate roundings and the cast to bf16.
The fast family (models/fastnet.py) walks its own sites on the same
quantizers (`_qconv`, `_qkernel`, `_Sites`, `fake_quant_*`).

`calibration_amaxes` and the int8 walk visit conv sites in the same order,
so the amax vector indexes sites positionally.

The walk's fake-quant mode (`fake_quant=True`, QAT training through
`unet.apply_logits_fake_quant`) is the float walk with consumed scales:
every site quantize-dequantizes its input with the static site scale
(`fake_quant_act`, a clipped straight-through estimator) and its folded or
rewritten kernel with live per-output-channel scales (`fake_quant_weight`),
so the forward sees the int8 datapath's grids and stays differentiable. It
runs in torch ops (the JAX package leaves it to XLA; no kernel).
"""

import numpy as np
import torch

from robosat_tpu_torch.models.layers import (
    conv_bias_apply,
    conv_nhwc,
    max_pool,
    s2d_conv3x3_kernel,
    s2d_up_conv3x3_kernel,
    upsample_conv_k4,
)
from robosat_tpu_torch.models.layers import fused_k4 as _fused_k4  # the 4x4 parity-combined kernel
from robosat_tpu_torch.models.resnet import RESNET50_STAGES, stem_folded, stem_folded_s2d4, walk_stages

# Candidate clip fractions of the site amax for the "mse"/"mae" grids.
_MSE_GRID = np.geomspace(0.02, 1.0, 28).astype(np.float32)

# XLA rewrites `amax / 127.0` into a multiply by the f32 reciprocal; the
# port does the same so weight scales agree bit for bit.
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize_weight(w, act_scale=None):
    """HWIO float kernel -> (int8 kernel, float32 per-output-channel scale).
    With `act_scale`, a per-input-channel vector ("pc"), the kernel is
    first multiplied by it along its input axis: W[..., c, :] * s_c."""
    w = w.float()
    if act_scale is not None:
        w = w * torch.as_tensor(act_scale, dtype=torch.float32, device=w.device)[:, None]
    scale = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12) * _RECIP_127
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale


def _qconv(node, act_scale=None):
    wq, ws = _quantize_weight(node["w"], act_scale)
    out = {"wq": wq, "ws": ws}
    if "b" in node:
        out["b"] = node["b"].float()
    return out


def _qkernel(k, act_scale=None):
    """Pre-rewritten float kernel -> {"wq", "ws"} (per-output-channel),
    `act_scale` folded along its input axis first (see _quantize_weight)."""
    wq, ws = _quantize_weight(k, act_scale)
    return {"wq": wq, "ws": ws}


class ScaleCursor:
    """Positional planner of the per-channel ("pc") scales, consumed by the
    quantizers in the walk's site order, as the JAX package's.

    Per site it balances the calibrated per-input-channel activation range
    a_c against the kernel's per-input-channel weight range w_c:
    s_c = sqrt(a_c / w_c), then scaled so that max_c(a_c / s_c) = 127, in
    the arithmetic XLA compiles the JAX package's to (the division by 127 a
    multiply by its f32 reciprocal, the square root correctly rounded).
    `out_scales` collects the vectors, on the kernel's device, which the
    walk must quantize with. Without amaxes (per-tensor modes) fold_scale
    returns None."""

    def __init__(self, act_amaxes=None):
        self.act_amaxes = None if act_amaxes is None else list(act_amaxes)
        self.idx = 0
        self.out_scales = []

    def fold_scale(self, kernel):
        if self.act_amaxes is None:
            return None
        assert self.idx < len(self.act_amaxes), (
            "act-amax count mismatch: more conv sites than the {} amax vectors".format(len(self.act_amaxes))
        )
        a = torch.clamp_min(torch.as_tensor(self.act_amaxes[self.idx], dtype=torch.float32, device=kernel.device),
                            1e-12)
        self.idx += 1
        w_amax = torch.clamp_min(kernel.float().abs().amax(dim=(0, 1, 3)), 1e-12)
        # The square root rounded once to f32, as XLA's (torch's f32 sqrt
        # on the CPU is not correctly rounded; through float64 it is).
        s = torch.sqrt((a / w_amax).double()).float()
        s = s * ((a / s).amax() * _RECIP_127)
        self.out_scales.append(s)
        return s

    def assert_done(self):
        if self.act_amaxes is not None:
            assert self.idx == len(self.act_amaxes), (
                "act-amax count mismatch: consumed {} of {}".format(self.idx, len(self.act_amaxes))
            )


def _qconv_pc(node, cursor):
    """_qconv with the cursor planning this site's per-channel fold."""
    return _qconv(node, cursor.fold_scale(node["w"]))


def _qkernel_pc(k, cursor):
    """_qkernel on a pre-rewritten kernel, the cursor planning its fold."""
    return _qkernel(k, cursor.fold_scale(k))


def quantize_encoder_stages(enc, cursor=None):
    """The four bottleneck stages quantized in walk order (conv1, conv2,
    conv3, down_conv per block), each site's per-channel fold planned by
    `cursor` ("pc"; None: per-tensor); the stem stays float."""
    cursor = ScaleCursor() if cursor is None else cursor
    qenc = {"conv1": dict(enc["conv1"])}
    for si, (blocks, _) in enumerate(RESNET50_STAGES):
        name = "layer{}".format(si + 1)
        stage = []
        for bi in range(blocks):
            fb = enc[name][bi]
            qb = {k: _qconv_pc(fb[k], cursor) for k in ("conv1", "conv2", "conv3")}
            if "down_conv" in fb:
                qb["down_conv"] = _qconv_pc(fb["down_conv"], cursor)
            stage.append(qb)
        qenc[name] = stage
    return qenc


def quantize_unet_folded(folded, act_amaxes=None):
    """BN-folded U-Net params -> hybrid tree: bottleneck stages and decoder
    int8 (the decoder in its rewritten kernel forms), stem and head float.

    With `act_amaxes` (the "pc" calibration: one per-input-channel range
    vector per site, in walk order) each site's balanced scales fold into
    its kernel (ScaleCursor) and the function returns (qtree, scale
    vectors); the decoder's vectors are over the rewritten kernels' input
    channels, the tensors the calibration walk tapped."""
    cursor = ScaleCursor(act_amaxes)
    q = {"encoder": quantize_encoder_stages(folded["encoder"], cursor)}
    for name in ("center", "dec0", "dec1", "dec2", "dec3"):
        q[name] = _qkernel_pc(_fused_k4(folded[name]["w"].float()), cursor)
    q["dec4"] = _qkernel_pc(s2d_up_conv3x3_kernel(folded["dec4"]["w"].float()), cursor)
    q["dec5"] = _qkernel_pc(s2d_conv3x3_kernel(folded["dec5"]["w"].float()), cursor)
    cursor.assert_done()
    q["final"] = dict(folded["final"])
    if act_amaxes is not None:
        return q, cursor.out_scales
    return q


def is_vector(scale):
    """True for a per-channel site scale: a 1-d host float32 vector."""
    return isinstance(scale, np.ndarray) and scale.ndim == 1


def host_scales(scale_list):
    """ScaleCursor's vectors as the walk consumes them: host float32 arrays."""
    return [np.asarray(torch.as_tensor(s).cpu(), np.float32) for s in scale_list]


def _act_inv(scale):
    """The host-f32 reciprocal every quantizer multiplies by (division is
    reciprocal-approximated differently per backend; this is not): a float,
    or for a per-channel vector a float32 vector."""
    if is_vector(scale):
        return np.float32(1.0) / np.asarray(scale, np.float32)
    return float(np.float32(1.0) / np.float32(scale))


def device_inv(node, scale, device, channels=None):
    """A per-channel site's reciprocals (`_act_inv` of its vector) as the
    CUDA kernels read them: float32 on `device`, zero-padded to a multiple
    of 128 channels (the kernels pad input channels to 64 and output
    channels to 128), cached on the site's node for the last vector given.
    `channels` checks the vector's length against the site's input."""
    scale = np.asarray(scale, np.float32)
    if channels is not None and scale.shape != (channels,):
        raise ValueError("a per-channel scale of {} channels (got shape {})".format(channels, scale.shape))
    key = scale.tobytes()
    cached = node.get("inv_v")
    if cached is None or cached[0] != key or cached[1].device != device:
        padded = np.zeros(-(-scale.size // 128) * 128, np.float32)
        padded[:scale.size] = _act_inv(scale)
        cached = node["inv_v"] = (key, torch.from_numpy(padded).to(device))
    return cached[1]


def kernel_inv(node, scale, device, channels):
    """A site's scale as a kernel takes it: (1 / s, None) per tensor, or
    (0.0, the reciprocal vector on the card, `device_inv`) per channel."""
    if is_vector(scale):
        return 0.0, device_inv(node, scale, device, channels)
    return _act_inv(scale), None


def check_one_kind(scales):
    """Raise a ValueError for a mix of per-tensor and per-channel scales
    (None skipped), which no kernel launch takes."""
    if len({is_vector(s) for s in scales if s is not None}) > 1:
        raise ValueError("the scales of one launch are all per-tensor or all per-channel vectors")


def _quantize_act(x, scale):
    inv = _act_inv(scale)
    if isinstance(inv, np.ndarray):
        inv = torch.from_numpy(inv).to(x.device)
    return torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)


def scaled_ws(node, scale):
    """The dequant scale ws * f32(s), rounded once in f32; a per-channel
    vector is folded into the weights, so it dequantizes by ws alone."""
    if is_vector(scale):
        return node["ws"]
    return node["ws"] * float(np.float32(scale))


def _int8_acc(xq, wq, stride=1, padding="SAME", dilation=1, lhs_dilation=None):
    """Exact int32 conv accumulator of int8 NHWC `xq` with HWIO int8 `wq`
    (float64 conv: every partial sum is an integer below 2**53), in
    lax.conv_general_dilated's terms: `lhs_dilation` (rows, cols) puts
    that many minus one zeros between the input's pixels before the
    padding, `dilation` spaces the kernel's taps."""
    xd = xq.double()
    if lhs_dilation is not None and tuple(lhs_dilation) != (1, 1):
        (dh, dw), (n, h, w, c) = lhs_dilation, xq.shape
        xd = xd.new_zeros((n, (h - 1) * dh + 1, (w - 1) * dw + 1, c))
        xd[:, ::dh, ::dw] = xq.double()
    return conv_nhwc(xd, wq.double(), stride=stride, padding=padding, dilation=dilation).to(torch.int32)


def _int8_conv(node, x, scale, stride=1, padding="SAME", lhs_dilation=None, dilation=1,
               compute_dtype=torch.bfloat16):
    """Quantize x with the static `scale`, int8 conv, dequant (+ bias), cast."""
    acc = _int8_acc(_quantize_act(x, scale), node["wq"], stride=stride, padding=padding, dilation=dilation,
                    lhs_dilation=lhs_dilation)
    y = acc.float() * scaled_ws(node, scale)
    if "b" in node:
        y = y + node["b"]
    return y.to(compute_dtype)


def is_per_channel(spec):
    """True for the per-channel calibration specs ("pc", "pc99.8", ...)."""
    return isinstance(spec, str) and spec.startswith("pc")


def calibration_spec(calib):
    """A config's `int8_calibration` as the walk's percentile spec: None
    for "amax", "mse"/"mae" as they are, a float percentile, or a "pc..."
    spec, whose percentile is checked here."""
    if calib in ("amax", None):
        return None
    if calib in ("mse", "mae"):
        return calib
    if is_per_channel(calib):
        if calib[2:] not in ("", "amax"):
            float(calib[2:])  # fail at config read, not in the step build
        return calib
    return float(calib)


class _FakeQuantAct(torch.autograd.Function):
    """clip(round(x * inv), -127, 127) * scale in x's dtype; the gradient
    passes where |x * inv| <= 127 and is zero outside (the clipped STE)."""

    @staticmethod
    def forward(ctx, x, scale):
        inv = float(np.float32(1.0) / np.float32(scale))
        r = x * torch.tensor(inv, dtype=x.dtype)  # in bf16 the reciprocal is rounded to bf16 too
        ctx.save_for_backward(r.abs() <= 127.0)
        # + 0 as the JAX package's q + (x - x) * gate: -0.0 bins come out +0.0.
        return torch.round(r).clamp_(-127, 127).mul_(torch.tensor(float(np.float32(scale)), dtype=x.dtype)).add_(0.0)

    @staticmethod
    def backward(ctx, grad):
        (gate,) = ctx.saved_tensors
        return torch.where(gate, grad, 0.0), None


def fake_quant_act(x, scale):
    """Clipped straight-through quantize-dequantize of an activation with
    the static per-tensor `scale` (QAT): the forward puts every value in the
    int8 bin the datapath gives it, with the host-f32 reciprocal and the
    scale cast to x's dtype (round half to even); the backward passes the
    gradient only inside the representable range, so the finetuned float
    forward stays consistent with its own int8 path."""
    return _FakeQuantAct.apply(x, scale)


def fake_quant_weight(w):
    """Straight-through quantize-dequantize of a kernel with live
    per-output-channel scales (`_quantize_weight`'s grid, recomputed from
    the current weights): w + (q - w) with the difference detached, so the
    gradient reaches w unchanged."""
    with torch.no_grad():
        scale = torch.clamp_min(w.abs().amax(dim=tuple(range(w.dim() - 1))), 1e-12) * _RECIP_127
        q = torch.clamp(torch.round(w / scale), -127, 127) * scale
    return w + (q - w).detach()


class _Sites:
    """Positional conv-site cursor shared by calibration and inference."""

    def __init__(self, scales=None, percentile=None):
        self.scales = scales
        self.percentile = percentile
        self.taps = []
        self.idx = 0

    def next_scale(self, x):
        if self.scales is None:
            a = x.detach().float().abs()
            if is_per_channel(self.percentile):
                # Per input channel, over batch and space: its amax
                # ("pc", "pcamax") or its percentile ("pc<p>").
                spec, a = self.percentile[2:], a.reshape(-1, a.shape[-1])
                self.taps.append(a.amax(dim=0) if spec in ("", "amax") else _percentile(a, float(spec)))
            elif self.percentile is None:
                self.taps.append(a.amax())
            elif self.percentile in ("mse", "mae"):
                self.taps.append(_grid_clip(a, self.percentile == "mse"))
            else:
                self.taps.append(_percentile(a.reshape(-1), self.percentile))
            return 1.0  # calibration runs in float; the scale is unused
        s = self.scales[self.idx]
        self.idx += 1
        return s if is_vector(s) else float(s)


def _grid_clip(a, squared):
    """The clip of |x| `a` (float32) among the `_MSE_GRID` fractions of its
    amax that minimizes the mean squared (`squared`) or absolute error of
    the symmetric int8 quantize-dequantize, in float32 on a's device, in
    the arithmetic XLA compiles the JAX package's grid to: step = clip *
    f32(1/127), q = min(round(a / step), 127), and the residual q * step - a
    as one fused multiply-add (rounded once from float64, where q * step is
    exact). Only the means' summation order differs."""
    amax = a.amax()
    errs = []
    for frac in _MSE_GRID:
        step = torch.clamp_min(amax * float(frac), 1e-12) * _RECIP_127
        q = torch.clamp_max(torch.round(a / step), 127.0)
        resid = (q.double() * step.double() - a.double()).float()
        errs.append((resid.square() if squared else resid.abs()).mean())
    return amax * float(_MSE_GRID[int(torch.argmin(torch.stack(errs)))])


def _percentile(flat, percentile):
    """jnp.percentile's linear interpolation along dim 0 (of all values of a
    1-d `flat`, of each column of a 2-d one), its index arithmetic in f32
    as the JAX package computes it; the order statistics come from
    kthvalue (torch.quantile refuses inputs above 2**24 elements)."""
    f32 = np.float32
    n = flat.shape[0]
    pos = (f32(percentile) / f32(100.0)) * (f32(n) - f32(1.0))
    low, high = np.floor(pos), np.ceil(pos)
    hw = f32(pos - low)
    lw = f32(f32(1.0) - hw)
    lo = flat.kthvalue(int(min(max(low, 0), n - 1)) + 1, dim=0).values
    hi = flat.kthvalue(int(min(max(high, 0), n - 1)) + 1, dim=0).values
    return lo * float(lw) + hi * float(hw)


def _walk(q, x, sites, float_mode=False, blocked=False, stop_at=None, plain=False, fake_quant=False):
    """The stem (on fine input, or with `blocked` on 4x4 space-to-depth
    input), then `_walk_from_stem`."""
    stem = stem_folded_s2d4 if blocked else stem_folded
    return _walk_from_stem(q, stem(q["encoder"]["conv1"], x), sites, float_mode, stop_at, plain, fake_quant)


def _walk_from_stem(q, out, sites, float_mode=False, stop_at=None, plain=False, fake_quant=False):
    """Bottleneck stacks and decoder from the stem output, visiting conv
    sites in a fixed order; mirrors the JAX package's `_walk`.

    In float_mode (calibration) `q` is the folded float tree and every site
    runs in float through the rewrites the int8 kernels were built from,
    to the dec5 features. With `fake_quant` (float mode with consumed
    scales: QAT) every site also quantize-dequantizes its input with the
    site scale (`fake_quant_act`) and its kernel with live per-output-channel
    scales (`fake_quant_weight`, in float32, then cast to the activations'
    dtype): the folded encoder kernels, the up-blocks' rewritten 4x4
    kernels, dec4's and dec5's s2d kernels. Otherwise every int8 site runs
    through its kernel (`plain=True`: the kernels' plain versions) and the
    walk stops at dec3 (stop_at="dec3"), leaving dec4, dec5 and the head to
    the fused tail (qtail), or before dec3 (stop_at="dec3_in"), returning
    cat(enc1, dec2) for the parity-separated dec3
    (qdec.parity_up_conv_separated).
    """
    from robosat_tpu_torch.models import qdec

    def weight(k):
        return fake_quant_weight(k.float()) if fake_quant else k

    def act(xx, scale):
        return fake_quant_act(xx, scale) if fake_quant else xx

    if float_mode:

        def conv(node, xx, stride=1, padding="SAME", dilation=1):
            scale = sites.next_scale(xx)
            node = {"w": weight(node["w"]).to(xx.dtype), "b": node["b"]} if fake_quant else node
            return conv_bias_apply(node, act(xx, scale), stride=stride, padding=padding, dilation=dilation)

        enc1, enc2, enc3, enc4 = walk_stages(q["encoder"], out, conv)
    else:
        enc1, enc2, enc3, enc4 = walk_stages_int8(q["encoder"], out, sites, plain=plain)

    up = qdec.parity_up_conv_plain if plain else qdec.parity_up_conv

    def up_block(name, xx):
        scale = sites.next_scale(xx)
        if float_mode:
            # Fake-quant the rewritten 4x4 kernel, which predict quantizes.
            return torch.relu(upsample_conv_k4(weight(_fused_k4(q[name]["w"].float())), act(xx, scale)))
        return up(xx, q[name], scale)

    center = up_block("center", max_pool(enc4, window=2, stride=2, padding=0))
    dec0 = up_block("dec0", torch.cat([enc4, center], dim=-1))
    dec1 = up_block("dec1", torch.cat([enc3, dec0], dim=-1))
    dec2 = up_block("dec2", torch.cat([enc2, dec1], dim=-1))
    cat3 = torch.cat([enc1, dec2], dim=-1)
    if stop_at == "dec3_in":
        return cat3
    dec3 = up_block("dec3", cat3)
    if not float_mode:
        if stop_at != "dec3":
            raise NotImplementedError("the int8 walk ends at dec3; dec4, dec5 and the head run in qtail")
        return dec3

    def s2d_block(name, kernel_fn, xx):
        scale = sites.next_scale(xx)
        return torch.relu(conv_nhwc(act(xx, scale), weight(kernel_fn(q[name]["w"].float())), padding="SAME"))

    dec4 = s2d_block("dec4", s2d_up_conv3x3_kernel, dec3)
    return s2d_block("dec5", s2d_conv3x3_kernel, dec4)


def walk_stages_int8(enc, out, sites, plain=False, dilate_last_stage=False):
    """The four int8 bottleneck stages, stage by stage through
    `qenc.apply_stage_blocks` (K3/K4 on the GPU, `plain`: their plain
    versions), each stage consuming its sites' scales from `sites` in walk
    order; with `dilate_last_stage` layer4 runs at stride 1 and dilation 2
    (DeepLab). Returns (enc1..enc4)."""
    from robosat_tpu_torch.models import qenc

    skips = []
    for si in range(len(RESNET50_STAGES)):
        stage = enc["layer{}".format(si + 1)]
        n_sites = sum(3 + ("down_conv" in qb) for qb in stage)
        stage_scales = [sites.next_scale(out) for _ in range(n_sites)]
        dilated = dilate_last_stage and si == len(RESNET50_STAGES) - 1
        out = qenc.apply_stage_blocks(out, stage, stage_scales, first_stride=2 if si and not dilated else 1,
                                      plain=plain, dilation=2 if dilated else 1)
        skips.append(out)
    return tuple(skips)


def calibration_amaxes(folded, x, blocked=False, percentile=None):
    """Per-conv-site input amaxes (or |activation| percentiles, or grid
    clips) from one float32 forward over the normalized batch `x` (fine, or
    4x4-blocked with `blocked`); a float32 vector on the host in conv-site
    order, or for a per-channel spec a list of one vector per site."""
    sites = _Sites(scales=None, percentile=percentile)
    with torch.no_grad():
        _walk(folded, x.float(), sites, float_mode=True, blocked=blocked)
    return site_taps(sites, percentile)


def site_taps(sites, percentile):
    """A calibration's taps on the host: stacked into one float32 vector,
    or (per-channel spec) a ragged list of float32 vectors."""
    if is_per_channel(percentile):
        return [t.float().cpu() for t in sites.taps]
    return torch.stack(sites.taps).float().cpu()


def apply_features_int8_to_dec3(qtree, scales, x, blocked=False, plain=False):
    """The int8 walk stopped at dec3: returns (dec3 activations, s4, s5),
    the last two site scales left for the fused tail."""
    scales = list(scales)
    sites = _Sites(scales=scales)
    dec3 = _walk(qtree, x, sites, blocked=blocked, stop_at="dec3", plain=plain)
    assert sites.idx == len(scales) - 2, "dec4/dec5 scales must remain for the fused tail"
    return dec3, scales[-2], scales[-1]


def apply_features_int8_to_dec3_input(qtree, scales, x, blocked=False, plain=False):
    """The int8 walk stopped before dec3: returns (cat(enc1, dec2), s3, s4,
    s5), the last three site scales left for the separated dec3 and tail."""
    scales = list(scales)
    sites = _Sites(scales=scales)
    cat3 = _walk(qtree, x, sites, blocked=blocked, stop_at="dec3_in", plain=plain)
    assert sites.idx == len(scales) - 3, "dec3/dec4/dec5 scales must remain for the separated tail"
    return cat3, scales[-3], scales[-2], scales[-1]


def scales_from_amaxes(amaxes, margin=1.0):
    """amax vector -> per-site static quantization scales (per-tensor)."""
    amaxes = np.asarray(amaxes, np.float64)
    return np.maximum(amaxes * margin, 1e-12) / 127.0
