"""The hybrid int8 arithmetic of the predict path, frozen for the reference.

Symmetric per-output-channel weights and per-tensor static activation
scales from a one-batch float32 amax calibration; each site quantizes its
bf16 input with the host-f32 reciprocal of its scale, accumulates exactly
(a float64 conv over the integer values: every partial sum is an integer
below 2**53), and dequantizes as acc * (ws * s) + b in float32 before the
cast to bf16. `Quant(levels)` holds the grid: 127 is the program's int8;
7 is int4, the precision below it, which the control runs.

The heads digitize sigmoid(margin) into 256 bins exactly (the anchors
k / 255 by IEEE division) and wrap p == 1.0 to bin 0, as the output
contract of the system says. Nothing here imports the program.
"""

import numpy as np
import torch

from portbench.reference.layers import conv_nhwc, resize_bilinear


class Quant:
    """The symmetric grid of `levels` steps either side of zero."""

    def __init__(self, levels=127):
        self.levels = levels
        self.recip = float(np.float32(1.0) / np.float32(levels))

    def weight(self, w):
        """HWIO float kernel -> {"wq": integer kernel (int8), "ws": float32
        per-output-channel scale}."""
        w = w.float()
        scale = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12) * self.recip
        wq = torch.clamp(torch.round(w / scale), -self.levels, self.levels).to(torch.int8)
        return {"wq": wq, "ws": scale}

    def node(self, node):
        q = self.weight(node["w"])
        if "b" in node:
            q["b"] = node["b"].float()
        return q

    def scales(self, amaxes):
        """Per-site activation scales from the calibration's amaxes."""
        return [float(s) for s in np.maximum(np.asarray(amaxes, np.float64), 1e-12) / float(self.levels)]

    def act(self, x, scale):
        inv = float(np.float32(1.0) / np.float32(scale))
        return torch.clamp(torch.round(x.float() * inv), -self.levels, self.levels).to(torch.int8)


def int8_acc(xq, wq, stride=1, padding="SAME", dilation=1):
    """Exact int32 accumulator of integer NHWC `xq` with HWIO `wq`."""
    return conv_nhwc(xq.double(), wq.double(), stride=stride, padding=padding, dilation=dilation).to(torch.int32)


def scaled_ws(node, scale):
    return node["ws"] * float(np.float32(scale))


def int8_conv(quant, node, x, scale, stride=1, padding="SAME", dilation=1):
    """Quantize x with the static `scale`, accumulate exactly, dequantize
    (+ bias) in float32, cast to bf16."""
    acc = int8_acc(quant.act(x, scale), node["wq"], stride=stride, padding=padding, dilation=dilation)
    y = acc.float() * scaled_ws(node, scale)
    if "b" in node:
        y = y + node["b"]
    return y.to(torch.bfloat16)


def bottleneck(quant, x, qb, scales, stride=1, dilation=1):
    """One int8 bottleneck block; `scales` (s1, s2, s3[, sd])."""
    s1, s2, s3 = scales[:3]
    d = dilation
    inner = torch.relu(int8_conv(quant, qb["conv1"], x, s1))
    inner = torch.relu(int8_conv(quant, qb["conv2"], inner, s2, stride=stride, padding=((d, d), (d, d)), dilation=d))
    inner = int8_conv(quant, qb["conv3"], inner, s3)
    shortcut = int8_conv(quant, qb["down_conv"], x, scales[3], stride=stride) if "down_conv" in qb else x
    return torch.relu(inner.float() + shortcut.float()).to(x.dtype)


# Output parity -> (coarse offsets, rows of the 4x4 kernel).
_PARITY_TAPS = {0: ((-1, 0), (0, 2)), 1: ((0, 1), (1, 3))}


def up_block(quant, x, node, scale):
    """Nearest-2x upsample + 3x3 conv + relu as four exact 2x2-tap parity
    convs of the int8 4x4 parity-combined kernel, interleaved:
    (N, H, W, Cin) bf16 -> (N, 2H, 2W, Cout) bf16."""
    n, h, w, _ = x.shape
    cout = node["wq"].shape[-1]
    xq = quant.act(x, scale)
    e = scaled_ws(node, scale)
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    for di in (0, 1):
        for dj in (0, 1):
            rows, cols = _PARITY_TAPS[di][1], _PARITY_TAPS[dj][1]
            w2 = torch.stack([node["wq"][r, c] for r in rows for c in cols]).reshape(2, 2, -1, cout)
            acc = int8_acc(xq, w2, padding=((1 - di, di), (1 - dj, dj)))
            y = acc.float() * e
            if "b" in node:
                y = y + node["b"]
            out[:, di::2, dj::2, :] = torch.relu(y.to(x.dtype).float()).to(x.dtype)
    return out


def digitize(p):
    """np.digitize(p, linspace(0, 1, 256)) for float32 p in [0, 1]."""
    k = torch.round(p * 255.0)
    denom = torch.tensor(255.0, dtype=torch.float32, device=p.device)
    q = k.to(torch.int32) - 1
    for off in (-1.0, 0.0, 1.0):
        q = q + ((k + off) / denom <= p).to(torch.int32)
    return q


def to_u8(q):
    return (q & 0xFF).to(torch.uint8)


def _crop(x, o):
    return x[:, o:-o, o:-o] if o else x


def margin(features, final, groups, o):
    """float32 margins (N, H - 2o, W - 2o, groups) of the binary head:
    (w1 - w0) . f + (b1 - b0). One group sums in channel order; blocked
    features sum channel c into accumulator c % 4 (each step rounded once
    to float32 from float64), then (a0 + a1) + (a2 + a3)."""
    cin = features.shape[-1] // groups
    w2 = final["w"].reshape(cin, 2)
    wm, bm = (w2[:, 1] - w2[:, 0]).float(), (final["b"][1] - final["b"][0]).float()
    f = _crop(features, o).float()
    f = f.reshape(*f.shape[:3], groups, cin)
    if groups == 1:
        m = f[..., 0] * wm[0]
        for c in range(1, cin):
            m = m + f[..., c] * wm[c]
    else:
        w64 = wm.double().tolist()
        acc = [torch.zeros(f.shape[:-1], dtype=torch.float32, device=f.device) for _ in range(4)]
        for c in range(cin):
            acc[c % 4] = (acc[c % 4].double() + f[..., c].double() * w64[c]).float()
        m = (acc[0] + acc[1]) + (acc[2] + acc[3])
    return m + bm


def blocked_head(features, final, overlap):
    """Parity-blocked features (N, H, W, 4C) -> blocked bins (N, H - overlap,
    W - overlap, 4), cropped by overlap/2 on the blocked grid."""
    return to_u8(digitize(torch.sigmoid(margin(features, final, 4, overlap // 2))))


def resized_head(features, final, h, w, overlap):
    """The margin at the features' grid, bilinear to (h, w), the sigmoid,
    the digitize and the crop -> fine bins (N, h - 2o, w - 2o)."""
    m = resize_bilinear(margin(features, final, 1, 0), h, w)[..., 0]
    return _crop(to_u8(digitize(torch.sigmoid(m))), overlap)


def bin_gaps(got, want):
    """Per-pixel circular distance between two uint8 bin arrays."""
    d = (got.int() - want.int()) % 256
    return torch.minimum(d, 256 - d)
