"""Layer arithmetic of the int8 predict path, frozen for the reference.

Plain PyTorch copies of the forms the program's int8 walk is built from:
NHWC convolutions through torch's NCHW operators, the batch-norm fold, the
4x4 parity-combined kernel of a nearest-2x upsample + 3x3 conv, the
space-to-depth kernels of the U-Net's tail and of the blocked stem, the
stride-2 pool on parity blocks, and jax.image.resize's bilinear weights.
They are copies, not imports: the program may change, the yardstick may
not. Nothing here imports the program.
"""

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """uint8 NHWC -> normalized float32, rounded once from float64 as one
    fused multiply-add would round x * (1/255) - mean, then times 1/std."""
    inv_std = torch.from_numpy(np.float32(1.0) / np.asarray(std, np.float32)).to(images.device)
    mean64 = torch.from_numpy(np.asarray(mean, np.float32)).to(images.device, torch.float64)
    centered = (images.double() * float(np.float32(1.0) / np.float32(255.0)) - mean64).float()
    return centered * inv_std


def normalize_s2d4(raw48):
    """Normalize 4x4 space-to-depth uint8 input (N, H/4, W/4, 48)."""
    return normalize(raw48, mean=IMAGENET_MEAN * 16, std=IMAGENET_STD * 16)


def same_pads(size, k, stride, dilation):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x, w, stride=1, padding="SAME", dilation=1):
    """x (N, H, W, Cin), w (KH, KW, Cin, Cout); `padding` "SAME" or
    ((top, bottom), (left, right)); runs in x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        padding = (same_pads(x.shape[1], kh, stride, dilation), same_pads(x.shape[2], kw, stride, dilation))
    (pt, pb), (pl, pr) = padding
    xc = x.permute(0, 3, 1, 2)
    wc = w.to(x.dtype).permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, wc, stride=stride, padding=(pt, pl), dilation=dilation)
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), wc, stride=stride, dilation=dilation)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_bias_apply(node, x, stride=1, padding="SAME", dilation=1):
    return conv_nhwc(x, node["w"], stride=stride, padding=padding, dilation=dilation) + node["b"].to(x.dtype)


def fold_conv_bn(conv, bn, bn_state, eps=1e-5):
    """W' = W * scale / sqrt(var + eps), b' = bias - mean * scale / sqrt(..)."""
    inv = bn["scale"] * torch.rsqrt(bn_state["var"].float() + eps)
    return {"w": (conv["w"] * inv).float(), "b": (bn["bias"] - bn_state["mean"] * inv).float()}


def max_pool(x, window, stride, padding):
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


_K4_SETS = ((0,), (0, 1), (1, 2), (2,))


def fused_k4(w3):
    """The 4x4 parity-combined kernel of nearest-2x upsample + 3x3 conv:
    rows and columns [W0, W0+W1, W1+W2, W2]."""
    return torch.stack(
        [torch.stack([sum(w3[r, c] for r in rows for c in cols) for cols in _K4_SETS]) for rows in _K4_SETS]
    )


def upsample_conv_k4(k4, x):
    """The lhs-dilated conv (dilation 2, padding 2) of x with the 4x4 kernel
    `k4`, as the transposed conv of its flipped kernel."""
    wt = k4.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=2, padding=(1, 1))
    return y.permute(0, 2, 3, 1).contiguous()


_UPS_TAPS = {
    0: {-1: (0,), 0: (1, 2), 1: ()},
    1: {-1: (), 0: (0, 1), 1: (2,)},
}


def s2d_up_conv3x3_kernel(w3):
    """(3, 3, Cin, Cout) -> (3, 3, Cin, 4 Cout): nearest-2x upsample + 3x3
    SAME conv emitting parity-blocked output."""
    _, _, cin, cout = w3.shape
    blocks = []
    for di in (0, 1):
        for dj in (0, 1):
            rows = []
            for a in (-1, 0, 1):
                cols = []
                for b in (-1, 0, 1):
                    taps = [w3[t, s] for t in _UPS_TAPS[di][a] for s in _UPS_TAPS[dj][b]]
                    cols.append(sum(taps) if taps else torch.zeros((cin, cout), dtype=w3.dtype, device=w3.device))
                rows.append(torch.stack(cols))
            blocks.append(torch.stack(rows))
    return torch.cat(blocks, dim=-1)


def s2d_conv3x3_kernel(w3):
    """(3, 3, Cin, Cout) -> (3, 3, 4 Cin, 4 Cout): a fine-grid 3x3 SAME conv
    on the space-to-depth grid, parity-blocked on both sides."""
    _, _, cin, cout = w3.shape
    k = torch.zeros((3, 3, 4 * cin, 4 * cout), dtype=w3.dtype, device=w3.device)
    for di in (0, 1):
        for dj in (0, 1):
            for t in range(3):
                for s in range(3):
                    a, ei = (di + t - 1) // 2, (di + t - 1) % 2
                    b, ej = (dj + s - 1) // 2, (dj + s - 1) % 2
                    k[a + 1, b + 1, (2 * ei + ej) * cin:(2 * ei + ej + 1) * cin,
                      (2 * di + dj) * cout:(2 * di + dj + 1) * cout] = w3[t, s]
    return k


def space_to_depth4(x):
    """(N, 4H, 4W, C) -> (N, H, W, 16C), channel (er * 4 + ec) * C + c."""
    n, h4, w4, c = x.shape
    return x.reshape(n, h4 // 4, 4, w4 // 4, 4, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h4 // 4, w4 // 4, 16 * c)


def stem_s2d4_kernel(w7):
    """7x7/stride-2 stem kernel -> its 4x4 space-to-depth form (3, 3, 16 Cin,
    4 Cout) emitting the four stride-2 output parities."""
    _, _, cin, cout = w7.shape
    w7p = F.pad(w7, (0, 0, 0, 0, 0, 1, 0, 1))
    blocks = []
    for fi in (0, 1):
        for fj in (0, 1):
            t_map = np.full((3, 3, 16), 7)
            s_map = np.full((3, 3, 16), 7)
            for ai, a in enumerate((-1, 0, 1)):
                for bi, b in enumerate((-1, 0, 1)):
                    for er in range(4):
                        for ec in range(4):
                            t = 4 * a + er + 3 - 2 * fi
                            s = 4 * b + ec + 3 - 2 * fj
                            if 0 <= t <= 6 and 0 <= s <= 6:
                                t_map[ai, bi, er * 4 + ec] = t
                                s_map[ai, bi, er * 4 + ec] = s
            blocks.append(w7p[torch.from_numpy(t_map), torch.from_numpy(s_map)].reshape(3, 3, 16 * cin, cout))
    return torch.cat(blocks, dim=-1)


def pool3s2_from_parity(x, cout):
    """3x3/stride-2/pad-1 max pool of a fine grid held as 2x2 parity blocks."""
    p = [x[..., k * cout:(k + 1) * cout] for k in range(4)]

    def up(t):
        return F.pad(t, (0, 0, 0, 0, 1, 0), value=float("-inf"))[:, :-1]

    def left(t):
        return F.pad(t, (0, 0, 1, 0), value=float("-inf"))[:, :, :-1]

    out = None
    for fi, row_shift in ((1, True), (0, False), (1, False)):
        for fj, col_shift in ((1, True), (0, False), (1, False)):
            t = p[fi * 2 + fj]
            if row_shift:
                t = up(t)
            if col_shift:
                t = left(t)
            out = t if out is None else torch.maximum(out, t)
    return out.contiguous()


def stem_folded_s2d4(conv1, x48):
    """The folded stem on 4x4 space-to-depth input, in x48's dtype."""
    w = conv1["w"]
    out = conv_nhwc(x48, stem_s2d4_kernel(w), padding="SAME")
    b4 = conv1["b"].repeat(4).to(out.dtype)
    return pool3s2_from_parity(torch.relu(out + b4), w.shape[-1])


def _resize_weights(size_in, size_out, dtype, device):
    """jax.image.resize's bilinear weight matrix (size_in, size_out)."""
    inv_scale = float(np.float32(1.0 / (size_out / size_in)))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(size_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(size_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = torch.clamp_min(1.0 - dist, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device=device, dtype=dtype)


def resize_bilinear(x, h, w):
    """NHWC x resized to (h, w) as jax.image.resize(method="bilinear"):
    rows, then columns, each a float32 contraction rounded to x's dtype."""
    _, hi, wi, _ = x.shape
    out = x
    if hi != h:
        wm = _resize_weights(hi, h, x.dtype, x.device).float()
        out = torch.einsum("nhwc,hH->nHwc", out.float(), wm).to(x.dtype)
    if wi != w:
        wm = _resize_weights(wi, w, x.dtype, x.device).float()
        out = torch.einsum("nhwc,wW->nhWc", out.float(), wm).to(x.dtype)
    return out
