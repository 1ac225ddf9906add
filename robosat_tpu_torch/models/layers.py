"""Layer helpers and weight rewrites of the U-Net walk (NHWC, HWIO).

Counterpart of robosat_tpu/models/layers.py, limited to what the int8
predict walk and its float calibration need. Activations stay NHWC and conv
kernels HWIO at every public function; the convs themselves run through
torch's NCHW operators on permuted views.
"""

import numpy as np
import torch
import torch.nn.functional as F


def _same_pads(size, k, stride, dilation):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x, w, stride=1, padding="SAME", dilation=1):
    """XLA-style conv: x (N, H, W, Cin), w (KH, KW, Cin, Cout); `padding` is
    "SAME" or ((top, bottom), (left, right)). Runs in x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    if padding == "SAME":
        padding = (_same_pads(x.shape[1], kh, stride, dilation), _same_pads(x.shape[2], kw, stride, dilation))
    (pt, pb), (pl, pr) = padding
    xc = x.permute(0, 3, 1, 2)
    wc = w.to(x.dtype).permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, wc, stride=stride, padding=(pt, pl), dilation=dilation)
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), wc, stride=stride, dilation=dilation)
    return y.permute(0, 2, 3, 1).contiguous()


def fold_conv_bn(conv_params, bn_params, bn_state, eps=1e-5):
    """Fold an inference-mode batch norm into the preceding conv:
    W' = W * scale / sqrt(var + eps), b' = bias - mean * scale / sqrt(..)."""
    inv = bn_params["scale"] * torch.rsqrt(bn_state["var"].float() + eps)
    w = conv_params["w"] * inv
    b = bn_params["bias"] - bn_state["mean"] * inv
    return {"w": w.float(), "b": b.float()}


def conv_bias_apply(params, x, stride=1, padding="SAME", dilation=1):
    return conv_nhwc(x, params["w"], stride=stride, padding=padding, dilation=dilation) + params["b"].to(x.dtype)


def max_pool(x, window, stride, padding):
    """Max pooling of NHWC `x`; `padding` is applied symmetrically."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


_K4_SETS = ((0,), (0, 1), (1, 2), (2,))


def fused_k4(w3):
    """The 4x4 parity-combined kernel of nearest-2x upsample + 3x3 conv:
    rows and columns [W0, W0+W1, W1+W2, W2] (summed in the JAX package's
    order, so the float32 sums are bit-equal)."""
    return torch.stack(
        [torch.stack([sum(w3[r, c] for r in rows for c in cols) for cols in _K4_SETS]) for rows in _K4_SETS]
    )


def fused_upsample_conv3x3(params, x):
    """Nearest-2x upsample + 3x3 SAME conv as one transposed conv with the
    4x4 parity-combined kernel (the lhs-dilated conv of the JAX package,
    whose flipped kernel this is)."""
    k4 = fused_k4(params["w"]).to(x.dtype)
    wt = k4.flip(0, 1).permute(2, 3, 0, 1)  # (Cin, Cout, 4, 4)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


# Row/col tap maps of upsample + conv3x3 on the space-to-depth grid: for
# output parity d and coarse offset a, the fine conv taps landing there.
_UPS_TAPS = {
    0: {-1: (0,), 0: (1, 2), 1: ()},
    1: {-1: (), 0: (0, 1), 1: (2,)},
}


def s2d_up_conv3x3_kernel(w3):
    """(3, 3, Cin, Cout) -> (3, 3, Cin, 4 Cout): nearest-2x upsample + 3x3
    SAME conv emitting parity-blocked space-to-depth output."""
    kh, kw, cin, cout = w3.shape
    assert kh == 3 and kw == 3
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
    kh, kw, cin, cout = w3.shape
    assert kh == 3 and kw == 3
    k = torch.zeros((3, 3, 4 * cin, 4 * cout), dtype=w3.dtype, device=w3.device)
    for di in (0, 1):
        for dj in (0, 1):
            for t in range(3):
                for s in range(3):
                    a, ei = (di + t - 1) // 2, (di + t - 1) % 2
                    b, ej = (dj + s - 1) // 2, (dj + s - 1) % 2
                    k[a + 1, b + 1, (2 * ei + ej) * cin : (2 * ei + ej + 1) * cin,
                      (2 * di + dj) * cout : (2 * di + dj + 1) * cout] = w3[t, s]
    return k


def space_to_depth4(x):
    """(N, 4H, 4W, C) -> (N, H, W, 16C), slot (er, ec) channel-minor:
    channel (er * 4 + ec) * C + c. Works on numpy arrays and tensors."""
    n, h4, w4, c = x.shape
    x = x.reshape(n, h4 // 4, 4, w4 // 4, 4, c)
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4, 5)).reshape(n, h4 // 4, w4 // 4, 16 * c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h4 // 4, w4 // 4, 16 * c)


def stem_s2d4_kernel(w7):
    """7x7/stride-2 stem kernel (7, 7, Cin, Cout) -> its 4x4 space-to-depth
    form (3, 3, 16 Cin, 4 Cout): a 3x3 SAME conv on the blocked grid that
    emits the four stride-2 output parities p = 2 fi + fj."""
    kh, kw, cin, cout = w7.shape
    assert kh == 7 and kw == 7, "rewrite is specific to the 7x7 stem"
    w7p = F.pad(w7, (0, 0, 0, 0, 0, 1, 0, 1))  # taps padded to 8x8: index 7 reads zeros
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
    """3x3/stride-2/pad-1 max pool of a fine grid held as 2x2 parity blocks
    (N, H, W, 4 cout) -> pooled (N, H, W, cout)."""
    p = [x[..., k * cout : (k + 1) * cout] for k in range(4)]

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


def space_to_depth2(x):
    """(N, 2H, 2W, C) -> (N, H, W, 4C), parity-blocked (p = 2 di + dj)."""
    n, h2, w2, c = x.shape
    return x.reshape(n, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h2 // 2, w2 // 2, 4 * c)


def depth_to_space2(x):
    """(N, H, W, 4C) -> (N, 2H, 2W, C), inverse of space_to_depth2. Works on
    numpy arrays and tensors."""
    n, h, w, c4 = x.shape
    x = x.reshape(n, h, w, 2, 2, c4 // 4)
    x = x.transpose(0, 1, 3, 2, 4, 5) if isinstance(x, np.ndarray) else x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c4 // 4)
