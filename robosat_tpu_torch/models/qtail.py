"""int8 decoder tail: CUDA kernels K6, K7 and K9 and their plain versions.

Counterpart of robosat_tpu/models/qtail.py. dec3's activations
(N, H, W, 128) bf16 on the 2x2 space-to-depth grid go through

    y4 = relu(_int8_conv(dec4, x, s4))          # s2d upsample + conv, 128 -> 128
    y5 = relu(_int8_conv(dec5, y4, s5))         # s2d conv, 128 -> 128

- `fused_tail_features` (K7) returns y5, bit for bit;
- `fused_tail_features_sep` (K9) runs the same two convs on parity planes,
  (N, Hc, Wc, 512) in and out: space_to_depth2(K7(depth_to_space2(x))),
  bit for bit;
- `fused_tail` (K6) adds the blocked head,
  fused_prediction_head_s2d_blocked(y5, w_final, b_final, overlap), to
  parity-blocked uint8 (N, H - overlap, W - overlap, 4). The head's 32-wide
  margin sum and its sigmoid may differ from XLA's in the last ulps, which
  can move a probability across a 1/255 bin edge (a counted +-1 flip).

On a CUDA tensor each launches csrc/qtail.cu; on a CPU tensor it runs its
`_plain` version.
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _act_inv, _int8_conv, scaled_ws
from robosat_tpu_torch.models.layers import depth_to_space2, space_to_depth2
from robosat_tpu_torch.ops.head import _margin_weights, fused_prediction_head_s2d_blocked


def tap_weights(wq):
    """(KH, KW, Cin, Cout) int8 kernel -> (KH * KW, Cin, Cout) in row-major
    tap order."""
    kh, kw, cin, cout = wq.shape
    return wq.reshape(kh * kw, cin, cout)


def conv_weights(node):
    """A node's int8 kernel in the CUDA conv's (Cout, taps, Cin) layout,
    cached on the node (the tree is quantized once and reused every batch)."""
    wk = node.get("wk")
    if wk is None:
        wk = node["wk"] = tap_weights(node["wq"]).permute(2, 0, 1).contiguous()
    return wk


def fused_tail_features_plain(x, node4, s4, node5, s5):
    """dec4 + dec5 as two plain int8 convs (any device)."""
    y4 = torch.relu(_int8_conv(node4, x, s4))
    return torch.relu(_int8_conv(node5, y4, s5))


def fused_tail_features_sep_plain(x, node4, s4, node5, s5):
    """dec4 + dec5 on parity planes (N, Hc, Wc, 512) (any device)."""
    return space_to_depth2(fused_tail_features_plain(depth_to_space2(x), node4, s4, node5, s5))


def fused_tail_plain(x, node4, s4, node5, s5, w_final, b_final, overlap=0):
    """The tail as two plain int8 convs and the plain head (any device)."""
    y5 = fused_tail_features_plain(x, node4, s4, node5, s5)
    return fused_prediction_head_s2d_blocked(y5, w_final, b_final, overlap=overlap)


def _conv_operands(node4, s4, node5, s5):
    """The two convs' int8 weights and dequant scales, checked for the card."""
    if node4["wq"].shape[-1] != 128 or node5["wq"].shape[-1] != 128:
        raise ValueError("the fused tail runs 128 -> 128 -> 128 channels")
    w4 = kernels.check_cuda(conv_weights(node4), "dec4.wq", torch.int8, (128, 9, 128))
    w5 = kernels.check_cuda(conv_weights(node5), "dec5.wq", torch.int8, (128, 9, 128))
    e4 = kernels.check_cuda(scaled_ws(node4, s4).contiguous(), "dec4.ws", torch.float32, (128,))
    e5 = kernels.check_cuda(scaled_ws(node5, s5).contiguous(), "dec5.ws", torch.float32, (128,))
    return w4, e4, w5, e5


def _check_input(x, channels):
    kernels.check_cuda(x, "x", torch.bfloat16)
    if x.shape[-1] != channels:
        raise ValueError("x must have {} channels (got {})".format(channels, x.shape[-1]))
    return x.shape[:3]


def fused_tail_features(x, node4, s4, node5, s5):
    """dec3 activations (N, H, W, 128) bf16 -> dec5 activations, same shape."""
    if x.device.type == "cpu":
        return fused_tail_features_plain(x, node4, s4, node5, s5)
    n, h, w = _check_input(x, 128)
    w4, e4, w5, e5 = _conv_operands(node4, s4, node5, s5)
    y4 = torch.empty_like(x)
    y5 = torch.empty_like(x)
    p = kernels.ptr
    kernels.launch("rs_fused_tail_features", p(x), p(w4), p(e4), p(w5), p(e5), _act_inv(s4), _act_inv(s5),
                   p(y4), p(y5), n, h, w)
    fused_tail_features.launches += 1
    return y5


fused_tail_features.launches = 0


def fused_tail_features_sep(x, node4, s4, node5, s5):
    """Separated dec3 (N, Hc, Wc, 512) bf16 -> separated dec5 activations,
    same shape: channel p288 * 128 + c of coarse pixel (i, j) is channel c
    of pixel (2i + p288 // 2, 2j + p288 % 2) of the 2Hc x 2Wc grid."""
    if x.device.type == "cpu":
        return fused_tail_features_sep_plain(x, node4, s4, node5, s5)
    n, hc, wc = _check_input(x, 512)
    w4, e4, w5, e5 = _conv_operands(node4, s4, node5, s5)
    y4 = torch.empty_like(x)
    y5 = torch.empty_like(x)
    p = kernels.ptr
    kernels.launch("rs_fused_tail_features_sep", p(x), p(w4), p(e4), p(w5), p(e5), _act_inv(s4), _act_inv(s5),
                   p(y4), p(y5), n, hc, wc)
    fused_tail_features_sep.launches += 1
    return y5


fused_tail_features_sep.launches = 0


def fused_tail(x, node4, s4, node5, s5, w_final, b_final, overlap=0):
    """dec3 activations (N, H, W, 128) bf16 -> quantized parity-blocked
    uint8 (N, H - overlap, W - overlap, 4)."""
    if x.device.type == "cpu":
        return fused_tail_plain(x, node4, s4, node5, s5, w_final, b_final, overlap)
    n, h, w = _check_input(x, 128)
    if overlap % 2 or overlap >= min(h, w):
        raise ValueError("overlap must be even and smaller than the blocked grid")
    w4, e4, w5, e5 = _conv_operands(node4, s4, node5, s5)
    wm, bm = _margin_weights(w_final, b_final, 32)
    wmb = kernels.check_cuda(torch.cat([wm, bm.reshape(1)]).contiguous(), "final", torch.float32, (33,))
    y4 = torch.empty_like(x)
    y5 = torch.empty_like(x)
    o = overlap // 2
    out = torch.empty((n, h - 2 * o, w - 2 * o, 4), dtype=torch.uint8, device=x.device)
    p = kernels.ptr
    kernels.launch(
        "rs_fused_tail", p(x), p(w4), p(e4), p(w5), p(e5), p(wmb), _act_inv(s4), _act_inv(s5),
        p(y4), p(y5), p(out), n, h, w, o,
    )
    fused_tail.launches += 1
    return out


fused_tail.launches = 0
