"""int8 decoder tail: CUDA kernel K6 (dec4 + dec5 + head) and its plain version.

Counterpart of robosat_tpu/models/qtail.py:fused_tail. dec3's activations
(N, H, W, 128) bf16 on the 2x2 space-to-depth grid go through

    y4 = relu(_int8_conv(dec4, x, s4))          # s2d upsample + conv, 128 -> 128
    y5 = relu(_int8_conv(dec5, y4, s5))         # s2d conv, 128 -> 128
    fused_prediction_head_s2d_blocked(y5, w_final, b_final, overlap)

to parity-blocked uint8 (N, H - overlap, W - overlap, 4). The convs are bit
for bit the JAX package's; the head's 32-wide margin sum and its sigmoid
may differ from XLA's in the last ulps, which can move a probability across
a 1/255 bin edge (a counted +-1 flip). On a CUDA tensor `fused_tail`
launches csrc/qtail.cu; on a CPU tensor it runs `fused_tail_plain`.
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _act_inv, _int8_conv, scaled_ws
from robosat_tpu_torch.ops.head import fused_prediction_head_s2d_blocked


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


def fused_tail_plain(x, node4, s4, node5, s5, w_final, b_final, overlap=0):
    """The tail as two plain int8 convs and the plain head (any device)."""
    y4 = torch.relu(_int8_conv(node4, x, s4))
    y5 = torch.relu(_int8_conv(node5, y4, s5))
    return fused_prediction_head_s2d_blocked(y5, w_final, b_final, overlap=overlap)


def fused_tail(x, node4, s4, node5, s5, w_final, b_final, overlap=0):
    """dec3 activations (N, H, W, 128) bf16 -> quantized parity-blocked
    uint8 (N, H - overlap, W - overlap, 4)."""
    if x.device.type == "cpu":
        return fused_tail_plain(x, node4, s4, node5, s5, w_final, b_final, overlap)
    kernels.check_cuda(x, "x", torch.bfloat16)
    n, h, w, c = x.shape
    if c != 128 or node4["wq"].shape[-1] != 128 or node5["wq"].shape[-1] != 128:
        raise ValueError("the fused tail runs 128 -> 128 -> 128 channels")
    if overlap % 2 or overlap >= min(h, w):
        raise ValueError("overlap must be even and smaller than the blocked grid")
    w4 = kernels.check_cuda(conv_weights(node4), "dec4.wq", torch.int8, (128, 9, 128))
    w5 = kernels.check_cuda(conv_weights(node5), "dec5.wq", torch.int8, (128, 9, 128))
    e4 = kernels.check_cuda(scaled_ws(node4, s4).contiguous(), "dec4.ws", torch.float32, (128,))
    e5 = kernels.check_cuda(scaled_ws(node5, s5).contiguous(), "dec5.ws", torch.float32, (128,))
    w2 = w_final.reshape(32, 2)
    b2 = b_final.reshape(2)
    wmb = torch.cat([w2[:, 1] - w2[:, 0], (b2[1] - b2[0]).reshape(1)]).float().contiguous()
    kernels.check_cuda(wmb, "final", torch.float32, (33,))
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
