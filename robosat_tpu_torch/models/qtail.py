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
`_plain` version. The three kernels' convs (csrc/int8_conv_sm90.cuh's
tail_kernel, K9's reading and writing the parity planes) issue MMAs only
over the 32 x 32 weight blocks `nonzero_blocks` lists (every block of dense
weights; on the s2d weights of the model dec4's 4 of 9 taps and dec5's 9 of
36 blocks per output parity), packed by `block_operands`;
`sparse_tail_features_plain` is what that computes, in plain PyTorch.
s4 and s5 are per-tensor floats or, for K6 and K7, per-channel vectors
(the "pc" calibrations: dec4 quantizes its input and requantizes its
output channel by channel); K9 serves `pallas_tail = "sep"`, which the
per-channel modes refuse, and raises on a vector.
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _int8_conv, _quantize_act, check_one_kind, is_vector, kernel_inv, scaled_ws
from robosat_tpu_torch.models.layers import conv_nhwc, depth_to_space2, space_to_depth2
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


def nonzero_blocks(node):
    """For each 32-wide output slice of a node's int8 kernel, the (tap,
    32-channel input block) pairs whose weights are not all zero, cached on
    the node (the tree is quantized once). A zero block adds nothing to an
    int32 sum, so a conv over the listed blocks only is exact."""
    blocks = node.get("blocks")
    if blocks is None:
        wk = conv_weights(node)
        cout, taps, cin = wk.shape
        nz = wk.reshape(cout // 32, 32, taps, cin // 32, 32).ne(0).any(dim=4).any(dim=1).cpu()
        blocks = node["blocks"] = [[(t, kb) for t in range(taps) for kb in range(cin // 32) if nz[ns, t, kb]]
                                   for ns in range(cout // 32)]
    return blocks


def block_operands(node):
    """K6's operands for a 3x3 128 -> 128 conv, cached on the node: (the
    blocks `nonzero_blocks` lists, then one all-zero block, packed, on the
    weights' device: (nb, 1024) int8, block (tap, kb) of slice ns being
    wk[32 ns:, tap, 32 kb:][:32, :32] with byte (row, k) at
    ((row // 8) * 2 + k // 16) * 128 + (row % 8) * 16 + k % 16; and the
    host int32 table the kernel receives among its parameters: the MMAs per
    output slice (the most listed in a slice, rounded up to 9, 16 or 36,
    the counts the kernel is built for), then per slice that many entries
    tap | kb << 4 | packed block << 8, a slice's extra entries multiplying
    the zero block)."""
    ops = node.get("block_ops")
    if ops is None:
        wk, blocks = conv_weights(node), nonzero_blocks(node)
        listed = [(ns, tap, kb) for ns, pairs in enumerate(blocks) for tap, kb in pairs]
        w = torch.stack([wk[32 * ns:32 * ns + 32, tap, 32 * kb:32 * kb + 32] for ns, tap, kb in listed]
                        + [torch.zeros((32, 32), dtype=torch.int8, device=wk.device)])
        packed = w.reshape(len(w), 4, 8, 2, 16).permute(0, 1, 3, 2, 4).reshape(len(w), 1024).contiguous()
        per_slice = next(k for k in (9, 16, 36) if k >= max(map(len, blocks)))
        table, b = [per_slice], 0
        for pairs in blocks:
            table += [tap | kb << 4 | (b + i) << 8 for i, (tap, kb) in enumerate(pairs)]
            table += [len(listed) << 8] * (per_slice - len(pairs))
            b += len(pairs)
        ops = node["block_ops"] = (packed, torch.tensor(table, dtype=torch.int32))
    return ops


def _int8_conv_blocks(node, x, scale):
    """`_int8_conv` (3x3 SAME, no bias) summing only the blocks that
    `nonzero_blocks` lists: one 32 -> 32 single-tap conv per (slice, tap,
    input block)."""
    xq = _quantize_act(x, scale).double()
    wq = node["wq"].double()
    cout = wq.shape[-1]
    acc = torch.zeros(x.shape[:3] + (cout,), dtype=torch.float64)
    for ns, pairs in enumerate(nonzero_blocks(node)):
        for tap, kb in pairs:
            w = torch.zeros((3, 3, 32, 32), dtype=torch.float64)
            w[tap // 3, tap % 3] = wq[tap // 3, tap % 3, 32 * kb:32 * kb + 32, 32 * ns:32 * ns + 32]
            acc[..., 32 * ns:32 * ns + 32] += conv_nhwc(xq[..., 32 * kb:32 * kb + 32], w)
    return (acc.to(torch.int32).float() * scaled_ws(node, scale)).to(torch.bfloat16)


def sparse_tail_features_plain(x, node4, s4, node5, s5):
    """dec4 + dec5 over the listed weight blocks only, as K6's convs run on
    the card (CPU, small shapes): equals `fused_tail_features_plain`."""
    y4 = torch.relu(_int8_conv_blocks(node4, x, s4))
    return torch.relu(_int8_conv_blocks(node5, y4, s5))


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
    """The two convs' operands, checked for the card: per conv its packed
    weight blocks (device), MMA table (host) and dequant scale ws * s."""
    ops = []
    for name, node, scale in (("dec4", node4, s4), ("dec5", node5, s5)):
        if tuple(node["wq"].shape) != (3, 3, 128, 128):
            raise ValueError("the fused tail runs 3x3 128 -> 128 convs ({}.wq: {})".format(name, tuple(node["wq"].shape)))
        blocks, table = block_operands(node)
        kernels.check_cuda(blocks, name + " blocks", torch.int8)
        ops.append((blocks, table, kernels.check_cuda(scaled_ws(node, scale).contiguous(), name + ".ws", torch.float32,
                                                      (128,))))
    return ops


def _launch(entry, x, node4, s4, node5, s5, fine_hw, out, head=None, vectors=True):
    """Launch a C entry of csrc/qtail.cu: the two convs over the listed
    blocks from x into `out`, through int8 scratch y4 on the fine grid
    `fine_hw`; `head` (K6 only): its margin weights and bias, and its crop;
    `vectors`: the entry takes the per-channel reciprocal vectors (K6, K7)."""
    p = kernels.ptr
    check_one_kind((s4, s5))
    ops = _conv_operands(node4, s4, node5, s5)
    y4 = torch.empty((x.shape[0], *fine_hw, 128), dtype=torch.int8, device=x.device)
    args = [p(x)]
    for blocks, table, e in ops:
        args += [p(blocks), p(table), len(blocks), p(e)]
    wmb, crop = ([], []) if head is None else ([p(head[0])], [head[1]])
    (inv4, v4), (inv5, v5) = kernel_inv(node4, s4, x.device, 128), kernel_inv(node5, s5, x.device, 128)
    vecs = [p(v4), p(v5)] if vectors else []
    kernels.launch(entry, *args, *wmb, inv4, inv5, *vecs, p(y4), p(out), *x.shape[:3], *crop)
    return out


def _check_input(x, channels):
    kernels.check_cuda(x, "x", torch.bfloat16)
    if x.shape[-1] != channels:
        raise ValueError("x must have {} channels (got {})".format(channels, x.shape[-1]))
    return x.shape[:3]


def fused_tail_features(x, node4, s4, node5, s5):
    """dec3 activations (N, H, W, 128) bf16 -> dec5 activations, same shape."""
    if x.device.type == "cpu":
        return fused_tail_features_plain(x, node4, s4, node5, s5)
    _, h, w = _check_input(x, 128)
    y5 = _launch("rs_fused_tail_features", x, node4, s4, node5, s5, (h, w), torch.empty_like(x))
    fused_tail_features.launches += 1
    return y5


fused_tail_features.launches = 0


def fused_tail_features_sep(x, node4, s4, node5, s5):
    """Separated dec3 (N, Hc, Wc, 512) bf16 -> separated dec5 activations,
    same shape: channel p288 * 128 + c of coarse pixel (i, j) is channel c
    of pixel (2i + p288 // 2, 2j + p288 % 2) of the 2Hc x 2Wc grid."""
    if is_vector(s4) or is_vector(s5):
        raise ValueError("fused_tail_features_sep takes per-tensor scales: the per-channel ('pc...') modes refuse "
                         "pallas_tail")
    if x.device.type == "cpu":
        return fused_tail_features_sep_plain(x, node4, s4, node5, s5)
    _, hc, wc = _check_input(x, 512)
    y5 = _launch("rs_fused_tail_features_sep", x, node4, s4, node5, s5, (2 * hc, 2 * wc), torch.empty_like(x),
                 vectors=False)
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
    wm, bm = _margin_weights(w_final, b_final, 32)
    wmb = kernels.check_cuda(torch.cat([wm, bm.reshape(1)]).contiguous(), "final", torch.float32, (33,))
    o = overlap // 2
    out = torch.empty((n, h - 2 * o, w - 2 * o, 4), dtype=torch.uint8, device=x.device)
    _launch("rs_fused_tail", x, node4, s4, node5, s5, (h, w), out, head=(wmb, o))
    fused_tail.launches += 1
    return out


fused_tail.launches = 0
