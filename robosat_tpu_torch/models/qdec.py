"""int8 decoder up-blocks: CUDA kernels K5 and K8 and their plain versions.

Counterpart of robosat_tpu/models/qdec.py. A decoder block (nearest-2x
upsample + 3x3 conv + relu) runs as the transposed conv of its 4x4
parity-combined int8 kernel, split per axis into two 2-tap parities:

    out[2i]   = x[i-1] * k4[0] + x[i]   * k4[2]
    out[2i+1] = x[i]   * k4[1] + x[i+1] * k4[3]

so output parity (di, dj) is a dense 2x2-tap conv on the coarse grid. The
int32 accumulators equal the lhs-dilated conv's, and the epilogue is
relu(bf16(acc * (ws * s) + b)), bit for bit the JAX package's up_block.
`parity_up_conv` (K5) interleaves the parities into the fine output
(N, 2H, 2W, Cout); `parity_up_conv_separated` (K8) groups them by channel,
(N, H, W, 4 Cout) with parity p = 2 di + dj in channels [p Cout, (p + 1)
Cout): space_to_depth2 of K5's output. On a CUDA tensor each launches
csrc/qdec.cu: both run csrc/int8_conv_sm90.cuh's up_kernel on the weights of
`packed_parity_weights`, K5 storing the fine NHWC grid and K8 its parity
planes. On a CPU tensor each runs its `_plain` version. `s_in` is a
per-tensor float or, for K5 only, a per-channel vector (the "pc"
calibrations; the separated K8 serves `pallas_tail = "sep"`, which the
per-channel modes refuse, and raises on one).
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _int8_acc, _quantize_act, is_vector, kernel_inv, scaled_ws

# Output parity -> (coarse row offsets, k4 rows), offsets ascending.
_PARITY_TAPS = {0: ((-1, 0), (0, 2)), 1: ((0, 1), (1, 3))}


def round_to(v32, dtype):
    """Round f32 to `dtype`'s precision (RNE), keeping float32."""
    if dtype == torch.float32:
        return v32
    return v32.to(dtype).to(torch.float32)


def parity_tap_weights(wq):
    """(4, 4, Cin, Cout) K4 kernel -> (4, 4, Cin, Cout) per-parity per-tap
    weights [p = 2 di + dj, tap], taps ((a0,b0), (a0,b1), (a1,b0), (a1,b1))."""
    blocks = []
    for di in (0, 1):
        t_rows = _PARITY_TAPS[di][1]
        for dj in (0, 1):
            t_cols = _PARITY_TAPS[dj][1]
            blocks.append(torch.stack([wq[tr, tc] for tr in t_rows for tc in t_cols]))
    return torch.stack(blocks)


def _parity_outputs(x, node, s_in):
    """The four relu'd parity outputs (N, H, W, Cout), p = 2 di + dj, as
    exact int8 2x2-tap convs."""
    cout = node["wq"].shape[-1]
    xq = _quantize_act(x, s_in)
    wp = parity_tap_weights(node["wq"])
    e = scaled_ws(node, s_in)
    outs = []
    for di in (0, 1):
        for dj in (0, 1):
            w2 = wp[2 * di + dj].reshape(2, 2, -1, cout)
            # Parity 0 reads offsets (-1, 0): pad one before; parity 1 reads (0, 1): one after.
            acc = _int8_acc(xq, w2, padding=((1 - di, di), (1 - dj, dj)))
            y = acc.float() * e
            if "b" in node:
                y = y + node["b"]
            outs.append(torch.relu(round_to(y, x.dtype)).to(x.dtype))
    return outs


def parity_up_conv_plain(x, node, s_in):
    """bf16 x (N, H, W, Cin) -> relu'd bf16 (N, 2H, 2W, Cout): the four
    parity sub-convs as exact int8 convs, interleaved (any device)."""
    n, h, w, _ = x.shape
    outs = _parity_outputs(x, node, s_in)
    out = torch.empty((n, 2 * h, 2 * w, outs[0].shape[-1]), dtype=x.dtype, device=x.device)
    for p, y in enumerate(outs):
        out[:, p >> 1 :: 2, p & 1 :: 2, :] = y
    return out


def parity_up_conv_separated_plain(x, node, s_in):
    """bf16 x (N, H, W, Cin) -> relu'd bf16 (N, H, W, 4 Cout), parity p in
    channels [p Cout, (p + 1) Cout) (any device)."""
    return torch.cat(_parity_outputs(x, node, s_in), dim=-1)


UP_BN = 64  # output channels per tile of csrc/int8_conv_sm90.cuh's up_kernel


def packed_parity_weights(node):
    """The K4 kernel packed for csrc/int8_conv_sm90.cuh's up_kernel, cached
    on the node: (tiles_n * chunks * 2 * 16, 64 * 32) int8, row
    ((tile_n * chunks + chunk) * 2 + half) * 16 + 4 p + tap the slab of
    output channels [64 tile_n, +64), input channels
    [64 chunk + 32 half, +32) of `parity_tap_weights`' [p, tap], in the
    wgmma core-matrix order: byte (row, k) at
    ((row // 8) * 2 + k // 16) * 128 + (row % 8) * 16 + k % 16. Cin and
    Cout pad to multiples of 64 with zeros; the 16 slabs of one (tile_n,
    chunk, half), a weight stage of the kernel, are one contiguous 32 KB
    piece."""
    wpp = node.get("wpp")
    if wpp is None:
        w = parity_tap_weights(node["wq"])
        _, _, cin, cout = w.shape
        chunks, tiles_n = -(-cin // 64), -(-cout // UP_BN)
        padded = torch.zeros((16, chunks * 64, tiles_n * UP_BN), dtype=torch.int8, device=w.device)
        padded[:, :cin, :cout] = w.reshape(16, cin, cout)
        # (slab, chunk, half, k // 16, k % 16, tile_n, row // 8, row % 8)
        # -> (tile_n, chunk, half, slab, row // 8, k // 16, row % 8, k % 16)
        slabs = padded.reshape(16, chunks, 2, 2, 16, tiles_n, UP_BN // 8, 8).permute(5, 1, 2, 0, 6, 3, 7, 4)
        wpp = node["wpp"] = slabs.reshape(tiles_n * chunks * 32, UP_BN * 32).contiguous()
    return wpp


def _launch(x, node, s_in, separated):
    kernels.check_cuda(x, "x", torch.bfloat16)
    n, h, w, cin = x.shape
    cout = node["wq"].shape[-1]
    if cin % 16 or cout % 16:
        raise ValueError("the int8 kernels need channel counts that are multiples of 16")
    if separated:
        entry, out_shape = "rs_parity_up_conv_separated", (n, h, w, 4 * cout)
    else:
        entry, out_shape = "rs_parity_up_conv", (n, 2 * h, 2 * w, cout)
    wp = kernels.check_cuda(packed_parity_weights(node), "wq", torch.int8,
                            (-(-cout // UP_BN) * -(-cin // 64) * 32, UP_BN * 32))
    e = kernels.check_cuda(scaled_ws(node, s_in).contiguous(), "ws", torch.float32, (cout,))
    b = node.get("b")
    if b is not None:
        b = kernels.check_cuda(b, "b", torch.float32, (cout,))
    out = torch.empty(out_shape, dtype=torch.bfloat16, device=x.device)
    p = kernels.ptr
    inv, inv_v = kernel_inv(node, s_in, x.device, cin)
    vector = [] if separated else [p(inv_v)]
    kernels.launch(entry, p(x), p(wp), p(e), p(b), inv, *vector, p(out), n, h, w, cin, cout)
    return out


def parity_up_conv(x, node, s_in):
    """int8 up-block: bf16 x (N, H, W, Cin) -> relu'd (N, 2H, 2W, Cout).

    `node` is the quantized tree entry {"wq": (4, 4, Cin, Cout) int8, "ws":
    (Cout,) f32[, "b"]}; `s_in` the site's static activation scale."""
    if x.device.type == "cpu":
        return parity_up_conv_plain(x, node, s_in)
    out = _launch(x, node, s_in, separated=False)
    parity_up_conv.launches += 1
    return out


parity_up_conv.launches = 0


def parity_up_conv_separated(x, node, s_in):
    """int8 up-block with parity-separated output: bf16 x (N, H, W, Cin) ->
    relu'd (N, H, W, 4 Cout), space_to_depth2 of `parity_up_conv`'s."""
    if is_vector(s_in):
        raise ValueError("parity_up_conv_separated takes a per-tensor scale: the per-channel ('pc...') modes refuse "
                         "pallas_tail")
    if x.device.type == "cpu":
        return parity_up_conv_separated_plain(x, node, s_in)
    out = _launch(x, node, s_in, separated=True)
    parity_up_conv_separated.launches += 1
    return out


parity_up_conv_separated.launches = 0
