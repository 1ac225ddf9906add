"""int8 decoder up-blocks: CUDA kernel K5 and its plain version.

Counterpart of robosat_tpu/models/qdec.py. A decoder block (nearest-2x
upsample + 3x3 conv + relu) runs as the transposed conv of its 4x4
parity-combined int8 kernel, split per axis into two 2-tap parities:

    out[2i]   = x[i-1] * k4[0] + x[i]   * k4[2]
    out[2i+1] = x[i]   * k4[1] + x[i+1] * k4[3]

so output parity (di, dj) is a dense 2x2-tap conv on the coarse grid. The
int32 accumulators equal the lhs-dilated conv's, and the epilogue is
relu(bf16(acc * (ws * s) + b)), bit for bit the JAX package's up_block.
On a CUDA tensor `parity_up_conv` launches csrc/qdec.cu; on a CPU tensor
it runs `parity_up_conv_plain`.
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _act_inv, _int8_acc, _quantize_act, scaled_ws

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


def parity_up_conv_plain(x, node, s_in):
    """bf16 x (N, H, W, Cin) -> relu'd bf16 (N, 2H, 2W, Cout): the four
    parity sub-convs as exact int8 convs, interleaved (any device)."""
    n, h, w, _ = x.shape
    cout = node["wq"].shape[-1]
    xq = _quantize_act(x, s_in)
    wp = parity_tap_weights(node["wq"])
    e = scaled_ws(node, s_in)
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=x.dtype, device=x.device)
    for di in (0, 1):
        for dj in (0, 1):
            w2 = wp[2 * di + dj].reshape(2, 2, -1, cout)
            # Parity 0 reads offsets (-1, 0): pad one before; parity 1 reads (0, 1): one after.
            acc = _int8_acc(xq, w2, padding=((1 - di, di), (1 - dj, dj)))
            y = acc.float() * e
            if "b" in node:
                y = y + node["b"]
            out[:, di::2, dj::2, :] = torch.relu(round_to(y, x.dtype)).to(x.dtype)
    return out


def kernel_weights(node):
    """The K4 kernel in the CUDA kernel's (4 parities, Cout, 4 taps, Cin)
    layout, cached on the node."""
    wk = node.get("wk")
    if wk is None:
        wk = node["wk"] = parity_tap_weights(node["wq"]).permute(0, 3, 1, 2).contiguous()
    return wk


def parity_up_conv(x, node, s_in):
    """int8 up-block: bf16 x (N, H, W, Cin) -> relu'd (N, 2H, 2W, Cout).

    `node` is the quantized tree entry {"wq": (4, 4, Cin, Cout) int8, "ws":
    (Cout,) f32[, "b"]}; `s_in` the site's static activation scale."""
    if x.device.type == "cpu":
        return parity_up_conv_plain(x, node, s_in)
    kernels.check_cuda(x, "x", torch.bfloat16)
    n, h, w, cin = x.shape
    cout = node["wq"].shape[-1]
    if cin % 16 or cout % 16:
        raise ValueError("the int8 kernels need channel counts that are multiples of 16")
    wk = kernels.check_cuda(kernel_weights(node), "wq", torch.int8, (4, cout, 4, cin))
    e = kernels.check_cuda(scaled_ws(node, s_in).contiguous(), "ws", torch.float32, (cout,))
    b = node.get("b")
    if b is not None:
        b = kernels.check_cuda(b, "b", torch.float32, (cout,))
    out = torch.empty((n, 2 * h, 2 * w, cout), dtype=torch.bfloat16, device=x.device)
    p = kernels.ptr
    kernels.launch("rs_parity_up_conv", p(x), p(wk), p(e), p(b), _act_inv(s_in), p(out), n, h, w, cin, cout)
    parity_up_conv.launches += 1
    return out


parity_up_conv.launches = 0
