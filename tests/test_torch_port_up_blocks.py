"""robosat_tpu_torch K5's and K8's packed weights, tile loop and store map
against the JAX package.

K5 and K8 (csrc/int8_conv_sm90.cuh's up_kernel) compute the four parity
outputs of an up-block from one 10 x 10 halo per 8 x 8-pixel coarse tile and
64-channel chunk: the 16 (parity, tap) products of a K step read windows of
the quantized halo at an offset and multiply the step's 2 x 16 weight slabs
(one set per 32-channel half), which `qdec.packed_parity_weights` packs on
the host. K5 stores the fine NHWC grid, K8 its parity planes, through one
pixel index (the kernel's tail_pixel). Here the packing is held against
`parity_tap_weights` byte by byte, and an emulation of the kernel's loop and
store over the packed operands against the JAX package's Pallas kernels in
interpret mode, bit for bit: the sums are integers and the roundings are the
stated ones, so there is no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import qdec as jqdec
from robosat_tpu_torch.models import qdec
from robosat_tpu_torch.models.int8 import _quantize_act, scaled_ws


def _tnode(node):
    return {k: torch.from_numpy(np.array(v)) for k, v in node.items()}


def _slab(packed_row):
    """One packed (64 * 32,) slab -> (64 output rows, 32 input k)."""
    return packed_row.reshape(8, 2, 8, 16).permute(0, 2, 1, 3).reshape(64, 32)


@pytest.mark.parametrize("cin,cout", [(64, 64), (96, 48), (320, 128), (80, 144)])
def test_packed_parity_weights_core_matrix_layout(cin, cout):
    """Row ((tile_n * chunks + chunk) * 2 + half) * 16 + 4 p + tap is the
    (64, 32) slab of `parity_tap_weights`' [p, tap] in wgmma's core-matrix
    order, Cin and Cout zero-padded to multiples of 64."""
    rng = np.random.default_rng(cin + cout)
    node = {"wq": torch.from_numpy(rng.integers(-127, 128, (4, 4, cin, cout)).astype(np.int8))}
    wp = qdec.parity_tap_weights(node["wq"])  # (4, 4, cin, cout)
    packed = qdec.packed_parity_weights(node)
    assert packed is qdec.packed_parity_weights(node)  # cached on the node
    chunks, tiles_n = -(-cin // 64), -(-cout // 64)
    assert tuple(packed.shape) == (tiles_n * chunks * 32, 64 * 32) and packed.dtype == torch.int8
    padded = torch.zeros((4, 4, chunks * 64, tiles_n * 64), dtype=torch.int8)
    padded[:, :, :cin, :cout] = wp
    row, k = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
    offset = torch.from_numpy(((row // 8) * 2 + k // 16) * 128 + (row % 8) * 16 + k % 16)
    for tile_n in range(tiles_n):
        for step in range(2 * chunks):  # (chunk, half): input channels [32 step, +32)
            for p in range(4):
                for tap in range(4):
                    want = padded[p, tap, 32 * step:32 * step + 32, 64 * tile_n:64 * tile_n + 64].T
                    got = packed[(tile_n * 2 * chunks + step) * 16 + 4 * p + tap]
                    assert torch.equal(got[offset], want)
                    assert torch.equal(_slab(got), want)


def _tail_pixel(img, y, x, h, w, planes):
    """The kernel's tail_pixel: index of pixel (y, x) of image img among the
    pixels of an (n, h, w, C) grid, NHWC or parity planes (plane pixel
    (y // 2, x // 2), slot 2 (y % 2) + x % 2)."""
    if planes:
        return (((img * (h >> 1) + (y >> 1)) * (w >> 1) + (x >> 1)) << 2) | ((y & 1) << 1) | (x & 1)
    return (img * h + y) * w + x


def _emulate_up_kernel(x, node, s_in, separated=False):
    """up_kernel's loop in PyTorch: per (8 x 8 coarse tile, 64-channel output
    tile) and 64-channel chunk, the 10 x 10 halo of the quantized chunk
    (origin one pixel up and left of the tile, zero outside the grid and
    past Cin), and per 32-channel half and (parity, tap) the halo window at
    pixel (di + a, dj + b) times the stage's packed slab; then the dequant
    epilogue and store_tile's store of parity (di, dj) of coarse pixel
    (oh, ow) at element m * Cout + c of the output, m the index of fine
    pixel (2 oh + di, 2 ow + dj) in the output's layout: (N, 2H, 2W, Cout)
    NHWC, or (`separated`) the parity planes (N, H, W, 4 Cout)."""
    packed = qdec.packed_parity_weights(node)
    n, h, w, cin = x.shape
    cout = node["wq"].shape[-1]
    chunks, tiles_n = -(-cin // 64), -(-cout // 64)
    tiles_y, tiles_x = -(-h // 8), -(-w // 8)
    xq = torch.zeros((n, 8 * tiles_y + 2, 8 * tiles_x + 2, 64 * chunks), dtype=torch.long)
    xq[:, 1:h + 1, 1:w + 1, :cin] = _quantize_act(x, s_in).long()
    acc = torch.zeros((4, n, 8 * tiles_y, 8 * tiles_x, 64 * tiles_n), dtype=torch.long)
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            for tile_n in range(tiles_n):
                for chunk in range(chunks):
                    halo = xq[:, 8 * ty:8 * ty + 10, 8 * tx:8 * tx + 10, 64 * chunk:64 * chunk + 64]
                    for half in range(2):
                        for p in range(4):
                            for tap in range(4):
                                r, c = (p >> 1) + (tap >> 1), (p & 1) + (tap & 1)
                                slab = _slab(packed[((tile_n * chunks + chunk) * 2 + half) * 16 + 4 * p + tap]).long()
                                acc[p, :, 8 * ty:8 * ty + 8, 8 * tx:8 * tx + 8, 64 * tile_n:64 * tile_n + 64] += (
                                    halo[:, r:r + 8, c:c + 8, 32 * half:32 * half + 32] @ slab.T)
    assert int(acc.abs().max()) < 2 ** 31
    y = acc[:, :, :h, :w, :cout].to(torch.int32).float() * scaled_ws(node, s_in)
    if "b" in node:
        y = y + node["b"]
    y = torch.relu(y.to(torch.bfloat16))
    out = torch.full((n * 4 * h * w * cout,), float("nan"), dtype=torch.bfloat16)
    img, oh, ow = torch.meshgrid(torch.arange(n), torch.arange(h), torch.arange(w), indexing="ij")
    for p in range(4):
        m = _tail_pixel(img, 2 * oh + (p >> 1), 2 * ow + (p & 1), 2 * h, 2 * w, separated)
        out[(m[..., None] * cout + torch.arange(cout)).reshape(-1)] = y[p].reshape(-1)
    assert not bool(out.isnan().any())  # every element stored
    return out.reshape((n, h, w, 4 * cout) if separated else (n, 2 * h, 2 * w, cout))


def _up_case(cin, cout, h, w, bias):
    """A quantized up-block node (JAX tree), a bf16 input and its scale."""
    rng = np.random.default_rng(7 * cin + cout + h)
    node = jq8._qkernel(jq8._fused_k4(jnp.asarray(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32))))
    if bias:
        node["b"] = jnp.asarray(rng.normal(0, 0.05, (cout,)).astype(np.float32))
    return node, jnp.asarray(rng.normal(0, 1.0, (2, h, w, cin)), jnp.bfloat16), 0.017


UP_CASES = [
    (64, 32, 8, 8, False),    # one whole tile
    (96, 48, 9, 9, True),     # ragged tiles, Cin off the 64-channel chunk
    (80, 16, 5, 7, True),     # dec3's 320 cut to 80: one partial tile, a partial second chunk
    (128, 80, 12, 10, False),  # two output tiles, the second partial
]


@pytest.mark.parametrize("cin,cout,h,w,bias", UP_CASES)
def test_up_kernel_emulation_matches_jax(cin, cout, h, w, bias):
    node, x, s = _up_case(cin, cout, h, w, bias)
    ref = np.asarray(jqdec.parity_up_conv(x, node, s, strip_rows=1, interpret=True), np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = _emulate_up_kernel(xt, _tnode(node), s)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape == (2, 2 * h, 2 * w, cout)
    assert int((got.float().numpy() != ref).sum()) == 0
    assert torch.equal(got, qdec.parity_up_conv(xt, _tnode(node), s))


@pytest.mark.parametrize("cin,cout,h,w,bias", UP_CASES)
def test_up_kernel_separated_emulation_matches_jax(cin, cout, h, w, bias):
    """K8: the same loop, stored through the planes index, against the JAX
    package's parity_up_conv_separated (4-row strips where they divide H)."""
    node, x, s = _up_case(cin, cout, h, w, bias)
    ref = np.asarray(jqdec.parity_up_conv_separated(x, node, s, strip_rows=4 if h % 4 == 0 else 1, interpret=True),
                     np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = _emulate_up_kernel(xt, _tnode(node), s, separated=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape == (2, h, w, 4 * cout)
    assert int((got.float().numpy() != ref).sum()) == 0
    assert torch.equal(got, qdec.parity_up_conv_separated(xt, _tnode(node), s))
