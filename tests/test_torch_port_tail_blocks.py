"""robosat_tpu_torch K6's, K7's and K9's weight blocks: the host's block
lists and packed operands, and the conv they describe, against the JAX
package.

K6, K7 and K9 (csrc/int8_conv_sm90.cuh's tail_kernel) issue MMAs only over
the (tap, 32-channel input block) pairs of each 32-wide output slice whose
int8 weights are not all zero (`qtail.nonzero_blocks`), reading them packed
(`qtail.block_operands`). On the model's s2d weights that leaves dec4 4 of
9 taps and dec5 9 of 36 blocks per output parity; on dense weights it keeps
every block. The conv over the listed blocks equals the JAX package's
interpreted tail kernel bit for bit, and so does an emulation of the
kernel's two launches over the packed operands, with its addressing of
NHWC and of parity planes (K9) and its int8 y4 between them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import qtail as jqtail
from robosat_tpu.models.layers import s2d_conv3x3_kernel, s2d_up_conv3x3_kernel
from robosat_tpu.models.layers import space_to_depth2 as jspace_to_depth2
from robosat_tpu_torch.models import qtail
from robosat_tpu_torch.models.int8 import _quantize_act, scaled_ws


def _tnode(node):
    return {k: torch.from_numpy(np.array(v)) for k, v in node.items()}


def _s2d_nodes(seed):
    """dec4 and dec5 as the model quantizes them: the s2d forms of random
    fine 3x3 kernels (128 -> 32 after a nearest-2x upsample, 32 -> 32)."""
    rng = np.random.default_rng(seed)
    w4 = jnp.asarray(rng.normal(0, 0.1, (3, 3, 128, 32)).astype(np.float32))
    w5 = jnp.asarray(rng.normal(0, 0.1, (3, 3, 32, 32)).astype(np.float32))
    return jq8._qkernel(s2d_up_conv3x3_kernel(w4)), jq8._qkernel(s2d_conv3x3_kernel(w5))


def _dense_nodes(seed):
    rng = np.random.default_rng(seed)
    return tuple(jq8._qkernel(jnp.asarray(rng.normal(0, 0.1, (3, 3, 128, 128)).astype(np.float32)))
                 for _ in range(2))


def _block_macs(node, pixels):
    return pixels * sum(map(len, qtail.nonzero_blocks(node))) * 32 * 32


def test_s2d_weights_list_the_blocks_the_function_needs():
    node4, node5 = (_tnode(n) for n in _s2d_nodes(0))
    blocks4, blocks5 = qtail.nonzero_blocks(node4), qtail.nonzero_blocks(node5)
    # dec4: per output parity, the 4 coarse taps of its 2x2 footprint, each over all 4 input blocks
    assert [sorted({t for t, _ in pairs}) for pairs in blocks4] == [[0, 1, 3, 4], [1, 2, 4, 5], [3, 4, 6, 7],
                                                                    [4, 5, 7, 8]]
    assert [len(pairs) for pairs in blocks4] == [16] * 4
    # dec5: per output parity (di, dj), one (coarse tap, input parity) block per fine tap (t, s)
    expected = []
    for di, dj in ((0, 0), (0, 1), (1, 0), (1, 1)):
        pairs = set()
        for t in range(3):
            for s in range(3):
                (a, ei), (b, ej) = divmod(di + t - 1, 2), divmod(dj + s - 1, 2)
                pairs.add((3 * (a + 1) + b + 1, 2 * ei + ej))
        expected.append(sorted(pairs))
    assert blocks5 == expected and [len(pairs) for pairs in blocks5] == [9] * 4
    # at chip_smoke.py's K6 input (8, 288, 288, 128): the 68 G MACs of its bound
    coarse = 8 * 288 * 288
    macs = _block_macs(node4, coarse) + _block_macs(node5, coarse)
    assert macs == coarse * (16 * 128 * 32 + 4 * 9 * 32 * 32) == 67_947_724_800


def _unpack(packed):
    """(nb, 1024) packed blocks -> (nb, 32, 32) (output row, input k)."""
    return packed.reshape(-1, 4, 2, 8, 16).permute(0, 1, 3, 2, 4).reshape(-1, 32, 32)


def test_dense_weights_list_every_block():
    for node in (_tnode(n) for n in _dense_nodes(1)):
        assert qtail.nonzero_blocks(node) == [[(t, kb) for t in range(9) for kb in range(4)]] * 4
        packed, table = qtail.block_operands(node)
        assert table.tolist() == [36] + [t | kb << 4 | (36 * ns + 4 * t + kb) << 8
                                         for ns in range(4) for t in range(9) for kb in range(4)]
        wk = qtail.conv_weights(node)
        want = torch.stack([wk[32 * ns:32 * ns + 32, t, 32 * kb:32 * kb + 32]
                            for ns in range(4) for t in range(9) for kb in range(4)])
        assert torch.equal(_unpack(packed), torch.cat([want, torch.zeros((1, 32, 32), dtype=torch.int8)]))


def test_uneven_slices_pad_with_the_zero_block():
    """A slice with fewer nonzero blocks than another multiplies the zero
    block in their place; the kernel's MMA count per slice is 9, 16 or 36."""
    node = _tnode(_s2d_nodes(5)[1])
    tap, kb = qtail.nonzero_blocks(dict(node))[1][0]
    node["wq"][:, :, :, :32] = 0  # slice 0: no block left
    node["wq"][tap // 3, tap % 3, 32 * kb:32 * kb + 32, 32:64] = 0  # slice 1: 8 blocks
    assert [len(pairs) for pairs in qtail.nonzero_blocks(node)] == [0, 8, 9, 9]
    packed, table = qtail.block_operands(node)
    assert len(packed) == 27 and table[0] == 9 and len(table) == 1 + 4 * 9
    zero = 26 << 8
    assert table[1:10].tolist() == [zero] * 9 and table[18] == zero and zero not in table[19:].tolist()
    assert int(_unpack(packed)[26].abs().sum()) == 0


def _pixel_index(layout, n, h, w):
    """tail_kernel's tail_pixel: for each pixel (img, y, x) of the (n, h, w)
    grid, its index among the 128-channel pixels of the tensor in memory,
    NHWC or parity planes (space_to_depth2: plane pixel (y // 2, x // 2),
    slot 2 (y % 2) + x % 2)."""
    img, y, x = torch.meshgrid(torch.arange(n), torch.arange(h), torch.arange(w), indexing="ij")
    if layout == "planes":
        return (((img * (h // 2) + y // 2) * (w // 2) + x // 2) << 2) | ((y % 2) << 1) | (x % 2)
    return (img * h + y) * w + x


def _load(mem, layout, n, h, w):
    """The (n, h, w, 128) grid the halo copy reads from `mem` in `layout`."""
    return mem.reshape(-1, 128)[_pixel_index(layout, n, h, w)]


def _store(grid, layout, shape):
    """The tensor of `shape` the epilogue's store writes `grid` into."""
    n, h, w, _ = grid.shape
    mem = torch.empty((n * h * w, 128), dtype=grid.dtype)
    mem[_pixel_index(layout, n, h, w).reshape(-1)] = grid.reshape(-1, 128)
    return mem.reshape(shape)


def _emulate_tail(node4, s4, node5, s5, x, layout, fine_hw):
    """csrc/qtail.cu's K7 (`layout` "nhwc") or K9 ("planes") on bf16 `x`
    over the fine grid `fine_hw`: dec4 reads x in `layout`, quantizes with
    dec4's reciprocal scale, multiplies the listed blocks and stores relu'd
    bf16 as int8 with dec5's (the NHWC y4); dec5 reads y4 and stores relu'd
    bf16 in `layout`."""
    n, (h, w) = x.shape[0], fine_hw
    acc4 = _emulate_block_conv(node4, _quantize_act(_load(x, layout, n, h, w), s4))
    y4 = _quantize_act(torch.relu((acc4.float() * scaled_ws(node4, s4)).to(torch.bfloat16)), s5)
    acc5 = _emulate_block_conv(node5, y4)
    y5 = torch.relu((acc5.float() * scaled_ws(node5, s5)).to(torch.bfloat16))
    return _store(y5, layout, x.shape)


def _emulate_block_conv(node, xq):
    """int32 accumulators of csrc/int8_conv_sm90.cuh's tail_kernel over
    `block_operands`: per output slice, per MMA entry (tap, kb, block), the
    32 x 32 product of the tap's shifted input block with the unpacked
    weights."""
    packed, table = qtail.block_operands(node)
    per_slice, entries = int(table[0]), table[1:].tolist()
    n, h, w, _ = xq.shape
    xp = torch.nn.functional.pad(xq.long(), (0, 0, 1, 1, 1, 1))
    blocks = _unpack(packed).long()
    acc = torch.zeros((n, h, w, 128), dtype=torch.long)
    for ns in range(4):
        for e in entries[ns * per_slice:(ns + 1) * per_slice]:
            tap, kb, b = e & 15, e >> 4 & 15, e >> 8
            a = xp[:, tap // 3:tap // 3 + h, tap % 3:tap % 3 + w, 32 * kb:32 * kb + 32]
            acc[..., 32 * ns:32 * ns + 32] += a @ blocks[b].T
    return acc


@pytest.mark.parametrize("weights", ["s2d", "dense"])
def test_listed_blocks_conv_matches_jax(weights):
    """The conv over the listed blocks (`sparse_tail_features_plain`) and the
    emulated block loop equal the JAX package's interpreted tail kernel bit
    for bit."""
    jnode4, jnode5 = _s2d_nodes(2) if weights == "s2d" else _dense_nodes(3)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(0, 1.0, (1, 16, 16, 128)), jnp.bfloat16)
    s4, s5 = 0.021, 0.013
    ref = np.asarray(jqtail.fused_tail_features(x, jnode4, s4, jnode5, s5, strip_rows=8, interpret=True), np.float32)
    node4, node5 = _tnode(jnode4), _tnode(jnode5)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = qtail.sparse_tail_features_plain(xt, node4, s4, node5, s5)
    assert got.dtype == torch.bfloat16 and int((got.float().numpy() != ref).sum()) == 0

    y4 = torch.relu((_emulate_block_conv(node4, _quantize_act(xt, s4)).float() * scaled_ws(node4, s4))
                    .to(torch.bfloat16))
    y5 = torch.relu((_emulate_block_conv(node5, _quantize_act(y4, s5)).float() * scaled_ws(node5, s5))
                    .to(torch.bfloat16))
    assert int((y5.float().numpy() != ref).sum()) == 0


@pytest.mark.parametrize("weights", ["s2d", "dense"])
@pytest.mark.parametrize("layout", ["nhwc", "planes"])
def test_emulated_tail_features_match_jax(weights, layout):
    """The emulated K7 (bf16 store on the grid) equals the JAX package's
    interpreted fused_tail_features, and the emulated K9 (planes read and
    written by the kernel's addressing) its fused_tail_features_sep, bit
    for bit, on a grid whose coarse height the strips divide and whose
    width is off the 8-pixel tiles."""
    jnode4, jnode5 = _s2d_nodes(6) if weights == "s2d" else _dense_nodes(7)
    rng = np.random.default_rng(8)
    fine = jnp.asarray(rng.normal(0, 1.0, (2, 24, 20, 128)), jnp.bfloat16)
    s4, s5 = 0.021, 0.013
    if layout == "planes":
        x = jspace_to_depth2(fine)
        ref = jqtail.fused_tail_features_sep(x, jnode4, s4, jnode5, s5, strip_rows=4, interpret=True)
    else:
        x = fine
        ref = jqtail.fused_tail_features(x, jnode4, s4, jnode5, s5, strip_rows=8, interpret=True)
    ref = np.asarray(ref, np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = _emulate_tail(_tnode(jnode4), s4, _tnode(jnode5), s5, xt, layout, (24, 20))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    assert int((got.float().numpy() != ref).sum()) == 0


def test_pixel_index_of_planes_is_space_to_depth2():
    """The planes addressing puts pixel (y, x) where space_to_depth2 does."""
    from robosat_tpu_torch.models.layers import space_to_depth2

    grid = torch.arange(2 * 6 * 4 * 128).reshape(2, 6, 4, 128)
    assert torch.equal(_store(grid, "planes", (2, 3, 2, 512)), space_to_depth2(grid))
    assert torch.equal(_load(space_to_depth2(grid), "planes", 2, 6, 4), grid)
    assert torch.equal(_store(grid, "nhwc", grid.shape), grid)
