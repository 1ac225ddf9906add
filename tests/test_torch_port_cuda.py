"""robosat_tpu_torch CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (they build csrc/ at first use);
elsewhere they skip. They import no JAX, so the card's machine runs them
without the JAX package's test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Shapes are small and ragged on purpose (pixel counts off the 64- and
128-row tiles, channel counts off the 64-wide tiles) to reach every masked
edge of the int8 conv kernels; chip_smoke.py checks the main-path
shapes.
"""

import pytest
import torch

from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qdec, qenc, qtail
from robosat_tpu_torch.models.layers import s2d_conv3x3_kernel, s2d_up_conv3x3_kernel, space_to_depth2
from robosat_tpu_torch.ops import head, head_rungs, int8_mm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _node(gen, kh, kw, cin, cout, bias=True, std=0.1):
    node = q8._qconv({"w": torch.randn(kh, kw, cin, cout, generator=gen, device="cuda") * std})
    if bias:
        node["b"] = torch.randn(cout, generator=gen, device="cuda") * 0.05
    return node


def _act(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


@pytest.mark.parametrize("down,cin,cmid,cout,h,w", [
    (True, 32, 16, 64, 7, 9),
    (False, 96, 48, 96, 13, 5),
    # each stage's widths (the pipelined wgmma conv's tile shapes), ragged pixel counts
    (True, 64, 64, 256, 9, 11),      # layer1.0
    (False, 256, 64, 256, 91, 93),   # layer1.1, on a grid large enough for 128-row tiles
    (True, 256, 128, 512, 7, 5),
    (False, 512, 128, 512, 9, 7),    # layer2.1
    (False, 1024, 256, 1024, 6, 7),  # layer3.1
    (True, 1024, 512, 2048, 5, 3),
    (False, 2048, 512, 2048, 5, 7),  # layer4.1
])
def test_bottleneck_block_kernel_bit_equal(gen, down, cin, cmid, cout, h, w):
    std = lambda fan_in: fan_in ** -0.5  # unit-scale activations at every width
    qb = {"conv1": _node(gen, 1, 1, cin, cmid, std=std(cin)), "conv2": _node(gen, 3, 3, cmid, cmid, std=std(9 * cmid)),
          "conv3": _node(gen, 1, 1, cmid, cout, std=std(cmid))}
    if down:
        qb["down_conv"] = _node(gen, 1, 1, cin, cout, std=std(cin))
    x = _act(gen, (3, h, w, cin))
    scales = (0.02, 0.015, 0.01, 0.02 if down else None)
    before = qenc.bottleneck_block.launches
    got = qenc.bottleneck_block(x, qb, *scales)
    torch.cuda.synchronize()
    assert qenc.bottleneck_block.launches == before + 1
    assert torch.equal(got, qenc.bottleneck_block_plain(x, qb, *scales))


@pytest.mark.parametrize("cin,cmid,cout,h,w", [
    (48, 32, 80, 10, 14),
    # each stage's widths, on grids whose output pixel counts are off the 64-row tiles
    (256, 128, 512, 10, 14),   # layer2.0
    (512, 256, 1024, 6, 10),   # layer3.0
    (1024, 512, 2048, 4, 6),   # layer4.0
    (64, 16, 32, 18, 2),       # one output column: every left halo is padding
])
def test_bottleneck_block_s2_kernel_bit_equal(gen, cin, cmid, cout, h, w):
    std = lambda fan_in: fan_in ** -0.5
    qb = {"conv1": _node(gen, 1, 1, cin, cmid, std=std(cin)), "conv2": _node(gen, 3, 3, cmid, cmid, std=std(9 * cmid)),
          "conv3": _node(gen, 1, 1, cmid, cout, std=std(cmid)), "down_conv": _node(gen, 1, 1, cin, cout, std=std(cin))}
    x = _act(gen, (2, h, w, cin))
    before = qenc.bottleneck_block_s2.launches
    got = qenc.bottleneck_block_s2(x, qb, 0.021, 0.012, 0.009, 0.017)
    torch.cuda.synchronize()
    assert qenc.bottleneck_block_s2.launches == before + 1
    assert tuple(got.shape) == (2, h // 2, w // 2, cout)
    assert torch.equal(got, qenc.bottleneck_block_s2_plain(x, qb, 0.021, 0.012, 0.009, 0.017))


@pytest.mark.parametrize("cin,cout,h,w,bias", [
    (48, 32, 5, 7, False),
    (144, 80, 9, 4, True),
    # each site's channel counts on small grids: one tile (5 x 7, so three tiles in all and the last pair
    # half empty), ragged tiles (9 x 9) and whole tiles (16 x 16)
    (2048, 256, 9, 9, True),     # center
    (2304, 256, 5, 7, False),    # dec0
    (1280, 256, 16, 16, True),   # dec1
    (768, 64, 9, 9, False),      # dec2
    (320, 128, 16, 16, True),    # dec3
    (320, 128, 5, 7, False),
    (96, 80, 9, 9, True),        # Cin and Cout off the 64-wide tiles
])
def test_parity_up_conv_kernel_bit_equal(gen, cin, cout, h, w, bias):
    node = q8._qkernel(q8._fused_k4(torch.randn(3, 3, cin, cout, generator=gen, device="cuda") * 3 * (9 * cin) ** -0.5))
    if bias:
        node["b"] = torch.randn(cout, generator=gen, device="cuda") * 0.05
    x = _act(gen, (3, h, w, cin))
    before = qdec.parity_up_conv.launches
    got = qdec.parity_up_conv(x, node, 0.017)
    torch.cuda.synchronize()
    assert qdec.parity_up_conv.launches == before + 1
    assert tuple(got.shape) == (3, 2 * h, 2 * w, cout)
    assert torch.equal(got, qdec.parity_up_conv_plain(x, node, 0.017))


def _s2d_tail_nodes(gen):
    """dec4 and dec5 as the model builds them: s2d forms of random fine 3x3
    kernels, quantized, with their structural zero blocks."""
    return (q8._qkernel(s2d_up_conv3x3_kernel(torch.randn(3, 3, 128, 32, generator=gen, device="cuda") * 0.1)),
            q8._qkernel(s2d_conv3x3_kernel(torch.randn(3, 3, 32, 32, generator=gen, device="cuda") * 0.1)))


def _uneven_tail_nodes(gen):
    """The s2d nodes with dec5's output slice 0 zeroed and one block of
    slice 1: slices of 0, 8, 9 and 9 blocks, the kernel padding the short
    ones with its zero block."""
    node4, node5 = _s2d_tail_nodes(gen)
    tap, kb = qtail.nonzero_blocks(dict(node5))[1][0]
    node5["wq"][..., :32] = 0
    node5["wq"][tap // 3, tap % 3, 32 * kb:32 * kb + 32, 32:64] = 0
    return node4, node5


@pytest.mark.parametrize("weights,blocks", [("dense", (144, 144)), ("s2d", (64, 36)), ("uneven", (64, 26))])
@pytest.mark.parametrize("overlap,h,w", [(0, 16, 16), (8, 24, 20), (0, 13, 11)])
def test_fused_tail_kernel_matches_plain(gen, weights, blocks, overlap, h, w):
    """K6 over the listed nonzero weight blocks: every block of dense
    weights, 16 + 9 of 36 per output parity of the s2d ones, and slices of
    uneven counts."""
    node4, node5 = {"dense": _tail_nodes, "s2d": _s2d_tail_nodes, "uneven": _uneven_tail_nodes}[weights](gen)
    assert tuple(sum(map(len, qtail.nonzero_blocks(node))) for node in (node4, node5)) == blocks
    w_final = torch.randn(1, 1, 32, 2, generator=gen, device="cuda") * 0.3
    b_final = torch.randn(2, generator=gen, device="cuda") * 0.1
    x = _act(gen, (2, h, w, 128))
    before = qtail.fused_tail.launches
    got = qtail.fused_tail(x, node4, 0.021, node5, 0.013, w_final, b_final, overlap=overlap)
    ref = qtail.fused_tail_plain(x, node4, 0.021, node5, 0.013, w_final, b_final, overlap=overlap)
    torch.cuda.synchronize()
    assert qtail.fused_tail.launches == before + 1
    assert got.shape == ref.shape == (2, h - overlap, w - overlap, 4)
    d = (got.int() - ref.int()) % 256
    d = torch.minimum(d, 256 - d)
    assert int(d.max()) <= 1
    assert int((d != 0).sum()) <= 0.001 * d.numel()


@pytest.mark.parametrize("cin,cout,h,w,bias", [
    (48, 32, 5, 7, True),
    (144, 80, 9, 4, False),
    (320, 128, 11, 13, True),  # dec3's widths on an odd coarse grid
    (96, 80, 9, 9, False),     # Cout off the 64-channel tile, no bias
])
def test_parity_up_conv_separated_kernel_bit_equal(gen, cin, cout, h, w, bias):
    """K8 (up_kernel storing parity planes) against its plain version and
    against space_to_depth2 of K5 (the same kernel storing the fine grid)."""
    node = q8._qkernel(q8._fused_k4(torch.randn(3, 3, cin, cout, generator=gen, device="cuda") * 0.1))
    if bias:
        node["b"] = torch.randn(cout, generator=gen, device="cuda") * 0.05
    x = _act(gen, (2, h, w, cin))
    before = qdec.parity_up_conv_separated.launches
    got = qdec.parity_up_conv_separated(x, node, 0.017)
    torch.cuda.synchronize()
    assert qdec.parity_up_conv_separated.launches == before + 1
    assert tuple(got.shape) == (2, h, w, 4 * cout)
    assert torch.equal(got, qdec.parity_up_conv_separated_plain(x, node, 0.017))
    assert torch.equal(got, space_to_depth2(qdec.parity_up_conv(x, node, 0.017)))


def _tail_nodes(gen):
    return (q8._qkernel(torch.randn(3, 3, 128, 128, generator=gen, device="cuda") * 0.1),
            q8._qkernel(torch.randn(3, 3, 128, 128, generator=gen, device="cuda") * 0.1))


@pytest.mark.parametrize("weights", ["dense", "s2d", "uneven"])
@pytest.mark.parametrize("h,w,const", [(12, 20, None), (16, 16, 3.0), (13, 11, None), (10, 14, None)])
def test_fused_tail_features_kernels_bit_equal(gen, weights, h, w, const):
    """K7 on the grid and K9 on its parity planes (tail_kernel over the
    listed blocks of dense, s2d and uneven weights) against their plain
    versions, at grids off the 8-pixel tiles (K9's planes 5 x 7 at
    10 x 14; K7 alone on the odd 13 x 11); the constant input makes a wrong
    zero padding flip the borders."""
    node4, node5 = {"dense": _tail_nodes, "s2d": _s2d_tail_nodes, "uneven": _uneven_tail_nodes}[weights](gen)
    x = _act(gen, (2, h, w, 128)) if const is None else torch.full((1, h, w, 128), const, device="cuda",
                                                                   dtype=torch.bfloat16)
    before = qtail.fused_tail_features.launches, qtail.fused_tail_features_sep.launches
    got = qtail.fused_tail_features(x, node4, 0.021, node5, 0.013)
    torch.cuda.synchronize()
    assert torch.equal(got, qtail.fused_tail_features_plain(x, node4, 0.021, node5, 0.013))
    if h % 2 or w % 2:
        return
    planes = space_to_depth2(x).contiguous()
    got_sep = qtail.fused_tail_features_sep(planes, node4, 0.021, node5, 0.013)
    torch.cuda.synchronize()
    assert (qtail.fused_tail_features.launches, qtail.fused_tail_features_sep.launches) == (before[0] + 1,
                                                                                          before[1] + 1)
    assert torch.equal(got_sep, qtail.fused_tail_features_sep_plain(planes, node4, 0.021, node5, 0.013))
    assert torch.equal(got_sep, space_to_depth2(got))


@pytest.mark.parametrize("groups,h,w,overlap", [(1, 20, 18, 4), (4, 13, 9, 2), (16, 10, 12, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_margin_head_kernel_matches_plain(gen, groups, h, w, overlap, dtype):
    feats = (torch.randn(3, h, w, 32 * groups, generator=gen, device="cuda") * 1.5).to(dtype)
    w_final = torch.randn(1, 1, 32, 2, generator=gen, device="cuda") * 0.3
    b_final = torch.randn(2, generator=gen, device="cuda") * 0.1
    before = head.margin_head.launches
    got = head.margin_head(feats, w_final, b_final, overlap=overlap, groups=groups)
    ref = head.margin_head_plain(feats, w_final, b_final, overlap=overlap, groups=groups)
    torch.cuda.synchronize()
    assert head.margin_head.launches == before + 1
    assert got.shape == ref.shape and got.dtype == torch.uint8
    d = (got.int() - ref.int()) % 256
    d = torch.minimum(d, 256 - d)
    assert int(d.max()) <= 1
    assert int((d != 0).sum()) <= max(1, 0.001 * d.numel())


@pytest.mark.parametrize("m,k,n", [
    (48, 80, 1040), (130, 1280, 64), (64, 64, 16),
    # "a": fewer P tiles than blocks (4), then ~5 tiles per block; "b": 4
    # and 648 slabs of weights. The transposed pair swaps the two roles.
    (64, 64, 1024), (64, 64, 165888), (165888, 64, 64),
    # dec3par's widths (cout 128, cin 1280) at a P off the 128 tile, in
    # either orientation's place ("a": (cout, cin, P), "b": (P, cin, cout))
    (128, 1280, 5200), (5200, 1280, 128),
    # cout 256 (one slab of 256) at cin 64 and 256, P off the tile
    (256, 64, 20000), (20000, 64, 256), (256, 256, 20000), (20000, 256, 256),
])
@pytest.mark.parametrize("orientation", ["a", "b"])
def test_int8_matmul_requant_kernel_bit_equal(gen, orientation, m, k, n):
    """K2 at ragged shapes (M and N off the P tiles and weight slabs, K off
    the 64 chunk), with rows and a column at +-127 (|acc| > 2**24 at
    K = 1280), over grids with fewer P tiles than blocks and with many
    tiles per block."""
    lhs = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    rhs = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    lhs[0], lhs[1], rhs[:, 0] = 127, -127, 127
    cols = m if orientation == "a" else n
    scale = torch.empty(cols, device="cuda").uniform_(2e-6, 2e-3, generator=gen)
    scale = scale.reshape(cols, 1) if orientation == "a" else scale.reshape(1, cols)
    before = int8_mm.int8_matmul_requant.launches
    got = int8_mm.int8_matmul_requant(lhs, rhs, scale, orientation)
    torch.cuda.synchronize()
    assert int8_mm.int8_matmul_requant.launches == before + 1
    assert torch.equal(got, int8_mm.int8_matmul_requant_plain(lhs, rhs, scale))


@pytest.mark.parametrize("orientation", ["a", "b"])
def test_int8_matmul_requant_kernel_rejects_weights_past_shared_memory(gen, orientation):
    """K = 4096: a 64-channel slab of weights and the smallest ring overflow
    a block's 227 KB, so the wrapper raises before any launch."""
    lhs = torch.zeros(64, 4096, device="cuda", dtype=torch.int8)
    rhs = torch.zeros(4096, 64, device="cuda", dtype=torch.int8)
    scale = torch.ones((64, 1) if orientation == "a" else (1, 64), device="cuda")
    before = int8_mm.int8_matmul_requant.launches
    with pytest.raises(ValueError, match="232448"):
        int8_mm.int8_matmul_requant(lhs, rhs, scale, orientation)
    assert int8_mm.int8_matmul_requant.launches == before


@pytest.mark.parametrize("shape", [(1, 8, 288, 128), (2, 5, 7, 128)])
@pytest.mark.parametrize("rung", head_rungs.RUNGS)
def test_head_rung_kernel_matches_plain(gen, rung, shape):
    x = (torch.randn(shape, generator=gen, device="cuda") * 1.5).to(torch.bfloat16)
    wm = torch.randn((1, 128), generator=gen, device="cuda") * 0.3
    bm = torch.randn((1, 4), generator=gen, device="cuda") * 0.5
    before = head_rungs.head_rung.launches
    got = head_rungs.head_rung(x, wm, bm, rung)
    ref = head_rungs.head_rung_plain(x, wm, bm, rung)
    torch.cuda.synchronize()
    assert head_rungs.head_rung.launches == before + 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == torch.uint8:
        d = (got.int() - ref.int()) % 256
        d = torch.minimum(d, 256 - d)
        assert int(d.max()) <= 1
        assert int((d != 0).sum()) <= max(1, 0.001 * d.numel())
    elif rung.startswith("sigmoid"):
        assert int((got.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max()) <= 4
    else:
        assert torch.equal(got, ref)


def test_kernel_wrappers_reject_bad_operands(gen):
    node = q8._qkernel(q8._fused_k4(torch.randn(3, 3, 24, 32, generator=gen, device="cuda") * 0.1))
    with pytest.raises(ValueError, match="bfloat16"):
        qdec.parity_up_conv(torch.zeros(1, 4, 4, 24, device="cuda"), node, 0.1)
    with pytest.raises(ValueError, match="multiples of 16"):
        qdec.parity_up_conv(torch.zeros(1, 4, 4, 24, device="cuda", dtype=torch.bfloat16), node, 0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        qdec.parity_up_conv_separated(torch.zeros(1, 4, 4, 24, device="cuda"), node, 0.1)
    node4, node5 = _tail_nodes(gen)
    with pytest.raises(ValueError, match="128 channels"):
        qtail.fused_tail_features(torch.zeros(1, 4, 4, 64, device="cuda", dtype=torch.bfloat16), node4, 0.1,
                                  node5, 0.1)
    with pytest.raises(ValueError, match="512 channels"):
        qtail.fused_tail_features_sep(torch.zeros(1, 4, 4, 128, device="cuda", dtype=torch.bfloat16), node4, 0.1,
                                      node5, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        qtail.fused_tail_features(torch.zeros(1, 4, 8, 128, device="cuda", dtype=torch.bfloat16)[:, :, ::2],
                                  node4, 0.1, node5, 0.1)
    w_final, b_final = torch.zeros(1, 1, 32, 2, device="cuda"), torch.zeros(2, device="cuda")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        head.margin_head(torch.zeros(1, 4, 4, 32, device="cuda", dtype=torch.float16), w_final, b_final)
    with pytest.raises(ValueError, match="128 channels"):
        head.margin_head(torch.zeros(1, 4, 4, 32, device="cuda"), w_final, b_final, groups=4)
    with pytest.raises(ValueError, match="whole pixels"):
        head.margin_head(torch.zeros(1, 8, 8, 512, device="cuda"), w_final, b_final, overlap=2, groups=16)
    lhs = torch.zeros(32, 24, device="cuda", dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 16"):
        int8_mm.int8_matmul_requant(lhs, torch.zeros(24, 32, device="cuda", dtype=torch.int8),
                                    torch.ones(32, 1, device="cuda"), "a")
    with pytest.raises(ValueError, match="int8"):
        int8_mm.int8_matmul_requant(lhs.float(), torch.zeros(24, 32, device="cuda"), torch.ones(32, 1, device="cuda"),
                                    "a")
    with pytest.raises(ValueError, match="bfloat16"):
        head_rungs.head_rung(torch.zeros(1, 2, 2, 128, device="cuda"), torch.ones(1, 128, device="cuda"),
                             torch.zeros(1, 4, device="cuda"), "reduce")
