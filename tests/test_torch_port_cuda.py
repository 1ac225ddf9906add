"""robosat_tpu_torch CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (they build csrc/ at first use);
elsewhere they skip. They import no JAX, so the card's machine runs them
without the JAX package's test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Shapes are small and ragged on purpose (pixel counts off the 64- and
128-row tiles, channel counts off the 64-wide tiles) to reach every masked
edge of the int8 conv kernels; chip_smoke.py checks the main-path
shapes. rs_int8_conv (models/qconv.py) is held at each of the fast
family's dense sites, each case asserting the route it took
(`qconv.route`: halo_conv_kernel for the stride-1 3x3 sites,
conv_kernel for the stride-2 "SAME" convs): the dilated b4b, the
residual blocks and the concatenations' convs, also at batch 8 on the
walk's own 18-, 36- and 72-px grids and on 1 x W and H x 1 grids; and at
DeepLab's seven sites (ASPP's 1x1, its 3x3 convs at dilations 6, 12 and
18, also where the padding is wider than the grid, its projection, and the
decoder's Cin-304 and Cin-256 convs), with K3 at dilation 2 at layer4's
widths. K2's dequant epilogue (SegFormer's dense route) is held at every
dense site shape of SegFormer's predict path and at M tails, the quantize
kernel at space-to-depth factors 1, 2, 4 and 8, and a whole dense site.
The per-channel ("pc") instantiations are held with scale vectors whose
channels differ by up to 100 x: K3/K4 (conv1's and the projection's
vectors on the same x differ, the int8 epilogues requantize with the next
sites' vectors), K5, K6 and K7 (dec4's on-load quantize and its int8
epilogue), and rs_int8_conv on both routes, at main-path widths and
channel tails. K1 is also held through its operator,
`torch.ops.robosat.margin_head`, against a direct launch, and inside a
`predict` program that `export` traces on the card. The multi-device layer
(parallel/mesh.py): a one-rank NCCL group from RS_*, and two gloo ranks on
the card (tests/torch_mesh_workers.py) for the halo exchange of every
spatial site on CUDA tensors and the height-split predict step, K1 on each
rank.
"""

import functools

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
    # --strip 8 at 512/32 (one 4160 x 576 image): H >> W at every stage, and a ragged tall grid
    (True, 64, 64, 256, 1040, 144),     # layer1.0
    (False, 1024, 256, 1024, 260, 36),  # layer3.1
    (False, 2048, 512, 2048, 130, 18),  # layer4.1
    (False, 256, 64, 256, 67, 5),
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
    # --strip 8 at 512/32: layer2.0 and layer4.0 of a 4160 x 576 strip, and a ragged tall grid
    (256, 128, 512, 1040, 144),
    (1024, 512, 2048, 260, 36),
    (64, 16, 32, 66, 6),
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
    # --strip 8 at 512/32: center on 65 x 9 (partial 8 x 8 tiles in both dimensions), dec1 and dec3
    (2048, 256, 65, 9, True),
    (1280, 256, 260, 36, True),
    (320, 128, 1040, 144, True),
    (96, 80, 37, 3, False),
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


# (stride, dilation, padding, epilogue) of each of the fast family's twelve dense sites.
_FAST_SITES = {"stem": (1, 1, "SAME", "relu"), "b": (1, 1, "SAME", "residual_relu"),
               "down": (2, 1, "SAME", "relu"), "b4b": (1, 2, ((2, 2), (2, 2)), "residual_relu"),
               "d": (1, 1, "SAME", "relu")}


_INT8_CONV_CASES = [
    # each site's widths on small grids (fastnet's walk at 64 to 192 px), then ragged ones
    ("stem", 48, 128, 16, 16, True),
    ("b", 128, 128, 16, 16, True),
    ("down", 128, 128, 16, 16, True),   # stride-2 SAME on an even grid: padding (0, 1)
    ("down", 128, 256, 8, 8, True),
    ("down", 256, 256, 4, 4, True),
    ("b", 256, 256, 8, 8, True),
    ("b4b", 256, 256, 2, 2, True),      # dilation 2 on a 2 x 2 grid: only the center tap inside
    ("b4b", 256, 256, 6, 6, True),
    ("d", 384, 128, 4, 4, False),
    ("d", 256, 128, 8, 8, False),
    ("d", 256, 128, 48, 48, False),
    ("down", 128, 128, 9, 7, True),     # stride-2 SAME on an odd grid: padding (1, 1)
    ("down", 64, 80, 11, 6, False),     # Cout off the 64- and 128-wide tiles
    ("b4b", 48, 48, 13, 9, True),
    ("stem", 48, 128, 37, 29, True),
    ("d", 96, 16, 5, 3, False),
    ("b", 128, 128, 144, 144, True),    # the 144-px grid of a 576-px tile
]
# Batch 8 on the walk's own grids at 576 px (18, 36, 72), and 1 x W and H x 1 grids.
_INT8_CONV_BATCH8 = [
    ("b", 256, 256, 18, 18, True),      # b4a
    ("b4b", 256, 256, 18, 18, True),
    ("d", 384, 128, 36, 36, False),     # d3
    ("d", 256, 128, 72, 72, False),     # d2
    ("b", 128, 128, 1, 29, True),
    ("d", 256, 128, 21, 1, False),
]


@pytest.mark.parametrize("site,cin,cout,h,w,bias,n", [case + (2,) for case in _INT8_CONV_CASES] +
                         [case + (8,) for case in _INT8_CONV_BATCH8],
                         ids=["-".join(map(str, case)) for case in _INT8_CONV_CASES] +
                         ["-".join(map(str, case)) + "-n8" for case in _INT8_CONV_BATCH8])
def test_int8_conv_kernel_bit_equal(gen, site, cin, cout, h, w, bias, n):
    """Bit-equal to the plain version, on the route qconv.route names: the
    halo kernel for the stride-1 sites, conv_kernel for the stride-2 ones."""
    from robosat_tpu_torch.models import qconv

    stride, dilation, padding, epilogue = _FAST_SITES[site]
    node = _node(gen, 3, 3, cin, cout, bias=bias, std=(9 * cin) ** -0.5)
    x = _act(gen, (n, h, w, cin))
    before, routes = qconv.int8_conv.launches, dict(qconv.int8_conv.by_route)
    got = qconv.int8_conv(x, node, 0.019, stride=stride, dilation=dilation, padding=padding, epilogue=epilogue)
    torch.cuda.synchronize()
    assert qconv.int8_conv.launches == before + 1
    route = "conv_kernel" if site == "down" else "halo"
    assert qconv.route(3, stride, dilation) == route
    assert qconv.int8_conv.by_route == {**routes, route: routes[route] + 1}
    ref = qconv.int8_conv_plain(x, node, 0.019, stride=stride, dilation=dilation, padding=padding, epilogue=epilogue)
    assert got.shape == ref.shape == (n, -(-h // stride), -(-w // stride), cout)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("epilogue", ["linear", "relu"])
def test_int8_conv_kernel_epilogues_and_scale_cache(gen, epilogue):
    """The linear epilogue, and a node reused at a second scale: the cached
    scale product follows the scale."""
    from robosat_tpu_torch.models import qconv

    node = _node(gen, 3, 3, 64, 64)
    x = _act(gen, (2, 10, 12, 64))
    for scale in (0.019, 0.031, 0.019):
        got = qconv.int8_conv(x, node, scale, epilogue=epilogue)
        assert torch.equal(got, qconv.int8_conv_plain(x, node, scale, epilogue=epilogue))


@pytest.mark.parametrize("down,cin,h,w,n", [
    (True, 1024, 5, 7, 2),    # layer4.0: the stride-1 projection
    (False, 2048, 6, 6, 2),   # layer4.1
    (False, 2048, 2, 3, 2),   # dilation 2 on a 2 x 3 grid: most taps in the padding
    (True, 1024, 13, 9, 3),
    (False, 2048, 36, 36, 2),  # the 36 x 36 grid of a 576-px tile
])
def test_dilated_bottleneck_block_kernel_bit_equal(gen, down, cin, h, w, n):
    """K3 at dilation 2 (DeepLab's layer4 at output stride 16), Cmid 512,
    Cout 2048."""
    std = lambda fan_in: fan_in ** -0.5
    qb = {"conv1": _node(gen, 1, 1, cin, 512, std=std(cin)), "conv2": _node(gen, 3, 3, 512, 512, std=std(9 * 512)),
          "conv3": _node(gen, 1, 1, 512, 2048, std=std(512))}
    if down:
        qb["down_conv"] = _node(gen, 1, 1, cin, 2048, std=std(cin))
    x = _act(gen, (n, h, w, cin))
    scales = (0.02, 0.015, 0.01, 0.02 if down else None)
    before = qenc.bottleneck_block.launches
    got = qenc.bottleneck_block(x, qb, *scales, dilation=2)
    torch.cuda.synchronize()
    assert qenc.bottleneck_block.launches == before + 1
    assert tuple(got.shape) == (n, h, w, 2048)
    assert torch.equal(got, qenc.bottleneck_block_plain(x, qb, *scales, dilation=2))


def test_bottleneck_block_rejects_bad_dilation(gen, monkeypatch):
    """The wrapper refuses dilation 0 and a dilated stride-2 block; past the
    wrapper's check the C entry refuses them too."""
    qb = {"conv1": _node(gen, 1, 1, 64, 16), "conv2": _node(gen, 3, 3, 16, 16), "conv3": _node(gen, 1, 1, 16, 64),
          "down_conv": _node(gen, 1, 1, 64, 64)}
    x = _act(gen, (1, 8, 8, 64))
    with pytest.raises(ValueError, match="dilation"):
        qenc.bottleneck_block(x, qb, 0.02, 0.02, 0.02, 0.02, dilation=0)
    with pytest.raises(ValueError, match="dilation"):
        qenc._launch_block(x, qb, 0.02, 0.02, 0.02, 0.02, stride=2, dilation=2)
    monkeypatch.setattr(qenc, "_check_geometry", lambda stride, dilation: None)
    for stride, dilation in ((1, 0), (2, 2)):
        with pytest.raises(RuntimeError, match="rs_bottleneck_block launch failed"):
            qenc._launch_block(x, qb, 0.02, 0.02, 0.02, 0.02, stride=stride, dilation=dilation)


# DeepLab's rs_int8_conv sites: (kernel side, Cin, Cout, dilation), with "SAME" padding and a relu.
_DEEPLAB_SITES = {"aspp1": (1, 2048, 256, 1), "aspp_d0": (3, 2048, 256, 6), "aspp_d1": (3, 2048, 256, 12),
                  "aspp_d2": (3, 2048, 256, 18), "aspp_proj": (1, 1280, 256, 1), "dec1": (3, 304, 256, 1),
                  "dec2": (3, 256, 256, 1)}


@pytest.mark.parametrize("site,h,w,n", [
    ("aspp1", 9, 7, 2),
    ("aspp_d0", 13, 11, 2),   # every tap reaches data for some outputs
    ("aspp_d1", 4, 4, 2),     # the padding (12) wider than the grid
    ("aspp_d1", 30, 26, 1),
    ("aspp_d2", 4, 4, 2),     # the 4 x 4 grid of a 64-px tile: only the center tap inside
    ("aspp_d2", 36, 36, 2),   # the 36 x 36 grid of a 576-px tile
    ("aspp_proj", 9, 9, 2),
    ("dec1", 16, 16, 2),      # Cin 304: four 64-channel chunks and a 48-channel one
    ("dec1", 13, 11, 2),
    ("dec2", 9, 9, 2),
])
def test_deeplab_int8_conv_kernel_bit_equal(gen, site, h, w, n):
    """Bit-equal to the plain version on the route qconv.route names:
    conv_kernel for ASPP's 1x1 and dilated convs, the halo kernel for the
    decoder's 3x3 convs (Cout 256 as two 128-wide items)."""
    from robosat_tpu_torch.models import qconv

    k, cin, cout, dilation = _DEEPLAB_SITES[site]
    node = _node(gen, k, k, cin, cout, std=(k * k * cin) ** -0.5)
    x = torch.relu(_act(gen, (n, h, w, cin)))
    before, routes = qconv.int8_conv.launches, dict(qconv.int8_conv.by_route)
    got = qconv.int8_conv(x, node, 0.023, dilation=dilation)
    torch.cuda.synchronize()
    route = qconv.route(k, 1, dilation)
    assert route == ("halo" if site.startswith("dec") else "conv_kernel")
    assert qconv.int8_conv.launches == before + 1
    assert qconv.int8_conv.by_route == {**routes, route: routes[route] + 1}
    ref = qconv.int8_conv_plain(x, node, 0.023, dilation=dilation)
    assert got.shape == ref.shape == (n, h, w, cout)
    assert torch.equal(got, ref)


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
@pytest.mark.parametrize("overlap,h,w", [(0, 16, 16), (8, 24, 20), (0, 13, 11),
                                         # overlap 0 on tall grids: --strip 8's 2080 x 288, and ragged ones
                                         (0, 2080, 288), (0, 130, 18), (0, 67, 9)])
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


@pytest.mark.parametrize("groups,h,w,overlap", [(1, 20, 18, 4), (4, 13, 9, 2), (16, 10, 12, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_margin_head_op_equals_a_direct_launch(gen, groups, h, w, overlap, dtype):
    """torch.ops.robosat.margin_head on the card is K1's launch, bit for bit,
    and counts as one."""
    feats = (torch.randn(3, h, w, 32 * groups, generator=gen, device="cuda") * 1.5).to(dtype)
    w_final = torch.randn(1, 1, 32, 2, generator=gen, device="cuda") * 0.3
    b_final = torch.randn(2, generator=gen, device="cuda") * 0.1
    before = head.margin_head.launches
    got = torch.ops.robosat.margin_head(feats, w_final, b_final, overlap, groups)
    direct = head._margin_head_cuda(feats, w_final, b_final, overlap, groups)
    torch.cuda.synchronize()
    assert head.margin_head.launches == before + 2
    assert torch.equal(got, direct)


def test_predict_pt2_traced_on_the_card_keeps_k1(gen, tmp_path):
    """`export --graph predict` traced on the card at 64 px: the program
    holds one robosat.margin_head node, launches K1 once a batch when
    reloaded, and equals the eager step bit for bit."""
    import argparse

    from robosat_tpu_torch.checkpoint import load_model_checkpoint, save_checkpoint, to_jax
    from robosat_tpu_torch.config import save_config
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.parallel.steps import make_predict_step
    from robosat_tpu_torch.tools import export

    params, state = unet.init(0, num_classes=2)
    ckpt, dataset, out = str(tmp_path / "unet.npz"), str(tmp_path / "dataset.toml"), str(tmp_path / "predict.pt2")
    save_checkpoint(ckpt, {"params": to_jax(params), "state": to_jax(state)}, meta={"epoch": 0})
    save_config({"common": {"dataset": str(tmp_path), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, dataset)
    export.main(argparse.Namespace(dataset=dataset, image_size=64, checkpoint=ckpt, batch_size=2, graph="predict",
                                   family="unet", format="pt2", model=out), device=torch.device("cuda"))
    program = torch.export.load(out)
    nodes = [n for n in program.graph.nodes if n.op == "call_function" and "robosat.margin_head" in str(n.target)]
    assert len(nodes) == 1
    raw = torch.randint(0, 256, (2, 64, 64, 3), generator=gen, device="cuda", dtype=torch.uint8)
    before = head.margin_head.launches
    got = program.module()(raw)
    torch.cuda.synchronize()
    assert head.margin_head.launches == before + 1
    params_d, state_d, _ = load_model_checkpoint(ckpt, device="cuda")
    eager = make_predict_step(unet, overlap=0, compute_dtype=torch.bfloat16, fused_head=True)(params_d, state_d, raw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 64, 64)
    assert torch.equal(got, eager)


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


# SegFormer's K2 dense sites (M, K, N) at batch 8 and 576 px: every distinct
# shape of the predict path (q/proj, kv, fc1, fc2 per stage, the SR convs as
# denses over their space-to-depth, the decoder projections, the fuse), then
# M tails off every P tile (64, 128 and 256 rows) at the narrowest and widest N.
SEGFORMER_DENSE = sorted({(m, k, n) for d, m in ((32, 165888), (64, 41472), (160, 10368), (256, 2592))
                          for k, n in ((d, d), (d, 4 * d), (4 * d, d), (d, 256))}
                         | {(2592, d, 2 * d) for d in (32, 64, 160, 256)}
                         | {(2592, 2048, 32), (2592, 1024, 64), (2592, 640, 160), (165888, 1024, 256)})
DENSE_TAILS = [(1, 32, 32), (63, 32, 32), (257, 64, 32), (130, 1024, 256), (65, 256, 1024), (2591, 2048, 32)]


@pytest.mark.parametrize("m,k,n", SEGFORMER_DENSE + DENSE_TAILS,
                         ids=["{}x{}x{}".format(*s) for s in SEGFORMER_DENSE + DENSE_TAILS])
def test_int8_matmul_dequant_kernel_bit_equal(gen, m, k, n):
    """K2's dequant epilogue, bf16(fma(f32(acc), sc, b)), at SegFormer's site
    shapes and at M tails, with a row and a column at +-127."""
    xq = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    xq[0], wq[:, 0] = 127, -127
    sc = torch.empty(n, device="cuda").uniform_(1e-6, 1e-3, generator=gen)
    b = torch.randn(n, generator=gen, device="cuda")
    before = int8_mm.int8_matmul_dequant.launches
    got = int8_mm.int8_matmul_dequant(xq, wq, sc, b)
    torch.cuda.synchronize()
    assert int8_mm.int8_matmul_dequant.launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    assert torch.equal(got.view(torch.int16), int8_mm.int8_matmul_dequant_plain(xq, wq, sc, b).view(torch.int16))


@pytest.mark.parametrize("r,c,h,w", [(1, 32, 13, 7), (1, 1024, 9, 11), (2, 160, 18, 18), (4, 64, 36, 36),
                                     (8, 32, 72, 72), (8, 32, 16, 24)])
def test_quantize_act_kernel_bit_equal(gen, r, c, h, w):
    """The quantize kernel at r = 1, 2, 4 and 8 (SegFormer's SR ratios on
    their grids at 576 px), values past +-127 clipped."""
    x = _act(gen, (3, h, w, c), scale=2.0)
    x[0, 0, 0, :16] = 1e4
    before = int8_mm.quantize_act.launches
    got = int8_mm.quantize_act(x, 0.02, r)
    torch.cuda.synchronize()
    assert int8_mm.quantize_act.launches == before + 1
    assert torch.equal(got, int8_mm.quantize_act_plain(x, 0.02, r))


@pytest.mark.parametrize("r,cin,cout,grid", [(1, 64, 64, (5, 7)), (1, 1024, 256, (9, 9)), (8, 32, 32, (16, 24)),
                                             (2, 160, 160, (6, 4))])
def test_int8_dense_site_bit_equal(gen, r, cin, cout, grid):
    """A whole dense site (quantize, then K2's dequant epilogue) against
    int8_dense_plain, the weight (K, N) or an SR conv's (r, r, C, N)."""
    node = _node(gen, r, r, cin, cout, std=(r * r * cin) ** -0.5)
    if r == 1:
        node = {"wq": node["wq"][0, 0], "ws": node["ws"], "b": node["b"]}
    x = _act(gen, (2, grid[0], grid[1], cin))
    before = (int8_mm.quantize_act.launches, int8_mm.int8_matmul_dequant.launches)
    got = int8_mm.int8_dense(x, node, 0.03, r)
    torch.cuda.synchronize()
    assert (int8_mm.quantize_act.launches, int8_mm.int8_matmul_dequant.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, int8_mm.int8_dense_plain(x, node, 0.03, r))


def test_int8_dense_raises_without_fallback(gen):
    """On CUDA tensors the dense route launches or raises: a channel count
    off 16 and a bf16 weight are refused, and nothing falls back."""
    node = {"wq": torch.zeros(24, 32, device="cuda", dtype=torch.int8), "ws": torch.ones(32, device="cuda"),
            "b": torch.zeros(32, device="cuda")}
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_mm.int8_dense(torch.zeros(2, 24, device="cuda", dtype=torch.bfloat16), node, 0.1)
    with pytest.raises(ValueError, match="bfloat16"):
        int8_mm.quantize_act(torch.zeros(2, 32, device="cuda"), 0.1)
    with pytest.raises(ValueError, match="int8"):
        int8_mm.int8_matmul_dequant(torch.zeros(4, 32, device="cuda", dtype=torch.int8),
                                    torch.zeros(32, 32, device="cuda"), torch.ones(32, device="cuda"),
                                    torch.zeros(32, device="cuda"))


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


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
def test_lovasz_function_on_the_card_matches_the_cpu(gen, ties):
    """The Lovasz autograd.Function on the card: its batched stable sort,
    cumsum and scatter give the CPU's value and gradient (ties broken by
    position on both)."""
    from robosat_tpu_torch.ops.losses import lovasz_loss

    cpu = torch.Generator().manual_seed(1)
    logits = torch.randn(3, 64, 48, 2, generator=cpu) * 3
    if ties:
        logits = torch.round(logits * 2) / 2
    targets = torch.randint(0, 2, (3, 64, 48), generator=cpu)
    grads = []
    for device in ("cpu", "cuda"):
        x = logits.detach().to(device).requires_grad_(True)
        loss = lovasz_loss(x, targets.to(device))
        loss.backward()
        grads.append((float(loss.detach()), x.grad.cpu()))
    (want, want_grad), (got, got_grad) = grads
    assert abs(got - want) <= 1e-5 * abs(want)
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-5, atol=1e-5 * float(want_grad.abs().max()))


def test_train_step_on_the_card_matches_the_cpu(gen):
    """One float32 train step (TF32 off) of the full-width U-Net at 64 px,
    batch 2, on the card and on the CPU from the same weights: the loss
    within 1e-4, gradient cosines at the head and the stem, BN statistics,
    and the card's new weights those of the port's Adam replayed on the CPU
    from the same start on the card's gradients (1e-6 relative, or 1e-6 *
    lr where a weight near zero cancels against its update)."""
    import numpy as np

    from robosat_tpu_torch import optim
    from robosat_tpu_torch.checkpoint import from_jax, to_jax, tree_leaves
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.steps import make_train_step

    configure_device(True)
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    masks = np.zeros((2, 64, 64), np.int32)
    masks[:, 16:40, 20:44] = 1
    params, state = unet.init(0)
    runs = {}
    for device in ("cpu", "cuda"):
        p, s = from_jax(to_jax(params), to_jax(state), device)
        optimizer = optim.adam(p, 1e-4)
        step = make_train_step(unet, get_loss("CrossEntropy"), optimizer, weight=[1.6248, 5.762827], augment=False)
        s, loss, counts = step(p, s, images, masks)
        runs[device] = float(loss), p, s, counts.cpu()
    (want, wp, ws, wc), (got, gp, gs, gc) = runs["cpu"], runs["cuda"]
    assert abs(got - want) <= 1e-4 * abs(want)
    assert int(gc.sum()) == masks.size
    for a, b in ((gp["final"]["w"], wp["final"]["w"]), (gp["encoder"]["conv1"]["w"], wp["encoder"]["conv1"]["w"])):
        a, b = a.grad.cpu().double().flatten(), b.grad.double().flatten()
        assert float(a @ b / (a.norm() * b.norm())) >= 0.99
    torch.testing.assert_close(gs["encoder"]["bn1"]["mean"].cpu(), ws["encoder"]["bn1"]["mean"], rtol=5e-3, atol=5e-3)
    card = tree_leaves(gp)
    replay = [t.detach().clone().requires_grad_(True) for t in tree_leaves(params)]
    for r, q in zip(replay, card):
        r.grad = q.grad.cpu()
    optim.Adam(replay, lr=1e-4).step()
    for r, q in zip(replay, card):
        torch.testing.assert_close(q.detach().cpu(), r.detach(), rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_fake_quant_on_the_card_matches_the_cpu(gen, dtype):
    """`fake_quant_act` and `fake_quant_weight` (QAT) on the card: forward
    and gradient bit-equal to the CPU's, on activations spanning bin edges
    and values past +-127 bins, and on kernels with an all-zero output
    channel."""
    scale = 0.0371
    cpu = torch.Generator().manual_seed(3)
    edges = (torch.arange(-130, 131, dtype=torch.float32) + 0.5) * scale
    x = torch.cat([torch.randn(4000, generator=cpu) * 3, edges, -edges, torch.tensor([0.0, -0.0, 200.0, -200.0])])
    w = torch.randn(3, 3, 64, 48, generator=cpu) * 0.05
    w[..., 0] = 0.0
    gx, gw = torch.randn(x.shape, generator=cpu), torch.randn(w.shape, generator=cpu)
    runs = {}
    for device in ("cpu", "cuda"):
        xd = x.to(device, dtype, copy=True).requires_grad_(True)
        wd = w.to(device, dtype, copy=True).requires_grad_(True)
        ya, yw = q8.fake_quant_act(xd, scale), q8.fake_quant_weight(wd)
        ya.backward(gx.to(device, dtype))
        yw.backward(gw.to(device, dtype))
        runs[device] = [t.detach().cpu() for t in (ya, yw, xd.grad, wd.grad)]
    for got, want in zip(runs["cuda"], runs["cpu"]):
        assert got.dtype == want.dtype == dtype
        assert torch.equal((got + 0).view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           (want + 0).view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("op,args", [("denoise_grow", (20, 20)), ("denoise_grow", (9, 9)), ("erode", (21,)),
                                     ("dilate", (4,)), ("opening", (8,)), ("closing", (5,))])
def test_morphology_on_the_card_matches_the_cpu(gen, op, args):
    """ops/morphology on the card (cuDNN's conv under deterministic
    algorithms, TF32 off): the same uint8 masks as the CPU, bit for bit, on
    blob-and-pepper masks off the 8-pixel grid."""
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.ops import morphology

    configure_device(True)
    cpu = torch.Generator().manual_seed(5)
    masks = (torch.rand(3, 133, 141, generator=cpu) < 0.02).to(torch.uint8)
    for _ in range(6):
        x, y, w, h = (int(v) for v in torch.randint(0, 90, (4,), generator=cpu))
        masks[:, y : y + h // 2 + 10, x : x + w // 2 + 10] ^= 1
    fn = getattr(morphology, op)
    if op != "denoise_grow":
        args = (morphology.ellipse_kernel(args[0]),)
    want = fn(masks, *args)
    got = fn(masks.cuda(), *args)
    assert got.dtype == torch.uint8 and got.is_cuda
    assert torch.equal(got.cpu(), want)


# ---- the per-channel ("pc") instantiations: reciprocal vectors on load and in EPI_RELU_Q8 ----


def _pc_amax(gen, cin, spread=100.0):
    """Per-channel activation ranges that differ by up to `spread` x."""
    return torch.exp(torch.rand(cin, generator=gen, device="cuda") * torch.log(torch.tensor(spread))) * 0.05


def _pc_site(gen, kernel, bias=True):
    """A per-channel site: the kernel folded and quantized by ScaleCursor on
    random ranges, its host scale vector, and the ranges (to scale inputs)."""
    a = _pc_amax(gen, kernel.shape[2])
    cursor = q8.ScaleCursor([a])
    node = q8._qkernel_pc(kernel, cursor)
    if bias:
        node["b"] = torch.randn(kernel.shape[-1], generator=gen, device="cuda") * 0.05
    return node, q8.host_scales(cursor.out_scales)[0], a


def _pc_act(gen, shape, a):
    """bf16 activations whose channel c spans about a[c] (relu'd, as a site's input is)."""
    return torch.relu(torch.randn(shape, generator=gen, device="cuda") * a / 2).to(torch.bfloat16)


@pytest.mark.parametrize("stride,down,cin,cmid,cout,h,w,dilation", [
    (1, True, 64, 64, 256, 9, 11, 1),       # layer1.0: conv1 and the projection read x with different vectors
    (1, False, 256, 64, 256, 91, 93, 1),    # layer1.1
    (2, True, 256, 128, 512, 10, 14, 1),    # layer2.0 (K4)
    (1, False, 1024, 256, 1024, 6, 7, 1),   # layer3.1
    (2, True, 48, 32, 80, 10, 14, 1),       # channel tails: Cin 48, Cmid 32, Cout 80
    (1, True, 1024, 512, 2048, 5, 7, 2),    # DeepLab's layer4.0 at dilation 2
])
def test_bottleneck_block_pc_kernel_bit_equal(gen, stride, down, cin, cmid, cout, h, w, dilation):
    """K3/K4 with per-channel vectors: conv1's and the projection's on-load
    quantizes of the same x, and conv1's and conv2's int8 epilogues with the
    next sites' vectors, bit-equal to the plain version."""
    std = lambda fan_in: fan_in ** -0.5
    qb, scales = {}, {}
    shapes = {"conv1": (1, cin, cmid), "conv2": (3, cmid, cmid), "conv3": (1, cmid, cout)}
    if down:
        shapes["down_conv"] = (1, cin, cout)
    amax = None
    for key, (k, ci, co) in shapes.items():
        kernel = torch.randn(k, k, ci, co, generator=gen, device="cuda") * std(k * k * ci)
        qb[key], scales[key], a = _pc_site(gen, kernel)
        amax = a if key == "conv1" else amax
    if down:
        ratio = scales["conv1"] / scales["down_conv"]
        assert ratio.max() / ratio.min() > 10.0  # the two vectors on x differ channel by channel
    x = _pc_act(gen, (2, h, w, cin), amax)
    args = (scales["conv1"], scales["conv2"], scales["conv3"], scales.get("down_conv"))
    fn = qenc.bottleneck_block_s2 if stride == 2 else functools.partial(qenc.bottleneck_block, dilation=dilation)
    counter = qenc.bottleneck_block_s2 if stride == 2 else qenc.bottleneck_block
    before = counter.launches
    got = fn(x, qb, *args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = qenc.bottleneck_block_plain(x, qb, *args, stride=stride, dilation=dilation)
    assert got.shape == ref.shape == (2, (h - 1) // stride + 1, (w - 1) // stride + 1, cout)
    assert torch.equal(got, ref)


def test_bottleneck_block_pc_entry_checks(gen):
    """The C entry refuses a partial set of vectors (v1 without v2), the
    wrapper a mix of vectors and floats; the per-tensor launch (null
    vectors) still equals its plain version."""
    kernels = {"conv1": (1, 64, 16), "conv2": (3, 16, 16), "conv3": (1, 16, 64)}
    qb, scales = {}, {}
    for key, (k, ci, co) in kernels.items():
        qb[key], scales[key], _ = _pc_site(gen, torch.randn(k, k, ci, co, generator=gen, device="cuda") * 0.1)
    x = _act(gen, (1, 8, 8, 64))
    with pytest.raises(ValueError, match="all per-tensor or all per-channel"):
        qenc.bottleneck_block(x, qb, scales["conv1"], 0.02, scales["conv3"])
    from robosat_tpu_torch import kernels as rk

    p = rk.ptr
    v1 = q8.device_inv(qb["conv1"], scales["conv1"], x.device, 64)
    w = [qenc.packed_weights(qb[k]) for k in ("conv1", "conv2", "conv3")]
    ws = [qb[k]["ws"] for k in ("conv1", "conv2", "conv3")]
    outs = [torch.empty((1, 8, 8, c), dtype=dt, device="cuda") for c, dt in ((16, torch.int8), (16, torch.int8),
                                                                             (64, torch.bfloat16))]
    with pytest.raises(RuntimeError, match="rs_bottleneck_block launch failed"):
        rk.launch("rs_bottleneck_block", p(x), p(w[0]), p(ws[0]), p(qb["conv1"]["b"]), p(w[1]), p(ws[1]),
                  p(qb["conv2"]["b"]), p(w[2]), p(ws[2]), p(qb["conv3"]["b"]), None, None, None, 0.0, 0.0, 0.0, 0.0,
                  p(v1), None, None, None, p(outs[0]), p(outs[1]), None, p(outs[2]), 1, 8, 8, 64, 16, 64, 1, 1)
    got = qenc.bottleneck_block(x, qb, 0.02, 0.015, 0.01)
    assert torch.equal(got, qenc.bottleneck_block_plain(x, qb, 0.02, 0.015, 0.01))


@pytest.mark.parametrize("cin,cout,h,w", [
    (2048, 256, 9, 9),     # center
    (1280, 256, 16, 16),   # dec1
    (320, 128, 16, 16),    # dec3
    (96, 80, 9, 9),        # Cin and Cout off the 64-wide tiles
])
def test_parity_up_conv_pc_kernel_bit_equal(gen, cin, cout, h, w):
    """K5 with a per-channel vector on load, bit-equal to the plain version;
    K8 refuses one."""
    k4 = q8._fused_k4(torch.randn(3, 3, cin, cout, generator=gen, device="cuda") * 3 * (9 * cin) ** -0.5)
    node, s, a = _pc_site(gen, k4)
    x = _pc_act(gen, (2, h, w, cin), a)
    before = qdec.parity_up_conv.launches
    got = qdec.parity_up_conv(x, node, s)
    torch.cuda.synchronize()
    assert qdec.parity_up_conv.launches == before + 1
    assert torch.equal(got, qdec.parity_up_conv_plain(x, node, s))
    with pytest.raises(ValueError, match="per-tensor"):
        qdec.parity_up_conv_separated(x, node, s)


@pytest.mark.parametrize("overlap,h,w", [(0, 16, 16), (8, 24, 20), (0, 13, 11)])
def test_fused_tail_pc_kernel_matches_plain(gen, overlap, h, w):
    """K6 and K7 with dec4's and dec5's vectors (dec4's quantize on load and
    its EPI_RELU_Q8 with dec5's vector) on the s2d weights: K7 bit-equal,
    K6 within one bin on at most 0.1% of pixels (the head's own rounding);
    K9 refuses vectors."""
    node4, s4, a4 = _pc_site(gen, s2d_up_conv3x3_kernel(torch.randn(3, 3, 128, 32, generator=gen, device="cuda")
                                                        * 0.1), bias=False)
    node5, s5, _ = _pc_site(gen, s2d_conv3x3_kernel(torch.randn(3, 3, 32, 32, generator=gen, device="cuda") * 0.1),
                            bias=False)
    w_final = torch.randn(1, 1, 32, 2, generator=gen, device="cuda") * 0.3
    b_final = torch.randn(2, generator=gen, device="cuda") * 0.1
    x = _pc_act(gen, (2, h, w, 128), a4)
    before = qtail.fused_tail.launches, qtail.fused_tail_features.launches
    got = qtail.fused_tail(x, node4, s4, node5, s5, w_final, b_final, overlap=overlap)
    feats = qtail.fused_tail_features(x, node4, s4, node5, s5)
    torch.cuda.synchronize()
    assert (qtail.fused_tail.launches, qtail.fused_tail_features.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(feats, qtail.fused_tail_features_plain(x, node4, s4, node5, s5))
    ref = qtail.fused_tail_plain(x, node4, s4, node5, s5, w_final, b_final, overlap=overlap)
    d = (got.int() - ref.int()) % 256
    d = torch.minimum(d, 256 - d)
    assert int(d.max()) <= 1 and int((d != 0).sum()) <= 0.001 * d.numel()
    if h % 2 == 0 and w % 2 == 0:
        with pytest.raises(ValueError, match="per-tensor"):
            qtail.fused_tail_features_sep(space_to_depth2(x).contiguous(), node4, s4, node5, s5)


@pytest.mark.parametrize("site,k,cin,cout,stride,dilation,epilogue,h,w", [
    ("stem", 3, 48, 128, 1, 1, "relu", 16, 16),            # Cin 48: a 64-channel chunk half padding
    ("b1", 3, 128, 128, 1, 1, "residual_relu", 18, 18),
    ("b4b", 3, 256, 256, 1, 2, "residual_relu", 6, 6),     # the dilated halo route
    ("down2", 3, 128, 128, 2, 1, "relu", 16, 16),          # conv_kernel, stride 2
    ("d1", 3, 256, 128, 1, 1, "relu", 36, 36),
    ("aspp1", 1, 2048, 256, 1, 1, "relu", 9, 7),
    ("aspp_d2", 3, 2048, 256, 1, 18, "relu", 36, 36),      # conv_kernel at dilation 18
    ("dec1", 3, 304, 256, 1, 1, "relu", 16, 16),           # Cin 304: a 48-channel last chunk
])
def test_int8_conv_pc_kernel_bit_equal(gen, site, k, cin, cout, stride, dilation, epilogue, h, w):
    """rs_int8_conv with a per-channel vector on both routes (halo_conv_kernel
    and conv_kernel), bit-equal to the plain version."""
    from robosat_tpu_torch.models import qconv

    kernel = torch.randn(k, k, cin, cout, generator=gen, device="cuda") * (k * k * cin) ** -0.5
    node, s, a = _pc_site(gen, kernel)
    x = _pc_act(gen, (2, h, w, cin), a)
    padding = ((dilation, dilation),) * 2 if dilation > 1 else "SAME"
    before, routes = qconv.int8_conv.launches, dict(qconv.int8_conv.by_route)
    got = qconv.int8_conv(x, node, s, stride=stride, dilation=dilation, padding=padding, epilogue=epilogue)
    torch.cuda.synchronize()
    route = qconv.route(k, stride, dilation)
    assert qconv.int8_conv.launches == before + 1
    assert qconv.int8_conv.by_route == {**routes, route: routes[route] + 1}
    ref = qconv.int8_conv_plain(x, node, s, stride=stride, dilation=dilation, padding=padding, epilogue=epilogue)
    assert torch.equal(got, ref)


def _mesh_workers():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_mesh_workers

    return torch_mesh_workers


def test_nccl_group_of_one_rank(gen):
    """RS_* with one process on the card: an NCCL group (the backend the
    config's CUDA device selects), the rank's device current, and the
    mesh's sum, gather and object broadcast through it."""
    workers = _mesh_workers()
    (backend, device, total, gathered, obj), = workers.launch(workers.nccl_one_rank, 1)
    assert (backend, device) == ("nccl", "cuda:0")
    assert total == [0.0, 1.0, 2.0, 3.0] and gathered == [[0.0, 1.0, 2.0, 3.0]]
    assert obj == {"amaxes": [1.5, 2.5]}


def test_halo_sites_on_the_card_match_the_whole_raster(gen):
    """Every spatial site of the U-Net's folded forward on CUDA tensors,
    split by height over 2 gloo ranks of the one card, against the whole
    raster's on the card, in float64 (the same products and sums)."""
    import numpy as np

    workers = _mesh_workers()
    rng = np.random.default_rng(0)
    c = 8
    x = rng.standard_normal((2, 16, 12, 4 * c))
    w = {"w3": rng.standard_normal((3, 3, 4 * c, c)), "w7": rng.standard_normal((7, 7, 4 * c, c)),
         "w1": rng.standard_normal((1, 1, 4 * c, c)), "w3q": rng.standard_normal((3, 3, c, c))}
    whole = workers.halo_site_outputs(torch.from_numpy(x).cuda(), {k: torch.from_numpy(v).cuda() for k, v in w.items()})
    ranks = workers.launch(workers.halo_sites, 2, x, w, "cuda")
    for name, ref in whole.items():
        got = np.concatenate([r[name] for r in ranks], axis=1)
        np.testing.assert_allclose(got, ref.cpu().numpy(), rtol=1e-12, atol=1e-12, err_msg=name)


def test_spatial_step_on_the_card_launches_k1_on_each_rank(gen):
    """make_spatial_predict_step on 2 gloo ranks of the card at (1, 256,
    128), overlap 32, float32: K1 once on each rank, the uint8 of the
    one-process make_predict_step(fused_head=True) within one bin on at
    most 0.1% of the pixels, and K1 on each rank's own features against
    its plain version under the same rule."""
    import numpy as np

    from robosat_tpu_torch.checkpoint import from_jax, to_jax
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.parallel.steps import make_predict_step

    workers = _mesh_workers()
    configure_device(True)
    raw = np.random.default_rng(3).integers(0, 255, (1, 256, 128, 3), dtype=np.uint8)
    params, state = from_jax(*(to_jax(t) for t in unet.init(0)), "cuda")
    ref = make_predict_step(unet, overlap=32, fused_head=True, fold_bn=True, s2d=True)(params, state, raw).cpu().numpy()
    for out, launches, k1, k1_plain in workers.launch(workers.spatial_predict_port, 2, raw, 32, "cuda"):
        assert launches == 1 and out.shape == ref.shape == (1, 192, 64)
        assert k1.shape == k1_plain.shape == (1, 64, 64, 4)
        for got, want in ((out, ref), (k1, k1_plain)):
            d = (got.astype(np.int32) - want.astype(np.int32)) % 256
            d = np.minimum(d, 256 - d)
            assert d.max() <= 1 and (d != 0).sum() <= 0.001 * d.size
