"""robosat_tpu_torch CUDA kernels vs their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc (they build csrc/ at first use);
elsewhere they skip. They import no JAX, so the card's machine runs them
without the JAX package's test configuration:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py

Shapes are small and ragged on purpose (pixel counts off the 128-row tile,
channel counts off the 64-wide tiles) to reach every masked edge of the
shared int8 conv; chip_smoke.py checks the main-path shapes.
"""

import pytest
import torch

from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qdec, qenc, qtail
from robosat_tpu_torch.models.layers import space_to_depth2
from robosat_tpu_torch.ops import head, head_rungs, int8_mm

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _node(gen, kh, kw, cin, cout, bias=True):
    node = q8._qconv({"w": torch.randn(kh, kw, cin, cout, generator=gen, device="cuda") * 0.1})
    if bias:
        node["b"] = torch.randn(cout, generator=gen, device="cuda") * 0.05
    return node


def _act(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


@pytest.mark.parametrize("down,cin,cmid,cout,h,w", [(True, 32, 16, 64, 7, 9), (False, 96, 48, 96, 13, 5)])
def test_bottleneck_block_kernel_bit_equal(gen, down, cin, cmid, cout, h, w):
    qb = {"conv1": _node(gen, 1, 1, cin, cmid), "conv2": _node(gen, 3, 3, cmid, cmid), "conv3": _node(gen, 1, 1, cmid, cout)}
    if down:
        qb["down_conv"] = _node(gen, 1, 1, cin, cout)
    x = _act(gen, (3, h, w, cin))
    scales = (0.02, 0.015, 0.01, 0.02 if down else None)
    before = qenc.bottleneck_block.launches
    got = qenc.bottleneck_block(x, qb, *scales)
    torch.cuda.synchronize()
    assert qenc.bottleneck_block.launches == before + 1
    assert torch.equal(got, qenc.bottleneck_block_plain(x, qb, *scales))


def test_bottleneck_block_s2_kernel_bit_equal(gen):
    qb = {"conv1": _node(gen, 1, 1, 48, 32), "conv2": _node(gen, 3, 3, 32, 32),
          "conv3": _node(gen, 1, 1, 32, 80), "down_conv": _node(gen, 1, 1, 48, 80)}
    x = _act(gen, (2, 10, 14, 48))
    got = qenc.bottleneck_block_s2(x, qb, 0.021, 0.012, 0.009, 0.017)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (2, 5, 7, 80)
    assert torch.equal(got, qenc.bottleneck_block_s2_plain(x, qb, 0.021, 0.012, 0.009, 0.017))


@pytest.mark.parametrize("cin,cout,h,w,bias", [(48, 32, 5, 7, False), (144, 80, 9, 4, True)])
def test_parity_up_conv_kernel_bit_equal(gen, cin, cout, h, w, bias):
    node = q8._qkernel(q8._fused_k4(torch.randn(3, 3, cin, cout, generator=gen, device="cuda") * 0.1))
    if bias:
        node["b"] = torch.randn(cout, generator=gen, device="cuda") * 0.05
    x = _act(gen, (2, h, w, cin))
    got = qdec.parity_up_conv(x, node, 0.017)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (2, 2 * h, 2 * w, cout)
    assert torch.equal(got, qdec.parity_up_conv_plain(x, node, 0.017))


@pytest.mark.parametrize("overlap,h,w", [(0, 16, 16), (8, 24, 20)])
def test_fused_tail_kernel_matches_plain(gen, overlap, h, w):
    node4 = q8._qkernel(torch.randn(3, 3, 128, 128, generator=gen, device="cuda") * 0.1)
    node5 = q8._qkernel(torch.randn(3, 3, 128, 128, generator=gen, device="cuda") * 0.1)
    w_final = torch.randn(1, 1, 32, 2, generator=gen, device="cuda") * 0.3
    b_final = torch.randn(2, generator=gen, device="cuda") * 0.1
    x = _act(gen, (2, h, w, 128))
    got = qtail.fused_tail(x, node4, 0.021, node5, 0.013, w_final, b_final, overlap=overlap)
    ref = qtail.fused_tail_plain(x, node4, 0.021, node5, 0.013, w_final, b_final, overlap=overlap)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (2, h - overlap, w - overlap, 4)
    d = (got.int() - ref.int()) % 256
    d = torch.minimum(d, 256 - d)
    assert int(d.max()) <= 1
    assert int((d != 0).sum()) <= 0.001 * d.numel()


@pytest.mark.parametrize("cin,cout,h,w,bias", [(48, 32, 5, 7, True), (144, 80, 9, 4, False)])
def test_parity_up_conv_separated_kernel_bit_equal(gen, cin, cout, h, w, bias):
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


def _tail_nodes(gen):
    return (q8._qkernel(torch.randn(3, 3, 128, 128, generator=gen, device="cuda") * 0.1),
            q8._qkernel(torch.randn(3, 3, 128, 128, generator=gen, device="cuda") * 0.1))


@pytest.mark.parametrize("h,w,const", [(12, 20, None), (16, 16, 3.0)])
def test_fused_tail_features_kernels_bit_equal(gen, h, w, const):
    """K7 on the grid and K9 on its parity planes against their plain
    versions; the constant input makes a wrong zero padding flip the borders."""
    node4, node5 = _tail_nodes(gen)
    x = _act(gen, (2, h, w, 128)) if const is None else torch.full((1, h, w, 128), const, device="cuda",
                                                                   dtype=torch.bfloat16)
    got = qtail.fused_tail_features(x, node4, 0.021, node5, 0.013)
    planes = space_to_depth2(x).contiguous()
    got_sep = qtail.fused_tail_features_sep(planes, node4, 0.021, node5, 0.013)
    torch.cuda.synchronize()
    assert torch.equal(got, qtail.fused_tail_features_plain(x, node4, 0.021, node5, 0.013))
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


@pytest.mark.parametrize("m,k,n", [(48, 80, 1040), (130, 1280, 64), (64, 64, 16)])
@pytest.mark.parametrize("orientation", ["a", "b"])
def test_int8_matmul_requant_kernel_bit_equal(gen, orientation, m, k, n):
    """K2 at ragged shapes (M and N off the 64/128 tiles, K off the 64
    chunk), with rows and a column at +-127 (|acc| > 2**24 at K = 1280)."""
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
