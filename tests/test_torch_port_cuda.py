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


def test_kernel_wrappers_reject_bad_operands(gen):
    node = q8._qkernel(q8._fused_k4(torch.randn(3, 3, 24, 32, generator=gen, device="cuda") * 0.1))
    with pytest.raises(ValueError, match="bfloat16"):
        qdec.parity_up_conv(torch.zeros(1, 4, 4, 24, device="cuda"), node, 0.1)
    with pytest.raises(ValueError, match="multiples of 16"):
        qdec.parity_up_conv(torch.zeros(1, 4, 4, 24, device="cuda", dtype=torch.bfloat16), node, 0.1)
