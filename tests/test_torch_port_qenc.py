"""robosat_tpu_torch K3/K4: the bottleneck blocks' plain versions vs the JAX package.

The JAX package pins its Pallas bottleneck kernels (run here in interpret
mode) bit for bit against its XLA int8 walk (tests/test_qenc.py); the
port's plain versions, which its CUDA kernels are held against on the
card, must equal them bit for bit on the same quantized nodes and inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import qenc as jqenc
from robosat_tpu_torch.models import qenc, qtail
from robosat_tpu_torch.models.int8 import _quantize_act, scaled_ws


def _node(rng, kh, kw, cin, cout):
    return jq8._qconv({
        "w": jnp.asarray(rng.normal(0, 0.1, (kh, kw, cin, cout)).astype(np.float32)),
        "b": jnp.asarray(rng.normal(0, 0.05, (cout,)).astype(np.float32)),
    })


def _block(rng, cin, cmid, cout, down):
    qb = {"conv1": _node(rng, 1, 1, cin, cmid), "conv2": _node(rng, 3, 3, cmid, cmid), "conv3": _node(rng, 1, 1, cmid, cout)}
    if down:
        qb["down_conv"] = _node(rng, 1, 1, cin, cout)
    return qb


def _torch_block(qb):
    return {k: {n: torch.from_numpy(np.array(v)) for n, v in node.items()} for k, node in qb.items()}


def _inputs(rng, shape):
    x = jnp.asarray(rng.normal(0, 1.0, shape), jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("down,cin,h", [(True, 32, 16), (False, 64, 16), (True, 128, 8)])
def test_bottleneck_block_plain_bit_equal(down, cin, h):
    rng = np.random.default_rng(6 + cin)
    cmid, cout = 16, 64
    qb = _block(rng, cin if down else cout, cmid, cout, down)
    x, xt = _inputs(rng, (2, h, h, cin if down else cout))
    s1, s2, s3, sd = 0.02, 0.015, 0.01, 0.02
    ref = jqenc.bottleneck_block(x, qb, s1, s2, s3, sd=sd if down else None, strip_rows=4, interpret=True)
    got = qenc.bottleneck_block(xt, _torch_block(qb), s1, s2, s3, sd if down else None)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape
    assert int((np.asarray(ref, np.float32) != got.float().numpy()).sum()) == 0


@pytest.mark.parametrize("cin,h", [(32, 16), (64, 12)])
def test_bottleneck_block_s2_plain_bit_equal(cin, h):
    rng = np.random.default_rng(11 + cin)
    qb = _block(rng, cin, 32, 64, down=True)
    x, xt = _inputs(rng, (2, h, h, cin))
    s1, s2, s3, sd = 0.021, 0.012, 0.009, 0.017
    ref = jqenc.bottleneck_block_s2(x, qb, s1, s2, s3, sd, strip_rows=2, interpret=True)
    got = qenc.bottleneck_block_s2(xt, _torch_block(qb), s1, s2, s3, sd)
    assert tuple(got.shape) == ref.shape == (2, h // 2, h // 2, 64)
    assert int((np.asarray(ref, np.float32) != got.float().numpy()).sum()) == 0


def test_apply_stage_blocks_matches_jax_walk():
    """A stride-2 stage (projecting first block, then an identity block)
    against the JAX package's XLA int8 walk of the same stage."""
    rng = np.random.default_rng(21)
    stage = [_block(rng, 32, 16, 64, down=True), _block(rng, 64, 16, 64, down=False)]
    scales = [0.02, 0.015, 0.01, 0.02, 0.018, 0.013, 0.011]
    x, xt = _inputs(rng, (1, 16, 16, 32))
    ref = jqenc.apply_stage_blocks(x, stage, scales, first_stride=2, interpret=True)
    got = qenc.apply_stage_blocks(xt, [_torch_block(qb) for qb in stage], scales, first_stride=2)
    assert int((np.asarray(ref, np.float32) != got.float().numpy()).sum()) == 0


def test_identity_residual_needs_matching_channels():
    rng = np.random.default_rng(0)
    qb = _torch_block(_block(rng, 32, 16, 64, down=False))
    with pytest.raises(ValueError, match="down_conv and its scale"):
        qenc.bottleneck_block(torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16), qb, 0.1, 0.1, 0.1, sd=0.1)


@pytest.mark.parametrize("cin,cout,k", [(128, 128, 3), (32, 48, 1), (96, 256, 3)])
def test_packed_weights_core_matrix_layout(cin, cout, k):
    """K3's weights as csrc/int8_conv_sm90.cuh's conv_kernel reads them: one
    slab per (tap, 64-channel chunk), each (cout_pad, 64) tile in wgmma's
    core-matrix order, zero-padded."""
    rng = np.random.default_rng(cin + cout)
    node = {"wq": torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8))}
    wk = qtail.conv_weights(node)  # (cout, taps, cin)
    wp = qenc.packed_weights(node)
    chunks, cout_pad = -(-cin // 64), -(-cout // 128) * 128
    assert tuple(wp.shape) == (k * k * chunks, cout_pad * 64)
    row, kk = np.meshgrid(np.arange(cout_pad), np.arange(64), indexing="ij")
    offset = torch.from_numpy(((row // 8) * 4 + kk // 16) * 128 + (row % 8) * 16 + kk % 16)
    for tap in range(k * k):
        for chunk in range(chunks):
            tile = torch.zeros((cout_pad, chunks * 64), dtype=torch.int8)
            tile[:cout, :cin] = wk[:, tap]
            assert torch.equal(wp[tap * chunks + chunk][offset], tile[:, 64 * chunk:64 * chunk + 64])


def _emulate_conv_kernel(xq, node, k, stride):
    """csrc/int8_conv_sm90.cuh's conv_kernel in PyTorch, on int8 input: output
    row m of the (n, ho, wo) grid gathers, per tap, input pixel
    (stride oh + tap row - k // 2, stride ow + tap column - k // 2), zero
    outside the image (stride 2, k = 3: torch's (1, 1) padding, a zero row
    above and a zero column left of an even grid), and each K step
    (tap, 64-channel chunk) multiplies its slab of `packed_weights`; then the
    dequant to bf16."""
    wp = qenc.packed_weights(node)
    n, h, w, cin = xq.shape
    cout = node["wq"].shape[-1]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    chunks, cout_pad = -(-cin // 64), wp.shape[1] // 64
    xp = torch.zeros((n, h, w, 64 * chunks), dtype=torch.long)
    xp[..., :cin] = xq.long()
    m = torch.arange(n * ho * wo)
    img, rem = m // (ho * wo), m % (ho * wo)
    oh, ow = rem // wo, rem % wo
    acc = torch.zeros((n * ho * wo, cout_pad), dtype=torch.long)
    for tap in range(k * k):
        hi = stride * oh + tap // k - k // 2
        wi = stride * ow + tap % k - k // 2
        valid = (hi >= 0) & (hi < h) & (wi >= 0) & (wi < w)
        a = xp[img, hi.clamp(0, h - 1), wi.clamp(0, w - 1)] * valid[:, None]
        for chunk in range(chunks):
            slab = wp[tap * chunks + chunk].reshape(cout_pad // 8, 4, 8, 16).permute(0, 2, 1, 3).reshape(cout_pad, 64)
            acc += a[:, 64 * chunk:64 * chunk + 64] @ slab.long().T
    assert int(acc.abs().max()) < 2 ** 31
    return acc[:, :cout].reshape(n, ho, wo, cout).to(torch.int32)


def _dequant(acc, node, scale):
    y = acc.float() * scaled_ws(node, scale)
    if "b" in node:
        y = y + node["b"]
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("cin,cmid,cout,h,w", [(32, 32, 64, 16, 16), (96, 48, 80, 6, 10), (64, 16, 32, 18, 2)])
def test_stride2_gather_emulation_matches_jax(cin, cmid, cout, h, w):
    """K4 as csrc/qenc.cu runs it (conv1 at full resolution to int8 h1,
    conv2 and the projection gathering every other pixel, int8 h2, conv3
    with the residual) equals the JAX package's stride-2 Pallas block in
    interpret mode bit for bit."""
    rng = np.random.default_rng(31 + cin + h)
    jqb = _block(rng, cin, cmid, cout, down=True)
    x, xt = _inputs(rng, (2, h, w, cin))
    s1, s2, s3, sd = 0.021, 0.012, 0.009, 0.017
    ref = np.asarray(jqenc.bottleneck_block_s2(x, jqb, s1, s2, s3, sd, strip_rows=1, interpret=True), np.float32)
    qb = _torch_block(jqb)
    h1 = _quantize_act(torch.relu(_dequant(_emulate_conv_kernel(_quantize_act(xt, s1), qb["conv1"], 1, 1),
                                           qb["conv1"], s1)), s2)
    h2 = _quantize_act(torch.relu(_dequant(_emulate_conv_kernel(h1, qb["conv2"], 3, 2), qb["conv2"], s2)), s3)
    sc = _dequant(_emulate_conv_kernel(_quantize_act(xt, sd), qb["down_conv"], 1, 2), qb["down_conv"], sd)
    inner = _dequant(_emulate_conv_kernel(h2, qb["conv3"], 1, 1), qb["conv3"], s3)
    got = torch.relu(inner.float() + sc.float()).to(torch.bfloat16)
    assert tuple(got.shape) == ref.shape == (2, h // 2, w // 2, cout)
    assert int((got.float().numpy() != ref).sum()) == 0
    assert torch.equal(got, qenc.bottleneck_block_s2(xt, qb, s1, s2, s3, sd))
