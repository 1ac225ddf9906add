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
from robosat_tpu_torch.models import qenc


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
