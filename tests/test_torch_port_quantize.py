"""robosat_tpu_torch.ops.quantize (the unfused head's digitize) vs the JAX package.

`quantize_probs` is np.digitize against 256 float anchors with the uint8
wrap of p == 1.0 to 0; it is exact, so it is held bit-equal. The float32
softmax of `softmax_quantize` may differ from XLA's in the last ulp (their
exp differs), which could move a probability across a bin edge; on these
seeded logits no bin moves, and the test asserts 0 of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.ops import quantize as jquantize
from robosat_tpu_torch.ops import quantize


def _edge_probs():
    """Random probabilities, the anchors themselves and their float32
    neighbours, 0 and 1."""
    anchors = quantize.ANCHORS.astype(np.float32)
    near = np.concatenate([np.nextafter(anchors, np.float32(-1)), anchors, np.nextafter(anchors, np.float32(2))])
    rand = np.random.default_rng(0).random(100_000).astype(np.float32)
    return np.clip(np.concatenate([rand, near, [0.0, 1.0]]), 0, 1).astype(np.float32)


def test_quantize_probs_bit_equal():
    p = _edge_probs()
    ref = np.asarray(jax.jit(jquantize.quantize_probs)(p))
    got = quantize.quantize_probs(torch.from_numpy(p)).numpy()
    assert got.dtype == ref.dtype == np.uint8
    assert np.array_equal(got, ref)
    assert np.array_equal(quantize.ANCHORS, jquantize.ANCHORS)
    # p == 1.0 digitizes to 256, which the uint8 cast wraps to palette index 0.
    assert quantize.quantize_probs(torch.tensor([0.0, 1.0, 0.5])).tolist() == [1, 0, 128]


def test_unquantize_probs_bit_equal():
    q = np.arange(256, dtype=np.uint8).reshape(16, 16)
    ref = np.asarray(jquantize.unquantize_probs(q))
    got = quantize.unquantize_probs(torch.from_numpy(q)).numpy()
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_quantize_bit_equal(dtype):
    """NHWC binary logits (the unfused heads' float32, and the int8 step's
    bf16) -> the same uint8 NHW, the large margins that round p to 1.0 (and
    wrap) included."""
    logits = (np.random.default_rng(1).standard_normal((2, 96, 96, 2)) * 6).astype(np.float32)
    logits[0, 0, :4] = [[0.0, 200.0], [200.0, 0.0], [0.0, 0.0], [-50.0, 50.0]]
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    ref = np.asarray(jax.jit(jquantize.softmax_quantize)(jl))
    got = quantize.softmax_quantize(torch.from_numpy(np.array(jl.astype(jnp.float32))).to(getattr(torch, dtype)))
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape == (2, 96, 96)
    assert got[0, 0, :4].tolist() == [0, 1, 128, 0]
    assert int((got.numpy() != ref).sum()) == 0
