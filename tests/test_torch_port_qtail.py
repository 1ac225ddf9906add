"""robosat_tpu_torch K6: the fused tail's plain version vs the JAX package.

dec4 + dec5 are bit-exact int8 convs; the head's margin sum and sigmoid may
differ from XLA's in the last ulps, which could move a probability across a
1/255 bin edge. At the shapes of tests/test_qtail.py no such flip occurs,
and the test asserts 0 of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import qtail as jqtail
from robosat_tpu.ops.quantize import ANCHORS
from robosat_tpu_torch.models import qtail
from robosat_tpu_torch.ops.head import _digitize_exact, _to_u8


def _tnode(node):
    return {k: torch.from_numpy(np.array(v)) for k, v in node.items()}


def _tail_inputs(seed, shape, wscale=0.1, x=None):
    rng = np.random.default_rng(seed)
    c = 128
    node4 = jq8._qkernel(jnp.asarray(rng.normal(0, wscale, (3, 3, c, c)).astype(np.float32)))
    node5 = jq8._qkernel(jnp.asarray(rng.normal(0, wscale, (3, 3, c, c)).astype(np.float32)))
    w_final = rng.normal(0, 0.3, (1, 1, 32, 2)).astype(np.float32)
    b_final = rng.normal(0, 0.1, (2,)).astype(np.float32)
    if x is None:
        x = rng.normal(0, 1.0, shape)
    return node4, node5, w_final, b_final, jnp.asarray(x, jnp.bfloat16)


def _run_both(node4, node5, w_final, b_final, x, s4, s5, overlap):
    ref = np.asarray(jqtail.fused_tail(x, node4, s4, node5, s5, w_final, b_final, overlap=overlap, strip_rows=8,
                                       interpret=True))
    got = qtail.fused_tail(
        torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16), _tnode(node4), s4, _tnode(node5), s5,
        torch.from_numpy(w_final), torch.from_numpy(b_final), overlap=overlap,
    ).numpy()
    return ref, got


@pytest.mark.parametrize("overlap,h", [(0, 16), (8, 24)])
def test_fused_tail_plain_matches_jax(overlap, h):
    node4, node5, w_final, b_final, x = _tail_inputs(0, (2, h, h, 128))
    ref, got = _run_both(node4, node5, w_final, b_final, x, 0.021, 0.013, overlap)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (2, h - overlap, h - overlap, 4)
    flips = int((got != ref).sum())
    assert flips == 0, "{} of {} bins flipped".format(flips, ref.size)


def test_fused_tail_plain_edge_rows_zero_padded():
    """Large constant input: a wrong (non-zero) padding flips the borders."""
    node4, node5, w_final, b_final, x = _tail_inputs(1, None, wscale=0.2, x=np.full((1, 16, 16, 128), 3.0))
    b_final = np.zeros((2,), np.float32)
    ref, got = _run_both(node4, node5, w_final, b_final, x, 0.05, 0.05, 0)
    assert int((got != ref).sum()) == 0


def test_digitize_matches_reference_anchors():
    """_digitize_exact with IEEE division is np.digitize against the 256
    float32 anchors, including p == 1.0 -> 256, which wraps to 0."""
    p = np.concatenate([np.random.default_rng(3).random(200000), [0.0, 1.0], np.arange(256) / 255.0])
    p = p.astype(np.float32)
    ref = np.digitize(p, ANCHORS.astype(np.float32))
    got = _digitize_exact(torch.from_numpy(p)).numpy()
    assert np.array_equal(got, ref)
    assert _to_u8(torch.tensor([256, 255, 0], dtype=torch.int32)).tolist() == [0, 255, 0]
