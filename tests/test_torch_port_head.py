"""robosat_tpu_torch K1: the margin heads' plain versions vs the JAX package.

`margin_head(features, w, b, overlap, groups)` takes G = 1 (fine grid), 4
(parity-blocked) and 16 (doubly blocked) groups of 32 channels; on a CPU
tensor it runs the plain head of its layout. Those plain heads sum the
margin in another order than XLA, which could move a probability across a
1/255 bin edge; the flips are counted and 0 are expected at these shapes.
The JAX Pallas kernel (`pallas_prediction_head`, interpret mode) rounds its
dot differently again, and is held to +-1 bin on >= 99.9% equal bins, as
tests/test_head.py holds it against the XLA head.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.ops import head as jhead
from robosat_tpu_torch.models.layers import depth_to_space2, space_to_depth2
from robosat_tpu_torch.ops import head


def _bin_distance(a, b):
    d = (np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)) % 256
    return np.minimum(d, 256 - d)


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1.0, shape).astype(np.float32)
    w = rng.normal(0, 0.3, (1, 1, 32, 2)).astype(np.float32)
    b = rng.normal(0, 0.1, (2,)).astype(np.float32)
    jfeats = jnp.asarray(feats, dtype)
    tfeats = torch.from_numpy(np.array(jfeats, np.float32)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return jfeats, tfeats, w, b


_CASES = {
    # groups: (JAX head, feature shape, overlaps)
    1: (jhead.fused_prediction_head, (2, 32, 32, 32), (0, 8)),
    4: (jhead.fused_prediction_head_s2d_blocked, (2, 24, 24, 128), (0, 8)),
    16: (jhead.fused_prediction_head_s2d_blocked_sep, (2, 12, 12, 512), (0, 8)),
}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("groups", [1, 4, 16])
def test_margin_head_plain_matches_jax(groups, dtype):
    jfn, shape, overlaps = _CASES[groups]
    jfeats, tfeats, w, b = _inputs(groups, shape, dtype)
    for overlap in overlaps:
        ref = np.asarray(jfn(jfeats, w, b, overlap=overlap))
        got = head.margin_head(tfeats, torch.from_numpy(w), torch.from_numpy(b), overlap=overlap, groups=groups)
        assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape
        flips = int((_bin_distance(got.numpy(), ref) != 0).sum())
        assert flips == 0, "G = {}, overlap {}: {} of {} bins flipped".format(groups, overlap, flips, ref.size)


@pytest.mark.parametrize("overlap", [0, 6])
def test_fused_prediction_head_s2d_matches_jax(overlap):
    """The blocked margin, then the depth-to-space and the fine crop (any
    overlap): the host_s2d = false head."""
    jfeats, tfeats, w, b = _inputs(7, (2, 24, 24, 128), jnp.float32)
    ref = np.asarray(jhead.fused_prediction_head_s2d(jfeats, w, b, overlap=overlap))
    got = head.fused_prediction_head_s2d(tfeats, torch.from_numpy(w), torch.from_numpy(b), overlap=overlap)
    assert tuple(got.shape) == ref.shape == (2, 48 - 2 * overlap, 48 - 2 * overlap)
    assert int((_bin_distance(got.numpy(), ref) != 0).sum()) == 0


def test_sep_head_peels_to_blocked_head():
    """One depth_to_space2 of the doubly-blocked head is the blocked head
    of the interleaved features (the writer's peel), as in the JAX package."""
    _, tfeats, w, b = _inputs(6, (2, 32, 32, 128), jnp.float32)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    for overlap in (0, 8):
        sep = head.margin_head(space_to_depth2(tfeats), tw, tb, overlap=overlap, groups=16)
        ref = head.margin_head(tfeats, tw, tb, overlap=overlap, groups=4)
        assert tuple(sep.shape) == (2, 16 - overlap // 2, 16 - overlap // 2, 16)
        assert torch.equal(depth_to_space2(sep), ref)


def test_margin_head_g1_matches_pallas_kernel():
    """The port's K1 contract at G = 1 against the JAX Pallas kernel in
    interpret mode: +-1 bin everywhere and >= 99.9% equal."""
    for overlap in (0, 8):
        jfeats, tfeats, w, b = _inputs(3, (2, 32, 32, 32), jnp.float32)
        ref = np.asarray(jhead.pallas_prediction_head(jfeats, w, b, overlap=overlap))
        got = head.pallas_prediction_head(tfeats, torch.from_numpy(w), torch.from_numpy(b), overlap=overlap)
        d = _bin_distance(got.numpy(), ref)
        assert got.shape == ref.shape
        assert d.max() <= 1
        assert (d == 0).mean() >= 0.999


def test_margin_head_extremes_and_bad_groups():
    """Saturated margins hit the extremes, p == 1.0 wrapping to 0; groups
    outside (1, 4, 16) are refused."""
    feats = torch.ones(1, 8, 8, 128)
    w = torch.zeros(1, 1, 32, 2)
    assert (head.margin_head(feats, w, torch.tensor([-50.0, 50.0]), groups=4) == 0).all()
    assert (head.margin_head(feats, w, torch.tensor([50.0, -50.0]), groups=4) == 1).all()
    with pytest.raises(ValueError, match="groups"):
        head.margin_head(feats, w, torch.zeros(2), groups=2)
