"""robosat_tpu_torch.ops.morphology vs the JAX package's and cv2's, bit-equal.

The port's morphology is `F.conv2d` over padded float32 masks; the JAX
package's is XLA's convolution, held against cv2 in tests/test_morphology.py.
Both run here on the same seeded blob-and-pepper masks (the pattern of
tests/test_morphology.py) and must give the same uint8 masks as cv2.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from robosat_tpu.features import core as jcore  # noqa: E402
from robosat_tpu.ops import morphology as jmorph  # noqa: E402
from robosat_tpu_torch.features import core  # noqa: E402
from robosat_tpu_torch.ops import morphology  # noqa: E402

CPU = torch.device("cpu")


def _blobs(seed, n, size):
    rng = np.random.default_rng(seed)
    masks = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        for _ in range(4):
            x0, y0 = rng.integers(0, size - 20, 2)
            w, h = rng.integers(4, 40, 2)
            masks[i, y0 : y0 + h, x0 : x0 + w] = 1
        masks[i] ^= (rng.random((size, size)) < 0.02).astype(np.uint8)
    return masks


def _port(fn, masks, *args):
    return fn(torch.from_numpy(masks), *args).numpy()


@pytest.mark.parametrize("size", [3, 4, 5, 8, 9, 20, 21])
def test_ellipse_kernel_matches_jax_and_cv2(size):
    ours = morphology.ellipse_kernel(size)
    np.testing.assert_array_equal(ours, jmorph.ellipse_kernel(size))
    np.testing.assert_array_equal(ours, cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)))


_CV2_OPS = {
    "erode": lambda m, se: cv2.erode(m, se, borderType=cv2.BORDER_CONSTANT, borderValue=1),
    "dilate": lambda m, se: cv2.dilate(m, se),
    "opening": lambda m, se: cv2.morphologyEx(m, cv2.MORPH_OPEN, se),
    "closing": lambda m, se: cv2.morphologyEx(m, cv2.MORPH_CLOSE, se),
}


@pytest.mark.parametrize("op", sorted(_CV2_OPS))
@pytest.mark.parametrize("ksize,seed,n,size", [(4, 0, 2, 96), (9, 1, 3, 112), (20, 2, 4, 128), (21, 3, 2, 100)])
def test_ops_match_jax_and_cv2(op, ksize, seed, n, size):
    masks = _blobs(seed, n, size)
    se = morphology.ellipse_kernel(ksize)
    ours = _port(getattr(morphology, op), masks, se)
    assert ours.dtype == np.uint8 and ours.shape == masks.shape
    np.testing.assert_array_equal(ours, np.asarray(getattr(jmorph, op)(masks, se)))
    for i in range(n):
        np.testing.assert_array_equal(ours[i], _CV2_OPS[op](masks[i], se), err_msg="{} mask {}".format(op, i))


@pytest.mark.parametrize("denoise_size,grow_size,seed,n,size", [(20, 20, 0, 4, 128), (9, 9, 1, 3, 96), (5, 8, 2, 2, 120)])
def test_denoise_grow_matches_jax_and_cv2(denoise_size, grow_size, seed, n, size):
    # Label-valued masks (not just 0/1): denoise_grow binarizes them first.
    masks = _blobs(seed, n, size) * 3
    ours = _port(morphology.denoise_grow, masks, denoise_size, grow_size)
    np.testing.assert_array_equal(ours, np.asarray(jmorph.denoise_grow(masks, denoise_size, grow_size)))
    d_se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (denoise_size, denoise_size))
    g_se = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (grow_size, grow_size))
    for i in range(n):
        ref = cv2.morphologyEx((masks[i] > 0).astype(np.uint8), cv2.MORPH_OPEN, d_se)
        ref = cv2.morphologyEx(ref, cv2.MORPH_CLOSE, g_se)
        np.testing.assert_array_equal(ours[i], ref)


def test_single_mask_denoise_grow_match_jax():
    mask = _blobs(4, 1, 104)[0]
    np.testing.assert_array_equal(core.denoise(mask, 20, CPU), jcore.denoise(mask, 20))
    np.testing.assert_array_equal(core.grow(mask, 9, CPU), jcore.grow(mask, 9))
