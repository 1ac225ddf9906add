"""Mask -> polygon vectorization core.

Counterpart of robosat_tpu/features/core.py: morphology (denoise/grow) runs
on the device the caller names (robosat_tpu_torch.ops.morphology,
bit-identical to cv2), while contour tracing (OpenCV, as in the JAX
package), simplification, and the pixel->WGS84 transform stay on the host
since their output is vector data (reference: robosat/features/core.py).
"""

import cv2
import torch
from PIL import Image

from robosat_tpu_torch.ops import morphology
from robosat_tpu_torch.tiles import pixel_to_location


def visualize(mask, path):
    """Write a black/white visualization PNG for a binary mask."""
    out = Image.fromarray(mask, mode="P")
    out.putpalette([0, 0, 0, 255, 255, 255])
    out.save(path)


def _on_device(op, mask, eps, device):
    """One HW uint8 mask through a batched morphology op on `device`."""
    kernel = morphology.ellipse_kernel(eps)
    return op(torch.from_numpy(mask)[None].to(device), kernel)[0].cpu().numpy()


def denoise(mask, eps, device):
    """Morphological opening with an eps-sized ellipse (removes speckle).

    Single-mask convenience over the batched op on `device`; parity:
    robosat/features/core.py:65-77.
    """
    return _on_device(morphology.opening, mask, eps, device)


def grow(mask, eps, device):
    """Morphological closing with an eps-sized ellipse (fills small holes).

    Parity: robosat/features/core.py:80-92.
    """
    return _on_device(morphology.closing, mask, eps, device)


def contours(mask):
    """Contours + hierarchy of a binary mask (cv2 RETR_TREE semantics).

    Returns (contours, hierarchy) where hierarchy rows are
    (next, prev, first_child, parent) ids, -1 when absent.
    """
    found, hierarchy = cv2.findContours(mask, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    return found, hierarchy


def simplify(polygon, eps):
    """Douglas-Peucker simplification with eps as a fraction of arc length.

    Parity: robosat/features/core.py:112-124.
    """
    assert 0 <= eps <= 1, "approximation accuracy is percentage in [0, 1]"
    epsilon = eps * cv2.arcLength(polygon, closed=True)
    return cv2.approxPolyDP(polygon, epsilon=epsilon, closed=True)


def featurize(tile, polygon, shape):
    """Pixel-space contour -> closed WGS84 coordinate ring.

    dy flips because image rows grow southward while latitude grows northward
    (robosat/features/core.py:37-62).
    """
    xmax, ymax = shape

    ring = []
    for point in polygon:
        px, py = point[0]
        dx, dy = px / xmax, py / ymax
        ring.append(pixel_to_location(tile, dx, 1.0 - dy))

    assert ring, "at least one location in polygon"
    ring.append(ring[0])
    return ring


def parents_in_hierarchy(node, tree):
    """Yield ancestor ids walking the cv2 hierarchy upward from `node`."""
    _, _, _, parent = tree[node]
    while parent != -1:
        index = parent
        assert index != node, "upward path does not include starting node"
        yield index
        _, _, _, parent = tree[index]
