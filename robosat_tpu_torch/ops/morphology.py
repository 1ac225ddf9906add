"""Binary morphology (erode/dilate/open/close) as batched convolutions.

Counterpart of robosat_tpu/ops/morphology.py, whose XLA convolution becomes
`F.conv2d` on the tensor's own device (no Pallas kernel lies on this path):
binary masks become (N, 1, H, W) float32 tensors, are padded with the border
value and correlated with the structuring element, and the window sums are
thresholded back to uint8. A whole chunk of tiles' denoise+grow runs as one
batch.

Semantics are bit-exact with cv2 (held in tests/test_torch_port_morphology.py):
- window alignment: dst(y, x) = op over SE(y', x') of
  src(y + y' - kh//2, x + x' - kw//2)   [cv2's anchor for even kernels]
- borders: erosion pads with 1 (BORDER_CONSTANT +inf), dilation with 0.
The window sums are integers of at most 441 (a 21 x 21 element), exact in
float32 whatever the summation order, and each threshold sits half a unit
from the nearest sum.
"""

import numpy as np
import torch
import torch.nn.functional as F


def ellipse_kernel(size):
    """cv2.getStructuringElement(MORPH_ELLIPSE, (size, size)) equivalent.

    cv2 draws the inscribed ellipse row by row: for each row the horizontal
    extent is derived from the ellipse equation at the row's dy; replicated
    here exactly (validated against cv2 in tests).
    """
    r = size // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((size, size), np.uint8)
    for i in range(size):
        j1, j2 = 0, 0
        dy = i - r
        if abs(dy) <= r:
            dx = int(round(r * np.sqrt(max(r * r - dy * dy, 0) * inv_r2)))
            j1 = max(r - dx, 0)
            j2 = min(r + dx + 1, size)
            kernel[i, j1:j2] = 1
    return kernel


def _correlate(masks, kernel, pad_value):
    """Batched valid correlation of NHW binary masks with an HW kernel."""
    kh, kw = kernel.shape
    top, left = kh // 2, kw // 2
    bottom, right = kh - 1 - top, kw - 1 - left

    x = masks.to(torch.float32)[:, None]  # NCHW, C=1
    x = F.pad(x, (left, right, top, bottom), value=pad_value)
    k = torch.as_tensor(np.asarray(kernel), dtype=torch.float32, device=masks.device)[None, None]  # OIHW
    return F.conv2d(x, k)[:, 0]


def dilate(masks, kernel):
    """Binary dilation of NHW masks; returns uint8 NHW."""
    return (_correlate(masks, kernel, 0.0) > 0.5).to(torch.uint8)


def erode(masks, kernel):
    """Binary erosion of NHW masks; returns uint8 NHW."""
    total = float(np.sum(kernel))
    return (_correlate(masks, kernel, 1.0) > total - 0.5).to(torch.uint8)


def opening(masks, kernel):
    """Morphological opening (erode then dilate) — the reference's `denoise`."""
    return dilate(erode(masks, kernel), kernel)


def closing(masks, kernel):
    """Morphological closing (dilate then erode) — the reference's `grow`."""
    return erode(dilate(masks, kernel), kernel)


def denoise_grow(masks, denoise_size, grow_size):
    """Fused denoise (open) + grow (close) over a batch of binary masks.

    The per-tile cv2 pipeline of robosat/features/parking.py:26-27 over an
    NHW tensor, on the tensor's device; returns uint8 NHW there.
    """
    masks = (masks > 0).to(torch.uint8)
    opened = opening(masks, ellipse_kernel(denoise_size))
    return closing(opened, ellipse_kernel(grow_size))
