"""Blocked prediction head: margin, sigmoid, exact 256-bin digitize, crop.

Counterpart of the XLA head of robosat_tpu/ops/head.py that the int8
predict path ends in. For a binary model the softmax foreground probability
is sigmoid(l1 - l0), so the final 1x1 conv collapses to a margin dot with
w[:, 1] - w[:, 0]. The head is the plain version of the head pass of the
fused-tail kernel (robosat_tpu_torch/models/qtail.py).
"""

import torch


def _digitize_exact(p):
    """np.digitize(p, linspace(0, 1, 256)) for float32 p in [0, 1] as int32:
    k = rint(p * 255), then three exact comparisons against the anchors
    (k + off) / 255 with IEEE division. The caller's uint8 cast wraps the
    p == 1.0 index 256 to 0 (the reference's quirk)."""
    k = torch.round(p * 255.0)
    # Divide by a tensor, not a Python scalar: CUDA turns division by a host
    # scalar into multiplication by its reciprocal, which is not IEEE `/`.
    denom = torch.tensor(255.0, dtype=torch.float32, device=p.device)
    q = k.to(torch.int32) - 1
    for off in (-1.0, 0.0, 1.0):
        q = q + ((k + off) / denom <= p).to(torch.int32)
    return q


def _to_u8(q):
    """int32 -> uint8 with the modular wrap of the JAX package's cast."""
    return (q & 0xFF).to(torch.uint8)


def fused_prediction_head_s2d_blocked(features, w, b, overlap=0):
    """Parity-blocked decoder features (N, H, W, 4C) -> blocked quantized
    foreground (N, H - overlap, W - overlap, 4) uint8, cropped by overlap/2
    on the blocked grid before the margin."""
    n, h, w_, c4 = features.shape
    cin = c4 // 4
    w2 = w.reshape(cin, -1)
    assert w2.shape[1] == 2, "fused head requires a binary model"
    assert overlap % 2 == 0, "blocked head crops on the coarse grid"
    b2 = b.reshape(2)
    wm = (w2[:, 1] - w2[:, 0]).float()
    bm = (b2[1] - b2[0]).float()
    o = overlap // 2
    if o:
        features = features[:, o:-o, o:-o, :]
    wblock = torch.kron(torch.eye(4, dtype=torch.float32, device=wm.device), wm.reshape(cin, 1))  # (4C, 4)
    margin = features.float() @ wblock + bm
    return _to_u8(_digitize_exact(torch.sigmoid(margin)))
