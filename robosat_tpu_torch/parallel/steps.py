"""The int8 predict step of the U-Net.

Counterpart of robosat_tpu/parallel/steps.py:make_int8_predict_step in the
one form the port has: 4x4 space-to-depth host-blocked uint8 input, the
fused head, an even overlap and parity-blocked uint8 output. PyTorch runs
eagerly, so the step is a plain function; every int8 site of it is a CUDA
kernel on the GPU (K3/K4 for the 16 bottleneck blocks, K5 for the 5
up-blocks, K6 for dec4 + dec5 + head).
"""

import numpy as np
import torch

from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qtail

# ImageNet statistics (robosat/tools/train.py:246), as in robosat_tpu/ops/augment.py.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(images, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """uint8 NHWC -> normalized float32 NHWC, in the arithmetic XLA compiles
    the JAX package's `(x / 255 - mean) / std` to: both divisions become
    multiplies by float32 reciprocals, and `x * (1/255) - mean` one fused
    multiply-add. The float64 form below rounds that once, as the FMA does
    (u8 * f32 and the difference with the f32 mean are exact in float64)."""
    inv_std = torch.from_numpy(np.float32(1.0) / np.asarray(std, np.float32)).to(images.device)
    mean = torch.from_numpy(np.asarray(mean, np.float32)).to(images.device, torch.float64)
    centered = (images.double() * float(np.float32(1.0) / np.float32(255.0)) - mean).float()
    return centered * inv_std


def _normalize_s2d4(raw48):
    """Normalize 4x4 space-to-depth uint8 input (N, H/4, W/4, 48): channel c
    is fine channel c % 3, so the statistics repeat 16 times (tuple
    repetition, not multiplication)."""
    return normalize(raw48, mean=IMAGENET_MEAN * 16, std=IMAGENET_STD * 16)


def make_int8_predict_step(
    model,
    params,
    state,
    calib_raw,
    overlap=0,
    calib_percentile=None,
    calib_amaxes=None,
):
    """Hybrid-int8 prediction of the U-Net on the device of `params`.

    Folds BN, calibrates per-site activation scales on `calib_raw` (one
    host-blocked uint8 batch (N, H/4, W/4, 48)) and quantizes the weights.
    `calib_amaxes` (a host per-site amax vector) skips calibration and uses
    those exact scales: the QAT contract of the JAX package.

    Returns (step, qtree): step(qtree, raw) -> parity-blocked quantized
    foreground uint8 (N, H/2 - overlap, W/2 - overlap, 4) on the device;
    step(qtree, raw, plain=True) runs the kernels' plain versions instead,
    with the same qtree and scales.
    """
    if overlap % 2:
        raise NotImplementedError("the blocked int8 head crops on the coarse grid: overlap must be even")
    device = params["final"]["w"].device

    def to_device(raw):
        return torch.as_tensor(raw).to(device)

    with torch.no_grad():
        folded = model.fold(params, state)
        if calib_amaxes is None:
            calib_amaxes = q8.calibration_amaxes(
                folded, _normalize_s2d4(to_device(calib_raw)), percentile=calib_percentile
            )
        scales = tuple(q8.scales_from_amaxes(calib_amaxes))
        qtree = q8.quantize_unet_folded(folded)

    def step(qtree, raw, plain=False):
        with torch.no_grad():
            x = _normalize_s2d4(to_device(raw)).to(torch.bfloat16)
            dec3, s4, s5 = q8.apply_features_int8_to_dec3(qtree, scales, x, plain=plain)
            tail = qtail.fused_tail_plain if plain else qtail.fused_tail
            return tail(dec3, qtree["dec4"], s4, qtree["dec5"], s5, qtree["final"]["w"], qtree["final"]["b"], overlap)

    return step, qtree
