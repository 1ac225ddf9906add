"""Joint image + mask augmentation and normalization on the device.

Counterpart of robosat_tpu/ops/augment.py: raw uint8 batches go to the
device, where the flips, rotations and normalization run, so the host only
decodes and assembles batches. The reference's host-side pipeline
(robosat/tools/train.py:246-260: HFlip(0.5), then three Rotation(0.5,
90deg), ToTensor, Normalize) becomes `augment_batch` and `normalize`.

Randomness is explicit: `augment_batch` draws from the torch.Generator it is
given, on the batch's device. It draws other flips and rotations than the
JAX package's `jax.random` stream for the same seed, from the same
distribution.
"""

import functools

import numpy as np
import torch

# ImageNet statistics (robosat/tools/train.py:246).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=None)
def _statistics(mean, std, device):
    """(float64 mean, float32 1 / std) on `device`, copied there once (a
    host -> device copy from pageable memory would wait for the device).
    A trace (torch.export) calls the uncached builder, `__wrapped__`: the
    tensors it makes are the tracer's, and a cached one would reach the
    next trace or an eager call."""
    inv_std = torch.from_numpy(np.float32(1.0) / np.asarray(std, np.float32)).to(device)
    return torch.from_numpy(np.asarray(mean, np.float32)).to(device, torch.float64), inv_std


def normalize(images, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """uint8 NHWC -> normalized float32 NHWC, in the arithmetic XLA compiles
    the JAX package's `(x / 255 - mean) / std` to: both divisions become
    multiplies by float32 reciprocals, and `x * (1/255) - mean` one fused
    multiply-add. The float64 form below rounds that once, as the FMA does
    (u8 * f32 and the difference with the f32 mean are exact in float64)."""
    statistics = _statistics.__wrapped__ if torch.compiler.is_compiling() else _statistics
    mean, inv_std = statistics(tuple(mean), tuple(std), images.device)
    centered = (images.double() * float(np.float32(1.0) / np.float32(255.0)) - mean).float()
    return centered * inv_std


def _rot90(x, k):
    """Rotate the (H, W) axes 1, 2 of a batch by k * 90 degrees CCW (static
    k), as the JAX package's `_rot90_k` rotates one sample."""
    return torch.rot90(x, k, dims=(1, 2)) if k else x


def apply_dihedral(images, masks, flips, rots):
    """Per sample, an optional horizontal flip then `rots` quarter turns
    CCW, applied jointly to NHWC `images` and NHW `masks` (square H == W);
    `flips` (N,) bool and `rots` (N,) int in 0..3. The batched form of the
    JAX package's `_apply_dihedral` under vmap: every candidate is computed
    and each sample selects its own."""

    def select(x):
        shape = (-1,) + (1,) * (x.dim() - 1)
        x = torch.where(flips.view(shape), torch.flip(x, dims=(2,)), x)
        out = x
        for k in (1, 2, 3):
            out = torch.where((rots == k).view(shape), _rot90(x, k), out)
        return out

    return select(images), select(masks)


def augment_batch(generator, images, masks, p_flip=0.5, p_rot=0.5, mesh=None):
    """Joint random horizontal flip and three independent quarter turns, per
    sample: the reference's JointRandomHorizontalFlip(0.5) then three
    JointRandomRotation(0.5, 90) (robosat/tools/train.py:253-256), so the
    rotation count is Binomial(3, 0.5) mod 4. `generator` is a
    torch.Generator on the batch's device. With a `mesh` (parallel/mesh.py)
    the batch is this rank's rows of the global batch: the draws are the
    global batch's and the rank applies its rows' share, the flips and
    turns one process draws for the whole batch from the same generator."""
    n = images.shape[0] * (mesh.size if mesh is not None else 1)
    flips = torch.rand((n,), generator=generator, device=images.device) < p_flip
    rots = (torch.rand((n, 3), generator=generator, device=images.device) < p_rot).sum(dim=1) % 4
    if mesh is not None:
        flips, rots = flips[mesh.rows(n)], rots[mesh.rows(n)]
    return apply_dihedral(images, masks, flips, rots)
