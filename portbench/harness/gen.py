"""The traffic's inputs, made on the device from the seed.

- `aerial_tiles`: RGB tiles of smooth stripes at a random phase per
  channel with Gaussian noise (sd 12), the pattern of the system's chip
  script's generated tiles, drawn per tile.
- `learnable_batches`: uniform noise images with one brightened square blob
  per image (half side size * 10 // 64) as class 1, so that training has
  something to learn.

Every draw comes from a torch.Generator on the device seeded from the run's
seed and the purpose, in a few large calls.
"""

import math

import torch

from portbench.harness.weights import sub_seed


def aerial_tiles(seed, purpose, n, side, device):
    """(n, side, side, 3) uint8 on `device`."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))
    phase = torch.rand((n, 1, 1, 3), generator=gen, device=device) * (2 * math.pi)
    yy, xx = torch.meshgrid(torch.arange(side, device=device, dtype=torch.float32),
                            torch.arange(side, device=device, dtype=torch.float32), indexing="ij")
    c = torch.arange(3, device=device, dtype=torch.float32)
    arg = xx[..., None] / (23 + 7 * c) + yy[..., None] / (31 + 5 * c)
    base = 0.5 + 0.35 * torch.sin(arg[None] + phase)
    noise = torch.randn((n, side, side, 3), generator=gen, device=device) * 12
    return torch.clamp(base * 255 + noise, 0, 255).to(torch.uint8)


def learnable_batches(seed, purpose, count, batch, side, device):
    """`count` (images (batch, side, side, 3) uint8, masks (batch, side,
    side) uint8) pairs on `device`."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))
    half = max(side * 10 // 64, 2)
    yy, xx = torch.meshgrid(torch.arange(side, device=device), torch.arange(side, device=device), indexing="ij")
    out = []
    for _ in range(count):
        images = torch.randint(0, 256, (batch, side, side, 3), generator=gen, device=device, dtype=torch.uint8)
        centers = torch.randint(side // 4, side - side // 4, (batch, 2), generator=gen, device=device)
        blob = ((yy[None] - centers[:, 0, None, None]).abs() < half) & ((xx[None] - centers[:, 1, None, None]).abs()
                                                                         < half)
        bright = torch.clamp(images.int() + 80, 0, 255).to(torch.uint8)
        images = torch.where(blob[..., None], bright, images)
        out.append((images, blob.to(torch.uint8)))
    return out


def to_host(t, device):
    """A made input on the host, pinned where the card copies it from."""
    return t.cpu().pin_memory() if device.type == "cuda" else t.cpu()
