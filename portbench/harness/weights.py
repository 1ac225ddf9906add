"""Seeded weights in the system's parameter layout, made on the device.

A family's `spec()` (portbench/reference/<family>.py) gives the trees of
leaves ("conv", HWIO shape), ("ones", n) and ("zeros", n). Every conv
kernel is drawn in one call from a torch.Generator on the device, as
He-normal with fan-out (std sqrt(2 / (kh kw cout)), torchvision's ResNet
init) through one fused multiply of its views; the constants are carved
from one buffer. Leaves are views of those two buffers, each aligned as a
fresh allocation is (CUDA kernels load parameters in vectors).
"""

import numpy as np
import torch

from portbench.reference.layers import normalize
from portbench.reference.train import Recorder, flatten


def sub_seed(seed, purpose):
    """A 63-bit seed for one purpose ("weights", "data", "augment", ...)
    derived from the run's seed, so that purposes draw independently."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, *map(ord, purpose)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _unflatten(tree, leaves):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_unflatten(v, leaves) for v in tree]
    return next(leaves)


def _shape(entry):
    kind, shape = entry
    return tuple(shape) if isinstance(shape, tuple) else (shape,)


ALIGN = 64  # elements: every leaf starts 256 bytes into its buffer, as a fresh allocation would


def _carve(entries, fill):
    """Views of one buffer of fill(n) elements, one per entry, each at an
    aligned offset."""
    sizes = [int(np.prod(_shape(e))) for e in entries]
    padded = [-(-n // ALIGN) * ALIGN for n in sizes]
    buf = fill(sum(padded))
    return [chunk[:n] for chunk, n in zip(torch.split(buf, padded), sizes)]


def make(spec_tree, seed, device):
    """The tree of `spec_tree` with its leaves made from `seed`."""
    entries = [e for _, e in flatten(spec_tree)]
    convs = [e for e in entries if e[0] == "conv"]
    consts = [e for e in entries if e[0] != "conv"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    conv_views = _carve(convs, lambda n: torch.randn(n, generator=gen, device=device))
    if conv_views:
        torch._foreach_mul_(conv_views, [(2.0 / (s[0] * s[1] * s[3])) ** 0.5 for s in map(_shape, convs)])
    const_views = _carve(consts, lambda n: torch.zeros(n, device=device))
    ones = [v for v, e in zip(const_views, consts) if e[0] == "ones"]
    if ones:
        torch._foreach_add_(ones, 1.0)
    conv_views, const_views = iter(conv_views), iter(const_views)
    leaves = [(next(conv_views) if e[0] == "conv" else next(const_views)).view(_shape(e)).detach() for e in entries]
    return _unflatten(spec_tree, iter(leaves))


def init_statistics(reference, params, state, fine):
    """The batch norms' running statistics recorded from the reference's
    float32 forward over the uint8 batch `fine`, and the classifier scaled
    to margins of mean 0 and sd 2 there, so that the bins spread."""
    with torch.no_grad():
        feats, final = reference.head_input(Recorder(), params, state, normalize(fine))
        wd = (final["w"][..., 1] - final["w"][..., 0]).reshape(-1)
        m = feats.float() @ wd
        scale = 2.0 / float(m.std())
        final["w"].mul_(scale)
        final["b"].copy_(torch.tensor([0.0, -float(m.mean()) * scale], device=final["b"].device))
