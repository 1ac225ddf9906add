"""Probability quantization for the palette-PNG output contract.

Counterpart of robosat_tpu/ops/quantize.py: foreground probabilities are
digitized against 256 evenly spaced anchors in [0, 1] and cast to uint8, as
the reference robosat stores them (robosat/tools/predict.py:102-103),
including the quirk that p == 1.0 digitizes to index 256, which wraps to
palette index 0. Masks read them back with `anchors[quantized]`. Plain
PyTorch on any device: the unfused head of the predict steps runs it after
the final 1x1 conv.
"""

import functools

import numpy as np
import torch

ANCHORS = np.linspace(0, 1, 256)


@functools.lru_cache(maxsize=None)
def _anchors(device, dtype):
    """The anchors in `dtype` on `device`, copied there once (a host ->
    device copy from pageable memory would wait for the device each step).
    A trace builds its own (`_anchors_on`), as `augment.normalize` does."""
    return torch.from_numpy(ANCHORS).to(device, dtype)


def _anchors_on(device, dtype):
    """`_anchors`, uncached while torch.export or torch.compile traces."""
    return (_anchors.__wrapped__ if torch.compiler.is_compiling() else _anchors)(device, dtype)


def quantize_probs(fg_probs):
    """float probabilities in [0, 1] -> uint8 palette indices: np.digitize
    against the anchors in the probabilities' dtype, which for increasing
    bins is searchsorted(anchors, p, side="right"); the uint8 cast wraps
    256 -> 0."""
    q = torch.searchsorted(_anchors_on(fg_probs.device, fg_probs.dtype), fg_probs.contiguous(), right=True)
    return (q & 0xFF).to(torch.uint8)


def unquantize_probs(quantized):
    """uint8 palette indices -> float32 foreground probabilities."""
    return _anchors_on(quantized.device, torch.float32)[quantized.long()]


def softmax_quantize(logits):
    """NHWC binary logits -> quantized foreground uint8 NHW: a float32
    softmax over the classes, then `quantize_probs` of class 1."""
    probs = torch.softmax(logits.float(), dim=-1)
    return quantize_probs(probs[..., 1])
