"""Device selection.

The model config's `cuda` key (config/model-unet.toml) selects the GPU:
true returns `torch.device("cuda")` and raises if no GPU is present; false
pins the CPU, which is the key's documented meaning and not a fallback.
TF32 is turned off for convolutions and matrix products alike, so float32
calibration runs in full float32 on the card, and cuDNN is held to its
deterministic algorithms: the calibration walk's transposed convolutions
would otherwise sum with atomics, and the same first batch could give other
scales, hence other bins, from one run to the next.
"""

import torch


def configure_device(use_cuda):
    """The torch.device the config's `cuda` flag asks for."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if not use_cuda:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("config sets cuda = true but no CUDA device is available")
    return torch.device("cuda")
