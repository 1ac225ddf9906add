"""Device selection, the device's profiler, and fetches that do not wait.

The model config's `cuda` key (config/model-unet.toml) selects the GPU:
true returns `torch.device("cuda")` and raises if no GPU is present; false
pins the CPU, which is the key's documented meaning and not a fallback.
TF32 is turned off for convolutions and matrix products alike, so float32
calibration runs in full float32 on the card, and cuDNN is held to its
deterministic algorithms: the calibration walk's transposed convolutions
would otherwise sum with atomics, and the same first batch could give other
scales, hence other bins, from one run to the next.
"""

import contextlib

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


def profiler(trace_dir, device):
    """torch.profiler over the loop it wraps when `trace_dir` is set: the
    host's ranges, and on the card its kernels, written to `trace_dir` as a
    trace TensorBoard's profile plugin reads; otherwise no profiler."""
    if not trace_dir:
        return contextlib.nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir))


class Dispatched:
    """A step's output on its way to the host: on the card a copy into
    pinned memory behind a CUDA event, which `fetch` waits for; `keep`
    holds the host input the step's copy may still read until then."""

    def __init__(self, out, keep=None):
        self.keep = keep
        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = out, None

    def fetch(self):
        """The output as a numpy array, once the device is done with it."""
        if self.event is not None:
            self.event.synchronize()
        self.keep = None
        return self.host.numpy()
