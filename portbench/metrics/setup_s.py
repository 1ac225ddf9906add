"""Set-up seconds: process start to the first timed batch or step (the
kernels' build or load, the inputs and weights, calibration,
quantization, warm-up)."""


def read(run):
    return run.setup_s
