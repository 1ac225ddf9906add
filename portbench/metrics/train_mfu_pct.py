"""The share of the traced window that the images trained in it would take
at the card's bf16 peak, 989 TFLOP/s: three times the forward's float
operations of an image (portbench/work/<family>.py)."""

PEAK_BF16 = 989e12


def read(run):
    if run.trace is None or not run.steps:
        return None
    images = run.steps * run.ctx.traffic["batch"]
    return 100.0 * images * run.train_flops / PEAK_BF16 / run.trace.window_s
