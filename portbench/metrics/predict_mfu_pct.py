"""The share of the traced window that the tiles predicted in it would
take at the card's peaks: the int8 sites at 1,979 TOP/s, the bf16 stem
and head at 989 TFLOP/s (work from the published shapes,
portbench/work/<family>.py)."""


def read(run):
    if run.trace is None or not run.batches:
        return None
    return 100.0 * run.batches * sum(s.peak_s() for s in run.sites) / run.trace.window_s
