"""The share of the traced window in which no kernel, copy or set runs on
the card: one minus the union of the device's intervals over the window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
