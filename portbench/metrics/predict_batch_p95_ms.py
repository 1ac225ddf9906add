"""The 95th percentile, over every batch issued in the window, of the
milliseconds from the start of its issue to the return of its fetch."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latency_s) * 1e3, 95)) if run.latency_s else None
