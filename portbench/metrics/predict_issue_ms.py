"""Mean host milliseconds of one issue: the step's launches and its
pinned copies, by the benchmark's clock around each call."""

import numpy as np


def read(run):
    return float(np.mean(run.issue_s) * 1e3) if run.issue_s else None
