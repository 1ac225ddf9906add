"""The int8 convolutions' share of their roofline: the sum over the
batches of the traced window of each int8 unit's bound, max(operations /
1,979 TOP/s, bytes / 3.35 TB/s) from the published shapes
(portbench/work/<family>.py), over the device seconds of the kernels that
ran them, matched by name. It prints the matched launches per batch beside
the system's launch counters."""

import sys

KERNELS = r"conv_kernel|up_kernel|tail_kernel"


def read(run):
    if run.trace is None or not run.batches:
        return None
    seconds, launches = run.trace.device_seconds(KERNELS)
    counters = ", ".join("{} {:g}".format(k, v / run.batches) for k, v in sorted(run.counters.items()))
    print("portbench: int8_conv_roofline matched {:g} launches a batch ({}); counters a batch: {}".format(
        launches / run.batches, KERNELS, counters), file=sys.stderr)
    if not seconds:
        return None
    bound = sum(s.bound_s() for s in run.sites if s.kind == "int8")
    return 100.0 * run.batches * bound / seconds
