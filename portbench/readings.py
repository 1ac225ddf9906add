"""The readings that the limits of `correct` are set from, many seeds in one
process (set-up is paid once for the kernels and the interpreter):

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 --seconds 3 \\
        [--control] [--faults stale,half_batch] [--out FILE]

For each seed one line: the system's numbers after a run of `--seconds`
(the lower readings), with `--control` the control's (the reference in
the precision below the configured one, in the system's place), and for
each of `--faults` the numbers of the system with that fault planted
(predict: stale, half_batch, altered; train: no_update, half_batch,
altered). Lines go to standard output and, with `--out`, to FILE. Needs the
card, as run.py does.
"""

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def reading(ctx):
    """(driver's numbers, failed, cell, seconds) of one run."""
    start = time.perf_counter()
    cell = ctx.driver.setup(ctx)
    run = ctx.driver.window(ctx, cell)
    numbers, failed = ctx.driver.check(ctx, cell, run)
    return numbers, failed, cell, time.perf_counter() - start


def main(argv):
    import torch

    from portbench.harness.main import Context

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    try:
        for seed in map(int, args.seeds.split(",")):
            lines = []
            ctx = Context(args.workload, seed, args.seconds, 0, device, time.perf_counter())
            numbers, failed, cell, secs = reading(ctx)
            lines.append({"variant": "system", "numbers": numbers, "failed": failed, "s": secs})
            if args.control:
                start = time.perf_counter()
                lines.append({"variant": "control", "numbers": ctx.driver.control(ctx, cell),
                              "s": time.perf_counter() - start})
            del cell
            torch.cuda.empty_cache()
            for fault in filter(None, args.faults.split(",")):
                fctx = Context(args.workload, seed, args.seconds, 0, device, time.perf_counter(), fault=fault)
                numbers, failed, cell, secs = reading(fctx)
                lines.append({"variant": "fault:" + fault, "numbers": numbers, "failed": failed, "s": secs})
                del cell
                torch.cuda.empty_cache()
            for line in lines:
                line.update(workload=args.workload, seed=seed)
                text = json.dumps(line)
                print(text, flush=True)
                if out:
                    out.write(text + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
