"""One run of one cell: find its pieces by name, drive it, read its metrics,
check its outputs, print one line.

Everything a cell needs is found from BENCHMARK.json by name:

- the configuration's file (`configs[].file`, TOML: the system's [common]
  and [opt] keys as run, and [portbench] with its source and what was
  assumed);
- the traffic mix, `portbench/traffic/<traffic>.json`, whose "kind" names
  its driver, `portbench/drivers/<kind>.py`;
- the family of the configuration's `model` key: its reference,
  `portbench/reference/<family>.py`, and its work counts,
  `portbench/work/<family>.py`;
- each metric's reader, `portbench/metrics/<metric>.py`;
- the limits that decide `correct`, `portbench/checks/<workload>.json`.

A driver's `setup(ctx)` builds the cell (inputs and weights from the seed,
the system's objects, every shape warmed), `window(ctx, cell)` drives it
for `ctx.seconds`, and `check(ctx, cell)` frees the system's state and
compares what the window produced with the reference: it returns the
numbers compared, each of which must not exceed its limit, and the count
of answers that failed outright.
"""

import importlib
import importlib.util
import json
import os
import sys
import tomllib

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "robosat_tpu")


class Context:
    """What a driver gets: the run's arguments, the cell's pieces, the
    device and the start of the process's clock."""

    def __init__(self, workload, seed, seconds, trace, device, t0, fault=None, root=ROOT):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit("unknown workload {!r}; BENCHMARK.json has {}".format(workload, sorted(cells)))
        self.cell = cells[workload]
        self.workload, self.seed, self.seconds, self.trace = workload, int(seed), float(seconds), bool(trace)
        self.device, self.t0, self.fault = device, t0, fault
        config_entry = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        with open(os.path.join(root, config_entry["file"]), "rb") as f:
            self.config = tomllib.load(f)
        self.common, self.opt = self.config["common"], self.config.get("opt", {})
        self.family_name = self.common.get("model", "unet")
        self.traffic = load_json(os.path.join(HERE, "traffic", self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "checks", workload + ".json"))
        self.reference = importlib.import_module("portbench.reference." + self.family_name)
        self.work = importlib.import_module("portbench.work." + self.family_name)
        self.driver = importlib.import_module("portbench.drivers." + self.traffic["kind"])
        trace_key = "per_layer" if self.trace else "end_to_end"
        self.metrics = [m for m in bench[trace_key] if workload in m.get("workloads", [workload])]

    def log(self, message):
        print("portbench: " + message, file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def read_metric(name, run):
    """The reader of metric `name` on the run's record, or None."""
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  os.path.join(HERE, "metrics", name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_record(ctx, run):
    if ctx.device.type == "cuda":
        record = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device), "count": int(ctx.cell["chips"]),
                  "memory_peak_bytes": int(run.memory_peak_bytes)}
    else:
        record = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace is not None:
        record["busy_s"] = run.trace.busy_s
        record["window_s"] = run.trace.window_s
    return record


def execute(ctx):
    """Set up, drive and check one run; returns the result's dict."""
    driver = ctx.driver
    cell = driver.setup(ctx)
    run = driver.window(ctx, cell)
    numbers, failed = driver.check(ctx, cell, run)
    checks = {name: {"value": value, "limit": ctx.limits[name]} for name, value in numbers.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in ctx.metrics:
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(failed), "metrics": metrics,
              "device": device_record(ctx, run)}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result


def main(argv, t0):
    import argparse

    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; this benchmark measures the card and never falls back to the CPU",
              file=sys.stderr)
        return 1
    ctx = Context(args.workload, args.seed, args.seconds, args.trace, torch.device("cuda"), t0)
    if torch.cuda.device_count() < int(ctx.cell["chips"]):
        ctx.log("{} CUDA devices, the cell asks for {}".format(torch.cuda.device_count(), ctx.cell["chips"]))
        return 1
    result = execute(ctx)
    found = forbidden_modules()
    if found:
        ctx.log("refused: loaded modules {} (JAX or the JAX package)".format(", ".join(found)))
        return 1
    report(result)
    return 0


def report(result):
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print("check {}: {!r} (limit {!r})".format(name, c["value"], c["limit"]), file=sys.stderr)
    print("check failed answers: {} of {} attempted; correct: {}".format(result["failed"], result["attempted"],
                                                                       result["correct"]), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
