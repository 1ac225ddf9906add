"""Where tier-1's time goes: a pytest plugin and a junit summary.

As a plugin (`PYTHONPATH=tests python -m pytest -p tier1_timing ...` with
TIER1_TIMING_OUT=path), it appends one JSON line per test: its seconds
(setup, call and teardown), and of them the seconds in JAX's tracing and
lowering, in XLA's backend compile (persistent-cache hits included) and
in JAX executions (each blocked until its outputs are ready); the rest is
the test's own work, for a port test mostly the port's torch code.

As a script:

    python tests/tier1_timing.py split OUT.jsonl...    # the plugin's lines, by file
    python tests/tier1_timing.py junit A.xml [B.xml]   # per-file sums, A beside B, the slowest cases of A
    python tests/tier1_timing.py replay A.xml          # A's tests on 6 workers as `--dist loadfile` hands them out

`replay` follows pytest-xdist's file scheduler: files ordered by their
count of tests, most first (ties in collection order), one file to each
worker, and a worker takes the next file when it has two tests or fewer
left. It prints each worker's last files and the makespan beside the
summed time over the workers; the measured wall adds start-up and the
change of load as workers finish.
"""

import collections
import json
import os
import sys
import time

import pytest

_acc = {"trace": 0.0, "compile": 0.0, "run": 0.0, "compiles": 0}
_installed = []


def _install():
    import jax
    from jax._src import dispatch, monitoring
    from jax._src.interpreters import pxla

    def listener(event, duration, **_):
        if event in (dispatch.JAXPR_TRACE_EVENT, dispatch.JAXPR_TO_MLIR_MODULE_EVENT):
            _acc["trace"] += duration
        elif event == dispatch.BACKEND_COMPILE_EVENT:
            _acc["compile"] += duration
            _acc["compiles"] += 1

    monitoring.register_event_duration_secs_listener(listener)
    execute = pxla.ExecuteReplicated.__call__

    def timed(self, *args):
        start = time.perf_counter()
        out = execute(self, *args)
        jax.block_until_ready(out)
        _acc["run"] += time.perf_counter() - start
        return out

    pxla.ExecuteReplicated.__call__ = timed
    _installed.append(True)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if not _installed:
        _install()
    for key in _acc:
        _acc[key] = 0
    start = time.perf_counter()
    yield
    record = dict(id=item.nodeid, seconds=time.perf_counter() - start, **_acc)
    with open(os.environ["TIER1_TIMING_OUT"], "a") as f:
        f.write(json.dumps(record) + "\n")


def _split(paths):
    by_file = collections.defaultdict(collections.Counter)
    for path in paths:
        for line in open(path):
            r = json.loads(line)
            c = by_file[r["id"].split("::")[0]]
            c["tests"] += 1
            for key in ("seconds", "trace", "compile", "run", "compiles"):
                c[key] += r[key]
    print("file | s | JAX trace+lower s | XLA compile s (compiles) | JAX run s | the rest s")
    for name, c in sorted(by_file.items(), key=lambda kv: -kv[1]["seconds"]):
        rest = c["seconds"] - c["trace"] - c["compile"] - c["run"]
        print("{} | {:.1f} | {:.1f} | {:.1f} ({}) | {:.1f} | {:.1f}".format(
            name, c["seconds"], c["trace"], c["compile"], c["compiles"], c["run"], rest))


def _junit(path):
    import xml.etree.ElementTree as ET

    files, cases = collections.Counter(), {}
    for case in ET.parse(path).getroot().iter("testcase"):
        name = "tests/{}.py".format(case.get("classname").split(".")[-1])
        files[name] += float(case.get("time") or 0)
        cases["{}::{}".format(name, case.get("name"))] = float(case.get("time") or 0)
    return files, cases


def _junit_table(paths, slowest=30):
    runs = [_junit(p) for p in paths]
    for p, (files, _) in zip(paths, runs):
        port = sum(v for k, v in files.items() if k.startswith("tests/test_torch_"))
        print("{}: all {:.1f} s, tests/test_torch_*.py {:.1f} s".format(p, sum(files.values()), port))
    names = sorted(set().union(*(f for f, _ in runs)), key=lambda k: -runs[0][0].get(k, 0))
    for name in names:
        print(name, " | ".join("{:.1f}".format(f.get(name, 0.0)) for f, _ in runs))
    print("slowest cases of {}:".format(paths[0]))
    for name, t in sorted(runs[0][1].items(), key=lambda kv: -kv[1])[:slowest]:
        print("{:.1f} {}".format(t, name))


def _replay(paths, workers=6):
    import xml.etree.ElementTree as ET

    files = collections.OrderedDict()
    for case in ET.parse(paths[0]).getroot().iter("testcase"):
        files.setdefault("tests/{}.py".format(case.get("classname").split(".")[-1]), []).append(
            float(case.get("time") or 0))
    queue = collections.deque(sorted(sorted(files), key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    started = [[] for _ in range(workers)]
    clock = [0.0] * workers

    def assign(w):
        if queue:
            name = queue.popleft()
            started[w].append((name, clock[w]))
            pending[w].extend(files[name])

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        w = min((i for i in range(workers) if pending[i]), key=lambda i: clock[i])
        clock[w] += pending[w].popleft()
        if len(pending[w]) <= 2:
            assign(w)
    for w in range(workers):
        print("worker {} ends at {:.0f} s; its last files (start s): {}".format(
            w, clock[w], ", ".join("{} {:.0f}".format(n, t) for n, t in started[w][-3:])))
    total = sum(sum(v) for v in files.values())
    print("makespan {:.0f} s, summed time over {} workers {:.0f} s".format(max(clock), workers, total / workers))


if __name__ == "__main__":
    import signal

    signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # quiet under `| head`
    {"split": _split, "junit": _junit_table, "replay": _replay}[sys.argv[1]](sys.argv[2:])
