"""On the card (marked `cuda`; skips without one): a short run of each cell
as the driver runs it comes out correct, and the control, the reference
one precision below the configured one in the system's place, fails the
cell's limits at the cell's own size."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_on_the_card_is_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 99),
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_limits_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "portbench/readings.py", "--workload", workload, "--seeds", str(2**31 + 98),
                          "--seconds", "3", "--control"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    limits = json.load(open(os.path.join(ROOT, "portbench", "checks", workload + ".json")))
    control = next(line["numbers"] for line in lines if line["variant"] == "control")
    system = next(line for line in lines if line["variant"] == "system")
    assert system["failed"] == 0 and all(system["numbers"][k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits)
