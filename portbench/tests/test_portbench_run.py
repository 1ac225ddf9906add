"""One run's result line, driven on the CPU at a tiny size (the harness's
look for a card skipped), and the refusal without a card."""

import json
import time

import pytest
import torch

from portbench.harness import main as harness

TINY = {"predict": dict(batch=4, tile=64, overlap=32, pool=2, check_tiles=4),
        "train": dict(batch=2, size=64, pool=4, checked_steps=3)}


def tiny_context(workload, trace=0, fault=None, seed=2**31 + 7, seconds=3.0):
    torch.set_num_threads(2)
    ctx = harness.Context(workload, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), fault=fault)
    ctx.traffic.update(TINY[ctx.traffic["kind"]])
    return ctx


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main(["--workload", "unet-int8-b32", "--seed", "1", "--seconds", "1"], time.perf_counter()) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no CUDA device" in out.err


@pytest.mark.parametrize("workload,trace", [("unet-int8-b32", 0), ("unet-int8-b32", 1), ("unet-train-b64", 0),
                                            ("unet-train-b64", 1)])
def test_the_result_line(workload, trace, capsys):
    ctx = tiny_context(workload, trace)
    result = harness.execute(ctx)
    harness.report(result)
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert ("breakdown" in line) == bool(trace)
    assert set(line["checks"]) == set(ctx.limits)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert out.err.strip().splitlines()[-1].startswith("check failed answers:")
    expected = {m["name"] for m in ctx.metrics}
    if not trace:
        assert set(line["metrics"]) == expected and "setup_s" in expected
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        # On the CPU no kernel runs: the idle share reads 100 and the
        # roofline, which has no kernel time to divide by, is left out.
        assert not {k for k in line["metrics"] if k.endswith("_roofline")}
    assert line["attempted"] >= 1
