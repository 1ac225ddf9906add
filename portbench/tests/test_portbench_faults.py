"""The check that decides `correct`, shown to fail: a run driven on the CPU
at a tiny size (the harness's look for a card skipped) with the system's
timed path broken underneath comes out not correct, once for each fault
its cell can have; and the control, the reference one precision below the
configured one in the system's place, fails the cell's limits.
(One-card cells exchange nothing between cards.)"""

import pytest

from portbench.harness import main as harness
from portbench.tests.test_portbench_run import tiny_context

PREDICT = ("unet-int8-b32",)


@pytest.mark.parametrize("workload", PREDICT)
def test_the_unbroken_run_is_correct(workload):
    assert harness.execute(tiny_context(workload))["correct"]


@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered"])
@pytest.mark.parametrize("workload", PREDICT)
def test_a_broken_predict_step_is_not_correct(workload, fault):
    result = harness.execute(tiny_context(workload, fault=fault))
    assert not result["correct"]
    assert result["failed"] == 0  # caught by the reference, not by a missing answer


@pytest.mark.parametrize("workload", PREDICT)
def test_the_int4_control_fails_the_limits(workload):
    ctx = tiny_context(workload)
    cell = ctx.driver.setup(ctx)
    run = ctx.driver.window(ctx, cell)
    ctx.driver.check(ctx, cell, run)
    numbers = ctx.driver.control(ctx, cell)
    assert any(numbers[k] > ctx.limits[k] for k in numbers)


TRAIN = ("unet-train-b64",)


def tiny_train(workload, fault=None):
    """A tiny train run in float32: at 64 px and four images bf16's rounding
    is far from what the cell's limits were set from on the card, while
    float32 meets the float32 reference."""
    ctx = tiny_context(workload, fault=fault, seconds=0.5)
    ctx.common["bf16"] = False
    ctx.traffic["batch"] = 4  # half a batch still normalizes over more than one image
    return ctx


@pytest.mark.parametrize("workload", TRAIN)
def test_the_unbroken_train_run_is_correct(workload):
    assert harness.execute(tiny_train(workload))["correct"]


@pytest.mark.parametrize("fault", ["no_update", "half_batch", "altered"])
@pytest.mark.parametrize("workload", TRAIN)
def test_a_broken_train_step_is_not_correct(workload, fault):
    assert not harness.execute(tiny_train(workload, fault))["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_the_float8_control_is_far_from_the_reference(workload):
    # float8's gap grows with the image: at 256 px it reads 0.01-0.05 on
    # the median gradient, at the cell's 512 px 0.22-0.27 (PERF.md), above
    # the limit; that comparison runs on the card (test_portbench_card.py).
    ctx = tiny_train(workload)
    ctx.traffic.update(batch=2, size=256)
    cell = ctx.driver.setup(ctx)
    run = ctx.driver.window(ctx, cell)
    system, _ = ctx.driver.check(ctx, cell, run)
    assert ctx.driver.control(ctx, cell)["grad_gap"] > 30 * system["grad_gap"]
