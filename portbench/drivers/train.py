"""The train kind: the system's training step (`make_train_step` with the
port's Adam, the configured loss, compute dtype and augmentation), one step
deep as the `train` tool runs it: step k's loss and counts are fetched
into pinned memory behind an event once step k + 1 is issued.

Traffic keys: "batch" (images a step), "size" (pixels), "pool" (distinct
learnable batches made from the seed and cycled), "checked_steps" (the
first steps, which the reference follows).

Set-up: weights from the seed, the step and its optimizer, the pool in
pinned host memory, then the checked steps through the window's own call
and feed on distinct batches. After the first the gradient that Adam got
is read back from its first moment (mu = (1 - b1) g); after the last the
change of every parameter is taken against a copy of the weights made
before the first. That same step object then runs the window.

Window: steps issued until `seconds` have passed; an image is done when
its step's loss is on the host inside the window. A non-finite loss is a
failed answer.

Check: the reference (portbench/reference/train.py with the family's
float32 forward) redoes the checked steps from the seed's weights, batches
and augmentation draws; `compare` gives the numbers. They are taken at the
median parameter, not the worst, and leave the losses out: in bf16 the
early batch norms' gradients and every step's loss carry the configured
precision's own rounding as far as float8 does (PERF.md).
"""

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import gen, weights
from portbench.harness.trace import Trace, span, traced
from portbench.reference import train as ref_train

B1 = 0.9  # Adam's first-moment decay, optax's default, which the configuration keeps


def pool_batches(ctx):
    tr = ctx.traffic
    made = gen.learnable_batches(ctx.seed, "train", tr["pool"], tr["batch"], tr["size"], ctx.device)
    return [(gen.to_host(i, ctx.device), gen.to_host(m, ctx.device)) for i, m in made]


def augment_generator(ctx):
    return torch.Generator(device=ctx.device).manual_seed(weights.sub_seed(ctx.seed, "augment"))


def initial_weights(ctx, pool):
    """(params, state) from the seed, the classifier scaled so that the
    margins of the first batch have sd 2 (`weights.init_statistics`, whose
    batch-norm statistics go to a scratch state: training normalizes by
    the batch): He-initialized full depth starts at logits of ~40, where
    one Adam step moves the loss by a third."""
    params, state = (weights.make(t, ctx.seed, ctx.device) for t in ctx.reference.spec())
    scratch = weights.make(ctx.reference.spec()[1], ctx.seed, ctx.device)
    weights.init_statistics(ctx.reference, params, scratch, pool[0][0].to(ctx.device))
    return params, state


def _faulty(step, optimizer, fault):
    """The step with a planted fault (the tests' and the readings'):
    "no_update" leaves the parameters and the optimizer unchanged,
    "half_batch" trains on the first half of the rows alone, "altered"
    hands the optimizer gradients 10% off."""
    if fault == "no_update":
        optimizer.step = lambda: None
    elif fault == "altered":
        update = optimizer.step

        def step_altered():
            for group in optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is not None:
                        p.grad.mul_(1.1)
            update()

        optimizer.step = step_altered

    def run(params, state, images, masks, generator):
        if fault == "half_batch":
            half = images.shape[0] // 2
            images, masks = images[:half], masks[:half]
        return step(params, state, images, masks, generator)

    return run


def setup(ctx):
    from robosat_tpu_torch.device import Dispatched, configure_device
    from robosat_tpu_torch.models.registry import get_model
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.optim import adam
    from robosat_tpu_torch.parallel.steps import make_train_step

    configure_device(ctx.device.type == "cuda")
    common, opt = ctx.common, ctx.opt
    pool = pool_batches(ctx)
    params, state = initial_weights(ctx, pool)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    named = ref_train.flatten(params)
    start = [p.detach().clone() for _, p in named]
    optimizer = adam(params, opt["lr"])
    step = make_train_step(get_model(ctx.family_name), get_loss(opt["loss"]), optimizer,
                           compute_dtype=torch.bfloat16 if common.get("bf16", False) else torch.float32,
                           augment=common.get("augment", True), remat=common.get("remat", False))
    if ctx.fault:
        step = _faulty(step, optimizer, ctx.fault)
    cell = SimpleNamespace(params=params, state=state, step=step, pool=pool, generator=augment_generator(ctx))

    def issue(i):
        images, masks = pool[i % len(pool)]
        with span("step"):
            cell.state, loss, counts = step(cell.params, cell.state, images, masks, cell.generator)
            return Dispatched(torch.cat([loss.double().view(1), counts.double()]))

    cell.issue = issue
    for i in range(ctx.traffic["checked_steps"]):
        issue(i).fetch()
        if i == 0:
            cell.grads = {path: optimizer.moments(p)[0] / (1 - B1) for path, p in named}
    cell.change = {path: p.detach() - p0 for (path, p), p0 in zip(named, start)}
    del start
    return cell


def window(ctx, cell):
    batch = ctx.traffic["batch"]
    rec = SimpleNamespace(done=0, failed=0, steps=0)
    i = ctx.traffic["checked_steps"]
    with traced(ctx.trace, ctx.device) as traced_window:
        start = time.perf_counter()
        until = start + ctx.seconds
        pending = None
        while True:
            now = time.perf_counter()
            handle = cell.issue(i) if now < until else None
            i += 1
            if pending is not None:
                with span("fetch"):
                    values = pending.fetch()
                rec.steps += 1
                rec.failed += int(not np.isfinite(values[0]))
                if time.perf_counter() <= until:
                    rec.done += batch
            if handle is None:
                break
            pending = handle
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    rec.setup_s = start - ctx.t0
    rec.window_s = ctx.seconds
    rec.attempted = rec.steps
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    rec.trace = Trace(traced_window) if traced_window is not None else None
    rec.train_flops = 3 * ctx.work.train_flops(ctx.traffic["size"])
    rec.ctx = ctx
    return rec


def reference_steps(ctx, ops):
    """(first gradients, changes) of the reference's checked steps with
    `ops` (Float32; Fp8, the control)."""
    pool = pool_batches(ctx)[:ctx.traffic["checked_steps"]]
    params, state = initial_weights(ctx, pool)
    batches = [(i.to(ctx.device), m.to(ctx.device)) for i, m in pool]
    return ref_train.run(ctx.reference, params, state, batches, augment_generator(ctx), ctx.opt["lr"], ops)


def compare(grads, change, ref):
    """The numbers: per parameter the gap between the program's and the
    reference's norms of the first gradient, and of the change over the
    checked steps, each relative to the reference's norm of that parameter
    or the median parameter's, whichever is larger, taken at the median
    parameter. Parameters whose reference gradient is under a thousandth
    of the median's are left out. The losses are not compared (PERF.md:
    no control or fault separates them from bf16's own gap)."""
    ref_grads, ref_change = ref
    g_norm = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    kept = [k for k in ref_grads if g_norm[k] >= 1e-3 * float(np.median(list(g_norm.values())))]

    def median_gap(got, want):
        norms = {k: float(want[k].double().norm()) for k in kept}
        median = float(np.median(list(norms.values())))
        return float(np.median([abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], median)
                                for k in kept]))

    return {"grad_gap": median_gap(grads, ref_grads), "change_gap": median_gap(change, ref_change)}


def check(ctx, cell, run):
    grads, change = cell.grads, cell.change
    cell.params = cell.state = cell.step = cell.issue = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.device.type == "cuda":
        ctx.log("reference: {:.2f} GB held by the system's leftovers".format(torch.cuda.memory_allocated() / 1e9))
    cell.ref = reference_steps(ctx, ref_train.Float32())
    return compare(grads, change, cell.ref), run.failed


def control(ctx, cell):
    """The numbers of the control: the reference's steps in float8 in the
    system's place."""
    return compare(*reference_steps(ctx, ref_train.Fp8()), cell.ref)
