"""The predict kind: batches of buffered tiles through the system's int8
predict step, dispatched ahead and fetched behind by the `predict` tool's
own loop (tools/predict.dispatch_ahead over device.Dispatched handles),
closed loop.

Traffic keys: "batch" (tiles a batch), "tile" and "overlap" (pixels: the
buffered side is tile + 2 overlap), "pool" (distinct batches made from the
seed and cycled), "check_tiles" (tiles the reference recomputes, drawn
from the seed, alternately from each half of a batch).

Set-up: the pool on the device from the seed, 4x4 space-to-depth blocked
as the tool's loader blocks it (the configuration's host_s2d), into pinned
host memory; weights from the seed, with batch-norm statistics recorded
by the reference's float32 forward over the first batch and the
classifier scaled so that its margins have mean 0 and sd 2 there (so that
the bins spread); then the system's step (`make_int8_predict_step`: fold,
calibration on the first batch, quantization) and one pass over the pool.

Window: batches issued until `seconds` have passed, then drained. A tile
is done when its batch's bins are on the host; the rate counts those done
inside the window, the latency every batch issued in it. The first bins
fetched of each pool batch are kept; a later fetch of the same batch that
differs from them is a failed answer.

Check: the reference (portbench/reference/<family>.py) calibrates,
quantizes and predicts the sampled tiles again from the same weights and
pool in plain PyTorch; the numbers are the share of their pixels whose bin
differs from the reference's and the largest difference in bins.
"""

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import gen, weights
from portbench.harness.trace import Trace, span, traced
from portbench.reference import int8 as ref8
from portbench.reference.layers import normalize_s2d4, space_to_depth4


def inputs(ctx):
    """(pool of host batches, params, state), all from the seed."""
    tr, device = ctx.traffic, ctx.device
    side = tr["tile"] + 2 * tr["overlap"]
    params, state = (weights.make(t, ctx.seed, device) for t in ctx.reference.spec())
    pool = []
    for b in range(tr["pool"]):
        fine = gen.aerial_tiles(ctx.seed, "pool{}".format(b), tr["batch"], side, device)
        if b == 0:
            weights.init_statistics(ctx.reference, params, state, fine)
        pool.append(gen.to_host(space_to_depth4(fine), device))
        del fine
    return pool, params, state


def _faulty(step, fault):
    """The step with a planted fault (the tests' and the readings'): "stale"
    answers the first batch's bins every time, "half_batch" leaves the
    second half of each batch's rows at 0, "altered" moves one bin of every
    tile by 7."""
    first = []

    def run(qtree, raw):
        out = step(qtree, raw)
        if fault == "stale":
            first[:1] = first[:1] or [out.clone()]
            return first[0]
        if fault == "half_batch":
            out[out.shape[0] // 2:] = 0
        elif fault == "altered":
            out[:, out.shape[1] // 2, out.shape[2] // 3] += 7
        return out

    return run


def setup(ctx):
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models.registry import get_model
    from robosat_tpu_torch.parallel.steps import make_int8_predict_step
    from robosat_tpu_torch.tools import predict

    configure_device(ctx.device.type == "cuda")
    tr, common = ctx.traffic, ctx.common
    args = SimpleNamespace(strip=1, tile_size=tr["tile"], overlap=tr["overlap"])
    if not (predict.int8_walk(common, get_model(ctx.family_name)) and predict.host_s2d_input(common, args)):
        raise SystemExit("the predict kind drives the int8 walk on host-blocked input")
    pool, params, state = inputs(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    step, qtree = make_int8_predict_step(
        get_model(ctx.family_name), params, state, pool[0], overlap=tr["overlap"],
        fused_head=common.get("fused_head", True), host_s2d=True,
        calib_percentile=q8.calibration_spec(common.get("int8_calibration", 99.8)),
        pallas_tail=common.get("pallas_tail") or None)
    if ctx.fault:
        step = _faulty(step, ctx.fault)
    cell = SimpleNamespace(pool=pool, params=params, state=state, step=step, qtree=qtree, kept={})
    _drive(ctx, cell, until=None)  # every pool batch once: the warm-up
    return cell


class _Handle:
    """A Dispatched handle whose fetch the benchmark spans."""

    def __init__(self, handle):
        self.handle = handle

    def fetch(self):
        with span("fetch"):
            return self.handle.fetch()


def _drive(ctx, cell, until):
    """Batches through dispatch_ahead: the pool once (`until` None), or
    cycled until time.perf_counter() passes `until`. Returns the record."""
    from robosat_tpu_torch.device import Dispatched
    from robosat_tpu_torch.tools.predict import dispatch_ahead

    rec = SimpleNamespace(issued={}, issue_s=[], latency_s=[], done=0, failed=0, batches=0)
    n_pool, batch = len(cell.pool), ctx.traffic["batch"]

    def items():
        i = 0
        while (i < n_pool) if until is None else (time.perf_counter() < until):
            yield i, i % n_pool
            i += 1

    def issue(item):
        t = time.perf_counter()
        with span("issue"):
            raw = cell.pool[item[1]]
            handle = _Handle(Dispatched(cell.step(cell.qtree, raw), keep=raw))
        rec.issued[item[0]] = t
        rec.issue_s.append(time.perf_counter() - t)
        return handle

    def write(item, out):
        t = time.perf_counter()
        rec.batches += 1
        rec.latency_s.append(t - rec.issued.pop(item[0]))
        if until is not None and t <= until:
            rec.done += batch
        with span("check"):
            kept = cell.kept.get(item[1])
            if kept is None:
                cell.kept[item[1]] = np.array(out, copy=True)
            elif not np.array_equal(out, kept):
                rec.failed += 1

    dispatch_ahead(items(), issue, write)
    return rec


# The system's launch counters of its int8 kernels (module, function).
COUNTERS = (("qenc", "bottleneck_block"), ("qenc", "bottleneck_block_s2"), ("qdec", "parity_up_conv"),
            ("qtail", "fused_tail"), ("qconv", "int8_conv"))


def _counters():
    import importlib

    return {"{}.{}".format(m, f): getattr(importlib.import_module("robosat_tpu_torch.models." + m), f).launches
            for m, f in COUNTERS}


def window(ctx, cell):
    before = _counters()
    cell.kept = {}  # the window's own first answers, not the warm-up's
    with traced(ctx.trace, ctx.device) as traced_window:
        start = time.perf_counter()
        rec = _drive(ctx, cell, until=start + ctx.seconds)
    rec.counters = {k: v - before[k] for k, v in _counters().items()}
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    rec.setup_s = start - ctx.t0
    rec.window_s = ctx.seconds
    rec.attempted = rec.batches
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    rec.trace = Trace(traced_window) if traced_window is not None else None
    rec.sites = ctx.work.sites(ctx.traffic["batch"], ctx.traffic["tile"] + 2 * ctx.traffic["overlap"],
                               ctx.traffic["overlap"])
    rec.ctx = ctx
    return rec


def sample(ctx, n_pool):
    """[(pool batch, row)] the check recomputes: drawn from the seed,
    alternately from the first and the second half of a batch."""
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, "check"))
    half = ctx.traffic["batch"] // 2
    picks = []
    for k in range(ctx.traffic["check_tiles"]):
        b = int(rng.integers(n_pool))
        row = int(rng.integers(half)) + (half if k % 2 else 0)
        picks.append((b, row))
    return picks


def reference_bins(ctx, cell, picks, levels=127):
    """The reference's bins of the picked tiles, quantized on `levels`
    steps (127: int8; 7: int4, the control)."""
    fam, quant = ctx.reference, ref8.Quant(levels)
    with torch.no_grad():
        folded = fam.fold(cell.params, cell.state)
        calib = normalize_s2d4(cell.pool[0].to(ctx.device))
        scales = quant.scales(fam.calibrate(folded, calib))
        del calib
        q = fam.quantize(quant, folded)
        x = torch.stack([cell.pool[b][row] for b, row in picks]).to(ctx.device)
        return fam.predict_int8(quant, q, scales, normalize_s2d4(x).to(torch.bfloat16), ctx.traffic["overlap"])


def compare(got, want):
    gaps = ref8.bin_gaps(got, want)
    return {"bins_off_share": float((gaps >= 1).sum()) / gaps.numel(), "max_bin_gap": int(gaps.max())}


def check(ctx, cell, run):
    """Frees the system's state, recomputes the sampled tiles in the
    reference and compares them with the bins the window fetched."""
    cell.step = cell.qtree = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.device.type == "cuda":
        ctx.log("reference: {:.2f} GB held by the system's leftovers".format(torch.cuda.memory_allocated() / 1e9))
    picks = sample(ctx, len(cell.pool))
    missing = [b for b, _ in picks if b not in cell.kept]
    picks = [(b, row) for b, row in picks if b in cell.kept]
    cell.picks = picks
    cell.want = reference_bins(ctx, cell, picks)
    got = torch.from_numpy(np.stack([cell.kept[b][row] for b, row in picks])).to(cell.want.device)
    return compare(got, cell.want), run.failed + len(missing)


def control(ctx, cell):
    """The numbers of the control: the reference on int4's grid in the
    system's place, on the tiles `check` compared."""
    return compare(reference_bins(ctx, cell, cell.picks, levels=7), cell.want)
