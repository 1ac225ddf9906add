#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            (from the repository root; one GPU)

Drives robosat_tpu_torch's `predict` (the U-Net of config/model-unet.toml)
on the card along five paths, runs the two probe kernels, and checks each
hand-written kernel against its plain PyTorch version:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the CUDA kernels from robosat_tpu_torch/csrc;
3. each kernel against its plain version at main-path shapes (batch 8 at
   576 px buffered tiles, weights and scales of the calibrated model):
   K3 at one block of every stage (layer1.0 with its projection, layer1.1,
   layer2.1, layer3.1, layer4.1), K4 at the first block of layers 2-4, K5
   at its five up-blocks (center, dec0-dec3), K7/K8/K9, bit-equal in bf16, the
   uint8 of K6 and of K1 (G = 1, 4 and 16 groups, f32 and bf16 features)
   equal up to counted +-1-bin flips, K6, K7 and K9 with their counts of
   skipped weight blocks; kernel and plain times from CUDA events with the
   inputs rotated through copies larger than the 50 MB L2 (as in phase 4),
   and beside each kernel time its device-only time from torch.profiler's
   kernel rows and its TOP/s against the 1,979 TOP/s int8 peak;
4. the probes path: K2 (int8 matmul + requantize) in both orientations at
   the 8 contractions of benchmarks/bench_pallas_mm.py, bit-equal to its
   plain version, its int32 accumulators equal to `torch._int_mm`'s; K10's
   12 head-stage rungs at the bisect script's (1, 8, 288, 128) and at a full
   dec5 batch (8, 288, 288, 128), against the plain rungs (bit-equal up to
   the margins, the sigmoid within 4 ulps, uint8 up to counted +-1 flips);
   launches counted over one pass (K2 16, K10 24, every other kernel 0),
   kernel, plain and `_int_mm` times from CUDA events, and K2's device-only
   time from torch.profiler with its GB/s, TOP/s and share of its bound;
5. `predict.main` in-process on a generated 512-px slippy-map directory
   with a random-weight full-width U-Net checkpoint, once per path (the
   config as it is, int8; a copy with `pallas_tail = "tail"`; one with
   `"sep"`; one with `fused_head = false`, int8; one with `int8 = false`,
   bf16): one decodable palette PNG per tile, each kernel's launch counter
   per batch (13 K3, 3 K4, 5 K5, 1 K6; 13 K3, 3 K4, 5 K5, 1 K7, 1 K1;
   13 K3, 3 K4, 4 K5, 1 K8, 1 K9, 1 K1; 13 K3, 3 K4, 5 K5, 1 K7; 1 K1; 0
   for every other kernel), the "tail" and "sep" PNGs against the int8
   run's up to counted +-1 flips (the unfused head's are only counted),
   one batch's uint8 against the plain path with the same weights and
   scales, and a torch.profiler split of one step's device time: the int8
   convs summed (it fails if one runs outside csrc/int8_conv_sm90.cuh's
   rs::sm90 kernels) and, by kernel name, tail_kernel (K6, K7, K9),
   up_kernel (K5 storing NHWC, K8 parity planes; it fails unless the
   launches are the path's K5 + K8) and K4's blocks (each stride-2 conv2
   with the conv launched before it and the two after it).

`python3 chip_smoke.py --k2 [--tree DIR]` runs phases 1-2 and K2's part of
phase 4 only, on the robosat_tpu_torch of checkout DIR (default: this one),
so that two versions of K2 can be timed on one card, one after the other.

Each kernel's line also carries its bound: the least time the card could
take for the same work, max(bytes / 3.35 TB/s, operations / peak) with each
input read once and each output written once (int8 ops at 1,979 TOP/s, f32
at 67 TFLOP/s; NVIDIA's H100 SXM data sheet), computed from this run's
inputs. Prints a JSON line of per-kernel results, the nvidia-smi line, and
last `{"ok": true, "device": {...}}`. Any failed check raises (non-zero
exit); without a GPU, or outside the repository, it exits non-zero and
prints no result.
"""

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 8
TILE = 512
OVERLAP = 32
TILES_SIDE = 8  # an 8 x 8 block of tiles: 64 tiles, 8 batches
MAX_FLIP_SHARE = 0.001
SIGMOID_ULPS = 4
SEED = 0  # of the weights and the imagery
# H100 SXM peaks (NVIDIA's data sheet, dense): device memory, int8 tensor
# cores, float32 outside the tensor cores.
PEAK = {"bytes": 3.35e12, "int8": 1979e12, "f32": 67e12}
ROTATE_BYTES = 150e6  # inputs rotated through copies of at least this many bytes (3x the L2)

# Each kernel: its source, and the pallas_call of the TPU kernel it replaces.
SOURCES = {
    "K1": ("robosat_tpu_torch/csrc/head.cu", "robosat_tpu/ops/head.py:278"),
    "K2": ("robosat_tpu_torch/csrc/int8_mm.cu", "benchmarks/bench_pallas_mm.py:76"),
    "K3": ("robosat_tpu_torch/csrc/qenc.cu", "robosat_tpu/models/qenc.py:203"),
    "K4": ("robosat_tpu_torch/csrc/qenc.cu", "robosat_tpu/models/qenc.py:340"),
    "K5": ("robosat_tpu_torch/csrc/qdec.cu", "robosat_tpu/models/qdec.py:273"),
    "K6": ("robosat_tpu_torch/csrc/qtail.cu", "robosat_tpu/models/qtail.py:426"),
    "K7": ("robosat_tpu_torch/csrc/qtail.cu", "robosat_tpu/models/qtail.py:204"),
    "K8": ("robosat_tpu_torch/csrc/qdec.cu", "robosat_tpu/models/qdec.py:222"),
    "K9": ("robosat_tpu_torch/csrc/qtail.cu", "robosat_tpu/models/qtail.py:358"),
    "K10": ("robosat_tpu_torch/csrc/head_rungs.cu", "benchmarks/bisect_mosaic_head.py:108"),
}
ENCODER = {"K3": 13, "K4": 3}
# Substrings of the port's kernel names in torch.profiler's rows.
KERNEL_ROWS = ("conv_kernel", "tail_kernel", "up_kernel", "margin_head_kernel", "int8_mm_kernel", "head_rung_kernel")
# An int8 conv kernel by name (any *conv_kernel, tail_kernel, up_kernel);
# every one must be an instance of csrc/int8_conv_sm90.cuh's, in rs::sm90.
INT8_CONV = re.compile(r"\b(\w*conv_kernel|tail_kernel|up_kernel)\b")
SM90 = "rs::sm90::"
# up_kernel's instances by output layout (template argument): K5 NHWC, K8 planes.
UP_KERNELS = (("K5", re.compile(r"rs::sm90::up_kernel<\d+, 0>")), ("K8", re.compile(r"rs::sm90::up_kernel<\d+, 1>")))
# K4's conv2: conv_kernel<BN, int8 input, EPI_RELU_Q8, stride 2>; a K4 block
# launches conv1, conv2, the projection, conv3 in that order.
K4_CONV2 = re.compile(r"rs::sm90::conv_kernel<\d+, false, 3, 2>")
# The predict paths: label, model TOML keys over config/model-unet.toml,
# launches per batch of each kernel (every other kernel: 0).
PATHS = (
    ("int8", {}, {**ENCODER, "K5": 5, "K6": 1}),
    ("int8-tail", {"pallas_tail": "tail"}, {**ENCODER, "K5": 5, "K7": 1, "K1": 1}),
    ("int8-sep", {"pallas_tail": "sep"}, {**ENCODER, "K5": 4, "K8": 1, "K9": 1, "K1": 1}),
    ("int8-unfused", {"fused_head": False}, {**ENCODER, "K5": 5, "K7": 1}),
    ("bf16", {"int8": False, "bf16": True}, {"K1": 1}),
)


def log(*parts):
    print(*parts, flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--k2", action="store_true",
                        help="only phases 1, 2 and K2's part of phase 4 (bit-equality, events and device times)")
    parser.add_argument("--tree", default=ROOT,
                        help="with --k2: the checkout whose robosat_tpu_torch to build and time (default: this one)")
    opts = parser.parse_args()
    root = os.path.abspath(opts.tree if opts.k2 else ROOT)
    if not os.path.isdir(os.path.join(root, "robosat_tpu_torch", "csrc")):
        sys.exit("chip_smoke.py must run from a checkout of the repository (robosat_tpu_torch/ not found)")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA GPU (torch.cuda.is_available() is false)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log("phase 1: card {} | torch {} | CUDA {} | {} device(s)".format(
        smi, torch.__version__, torch.version.cuda, torch.cuda.device_count()))

    from robosat_tpu_torch import kernels

    start = time.perf_counter()
    kernels.library()
    log("phase 2: kernels built and loaded in {:.1f} s (nvcc {}) -> {}".format(
        time.perf_counter() - start,
        "skipped, cached" if kernels.build_seconds is None else "{:.1f} s".format(kernels.build_seconds),
        os.path.relpath(kernels.library_path(), root)))

    if opts.k2:
        from robosat_tpu_torch.ops import int8_mm

        device = torch.device("cuda")
        per_kernel = {}
        k2 = k2_operands(torch, device, torch.Generator(device=device).manual_seed(SEED + 1), int8_mm)
        int8_mm.int8_matmul_requant.launches = 0
        with torch.no_grad():
            k2_out = [int8_mm.int8_matmul_requant(*args, orient) for _, orient, args in k2]
        torch.cuda.synchronize()
        if int8_mm.int8_matmul_requant.launches != len(k2):
            raise AssertionError("K2: {} launches, expected {}".format(int8_mm.int8_matmul_requant.launches, len(k2)))
        check_and_time_k2(torch, int8_mm, k2, k2_out, per_kernel, smi)
        log(json.dumps({"K2": per_kernel["K2"], "tree": root}))
        log(smi)
        return

    with tempfile.TemporaryDirectory(prefix="rs_chip_smoke_") as work:
        results = run(torch, work, SEED, smi)

    log(json.dumps({"kernels": results}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def u8_flips(torch, got, ref):
    """(count of differing bins, largest bin distance modulo 256)."""
    d = (got.int() - ref.int()) % 256
    d = torch.minimum(d, 256 - d)
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def cuda_ms(torch, fn, arg_sets, reps):
    """Mean milliseconds of fn(*args) over `reps` runs that cycle through
    `arg_sets` (copies of the same inputs, so a run finds its inputs out of
    L2, as the main path would), after one warm-up, by CUDA events."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, arg_sets, reps):
    """Mean device milliseconds per fn(*args) of the port's kernels only
    (torch.profiler's kernel rows; the wrapper's host work and PyTorch's own
    small kernels excluded), over `reps` runs cycling through `arg_sets`;
    None when the profiler records no kernel time."""
    from torch.profiler import ProfilerActivity, profile

    fn(*arg_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    us = sum(k.self_device_time_total for k in prof.key_averages()
             if k.device_type == torch.autograd.DeviceType.CUDA and any(r in k.key for r in KERNEL_ROWS))
    return us / 1e3 / reps if us > 0 else None


def rotated(torch, args):
    """`args` and enough copies of its tensors that one cycle through them
    holds at least ROTATE_BYTES."""
    size = nbytes(*(a for a in args if torch.is_tensor(a)))
    copies = max(1, math.ceil(ROTATE_BYTES / max(size, 1)))
    return [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args) for _ in range(copies - 1)]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved, ops, op_type):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `bytes_moved` and do `ops` operations of `op_type`."""
    t_bytes = bytes_moved / PEAK["bytes"]
    t_ops = ops / PEAK[op_type]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def site_work(name, kargs, out):
    """(bytes, operations, operation type) of a phase-3 kernel call: the
    activations and int8 weights read once, the output written once, two
    operations per multiply-accumulate (K5/K8: four 2x2-tap parity convs,
    16 taps per coarse pixel; K6/K7/K9: dec4 the same way, then dec5 at the
    fine grid; K1: a multiply and an add per feature)."""
    x = kargs[0]
    io = nbytes(x, out)
    if name in ("K3", "K4"):
        qb, stride = kargs[1], 2 if name == "K4" else 1
        n, h, w, cin = x.shape
        cmid, cout = qb["conv1"]["wq"].shape[-1], qb["conv3"]["wq"].shape[-1]
        lo = n * (h // stride) * (w // stride)
        macs = n * h * w * cin * cmid + lo * (9 * cmid * cmid + cmid * cout + (cin * cout if "down_conv" in qb else 0))
        return io + nbytes(*(node["wq"] for node in qb.values())), 2 * macs, "int8"
    if name in ("K5", "K8"):
        node = kargs[1]
        return io + nbytes(node["wq"]), 2 * x.numel() * 16 * node["wq"].shape[-1], "int8"
    if name in ("K6", "K7", "K9"):
        # The work the function needs, not that of the s2d weights' dense
        # 3x3 128 -> 128 form: dec4, nearest-up x2 then 3x3 cin -> c, as four
        # 2x2-tap parity convs per coarse pixel; dec5, 3x3 c -> c per fine pixel.
        coarse = x.numel() // 128  # pixels of the 2x2 s2d grid (K9's planes hold four per plane pixel)
        cin, c = kargs[1]["wq"].shape[-2], kargs[3]["wq"].shape[-1] // 4
        macs = coarse * (16 * cin * c + 4 * 9 * c * c)
        return io + nbytes(kargs[1]["wq"], kargs[3]["wq"]), 2 * macs, "int8"
    return io + 33 * 4, 2 * x.numel(), "f32"  # K1


def record(per_kernel, name, site, shape, err, ms, plain_ms, work, library_ms=None, **extra):
    """Add one site's numbers to kernel `name`'s entry; returns its bound."""
    bound_ms, bound_by = bound(*work)
    entry = per_kernel.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                         "bound_by": None, "library_ms": None, "sites": []})
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["ms"] += ms
    entry["plain_ms"] += plain_ms
    entry["bound_ms"] += bound_ms
    if library_ms is not None:
        entry["library_ms"] = (entry["library_ms"] or 0.0) + library_ms
    entry["sites"].append({"site": site, "shape": list(shape), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": library_ms, "max_abs_err": err, **extra})
    entry["bound_by"] = max(entry["sites"], key=lambda e: e["bound_ms"])["bound_by"]
    return bound_ms, bound_by


def log_step_profile(torch, step, label, per_batch, steps=5, top=8):
    """Where one step's device time goes: torch.profiler's CUDA kernel rows
    over `steps` steps, against their wall time (host clock, synchronized),
    and the int8 convs' time summed; raises if an int8 conv ran outside
    rs::sm90 or if up_kernel's launches per step are not the path's K5 + K8
    (`per_batch`)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / steps
    rows = [(k.self_device_time_total / 1e3 / steps, k.count // steps, k.key) for k in prof.key_averages()
            if k.device_type == torch.autograd.DeviceType.CUDA and k.self_device_time_total > 0]
    rows.sort(reverse=True)
    if not rows:
        log("phase 5: [{}] profile of the step: the profiler recorded no kernel time (device split not measured)"
            .format(label))
        return
    busy = sum(r[0] for r in rows)
    log("phase 5: [{}] profile of the step: {:.2f} ms wall (profiled), {:.2f} ms of kernels, device idle {:.1%}"
        .format(label, wall_ms, busy, 1 - busy / wall_ms))
    for ms, count, key in rows[:top]:
        log("phase 5: [{}]   {:8.3f} ms/step {:4d} launches  {}".format(label, ms, count, key[:100]))
    convs = [r for r in rows if INT8_CONV.search(r[2])]
    outside = [r[2] for r in convs if SM90 not in r[2]]
    if outside:
        raise AssertionError("[{}] int8 convs outside {}: {}".format(label, SM90, outside))
    log("phase 5: [{}]   int8 convs, all on int8_conv_sm90.cuh ({}): {:.3f} ms/step, {} launches, {} kernels".format(
        label, SM90, sum(r[0] for r in convs), sum(r[1] for r in convs), len(convs)))
    mine = [r for r in rows if SM90 + "tail_kernel" in r[2]]
    if mine:
        log("phase 5: [{}]   K6/K7/K9 by kernel name (tail_kernel): {:.3f} ms/step, {} launches".format(
            label, sum(r[0] for r in mine), sum(r[1] for r in mine)))
    for name, pattern in UP_KERNELS:
        mine = [r for r in rows if pattern.search(r[2])]
        if sum(r[1] for r in mine) != per_batch.get(name, 0):
            raise AssertionError("[{}] {} up_kernel launches per step, expected {}".format(
                label, sum(r[1] for r in mine), per_batch.get(name, 0)))
        if mine:
            log("phase 5: [{}]   {} by kernel name (up_kernel, {}): {:.3f} ms/step, {} launches".format(
                label, name, "parity planes" if name == "K8" else "NHWC", sum(r[0] for r in mine),
                sum(r[1] for r in mine)))
    # K4 by kernel name and launch order: the convs in the order they ran.
    convs = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                    and "rs::sm90::conv_kernel" in e.name), key=lambda e: e.time_range.start)
    blocks = [convs[i - 1:i + 3] for i, e in enumerate(convs) if i >= 1 and K4_CONV2.search(e.name)]
    if blocks:
        log("phase 5: [{}]   K4 by kernel name (conv1, stride-2 conv2, stride-2 projection, conv3): {:.3f} ms/step, "
            "{} blocks, {} launches".format(label, sum(e.time_range.elapsed_us() for b in blocks for e in b) / 1e3 / steps,
                                            len(blocks) // steps, sum(map(len, blocks)) // steps))


def write_tiles(root, seed):
    """A deterministic TILES_SIDE x TILES_SIDE block of 512-px RGB tiles at z18."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:TILE, 0:TILE].astype(np.float32)
    tiles = []
    for i in range(TILES_SIDE):
        for j in range(TILES_SIDE):
            x, y, z = 69620 + i, 104940 + j, 18
            phase = rng.uniform(0, 2 * np.pi, 3)
            base = 0.5 + 0.35 * np.stack([np.sin(xx / (23 + 7 * c) + yy / (31 + 5 * c) + phase[c]) for c in range(3)], -1)
            img = np.clip(base * 255 + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
            path = os.path.join(root, str(z), str(x))
            os.makedirs(path, exist_ok=True)
            Image.fromarray(img).save(os.path.join(path, "{}.png".format(y)), compress_level=1)
            tiles.append((x, y, z))
    return tiles


def wrappers():
    """Each kernel's wrapper, whose `.launches` counts its launches."""
    from robosat_tpu_torch.models import qdec, qenc, qtail
    from robosat_tpu_torch.ops import head, head_rungs, int8_mm

    return {"K1": head.margin_head, "K2": int8_mm.int8_matmul_requant, "K3": qenc.bottleneck_block,
            "K4": qenc.bottleneck_block_s2, "K5": qdec.parity_up_conv, "K6": qtail.fused_tail,
            "K7": qtail.fused_tail_features, "K8": qdec.parity_up_conv_separated,
            "K9": qtail.fused_tail_features_sep, "K10": head_rungs.head_rung}


def fine_u8(out):
    """A step's uint8 (fine, blocked (..., 4) or doubly blocked (..., 16)) as fine tiles on the host."""
    from robosat_tpu_torch.models.layers import depth_to_space2

    q = out.cpu().numpy()
    if q.ndim == 3:
        return q
    if q.shape[-1] == 16:
        q = depth_to_space2(q)
    return depth_to_space2(q)[..., 0]


def read_pngs(probs, tiles):
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(probs, str(z), str(x), "{}.png".format(y))))
                     for (x, y, z) in tiles])


def run(torch, work, seed, smi):
    from PIL import Image

    from robosat_tpu_torch.checkpoint import load_model_checkpoint, save_checkpoint, to_jax
    from robosat_tpu_torch.config import load_config, save_config
    from robosat_tpu_torch.data.datasets import BufferedSlippyMapDirectory
    from robosat_tpu_torch.data.loader import batches
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models import qdec, qenc, qtail, unet
    from robosat_tpu_torch.models.layers import space_to_depth4
    from robosat_tpu_torch.ops import head
    from robosat_tpu_torch.parallel.steps import _normalize_s2d4, make_int8_predict_step, make_predict_step
    from robosat_tpu_torch.tools import predict

    device = configure_device(True)
    tiles_dir = os.path.join(work, "tiles")
    tiles = write_tiles(tiles_dir, seed)
    params, state = unet.init(seed, num_classes=2)
    checkpoint = os.path.join(work, "unet.npz")
    save_checkpoint(checkpoint, {"params": to_jax(params), "state": to_jax(state)}, meta={"epoch": 0})

    # The first loader batch, exactly as predict builds it.
    directory = BufferedSlippyMapDirectory(
        tiles_dir, size=TILE, overlap=OVERLAP, transform=lambda im: space_to_depth4(im[None])[0]
    )
    first = next(iter(batches(directory, BATCH, workers=2)))
    raw48 = first.arrays[0]
    if raw48.shape != (BATCH, (TILE + 2 * OVERLAP) // 4, (TILE + 2 * OVERLAP) // 4, 48):
        raise AssertionError("first batch has shape {}".format(raw48.shape))

    # ---- phase 3: kernels vs plain versions at main-path shapes ----------
    params_d, state_d, _ = load_model_checkpoint(checkpoint, device=device)
    with torch.no_grad():
        folded = unet.fold(params_d, state_d)
        x48 = _normalize_s2d4(torch.as_tensor(raw48).to(device))
        amaxes = q8.calibration_amaxes(folded, x48, percentile=99.8)
        if not torch.equal(amaxes, q8.calibration_amaxes(folded, x48, percentile=99.8)):
            raise AssertionError("calibration is not reproducible on the card")
        del x48
        log("phase 3: float32 calibration of {} sites is reproducible".format(len(amaxes)))
        scales = q8.scales_from_amaxes(amaxes)
        qtree = q8.quantize_unet_folded(folded)
    enc = qtree["encoder"]
    w_final, b_final = qtree["final"]["w"], qtree["final"]["b"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def act(shape, site, dtype=torch.bfloat16):
        """Relu'd activations spanning site `site`'s int8 range."""
        x = torch.randn(shape, generator=gen, device=device).relu_() * float(amaxes[site] / 3.0)
        return x.to(dtype)

    def block_scales(first_site, down):
        return [float(s) for s in scales[first_site:first_site + (4 if down else 3)]]

    n, side = BATCH, (TILE + 2 * OVERLAP) // 4  # 144: the stem's output grid
    s3, s4, s5 = (float(s) for s in scales[56:59])  # dec3, dec4, dec5
    # (name, site, kernel, plain, args, bit-equal?)
    # K3 at one block of each stage: (stage, block, its first site, its input grid and channels)
    k3_sites = (("layer1", 0, 0, side, 64), ("layer1", 1, 4, side, 256), ("layer2", 1, 14, side // 2, 512),
                ("layer3", 1, 27, side // 4, 1024), ("layer4", 1, 46, side // 8, 2048))
    # K4 at the first block of layers 2-4 and K5 at every up-block: (name, first site, input grid and channels)
    k4_sites = (("layer2", 10, side, 256), ("layer3", 23, side // 2, 512), ("layer4", 42, side // 4, 1024))
    k5_sites = (("center", 52, side // 16, 2048), ("dec0", 53, side // 8, 2304), ("dec1", 54, side // 4, 1280),
                ("dec2", 55, side // 2, 768), ("dec3", 56, side, 320))
    checks = [
        ("K3", "{}.{} ({})".format(stage, bi, "projection" if bi == 0 else "identity"), qenc.bottleneck_block,
         qenc.bottleneck_block_plain, (act((n, grid, grid, cin), site), enc[stage][bi], *block_scales(site, bi == 0)),
         True)
        for stage, bi, site, grid, cin in k3_sites
    ] + [
        ("K4", "{}.0".format(stage), qenc.bottleneck_block_s2, qenc.bottleneck_block_s2_plain,
         (act((n, grid, grid, cin), site), enc[stage][0], *block_scales(site, True)), True)
        for stage, site, grid, cin in k4_sites
    ] + [
        ("K5", name, qdec.parity_up_conv, qdec.parity_up_conv_plain,
         (act((n, grid, grid, cin), site), qtree[name], float(scales[site])), True)
        for name, site, grid, cin in k5_sites
    ] + [
        ("K6", "dec3 -> head", qtail.fused_tail, qtail.fused_tail_plain,
         (act((n, 2 * side, 2 * side, 128), 57), qtree["dec4"], s4, qtree["dec5"], s5, w_final, b_final, OVERLAP),
         False),
        ("K7", "dec4 + dec5", qtail.fused_tail_features, qtail.fused_tail_features_plain,
         (act((n, 2 * side, 2 * side, 128), 57), qtree["dec4"], s4, qtree["dec5"], s5), True),
        ("K8", "dec3 (separated)", qdec.parity_up_conv_separated, qdec.parity_up_conv_separated_plain,
         (act((n, side, side, 320), 56), qtree["dec3"], s3), True),
        ("K9", "dec4 + dec5 (planes)", qtail.fused_tail_features_sep, qtail.fused_tail_features_sep_plain,
         (act((n, side, side, 512), 57), qtree["dec4"], s4, qtree["dec5"], s5), True),
    ]
    # K1 on dec5-like features (relu'd, unit scale) of each layout and dtype.
    for groups, grid in ((1, 4 * side), (4, 2 * side), (16, side)):
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn((n, grid, grid, 32 * groups), generator=gen, device=device).relu_().to(dtype)
            checks.append(("K1", "G = {} {}".format(groups, str(dtype)[6:]), head.margin_head, head.margin_head_plain,
                           (feats, w_final, b_final, OVERLAP, groups), False))
    per_kernel = {}
    with torch.no_grad():
        for name, site, kernel, plain, kargs, bit_equal in checks:
            got = kernel(*kargs)
            ref = plain(*kargs)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError("{} {}: kernel {} {} vs plain {} {}".format(
                    name, site, tuple(got.shape), got.dtype, tuple(ref.shape), ref.dtype))
            if not bit_equal:
                flips, err = u8_flips(torch, got, ref)
                if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
                    raise AssertionError("{} {}: {} flipped bins (max distance {})".format(name, site, flips, err))
                detail = "{} of {} bins flipped by 1".format(flips, got.numel())
            else:
                err = float((got.float() - ref.float()).abs().max())
                if not torch.equal(got, ref):
                    raise AssertionError("{} {}: not bit-equal, max |diff| {}".format(name, site, err))
                detail = "bit-equal"
            extra = {}
            if name in ("K6", "K7", "K9"):
                listed = [sum(map(len, qtail.nonzero_blocks(node))) for node in (kargs[1], kargs[3])]
                extra["blocks_listed"] = listed
                extra["blocks_skipped"] = [9 * 16 - k for k in listed]
                detail += "; weight blocks skipped: dec4 {} of 144, dec5 {} of 144".format(*extra["blocks_skipped"])
            arg_sets = rotated(torch, kargs)
            ms = cuda_ms(torch, kernel, arg_sets, 20)
            dev_ms = device_ms(torch, kernel, arg_sets, 20)
            plain_ms = cuda_ms(torch, plain, arg_sets, 2)
            del arg_sets
            cost = site_work(name, kargs, got)
            extra["device_ms"] = dev_ms
            extra["tops"] = cost[1] / (dev_ms or ms) / 1e9
            bound_ms, bound_by = record(per_kernel, name, site, kargs[0].shape, err, ms, plain_ms, cost, **extra)
            peak = PEAK[cost[2]] / 1e12
            log("phase 3: {} {} {} -> {}: {}; kernel {:.4f} ms (events), {} (device), {:.1f} {} ({:.1%} of {:.0f}), "
                "plain {:.3f} ms, bound {:.4f} ms ({})".format(
                    name, site, tuple(kargs[0].shape), tuple(got.shape), detail, ms,
                    "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms), extra["tops"],
                    "TOP/s" if cost[2] == "int8" else "TFLOP/s", extra["tops"] / peak, peak, plain_ms, bound_ms,
                    bound_by))
    del checks, kargs, got, ref, feats
    torch.cuda.empty_cache()

    # ---- phase 4: the probes path (K2, K10) ------------------------------
    counted = wrappers()
    launches = {name: 0 for name in SOURCES}
    by_path = {"probes": run_probes(torch, device, seed, counted, per_kernel, smi)}
    for name, c in by_path["probes"].items():
        launches[name] += c
    torch.cuda.empty_cache()

    # ---- phase 5: predict on the card, along each path -------------------
    base_config = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    n_batches = -(-len(tiles) // BATCH)
    steady_tiles = len(tiles) - first.valid
    default_pngs = None
    for label, keys, per_batch in PATHS:
        config = {**base_config, "common": {**base_config["common"], **keys}}
        model_toml = os.path.join(work, "model-{}.toml".format(label))
        save_config(config, model_toml)
        probs = os.path.join(work, "probs-{}".format(label))
        pargs = argparse.Namespace(
            batch_size=BATCH, checkpoint=checkpoint, overlap=OVERLAP, strip=1, tile_size=TILE, workers=4, shard=None,
            tiles=tiles_dir, probs=probs, model=model_toml,
            dataset=os.path.join(ROOT, "config", "dataset-parking.toml"), profile=None, png_optimize=False,
        )
        for fn in counted.values():
            fn.launches = 0
        start = time.perf_counter()
        out = predict.main(pargs)
        wall = time.perf_counter() - start
        counts = {name: fn.launches for name, fn in counted.items()}
        expected = {name: per_batch.get(name, 0) * n_batches for name in counted}
        if counts != expected:
            raise AssertionError("[{}] launch counts {} != expected {} for {} batches".format(
                label, counts, expected, n_batches))
        if out["tiles"] != len(tiles):
            raise AssertionError("[{}] predict reported {} tiles, expected {}".format(label, out["tiles"], len(tiles)))
        by_path[label] = {name: c for name, c in counts.items() if c}
        for name, c in counts.items():
            launches[name] += c
        log("phase 5: [{}] predict wrote {} tiles in {:.2f} s; steady {:.2f} tiles/s over {} tiles ({:.3f} s) on {}; "
            "launches {}".format(label, out["tiles"], wall, steady_tiles / out["steady_s"], steady_tiles,
                                 out["steady_s"], smi, by_path[label]))

        for x, y, z in tiles:
            img = Image.open(os.path.join(probs, str(z), str(x), "{}.png".format(y)))
            img.load()
            if img.mode != "P" or img.size != (TILE, TILE):
                raise AssertionError("[{}] tile {}: {} {}".format(label, (x, y, z), img.mode, img.size))
        pngs = read_pngs(probs, tiles)
        if label == "int8":
            default_pngs = pngs
        elif label.startswith("int8-"):
            flips, err = u8_flips(torch, torch.from_numpy(pngs), torch.from_numpy(default_pngs))
            fused = keys.get("fused_head", True)
            if fused and (err > 1 or flips > MAX_FLIP_SHARE * pngs.size):
                raise AssertionError("[{}] PNGs vs the int8 run's: {} flipped pixels (max distance {})".format(
                    label, flips, err))
            log("phase 5: [{}] PNGs vs the int8 run's{}: {} of {} pixels differ, max distance {}".format(
                label, "" if fused else " (another head: bf16 logits and a softmax, counted only)", flips, pngs.size,
                err))

        # One batch again, with the same weights and scales, through the
        # kernels and through the plain versions; the kernel path must also
        # reproduce the PNGs predict wrote for that batch.
        if config["common"].get("int8", False):
            step, qt = make_int8_predict_step(unet, params_d, state_d, raw48, overlap=OVERLAP,
                                              fused_head=keys.get("fused_head", True), calib_percentile=99.8,
                                              pallas_tail=keys.get("pallas_tail"))

            def run_step(plain=False, step=step, qt=qt):
                return step(qt, raw48, plain=plain)
        else:
            float_step = make_predict_step(unet, overlap=OVERLAP, compute_dtype=torch.bfloat16, fused_head=True,
                                           host_s2d=True)

            def run_step(plain=False, float_step=float_step):
                return float_step(params_d, state_d, raw48, plain=plain)
        got = run_step()
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        ref = run_step(plain=True)
        end_ev.record()
        torch.cuda.synchronize()
        step_ms = cuda_ms(torch, run_step, [()], 5)
        flips, err = u8_flips(torch, got, ref)
        grid = TILE // 4 if keys.get("pallas_tail") == "sep" else TILE // 2 if keys.get("fused_head", True) else TILE
        if got.shape[:3] != (BATCH, grid, grid) or err > 1 or flips > MAX_FLIP_SHARE * got.numel():
            raise AssertionError("[{}] step {}: {} flipped bins vs the plain path (max distance {})".format(
                label, tuple(got.shape), flips, err))
        written = pngs[: first.valid]
        fine = fine_u8(got)[: first.valid]
        if not np.array_equal(written, fine):
            raise AssertionError("[{}] predict's PNGs differ from the step's output on {} pixels".format(
                label, int((written != fine).sum())))
        log("phase 5: [{}] batch of {} through the kernels vs the plain path: {} of {} bins flipped by 1; "
            "step {:.2f} ms with kernels, {:.2f} ms plain; PNGs match the kernel step".format(
                label, BATCH, flips, got.numel(), step_ms, start_ev.elapsed_time(end_ev)))
        log_step_profile(torch, run_step, label, per_batch)
        del run_step, got, ref
        torch.cuda.empty_cache()

    return [
        {"name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
         "launches": launches[name], "launches_by_path": {p: c[name] for p, c in by_path.items() if name in c},
         **per_kernel[name]}
        for name in SOURCES
    ]


def k2_operands(torch, device, gen, int8_mm):
    """K2's probe operands: [(shape name, orientation, (lhs, rhs, scale))]
    for the 8 contractions in both orientations, random int8 and scales
    from `gen`."""
    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)

    k2 = []
    for shape, (cout, cin, p) in int8_mm.PROBE_SHAPES.items():
        w = int8(cout, cin)
        scale = torch.empty(cout, device=device).uniform_(math.log(1e-5), math.log(1e-3), generator=gen).exp_()
        k2.append((shape, "a", (w, int8(cin, p), scale.reshape(cout, 1))))
        k2.append((shape, "b", (int8(p, cin), w.t().contiguous(), scale.reshape(1, cout))))
    return k2


def check_and_time_k2(torch, int8_mm, k2, k2_out, per_kernel, smi):
    """Each K2 output against the plain version (bit-equal) and torch._int_mm's
    int32 against the plain accumulators, then the kernel's events and device
    times (device rate in GB/s against 3.35 TB/s and in TOP/s), the plain
    version's and _int_mm's; adds the sites to per_kernel["K2"]."""
    with torch.no_grad():
        for (shape, orient, args), got in zip(k2, k2_out):
            lhs, rhs, scale = args
            ref = int8_mm.int8_matmul_requant_plain(*args)
            if got.shape != ref.shape or not torch.equal(got, ref):
                raise AssertionError("K2 {} {}: {} of {} outputs differ from the plain version".format(
                    shape, orient, int((got != ref).sum()), ref.numel()))
            if not torch.equal(torch._int_mm(lhs, rhs), int8_mm.int8_matmul_acc_plain(lhs, rhs)):
                raise AssertionError("K2 {} {}: torch._int_mm's int32 differs from the plain accumulators".format(
                    shape, orient))
            del ref
            arg_sets = rotated(torch, args)

            def kernel(a, b, s, o=orient):
                return int8_mm.int8_matmul_requant(a, b, s, o)

            ms = cuda_ms(torch, kernel, arg_sets, 20)
            dev_ms = device_ms(torch, kernel, arg_sets, 20)
            lib_ms = cuda_ms(torch, lambda a, b, s: torch._int_mm(a, b), arg_sets, 20)
            plain_ms = cuda_ms(torch, int8_mm.int8_matmul_requant_plain, arg_sets, 2)
            del arg_sets
            (m, k), n = lhs.shape, rhs.shape[1]
            moved, ops = nbytes(lhs, rhs, scale, got), 2 * m * n * k
            t = dev_ms or ms
            bound_ms, bound_by = bound(moved, ops, "int8")
            record(per_kernel, "K2", "{} {}".format(shape, orient), (m, k, n), 0.0, ms, plain_ms, (moved, ops, "int8"),
                   library_ms=lib_ms, device_ms=dev_ms, gbs=moved / t / 1e6, tops=ops / t / 1e9,
                   share_of_bound=bound_ms / t)
            site = per_kernel["K2"]["sites"][-1]
            log("phase 4: K2 {} {} (M, K, N) = {}: bit-equal, torch._int_mm int32 equal (rhs row-major); kernel "
                "{:.4f} ms (events), {} (device), {:.0f} GB/s ({:.1%} of 3350), {:.1f} TOP/s, {:.1%} of its bound "
                "by {} time; _int_mm {:.4f} ms, plain {:.3f} ms, bound {:.4f} ms ({}); {}".format(
                    shape, orient, (m, k, n), ms, "not measured" if dev_ms is None else "{:.4f} ms".format(dev_ms),
                    site["gbs"], site["gbs"] / 3350, site["tops"], site["share_of_bound"],
                    "events" if dev_ms is None else "device", lib_ms, plain_ms, bound_ms, bound_by, smi))


def run_probes(torch, device, seed, counted, per_kernel, smi):
    """Phase 4: K2 at the 8 contractions in both orientations and K10's 12
    rungs at two sizes, once each with every launch counter at 0 (the
    probes path), then each output against its plain version and the
    timings. Adds K2's and K10's entries to `per_kernel`; returns the
    path's launch counts."""
    from robosat_tpu_torch.ops import head_rungs, int8_mm

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    k2 = k2_operands(torch, device, gen, int8_mm)
    wm = torch.randn((1, 128), generator=gen, device=device) * 0.3
    bm = torch.randn((1, 4), generator=gen, device=device) * 0.5
    side = (TILE + 2 * OVERLAP) // 2  # dec5's grid
    strip = torch.randn((1, 8, side, 128), generator=gen, device=device).to(torch.bfloat16)
    dec5 = (torch.randn((BATCH, side, side, 128), generator=gen, device=device) * 1.5).relu_().to(torch.bfloat16)
    k10 = [(label, rung, (x, wm, bm)) for label, x in (("strip", strip), ("dec5 batch", dec5))
           for rung in head_rungs.RUNGS]

    for fn in counted.values():
        fn.launches = 0
    with torch.no_grad():
        k2_out = [int8_mm.int8_matmul_requant(*args, orient) for _, orient, args in k2]
        k10_out = [head_rungs.head_rung(*args, rung) for _, rung, args in k10]
    torch.cuda.synchronize()
    counts = {name: fn.launches for name, fn in counted.items()}
    expected = {name: {"K2": len(k2), "K10": len(k10)}.get(name, 0) for name in counted}
    if counts != expected:
        raise AssertionError("[probes] launch counts {} != expected {}".format(counts, expected))
    log("phase 4: [probes] launches {}".format({name: c for name, c in counts.items() if c}))

    check_and_time_k2(torch, int8_mm, k2, k2_out, per_kernel, smi)
    del k2, k2_out
    torch.cuda.empty_cache()
    with torch.no_grad():
        for (label, rung, args), got in zip(k10, k10_out):
            ref = head_rungs.head_rung_plain(*args, rung)
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError("K10 {} {}: kernel {} {} vs plain {} {}".format(
                    label, rung, tuple(got.shape), got.dtype, tuple(ref.shape), ref.dtype))
            if got.dtype == torch.uint8:
                flips, err = u8_flips(torch, got, ref)
                if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
                    raise AssertionError("K10 {} {}: {} flipped bins (max distance {})".format(label, rung, flips, err))
                detail = "{} of {} bins flipped by 1".format(flips, got.numel())
            else:
                err = float((got.float() - ref.float()).abs().max())
                if rung.startswith("sigmoid"):
                    ulps = int((got.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max())
                    if ulps > SIGMOID_ULPS:
                        raise AssertionError("K10 {} {}: {} ulps from the plain sigmoid".format(label, rung, ulps))
                    detail = "within {} ulps".format(ulps)
                elif not torch.equal(got, ref):
                    raise AssertionError("K10 {} {}: not bit-equal, max |diff| {}".format(label, rung, err))
                else:
                    detail = "bit-equal"
            arg_sets = rotated(torch, args)
            ms = cuda_ms(torch, lambda x, w, b, r=rung: head_rungs.head_rung(x, w, b, r), arg_sets, 20)
            plain_ms = cuda_ms(torch, lambda x, w, b, r=rung: head_rungs.head_rung_plain(x, w, b, r), arg_sets, 2)
            del arg_sets
            x = args[0]
            ops = {"base": 0, "mul": x.numel()}.get(rung, 2 * x.numel())
            bound_ms, bound_by = record(per_kernel, "K10", "{} {}".format(label, rung), x.shape, float(err), ms,
                                        plain_ms, (nbytes(*args, got), ops, "f32"))
            log("phase 4: K10 {} {} {} -> {}: {}; kernel {:.4f} ms ({:.0f} GB/s), plain {:.3f} ms, bound {:.4f} ms "
                "({})".format(label, rung, tuple(x.shape), tuple(got.shape), detail, ms,
                              nbytes(*args, got) / ms / 1e6, plain_ms, bound_ms, bound_by))
    return {name: c for name, c in counts.items() if c}


if __name__ == "__main__":
    main()
