#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            (from the repository root; one GPU)

Drives robosat_tpu_torch's int8 `predict` (the U-Net on the hybrid-int8
walk, config/model-unet.toml) on the card and checks each hand-written
kernel against its plain PyTorch version:

1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
2. build of the CUDA kernels from robosat_tpu_torch/csrc;
3. each kernel against its plain version at main-path shapes (batch 8 at
   576 px buffered tiles, weights and scales of the calibrated model):
   K3/K4/K5 bit-equal in bf16, K6's uint8 equal up to counted +-1-bin
   flips; kernel and plain times from CUDA events;
4. `predict.main` in-process on a generated 512-px slippy-map directory
   with a random-weight full-width U-Net checkpoint: one decodable palette
   PNG per tile, launch counters of 13 K3, 3 K4, 5 K5 and 1 K6 per batch,
   one batch's uint8 against the plain path with the same qtree and
   scales, and a torch.profiler split of one step's device time.

Prints a JSON line of per-kernel results, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failed check raises (non-zero exit);
without a GPU, or outside the repository, it exits non-zero and prints no
result.
"""

import argparse
import json
import os
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
SEED = 0  # of the weights and the imagery


def log(*parts):
    print(*parts, flush=True)


def main():
    if not os.path.isdir(os.path.join(ROOT, "robosat_tpu_torch", "csrc")):
        sys.exit("chip_smoke.py must run from a checkout of the repository (robosat_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
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
        os.path.relpath(kernels.library_path(), ROOT)))

    with tempfile.TemporaryDirectory(prefix="rs_chip_smoke_") as work:
        results = run(torch, work, SEED, smi)

    log(json.dumps({"kernels": results}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of fn() over `reps` runs after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def u8_flips(torch, got, ref):
    """(count of differing bins, largest bin distance modulo 256)."""
    d = (got.int() - ref.int()) % 256
    d = torch.minimum(d, 256 - d)
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def log_step_profile(torch, step, steps=5, top=8):
    """Where one step's device time goes: torch.profiler's CUDA kernel rows
    over `steps` steps, against their wall time (host clock, synchronized)."""
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
        log("phase 4: profile of the step: the profiler recorded no kernel time (device split not measured)")
        return
    busy = sum(r[0] for r in rows)
    log("phase 4: profile of the step: {:.2f} ms wall (profiled), {:.2f} ms of kernels, device idle {:.1%}".format(
        wall_ms, busy, 1 - busy / wall_ms))
    for ms, count, key in rows[:top]:
        log("phase 4:   {:8.3f} ms/step {:4d} launches  {}".format(ms, count, key[:100]))


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


def run(torch, work, seed, smi):
    from PIL import Image

    from robosat_tpu.checkpoint import save_checkpoint
    from robosat_tpu.data.datasets import BufferedSlippyMapDirectory
    from robosat_tpu.data.loader import batches
    from robosat_tpu_torch.checkpoint import load_model_checkpoint, to_jax
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import int8 as q8
    from robosat_tpu_torch.models import qdec, qenc, qtail, unet
    from robosat_tpu_torch.models.layers import depth_to_space2, space_to_depth4
    from robosat_tpu_torch.parallel.steps import _normalize_s2d4, make_int8_predict_step
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
    gen = torch.Generator(device=device).manual_seed(seed)

    def act(shape, site):
        """bf16 relu'd activations spanning site `site`'s int8 range."""
        x = torch.randn(shape, generator=gen, device=device).relu_() * float(amaxes[site] / 3.0)
        return x.to(torch.bfloat16)

    def block_scales(first_site, down):
        return [float(s) for s in scales[first_site:first_site + (4 if down else 3)]]

    n, side = BATCH, (TILE + 2 * OVERLAP) // 4  # 144: the stem's output grid
    checks = [
        ("K3", "layer1.0 (projection)", qenc.bottleneck_block, qenc.bottleneck_block_plain,
         (act((n, side, side, 64), 0), enc["layer1"][0], *block_scales(0, True))),
        ("K3", "layer3.1 (identity)", qenc.bottleneck_block, qenc.bottleneck_block_plain,
         (act((n, side // 4, side // 4, 1024), 27), enc["layer3"][1], *block_scales(27, False))),
        ("K4", "layer2.0", qenc.bottleneck_block_s2, qenc.bottleneck_block_s2_plain,
         (act((n, side, side, 256), 10), enc["layer2"][0], *block_scales(10, True))),
        ("K5", "center", qdec.parity_up_conv, qdec.parity_up_conv_plain,
         (act((n, side // 16, side // 16, 2048), 52), qtree["center"], float(scales[52]))),
        ("K5", "dec3", qdec.parity_up_conv, qdec.parity_up_conv_plain,
         (act((n, side, side, 320), 56), qtree["dec3"], float(scales[56]))),
        ("K6", "dec3 -> head", qtail.fused_tail, qtail.fused_tail_plain,
         (act((n, 2 * side, 2 * side, 128), 57), qtree["dec4"], float(scales[57]), qtree["dec5"],
          float(scales[58]), qtree["final"]["w"], qtree["final"]["b"], OVERLAP)),
    ]
    per_kernel = {}
    with torch.no_grad():
        for name, site, kernel, plain, kargs in checks:
            got = kernel(*kargs)
            ref = plain(*kargs)
            torch.cuda.synchronize()
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise AssertionError("{} {}: kernel {} {} vs plain {} {}".format(
                    name, site, tuple(got.shape), got.dtype, tuple(ref.shape), ref.dtype))
            if name == "K6":
                flips, err = u8_flips(torch, got, ref)
                if err > 1 or flips > MAX_FLIP_SHARE * got.numel():
                    raise AssertionError("K6 {}: {} flipped bins (max distance {})".format(site, flips, err))
                detail = "{} of {} bins flipped by 1".format(flips, got.numel())
            else:
                err = float((got.float() - ref.float()).abs().max())
                if not torch.equal(got, ref):
                    raise AssertionError("{} {}: not bit-equal, max |diff| {}".format(name, site, err))
                detail = "bit-equal"
            ms = cuda_ms(torch, lambda: kernel(*kargs), 20)
            plain_ms = cuda_ms(torch, lambda: plain(*kargs), 2)
            log("phase 3: {} {} {} -> {}: {}; kernel {:.3f} ms, plain {:.3f} ms".format(
                name, site, tuple(kargs[0].shape), tuple(got.shape), detail, ms, plain_ms))
            entry = per_kernel.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "sites": []})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["ms"] += ms
            entry["plain_ms"] += plain_ms
            entry["sites"].append({"site": site, "shape": list(kargs[0].shape), "ms": ms, "plain_ms": plain_ms,
                                   "max_abs_err": err})
    del checks, kargs, got, ref
    torch.cuda.empty_cache()

    # ---- phase 4: predict on the card, through the kernels ---------------
    probs = os.path.join(work, "probs")
    pargs = argparse.Namespace(
        batch_size=BATCH, checkpoint=checkpoint, overlap=OVERLAP, strip=1, tile_size=TILE, workers=4, shard=None,
        tiles=tiles_dir, probs=probs, model=os.path.join(ROOT, "config", "model-unet.toml"),
        dataset=os.path.join(ROOT, "config", "dataset-parking.toml"), profile=None, png_optimize=False,
    )
    wrappers = {"K3": qenc.bottleneck_block, "K4": qenc.bottleneck_block_s2, "K5": qdec.parity_up_conv,
                "K6": qtail.fused_tail}
    for fn in wrappers.values():
        fn.launches = 0
    start = time.perf_counter()
    out = predict.main(pargs)
    wall = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in wrappers.items()}
    n_batches = -(-len(tiles) // BATCH)
    expected = {"K3": 13 * n_batches, "K4": 3 * n_batches, "K5": 5 * n_batches, "K6": n_batches}
    if launches != expected:
        raise AssertionError("launch counts {} != expected {} for {} batches".format(launches, expected, n_batches))
    if out["tiles"] != len(tiles):
        raise AssertionError("predict reported {} tiles, expected {}".format(out["tiles"], len(tiles)))
    steady_tiles = len(tiles) - first.valid
    log("phase 4: predict wrote {} tiles in {:.2f} s; steady {:.2f} tiles/s over {} tiles ({:.3f} s) on {}; "
        "launches {}".format(out["tiles"], wall, steady_tiles / out["steady_s"], steady_tiles, out["steady_s"],
                             smi, launches))

    for x, y, z in tiles:
        img = Image.open(os.path.join(probs, str(z), str(x), "{}.png".format(y)))
        img.load()
        if img.mode != "P" or img.size != (TILE, TILE):
            raise AssertionError("tile {}: {} {}".format((x, y, z), img.mode, img.size))

    # One batch again, with the same qtree and scales, through the kernels
    # and through the plain versions; the kernel path must also reproduce
    # the PNGs predict wrote for that batch.
    step, qtree = make_int8_predict_step(unet, params_d, state_d, raw48, overlap=OVERLAP, calib_percentile=99.8)
    got = step(qtree, raw48)
    start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start_ev.record()
    ref = step(qtree, raw48, plain=True)
    end_ev.record()
    torch.cuda.synchronize()
    step_ms = cuda_ms(torch, lambda: step(qtree, raw48), 5)
    flips, err = u8_flips(torch, got, ref)
    if got.shape != (BATCH, TILE // 2, TILE // 2, 4) or err > 1 or flips > MAX_FLIP_SHARE * got.numel():
        raise AssertionError("step {}: {} flipped bins vs the plain path (max distance {})".format(
            tuple(got.shape), flips, err))
    written = np.stack([np.asarray(Image.open(os.path.join(probs, str(z), str(x), "{}.png".format(y))))
                        for (x, y, z) in first.meta])
    fine = depth_to_space2(got.cpu().numpy()[: first.valid])[..., 0]
    if not np.array_equal(written, fine):
        raise AssertionError("predict's PNGs differ from the step's output on {} pixels".format(
            int((written != fine).sum())))
    log("phase 4: batch of {} through the kernels vs the plain path: {} of {} bins flipped by 1; "
        "step {:.2f} ms with kernels, {:.2f} ms plain; PNGs match the kernel step".format(
            BATCH, flips, got.numel(), step_ms, start_ev.elapsed_time(end_ev)))
    log_step_profile(torch, lambda: step(qtree, raw48))

    sources = {"K3": ("robosat_tpu_torch/csrc/qenc.cu", "robosat_tpu/models/qenc.py:123"),
               "K4": ("robosat_tpu_torch/csrc/qenc.cu", "robosat_tpu/models/qenc.py:289"),
               "K5": ("robosat_tpu_torch/csrc/qdec.cu", "robosat_tpu/models/qdec.py:246"),
               "K6": ("robosat_tpu_torch/csrc/qtail.cu", "robosat_tpu/models/qtail.py:383")}
    return [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": launches[name], **per_kernel[name]}
        for name in ("K3", "K4", "K5", "K6")
    ]


if __name__ == "__main__":
    main()
