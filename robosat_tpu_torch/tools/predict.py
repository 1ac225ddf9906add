"""`predict` — per-tile class-probability PNGs from a trained U-Net.

The port of `rs predict` (robosat_tpu/tools/predict.py), with the same
flags and output contract: quantized foreground probabilities as palette
PNGs ("pink" continuous palette) in a slippy-map directory, from buffered
overlap tiles. It runs the U-Net on the config's device, as the model
TOML selects:

- `int8 = true`: the hybrid-int8 step (parallel/steps.py), with
  `pallas_tail` choosing the decoder's end (unset/"full", "tail", "sep")
  and `pallas_enc` accepted without effect;
- `int8 = false`: the folded float forward in bf16 (`bf16 = true`) or
  float32, with `host_s2d` and `s2d` as in the JAX package.

With `host_s2d` (the default) the loader workers 4x4 space-to-depth block
the buffered tiles, the step returns parity-blocked uint8 ("sep": doubly
blocked, peeled once here) and the writer pool interleaves it into the PNG
scanlines; otherwise the step returns the fine grid.

Not ported yet (ROADMAP Queue 1): `--strip > 1`, `fused_head = false`,
`int8 = true` with `host_s2d = false` or `s2d = false`, an odd overlap,
`--profile`, the 'mse'/'mae'/'pc' calibrations, and models other than the
U-Net.
"""

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image
from tqdm import tqdm

from robosat_tpu_torch.checkpoint import load_model_checkpoint
from robosat_tpu_torch.colors import continuous_palette_for_color
from robosat_tpu_torch.config import load_config
from robosat_tpu_torch.data.datasets import BufferedSlippyMapDirectory
from robosat_tpu_torch.data.loader import batches
from robosat_tpu_torch.device import configure_device
from robosat_tpu_torch.models.layers import depth_to_space2, space_to_depth4
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.native import imagecodec
from robosat_tpu_torch.parallel.steps import make_int8_predict_step, make_predict_step


def add_parser(subparser):
    parser = subparser.add_parser(
        "predict",
        help="runs the model over imagery tiles, writing probability tiles",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--batch_size", type=int, default=1, help="tiles per device batch")
    parser.add_argument("--checkpoint", type=str, required=True, help="checkpoint to run (.npz, or a reference .pth)")
    parser.add_argument("--overlap", type=int, default=32, help="context pixels borrowed from neighboring tiles on every side")
    parser.add_argument(
        "--strip",
        type=int,
        default=1,
        help="predict this many vertically-consecutive tiles as one image (not ported yet: must be 1)",
    )
    parser.add_argument("--tile_size", type=int, required=True, help="side length of the input tiles in pixels")
    parser.add_argument("--workers", type=int, default=0, help="decode/encode worker threads")
    parser.add_argument(
        "--shard",
        type=str,
        default=None,
        metavar="I/N",
        help="process only the I-th of N contiguous blocks of the tile list (0-based)",
    )
    parser.add_argument("tiles", type=str, help="slippy map directory with input imagery")
    parser.add_argument("probs", type=str, help="slippy map directory for the probability tiles")
    parser.add_argument("--model", type=str, required=True, help="path to model configuration file")
    parser.add_argument("--dataset", type=str, required=True, help="path to dataset configuration file")
    parser.add_argument("--profile", type=str, default=None, help="device trace directory (not ported yet)")
    parser.add_argument(
        "--png_optimize",
        action="store_true",
        help="spend ~37x more encode CPU for ~12%% smaller probability PNGs",
    )
    parser.set_defaults(func=main)


def _calibration(common):
    """The config's `int8_calibration` as the walk's percentile spec."""
    calib = common.get("int8_calibration", 99.8)
    if calib in ("amax", None):
        return None
    if isinstance(calib, str):
        return calib  # "mse"/"mae"/"pc..." raise NotImplementedError in the calibration walk
    return float(calib)


def main(args):
    model_config = load_config(args.model)
    dataset = load_config(args.dataset)
    common = model_config["common"]

    if args.strip > 1:
        raise NotImplementedError("--strip > 1 is not ported yet (ROADMAP Queue 1, item 4)")
    if getattr(args, "profile", None):
        raise NotImplementedError("--profile is not ported yet (ROADMAP Queue 1, item 6)")
    model = get_model(common.get("model", "unet"))
    int8_mode = common.get("int8", False)
    use_fused = common.get("fused_head", common.get("pallas_head", True))
    if not use_fused:
        raise NotImplementedError("fused_head = false (the 2-class conv + softmax head) is not ported yet "
                                  "(ROADMAP Queue 1, item 4)")
    use_s2d = common.get("s2d", True)
    use_host_s2d = common.get("host_s2d", True) and use_s2d
    if int8_mode and not use_host_s2d:
        raise NotImplementedError(
            "the port's int8 predict runs host_s2d and s2d only (ROADMAP Queue 1, item 4)"
        )
    if args.overlap % 2:
        raise NotImplementedError("an odd overlap (fine-grid output) is not ported yet (ROADMAP Queue 1, item 4)")
    calib_percentile = _calibration(common)
    # pallas_tail = "tail" | "sep" | "full" picks the int8 decoder's end
    # (parallel/steps.py); pallas_enc is accepted and changes nothing.
    pallas_tail = common.get("pallas_tail", None) or None
    pallas_enc = common.get("pallas_enc", False)
    compute_dtype = torch.bfloat16 if common.get("bf16", False) else torch.float32

    num_classes = len(dataset["common"]["classes"])
    assert num_classes == 2, "single channel requires binary model"

    # The U-Net center block pools enc4 2x and upsamples back for the concat:
    # the buffered side must keep side/32 even.
    buffered_side = args.tile_size + 2 * args.overlap
    if buffered_side % 64:
        sys.exit("Error: tile_size + 2*overlap must be a multiple of 64 (got {})".format(buffered_side))

    shard = None
    if args.shard is not None:
        try:
            i_s, n_s = args.shard.split("/")
            shard = (int(i_s), int(n_s))
            assert 0 <= shard[0] < shard[1]
        except (ValueError, AssertionError):
            sys.exit("Error: --shard must be I/N with 0 <= I < N (got {!r})".format(args.shard))

    device = configure_device(common["cuda"])
    params, state, ckpt_meta = load_model_checkpoint(args.checkpoint, num_classes, device=device)
    # A QAT checkpoint carries the frozen calibration vector its finetune
    # trained against; predict quantizes with exactly those scales.
    qat_amaxes = ckpt_meta.get("qat_amaxes") if isinstance(ckpt_meta, dict) else None

    transform = None
    if use_host_s2d:

        def transform(image):
            return space_to_depth4(image[None])[0]

    directory = BufferedSlippyMapDirectory(
        args.tiles, size=args.tile_size, overlap=args.overlap, transform=transform, shard=shard
    )
    if shard is not None and len(directory) == 0:
        print("shard {}/{}: no tiles in this block, nothing to do".format(*shard))
        return {"tiles": 0, "steady_s": 0.0}
    assert len(directory) > 0, "at least one tile in dataset"
    total_tiles = len(directory)
    batch_size = max(args.batch_size, 1)

    palette = continuous_palette_for_color("pink", 256)
    optimize = getattr(args, "png_optimize", False)

    def write_png(tile, quantized):
        x, y, z = map(int, tile)
        os.makedirs(os.path.join(args.probs, str(z), str(x)), exist_ok=True)
        path = os.path.join(args.probs, str(z), str(x), "{}.png".format(y))
        blocked = quantized.ndim == 3
        if blocked and quantized.shape[-1] == 16:
            # Doubly-blocked ("sep"): peel the 288-grid parity level first;
            # the remaining (..., 4) block takes the blocked writer.
            quantized = depth_to_space2(quantized[None])[0]
        if not optimize:
            # The native encoder fuses the parity interleave into scanline assembly.
            if blocked:
                if imagecodec.encode_palette_png_d2s(path, quantized, palette):
                    return
            elif imagecodec.encode_palette_png(path, quantized, palette):
                return
        if blocked:
            quantized = depth_to_space2(quantized[None])[0, :, :, 0]
        out = Image.fromarray(np.ascontiguousarray(quantized), mode="P")
        out.putpalette(palette)
        if optimize:
            out.save(path, optimize=True)
        else:
            out.save(path, optimize=False, compress_level=1)

    predict_step = qtree = None
    if not int8_mode:
        float_step = make_predict_step(model, overlap=args.overlap, compute_dtype=compute_dtype, s2d=use_s2d,
                                       host_s2d=use_host_s2d)

        def predict_step(_, raw):
            return float_step(params, state, raw)

    setup_done_t = None
    pending = []
    with ThreadPoolExecutor(max_workers=max(args.workers, 2)) as writers:
        progress = tqdm(total=total_tiles, desc="Eval", unit="tile", ascii=True)
        for batch in batches(directory, batch_size, workers=max(args.workers, 2)):
            (images,) = batch.arrays
            if predict_step is None:
                # Calibrate on the first batch as loaded, padded rows included.
                predict_step, qtree = make_int8_predict_step(
                    model, params, state, images, overlap=args.overlap, calib_percentile=calib_percentile,
                    calib_amaxes=np.asarray(qat_amaxes, np.float64) if qat_amaxes is not None else None,
                    pallas_tail=pallas_tail, pallas_enc=pallas_enc,
                )
            quantized = predict_step(qtree, images).cpu().numpy()  # synchronous device -> host copy
            if setup_done_t is None:
                # The steady clock starts after the first batch (calibration,
                # quantization and the kernel build stay out of steady_s).
                setup_done_t = time.perf_counter()
            for tile, q in zip(batch.meta, quantized[: batch.valid]):
                pending.append(writers.submit(write_png, tile, q))
            progress.update(batch.valid)
        for fut in pending:
            fut.result()
        progress.close()

    return {
        "tiles": total_tiles,
        "steady_s": (time.perf_counter() - setup_done_t) if setup_done_t else 0.0,
    }


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    add_parser(parser.add_subparsers())
    main(parser.parse_args(sys.argv[1:]))
