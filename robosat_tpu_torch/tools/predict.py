"""`predict` — per-tile class-probability PNGs from a trained U-Net, fast, DeepLab or SegFormer model.

The port of `rs predict` (robosat_tpu/tools/predict.py), with the same
flags and output contract: quantized foreground probabilities as palette
PNGs ("pink" continuous palette) in a slippy-map directory, from buffered
overlap tiles. It runs the model (`model = "unet"`, `"fast"`,
`"deeplabv3plus"` or `"segformer"`) on the
config's device, as the model TOML selects:

- `int8 = true`: the hybrid-int8 step (parallel/steps.py), with
  `pallas_tail` choosing the decoder's end (unset/"full", "tail", "sep")
  and `pallas_enc` accepted without effect;
- `int8 = false`: the folded float forward in bf16 (`bf16 = true`) or
  float32, with `host_s2d` and `s2d` as in the JAX package;
- `fused_head = false` (either): the final 1x1 conv, a softmax and the
  digitize on the fine grid in place of the margin head, on fine input as
  in the JAX package;
- `model = "fast"`: with `int8` its own int8 walk (host-blocked input
  and, with an overlap that is a multiple of 4, 16-channel blocked output
  that the writer peels like "sep"'s), otherwise its float sub-pixel head
  on fine input; `pallas_tail` and `pallas_enc` are ignored, and the
  buffered side needs a multiple of 32 (the U-Net: 64);
- `model = "deeplabv3plus"`: with `int8` its own int8 walk (host-blocked
  input, fine output: K3/K4 and rs_int8_conv on the GPU, the margin
  resized before the sigmoid), otherwise its float margin-then-resize
  head on fine input; no side multiple is checked (the model asserts 16);
- `model = "segformer"`: as DeepLab (host-blocked int8 input, fine
  output: K2's dequant epilogue for its 51 dense and spatial-reduction
  sites, rs_int8_conv for its 3 patch embeds), with a buffered side that
  is a multiple of its SIDE_MULTIPLE, 32.

With `host_s2d` (the default; it takes `s2d`, the fused head, `--strip 1`
and a buffered side that is a multiple of 4, as the JAX tool does) the
loader workers 4x4 space-to-depth block the buffered tiles and the step
runs the blocked stem. With an even overlap it then returns parity-blocked
uint8 ("sep": doubly blocked, peeled once here), which the writer pool
interleaves into the PNG scanlines; otherwise the step returns the fine
grid.

`--strip K` predicts K vertically consecutive tiles of a column as one
(K * size + 2 * overlap)-tall image on the fine grid (data/datasets.py's
StripBufferedSlippyMapDirectory); a batch then holds batch_size // K
strips, and the writer cuts each strip's output into its tiles.
`--profile DIR` records the dispatch loop with torch.profiler (host, and
the card's kernels on the GPU), one `predict_batch` range per batch, and
writes a trace that TensorBoard's profile plugin reads to DIR.

Batches are dispatched ahead and fetched behind, as in the JAX package:
the step of a batch is issued (its input copied from pinned memory on the
card), its output starts back into pinned host memory behind a CUDA event,
and a batch's PNGs go to the writer pool once two newer batches are in
flight. The steady clock starts when the first batch is done.

Several devices: launched as N processes with RS_COORDINATOR,
RS_NUM_PROCESSES and RS_PROCESS_ID set (parallel/mesh.py: one process per
GPU over NCCL, or gloo with `cuda = false`), the batch is rounded up to a
multiple of N, every rank walks the same tiles in the same order and runs
its rows of each batch, and writes the PNGs of its rows; the int8
calibration is the whole first batch's, on rank 0, broadcast to every
rank. `--shard` cuts the tile list first, the ranks then split its batches.

`int8_calibration` takes the JAX tool's values: "amax", a percentile,
"mse", "mae", or a per-channel spec ("pc", "pcamax", "pc<percentile>"),
which the U-Net, the fast family and DeepLab run and SegFormer refuses.
"""

import argparse
import collections
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
from robosat_tpu_torch.data.datasets import BufferedSlippyMapDirectory, StripBufferedSlippyMapDirectory
from robosat_tpu_torch.data.loader import batches
from robosat_tpu_torch.device import Dispatched, configure_device, profiler
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models.layers import depth_to_space2, space_to_depth4
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.native import imagecodec
from robosat_tpu_torch.parallel.mesh import create_mesh
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
        help="predict this many vertically-consecutive tiles as one image (less halo re-compute)",
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
    parser.add_argument("--profile", type=str, default=None, help="write a TensorBoard device trace to this directory")
    parser.add_argument(
        "--png_optimize",
        action="store_true",
        help="spend ~37x more encode CPU for ~12%% smaller probability PNGs",
    )
    parser.set_defaults(func=main)


IN_FLIGHT = 2  # batches issued beyond the one being fetched


def dispatch_ahead(batches, issue, write):
    """Dispatch ahead, fetch behind (robosat_tpu/tools/predict.py):
    issue(batch) starts a batch and returns its handle (`.fetch()` -> the
    output on the host); once more than IN_FLIGHT batches are pending the
    oldest is fetched and handed to write(batch, output), and the rest at
    the end. The first batch is fetched before the second is issued.
    Returns the time (time.perf_counter) at which the first batch was done:
    the end of the set-up (kernel build, calibration)."""
    pending = collections.deque()
    setup_done_t = None
    for batch in batches:
        pending.append((batch, issue(batch)))
        if setup_done_t is None:
            pending[0][1].fetch()
            setup_done_t = time.perf_counter()
        if len(pending) > IN_FLIGHT:
            batch, handle = pending.popleft()
            write(batch, handle.fetch())
    while pending:
        batch, handle = pending.popleft()
        write(batch, handle.fetch())
    return setup_done_t


def int8_walk(common, model):
    """Whether the config's `int8` runs: the U-Net's walk, or the walk of a
    model that owns one (`predict_quantized_int8`); other families run
    float, as in the JAX tool."""
    return bool(common.get("int8", False) and (common.get("model", "unet") == "unet"
                                               or hasattr(model, "predict_quantized_int8")))


def host_s2d_input(common, args):
    """Whether the loader 4x4-blocks the input (the JAX tool's rule): the
    config's `host_s2d` with `s2d` and the fused head, for the U-Net or a
    model-owned int8 walk, per tile only, and a buffered side that is a
    multiple of 4."""
    use_fused = common.get("fused_head", common.get("pallas_head", True))
    model = get_model(common.get("model", "unet"))
    family = common.get("model", "unet") == "unet" or int8_walk(common, model)
    return bool(common.get("host_s2d", True) and family and common.get("s2d", True) and use_fused
                and args.strip <= 1 and (args.tile_size + 2 * args.overlap) % 4 == 0)


def input_directory(args, use_host_s2d, shard=None):
    """The dataset `predict` batches, and the number of tiles it holds:
    column strips for `--strip > 1`, buffered tiles otherwise (4x4-blocked
    by the loader with `use_host_s2d`)."""
    if args.strip > 1:
        directory = StripBufferedSlippyMapDirectory(
            args.tiles, size=args.tile_size, overlap=args.overlap, strip=args.strip, shard=shard
        )
        return directory, sum(len(strip) for strip in directory.strips)
    transform = None
    if use_host_s2d:

        def transform(image):
            return space_to_depth4(image[None])[0]

    directory = BufferedSlippyMapDirectory(
        args.tiles, size=args.tile_size, overlap=args.overlap, transform=transform, shard=shard
    )
    return directory, len(directory)


def batch_items(args):
    """Items per batch: tiles, or with strips the strips of --strip tiles
    that fit the batch size (at least one)."""
    return max(args.batch_size // max(args.strip, 1), 1)


def main(args):
    model_config = load_config(args.model)
    dataset = load_config(args.dataset)
    common = model_config["common"]

    model = get_model(common.get("model", "unet"))
    int8_mode = int8_walk(common, model)
    use_fused = common.get("fused_head", common.get("pallas_head", True))
    use_s2d = common.get("s2d", True)
    calib_percentile = q8.calibration_spec(common.get("int8_calibration", 99.8))
    # pallas_tail = "tail" | "sep" | "full" picks the U-Net's int8 decoder
    # end (parallel/steps.py); pallas_enc is accepted and changes nothing,
    # and a model-owned int8 walk ignores both.
    pallas_tail = common.get("pallas_tail", None) or None
    pallas_enc = common.get("pallas_enc", False)
    compute_dtype = torch.bfloat16 if common.get("bf16", False) else torch.float32

    num_classes = len(dataset["common"]["classes"])
    assert num_classes == 2, "single channel requires binary model"

    # The U-Net center block pools enc4 2x and upsamples back for the concat:
    # the buffered side must keep side/32 even. Other families declare
    # their multiple (the fast family's /4 stem and three /2 stages: 32).
    buffered_side = args.tile_size + 2 * args.overlap
    side_multiple = 64 if common.get("model", "unet") == "unet" else getattr(model, "SIDE_MULTIPLE", 1)
    if buffered_side % side_multiple:
        sys.exit("Error: tile_size + 2*overlap must be a multiple of {} (got {})".format(side_multiple,
                                                                                       buffered_side))
    use_host_s2d = host_s2d_input(common, args)

    shard = None
    if args.shard is not None:
        try:
            i_s, n_s = args.shard.split("/")
            shard = (int(i_s), int(n_s))
            assert 0 <= shard[0] < shard[1]
        except (ValueError, AssertionError):
            sys.exit("Error: --shard must be I/N with 0 <= I < N (got {!r})".format(args.shard))

    device = configure_device(common["cuda"])
    mesh = create_mesh(device)
    if mesh is not None:
        device = mesh.device
    params, state, ckpt_meta = load_model_checkpoint(args.checkpoint, num_classes, device=device)
    # A QAT checkpoint carries the frozen calibration vector its finetune
    # trained against; predict quantizes with exactly those scales.
    qat_amaxes = ckpt_meta.get("qat_amaxes") if isinstance(ckpt_meta, dict) else None

    directory, total_tiles = input_directory(args, use_host_s2d, shard)
    if shard is not None and len(directory) == 0:
        print("shard {}/{}: no tiles in this block, nothing to do".format(*shard))
        return {"tiles": 0, "steady_s": 0.0}
    assert len(directory) > 0, "at least one tile in dataset"
    size = 1 if mesh is None else mesh.size
    batch_size = -(-batch_items(args) // size) * size

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
        float_step = make_predict_step(model, overlap=args.overlap, compute_dtype=compute_dtype, fused_head=use_fused,
                                       s2d=use_s2d, host_s2d=use_host_s2d)

        def predict_step(_, raw):
            return float_step(params, state, raw)

    pending = []

    def issue(batch):
        nonlocal predict_step, qtree
        (images,) = batch.arrays
        if predict_step is None:
            # Calibrate on the first batch as loaded, padded rows included
            # (with a mesh, the ranks' rows together).
            predict_step, qtree = make_int8_predict_step(
                model, params, state, images, overlap=args.overlap, fused_head=use_fused, host_s2d=use_host_s2d,
                calib_percentile=calib_percentile,
                calib_amaxes=np.asarray(qat_amaxes, np.float64) if qat_amaxes is not None else None,
                pallas_tail=pallas_tail, pallas_enc=pallas_enc, mesh=mesh,
            )
        # Pinned, the input's copy to the card does not wait for the device;
        # the handle keeps it until the batch is fetched.
        raw = torch.from_numpy(images).pin_memory() if device.type == "cuda" else images
        with torch.profiler.record_function("predict_batch"):
            return Dispatched(predict_step(qtree, raw), keep=raw)

    size = args.tile_size
    with ThreadPoolExecutor(max_workers=max(args.workers, 2)) as writers:
        progress = tqdm(total=total_tiles, desc="Eval", unit="tile", ascii=True,
                        disable=mesh is not None and mesh.rank != 0)

        def write(batch, quantized):
            for meta, q in zip(batch.meta, quantized[: batch.valid]):
                if args.strip > 1:
                    strip_tiles, valid = meta
                    for i, tile in enumerate(strip_tiles[:valid]):
                        pending.append(writers.submit(write_png, tile, q[i * size : (i + 1) * size]))
                    progress.update(valid)
                else:
                    pending.append(writers.submit(write_png, meta, q))
                    progress.update(1)

        with profiler(args.profile, device):
            # The steady clock starts after the first batch (calibration,
            # quantization and the kernel build stay out of steady_s).
            setup_done_t = dispatch_ahead(batches(directory, batch_size, workers=max(args.workers, 2), mesh=mesh),
                                          issue, write)
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
