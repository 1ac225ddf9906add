"""`masks` — class masks from (ensembles of) probability tilesets.

The port of `rs masks` (robosat_tpu/tools/masks.py), with the same flags
and output: each probability PNG of `predict` is read back through the 256
anchors, the tilesets are soft-voted by a weighted average, and the argmax
class index is written as a palette mask (denim/orange) at zlib level 1.
Host code only: numpy, the port's native index decode and PIL.
"""

import argparse
import os
import sys

import numpy as np
from PIL import Image
from tqdm import tqdm

from robosat_tpu_torch.colors import make_palette
from robosat_tpu_torch.native import imagecodec
from robosat_tpu_torch.ops.quantize import ANCHORS
from robosat_tpu_torch.tiles import tiles_from_slippy_map


def add_parser(subparser):
    parser = subparser.add_parser(
        "masks",
        help="turns probability tiles into class masks (with optional ensembling)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("masks", type=str, help="slippy map directory for the output masks")
    parser.add_argument("probs", type=str, nargs="+", help="one or more slippy map directories of probability tiles")
    parser.add_argument("--weights", type=float, nargs="+", help="per-directory weights for the soft-vote average")
    parser.set_defaults(func=main)


def softvote(probs, axis=0, weights=None):
    """Weighted-average soft-voting across probability stacks -> class indices."""
    return np.argmax(np.average(probs, axis=axis, weights=weights), axis=axis)


def _load_probs(path):
    """A quantized probability PNG -> (2, H, W) [background; foreground].

    The saturation un-wrap of the JAX package (docs/PARITY.md): the
    digitize maps p == 1.0 to index 256, which the uint8 cast wraps to 0,
    and index 0 is reachable only that way (p == 0.0 lands on index 1), so
    0 reads back as 1.0."""
    quantized = imagecodec.decode_indices(path)
    if quantized is None:
        quantized = np.array(Image.open(path).convert("P"))
    fg = ANCHORS[quantized]
    fg[quantized == 0] = 1.0
    return np.stack([1.0 - fg, fg], axis=0)


def main(args):
    if args.weights and len(args.probs) != len(args.weights):
        sys.exit("Error: number of slippy map directories and weights must be the same")

    tilesets = [list(tiles_from_slippy_map(path)) for path in args.probs]
    palette = make_palette("denim", "orange")

    for tileset in tqdm(list(zip(*tilesets)), desc="Masks", unit="tile", ascii=True):
        tiles = [tile for tile, _ in tileset]
        assert len(set(tiles)) == 1, "tilesets in sync"
        x, y, z = tiles[0]

        probs = [_load_probs(path) for _, path in tileset]
        mask = softvote(probs, axis=0, weights=args.weights).astype(np.uint8)

        out = Image.fromarray(mask, mode="P")
        out.putpalette(palette)

        os.makedirs(os.path.join(args.masks, str(z), str(x)), exist_ok=True)
        # zlib level 1 (the reference's optimize=True, robosat/tools/masks.py:69,
        # gives the same pixels for many times the encode time).
        out.save(os.path.join(args.masks, str(z), str(x), "{}.png".format(y)), optimize=False, compress_level=1)
