"""`rs compare` — visual QA strips: imagery | label | mask(s) side by side.

This package's copy of robosat_tpu/tools/compare.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_data_tools.py.

Contract parity: robosat/tools/compare.py, including the keep-filter that
drops tiles whose foreground share falls outside [minimum, maximum] in every
mask.
"""

import argparse
import os

import numpy as np
from PIL import Image
from tqdm import tqdm

from robosat_tpu_torch.tiles import tiles_from_slippy_map


def add_parser(subparser):
    parser = subparser.add_parser(
        "compare",
        help="renders imagery, label and masks side by side for QA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("out", type=str, help="slippy map directory for the comparison strips")
    parser.add_argument("images", type=str, help="slippy map directory with imagery")
    parser.add_argument("labels", type=str, help="slippy map directory with labels")
    parser.add_argument("masks", type=str, nargs="+", help="slippy map directories with masks")
    parser.add_argument("--minimum", type=float, default=0.0, help="keep tiles with at least this foreground share")
    parser.add_argument("--maximum", type=float, default=1.0, help="keep tiles with at most this foreground share")

    parser.set_defaults(func=main)


def _open_p(base, tile):
    path = os.path.join(base, str(tile.z), str(tile.x), "{}.png".format(tile.y))
    return Image.open(path).convert("P")


def _foreground_share(mask):
    arr = np.array(mask)
    return np.count_nonzero(arr) / arr.size


def _strip(panels):
    width, height = panels[0].size
    combined = Image.new(mode="RGB", size=(len(panels) * width, height))
    for i, panel in enumerate(panels):
        combined.paste(panel, box=(i * width, 0))
    return combined


def main(args):
    for tile, path in tqdm(list(tiles_from_slippy_map(args.images)), desc="Compare", unit="image", ascii=True):
        image = Image.open(path).convert("RGB")
        label = _open_p(args.labels, tile)
        assert image.size == label.size

        mask_panels = []
        keep = False
        for mask_dir in args.masks:
            mask = _open_p(mask_dir, tile)
            assert image.size == mask.size
            mask_panels.append(mask)

            if args.minimum <= _foreground_share(mask) <= args.maximum:
                keep = True

        if not keep:
            continue

        combined = _strip([image, label] + mask_panels)
        out_dir = os.path.join(args.out, str(tile.z), str(tile.x))
        os.makedirs(out_dir, exist_ok=True)
        combined.save(os.path.join(out_dir, "{}.png".format(tile.y)), optimize=True)
