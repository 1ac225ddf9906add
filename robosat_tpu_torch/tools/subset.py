"""`rs subset` — carve a tile subset out of a slippy-map directory.

This package's copy of robosat_tpu/tools/subset.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_data_tools.py.

Contract parity: robosat/tools/subset.py (CSV-driven copy, extensions
preserved). Implemented as a lookup-driven copy: walk the source once into a
tile->path map, then iterate the wanted CSV ids.
"""

import argparse
import os
import shutil

from tqdm import tqdm

from robosat_tpu_torch.tiles import tiles_from_csv, tiles_from_slippy_map


def add_parser(subparser):
    parser = subparser.add_parser(
        "subset",
        help="copies the tiles listed in a csv out of a slippy map directory",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("images", type=str, help="slippy map directory to copy tiles from")
    parser.add_argument("tiles", type=str, help="csv of tile ids to keep")
    parser.add_argument("out", type=str, help="slippy map directory to copy tiles into")

    parser.set_defaults(func=main)


def main(args):
    available = dict(tiles_from_slippy_map(args.images))

    for tile in tqdm(list(tiles_from_csv(args.tiles)), desc="Subset", unit="image", ascii=True):
        src = available.get(tile)
        if src is None:
            continue

        ext = os.path.splitext(src)[1]  # includes the leading period
        dst_dir = os.path.join(args.out, str(tile.z), str(tile.x))
        os.makedirs(dst_dir, exist_ok=True)
        shutil.copyfile(src, os.path.join(dst_dir, "{}{}".format(tile.y, ext)))
