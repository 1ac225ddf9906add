"""`rs cover` — CSV of all tiles covering a GeoJSON feature collection.

This package's copy of robosat_tpu/tools/cover.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_data_tools.py.

Contract parity: robosat/tools/cover.py (per-feature tile cover, de-duplicated
across features), using the in-repo tile covering instead of supermercado.
"""

import argparse
import csv
import json

from tqdm import tqdm

from robosat_tpu_torch.geo.raster import burn_tiles


def add_parser(subparser):
    parser = subparser.add_parser(
        "cover",
        help="lists the tiles covering GeoJSON features",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

    parser.add_argument("--zoom", type=int, required=True, help="zoom level of tiles")
    parser.add_argument("features", type=str, help="GeoJSON features to cover")
    parser.add_argument("out", type=str, help="csv file the covering tile ids are written to")

    parser.set_defaults(func=main)


def cover(features, zoom):
    """The de-duplicated set of (x, y, z) ids covering all features."""
    covered = set()
    for feature in tqdm(features, ascii=True, unit="feature"):
        covered.update((t.x, t.y, t.z) for t in burn_tiles(feature, zoom))
    return covered


def main(args):
    with open(args.features) as fp:
        collection = json.load(fp)

    rows = sorted(cover(collection["features"], args.zoom))

    with open(args.out, "w") as fp:
        csv.writer(fp).writerows(rows)
