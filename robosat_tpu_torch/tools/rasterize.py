"""`rs rasterize` — burn GeoJSON features into slippy-map label masks.

This package's copy of robosat_tpu/tools/rasterize.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_data_tools.py.

Contract parity with robosat/tools/rasterize.py: features projected to
EPSG:3857, burned (value 1) over each CSV tile's xy bounds at the requested
size, np.maximum-merged with any existing tile file, written as palette PNGs
using the dataset's two colors. Uses the in-repo rasterizer and tile covering
instead of rasterio/supermercado — output is pixel-identical to rasterio on
the reference's real fixtures (tests/test_reference_fixtures.py).
"""

import argparse
import collections
import json
import os
import sys

import numpy as np
from PIL import Image
from tqdm import tqdm

from robosat_tpu_torch.colors import make_palette
from robosat_tpu_torch.config import load_config
from robosat_tpu_torch.geo import tilemath
from robosat_tpu_torch.geo.proj import wgs_to_webmercator
from robosat_tpu_torch.geo.raster import burn_tiles, rasterize_polygons
from robosat_tpu_torch.tiles import tiles_from_csv


def add_parser(subparser):
    parser = subparser.add_parser(
        "rasterize", help="burns GeoJSON features into label tiles", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )

    parser.add_argument("features", type=str, help="GeoJSON features to burn")
    parser.add_argument("tiles", type=str, help="csv of tile ids to rasterize")
    parser.add_argument("out", type=str, help="slippy map directory for the label tiles")
    parser.add_argument("--dataset", type=str, required=True, help="path to dataset configuration file")
    parser.add_argument("--zoom", type=int, required=True, help="zoom level the csv tiles live at")
    parser.add_argument("--size", type=int, default=512, help="side length of the burned tiles in pixels")

    parser.set_defaults(func=main)


def feature_to_mercator(feature):
    """Yield a feature's polygon geometries with EPSG:3857 coordinates.

    Parity: robosat/tools/rasterize.py:38-61 (MultiPolygons split into
    Polygons); the projection is the in-repo closed form, vectorized over
    each ring at once.
    """
    geometry = feature["geometry"]

    def project_ring(ring):
        ring = np.asarray(ring, dtype=np.float64)
        xs, ys = wgs_to_webmercator(ring[:, 0], ring[:, 1])
        return [list(pt) for pt in np.stack([xs, ys], axis=1)]

    if geometry["type"] == "Polygon":
        yield {"type": "Polygon", "coordinates": [project_ring(r) for r in geometry["coordinates"]]}
    elif geometry["type"] == "MultiPolygon":
        for component in geometry["coordinates"]:
            yield {"type": "Polygon", "coordinates": [project_ring(r) for r in component]}


def burn(tile, features, size):
    """Rasterize `features` (EPSG:4326 GeoJSON) into a (size, size) uint8 tile."""
    shapes = ((geometry, 1) for feature in features for geometry in feature_to_mercator(feature))
    return rasterize_polygons(shapes, (size, size), tilemath.xy_bounds(tile))


def features_by_tile(features, zoom):
    """Index Polygon features by the zoom-`zoom` tiles they cover.

    Non-Polygon geometries are ignored; degenerate features are skipped with
    a warning, matching robosat/tools/rasterize.py:106-117.
    """
    index = collections.defaultdict(list)
    for n, feature in enumerate(tqdm(features, ascii=True, unit="feature")):
        if feature["geometry"]["type"] != "Polygon":
            continue
        try:
            covered = burn_tiles(feature, zoom)
        except ValueError:
            print("Warning: invalid feature {}, skipping".format(n), file=sys.stderr)
            continue
        for tile in covered:
            index[tile].append(feature)
    return index


class LabelSink:
    """Writes label masks as palette PNGs into a slippy-map tree.

    A tile already on disk is np.maximum-merged with the incoming mask so
    successive rasterize passes over different feature sets compose
    (robosat/tools/rasterize.py:131-133).
    """

    def __init__(self, root, background, foreground):
        self.root = root
        self.palette = make_palette(background, foreground)

    def write(self, tile, mask):
        directory = os.path.join(self.root, str(tile.z), str(tile.x))
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "{}.png".format(tile.y))

        if os.path.exists(path):
            mask = np.maximum(mask, np.array(Image.open(path)))

        png = Image.fromarray(mask, mode="P")
        png.putpalette(self.palette)
        png.save(path, optimize=True)


def main(args):
    config = load_config(args.dataset)["common"]
    if len(config["classes"]) != len(config["colors"]):
        sys.exit("Error: dataset classes and colors must pair up")
    if len(config["colors"]) != 2:
        sys.exit("Error: rasterize handles binary (two-class) datasets only")

    tiles = list(tiles_from_csv(args.tiles))
    if any(tile.z != args.zoom for tile in tiles):
        sys.exit("Error: tiles.csv contains tiles outside zoom {}".format(args.zoom))

    with open(args.features) as f:
        collection = json.load(f)
    index = features_by_tile(collection["features"], args.zoom)

    os.makedirs(args.out, exist_ok=True)
    sink = LabelSink(args.out, *config["colors"])
    blank = np.zeros((args.size, args.size), dtype=np.uint8)

    for tile in tqdm(tiles, ascii=True, unit="tile"):
        covering = index.get(tile)
        sink.write(tile, burn(tile, covering, args.size) if covering else blank)
