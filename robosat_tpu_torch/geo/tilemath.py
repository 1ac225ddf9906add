"""Web Mercator (Slippy Map / XYZ) tile math.

The part of robosat_tpu/geo/tilemath.py that the port runs: the `Tile`
namedtuple and a tile's geographic bounds, replacing the ``mercantile``
package of the reference (robosat/tiles.py:16). Implements the OSM
slippy-map tile scheme: https://wiki.openstreetmap.org/wiki/Slippy_map_tilenames
"""

import math
from collections import namedtuple

# Field order matches mercantile.Tile so `Tile(*map(int, row))` on `x,y,z` CSV
# rows keeps working (reference contract: robosat/tiles.py:120).
Tile = namedtuple("Tile", ["x", "y", "z"])

LngLatBbox = namedtuple("LngLatBbox", ["west", "south", "east", "north"])


def _lat_from_ty(ty, n):
    """Latitude in degrees of the fractional tile row `ty` at `n = 2**z`."""
    return math.degrees(math.atan(math.sinh(math.pi * (1.0 - 2.0 * ty / n))))


def bounds(tile):
    """Geographic (west, south, east, north) degrees bounding box of a tile."""
    x, y, z = tile.x, tile.y, tile.z
    n = 2.0**z
    west = x / n * 360.0 - 180.0
    east = (x + 1) / n * 360.0 - 180.0
    north = _lat_from_ty(y, n)
    south = _lat_from_ty(y + 1, n)
    return LngLatBbox(west, south, east, north)
