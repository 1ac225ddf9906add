"""Web Mercator (Slippy Map / XYZ) tile math.

This package's copy of robosat_tpu/geo/tilemath.py: the same code, held to
the original by tests/test_torch_port_raster.py. It replaces the
``mercantile`` package of the reference (robosat/tiles.py:16,
robosat/tools/rasterize.py:12). Implements the OSM slippy-map tile scheme:
https://wiki.openstreetmap.org/wiki/Slippy_map_tilenames
"""

import math
from collections import namedtuple

# Field order matches mercantile.Tile so `Tile(*map(int, row))` on `x,y,z` CSV
# rows keeps working (reference contract: robosat/tiles.py:120).
Tile = namedtuple("Tile", ["x", "y", "z"])

LngLatBbox = namedtuple("LngLatBbox", ["west", "south", "east", "north"])
XYBbox = namedtuple("XYBbox", ["left", "bottom", "right", "top"])

# WGS84 semi-major axis; circumference of the web-mercator world square.
EARTH_RADIUS = 6378137.0
CE = 2.0 * math.pi * EARTH_RADIUS

# Latitude bounds of the web-mercator square.
MAX_LAT = math.degrees(2.0 * math.atan(math.exp(math.pi)) - math.pi / 2.0)


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


def xy(lng, lat):
    """Project (lng, lat) degrees to EPSG:3857 web-mercator meters."""
    mx = EARTH_RADIUS * math.radians(lng)
    if lat >= 90.0:
        my = math.inf
    elif lat <= -90.0:
        my = -math.inf
    else:
        my = EARTH_RADIUS * math.log(math.tan(math.pi / 4.0 + math.radians(lat) / 2.0))
    return mx, my


def lnglat(mx, my):
    """Inverse of :func:`xy`: EPSG:3857 meters back to (lng, lat) degrees."""
    lng = math.degrees(mx / EARTH_RADIUS)
    lat = math.degrees(2.0 * math.atan(math.exp(my / EARTH_RADIUS)) - math.pi / 2.0)
    return lng, lat


def xy_bounds(tile):
    """EPSG:3857 (left, bottom, right, top) meters bounding box of a tile.

    Matches mercantile.xy_bounds used for the rasterization transform
    (reference: robosat/tools/rasterize.py:81).
    """
    x, y, z = tile.x, tile.y, tile.z
    n = 2.0**z
    tile_size_m = CE / n
    left = x * tile_size_m - CE / 2.0
    right = (x + 1) * tile_size_m - CE / 2.0
    top = CE / 2.0 - y * tile_size_m
    bottom = CE / 2.0 - (y + 1) * tile_size_m
    return XYBbox(left, bottom, right, top)


def tile_fraction(lng, lat, zoom):
    """Continuous (fractional) tile coordinates containing (lng, lat)."""
    n = 2.0**zoom
    tx = (lng + 180.0) / 360.0 * n
    lat = min(max(lat, -MAX_LAT), MAX_LAT)
    rad = math.radians(lat)
    ty = (1.0 - math.asinh(math.tan(rad)) / math.pi) / 2.0 * n
    return tx, ty


def tile(lng, lat, zoom):
    """The integer tile containing geographic coordinate (lng, lat)."""
    tx, ty = tile_fraction(lng, lat, zoom)
    n = 2**zoom
    ix = min(max(int(math.floor(tx)), 0), n - 1)
    iy = min(max(int(math.floor(ty)), 0), n - 1)
    return Tile(ix, iy, zoom)


def parent(t):
    """The tile one zoom level up containing this tile."""
    return Tile(t.x // 2, t.y // 2, t.z - 1)


def children(t):
    """The four tiles one zoom level down covering this tile."""
    x, y, z = t.x, t.y, t.z
    return [
        Tile(2 * x, 2 * y, z + 1),
        Tile(2 * x + 1, 2 * y, z + 1),
        Tile(2 * x + 1, 2 * y + 1, z + 1),
        Tile(2 * x, 2 * y + 1, z + 1),
    ]
