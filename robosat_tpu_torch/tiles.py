"""Slippy Map tile substrate: directory walking, CSV tile lists, pixel
geo-referencing, overlap buffering and HTTP fetches.

Counterpart of robosat_tpu/tiles.py, held to it by
tests/test_torch_port_data_tools.py. Images flow as HWC uint8 numpy arrays;
PIL is used only at the disk boundary. `fetch_image` takes the caller's
HTTP session, so this module imports no HTTP client.
"""

import csv
import io
import os

import numpy as np
from PIL import Image

from robosat_tpu_torch.geo.tilemath import Tile, bounds


def pixel_to_location(tile, dx, dy):
    """Convert a relative pixel offset in a tile to a (lng, lat) coordinate.

    Args:
      tile: the tile the pixel lives in.
      dx: relative x offset in [0, 1] (0 = west edge, 1 = east edge).
      dy: relative y offset in [0, 1] (0 = south edge, 1 = north edge).

    Parity: robosat/tiles.py:19-42 (lerp over tile bounds).
    """
    assert 0 <= dx <= 1, "x offset is in [0, 1]"
    assert 0 <= dy <= 1, "y offset is in [0, 1]"

    west, south, east, north = bounds(tile)
    lon = west + dx * (east - west)
    lat = south + dy * (north - south)
    return lon, lat


def fetch_image(session, url, timeout=10):
    """Fetch a tile image over HTTP; returns BytesIO or None on any error.

    Parity: robosat/tiles.py:45-62.
    """
    try:
        resp = session.get(url, timeout=timeout)
        resp.raise_for_status()
        return io.BytesIO(resp.content)
    except Exception:
        return None


def _as_int(v):
    try:
        return int(v)
    except ValueError:
        return None


def tiles_from_slippy_map(root):
    """Yield (Tile, path) for every `z/x/y.ext` file under `root`.

    Non-numeric directory/file names are skipped. Yields in sorted (z, x, y)
    order for determinism. Parity: robosat/tiles.py:65-100.
    """
    if not os.path.isdir(root):
        return
    for z_name in sorted(os.listdir(root), key=lambda s: (_as_int(s) is None, _as_int(s) or 0)):
        z = _as_int(z_name)
        if z is None:
            continue
        z_dir = os.path.join(root, z_name)
        if not os.path.isdir(z_dir):
            continue
        for x_name in sorted(os.listdir(z_dir), key=lambda s: (_as_int(s) is None, _as_int(s) or 0)):
            x = _as_int(x_name)
            if x is None:
                continue
            x_dir = os.path.join(z_dir, x_name)
            if not os.path.isdir(x_dir):
                continue
            for name in sorted(os.listdir(x_dir)):
                y = _as_int(os.path.splitext(name)[0])
                if y is None:
                    continue
                yield Tile(x=x, y=y, z=z), os.path.join(x_dir, name)


def tiles_from_csv(path):
    """Yield tiles from a line-delimited `x,y,z` CSV file.

    Parity: robosat/tiles.py:103-120.
    """
    with open(path) as fp:
        for row in csv.reader(fp):
            if not row:
                continue
            yield Tile(*map(int, row))


def load_image(path, mode="RGB"):
    """Decode an image file into an HWC uint8 numpy array."""
    with Image.open(path) as img:
        return np.asarray(img.convert(mode))


def adjacent_tile(tile, dx, dy, tiles, load=load_image):
    """Load the image of the tile at offset (dx, dy), or None if absent.

    Parity: robosat/tiles.py:139-159 (returns numpy HWC instead of PIL).
    """
    other = Tile(x=int(tile.x) + dx, y=int(tile.y) + dy, z=int(tile.z))
    try:
        path = tiles[other]
    except KeyError:
        return None
    return load(path)


def buffer_tile_image(tile, tiles, overlap, tile_size, nodata=0, load=load_image):
    """Compose a tile with `overlap` pixels of context from its 3x3 neighborhood.

    Returns an HWC uint8 array of side `tile_size + 2 * overlap`; missing
    neighbors are filled with `nodata` (robosat/tiles.py:162-227). `load`
    lets callers inject a caching decoder.
    """
    tiles = dict(tiles)
    o, s = overlap, tile_size
    side = s + 2 * o

    center = load(tiles[Tile(int(tile.x), int(tile.y), int(tile.z))])
    composite = np.full((side, side, center.shape[2]), nodata, dtype=np.uint8)
    composite[o : o + s, o : o + s] = center[:s, :s]

    if o == 0:
        return composite

    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neighbor = adjacent_tile(tile, dx, dy, tiles, load=load)
            if neighbor is None:
                continue
            # Destination strip in composite coordinates.
            dst_x0 = 0 if dx < 0 else (o if dx == 0 else o + s)
            dst_x1 = o if dx < 0 else (o + s if dx == 0 else side)
            dst_y0 = 0 if dy < 0 else (o if dy == 0 else o + s)
            dst_y1 = o if dy < 0 else (o + s if dy == 0 else side)
            # Source strip: trailing edge for negative offsets, leading for positive.
            src_x0 = s - o if dx < 0 else 0
            src_x1 = s if dx <= 0 else o
            if dx == 0:
                src_x0, src_x1 = 0, s
            src_y0 = s - o if dy < 0 else 0
            src_y1 = s if dy <= 0 else o
            if dy == 0:
                src_y0, src_y1 = 0, s
            composite[dst_y0:dst_y1, dst_x0:dst_x1] = neighbor[src_y0:src_y1, src_x0:src_x1]

    return composite


def unbuffer(probs, overlap):
    """Crop the overlap border back off a CHW probability array.

    Parity: robosat/datasets.py:123-136.
    """
    o = overlap
    if o == 0:
        return probs
    _, h, w = probs.shape
    return probs[:, o : h - o, o : w - o]


def stitch_image(into, into_box, image, image_box):
    """Paste a crop of `image` into `into` (both HWC numpy, in-place).

    Boxes are (left, upper, right, lower). Parity: robosat/tiles.py:123-136.
    """
    il, iu, ir, ilo = into_box
    sl, su, sr, slo = image_box
    into[iu:ilo, il:ir] = image[su:slo, sl:sr]
