"""Slippy Map tile substrate: directory walking and overlap buffering.

Counterpart of robosat_tpu/tiles.py, limited to what `predict` uses, with
the `Tile` namedtuple of robosat_tpu/geo/tilemath.py. Images flow as HWC
uint8 numpy arrays; PIL is used only at the disk boundary.
"""

import os
from collections import namedtuple

import numpy as np
from PIL import Image

# Field order matches mercantile.Tile (reference contract: robosat/tiles.py:120).
Tile = namedtuple("Tile", ["x", "y", "z"])


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
