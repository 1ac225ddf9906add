"""Polygon rasterization and tile covering.

This package's copy of robosat_tpu/geo/raster.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_raster.py.

Replaces rasterio.features.rasterize (robosat/tools/rasterize.py:64-83) and
supermercado.burntiles (robosat/tools/cover.py:30, rasterize.py:113) with
numpy implementations:

- :func:`rasterize_polygons` — pixel-center even-odd scanline fill (the
  GDAL/rasterio default `all_touched=False` semantic).
- :func:`burn_tiles` — tiles touched by a polygon at a zoom level (interior
  cells by center-inside fill plus boundary cells by grid traversal — the
  `all_touched=True` semantic supermercado uses).
"""

import math

import numpy as np

from robosat_tpu_torch.geo.tilemath import Tile, tile_fraction


def _polygon_rings(geometry):
    """Rings of a GeoJSON Polygon/MultiPolygon mapping as float arrays."""
    gtype = geometry["type"]
    coords = geometry["coordinates"]
    rings = []
    if gtype == "Polygon":
        rings.extend(coords)
    elif gtype == "MultiPolygon":
        for poly in coords:
            rings.extend(poly)
    else:
        raise ValueError("cannot rasterize geometry type {}".format(gtype))
    return [np.asarray(r, dtype=np.float64) for r in rings if len(r) >= 3]


def fill_rings(rings, out, value=1):
    """Even-odd scanline fill of rings (in pixel coordinates) into `out`.

    A pixel (row, col) is set iff its center (col + .5, row + .5) is inside
    an odd number of rings. Fully vectorized: all (row, edge) crossings are
    computed in one broadcast, paired per row, and filled through a
    difference-array cumsum — no Python loop over rows or spans (the
    reference leaned on GDAL's C scanline for this, rasterize.py:81-83).
    """
    height, width = out.shape

    starts = []
    for ring in rings:
        pts = np.asarray(ring, dtype=np.float64)
        if len(pts) >= 2:
            starts.append(np.concatenate([pts, np.roll(pts, -1, axis=0)], axis=1))
    if not starts:
        return out
    edges = np.concatenate(starts)
    keep = edges[:, 1] != edges[:, 3]  # drop horizontal edges
    if not keep.any():
        return out
    x1, y1, x2, y2 = (edges[keep, i] for i in range(4))

    ymin = max(0, int(math.floor(min(y1.min(), y2.min()) - 0.5)))
    ymax = min(height - 1, int(math.ceil(max(y1.max(), y2.max()))))
    if ymax < ymin:
        return out

    rows = np.arange(ymin, ymax + 1)
    yc = rows + 0.5

    # Every (row, edge) crossing at once.
    crossing = (y1[None, :] > yc[:, None]) != (y2[None, :] > yc[:, None])
    r_idx, e_idx = np.nonzero(crossing)
    if len(r_idx) == 0:
        return out
    xs = x1[e_idx] + (yc[r_idx] - y1[e_idx]) * (x2[e_idx] - x1[e_idx]) / (y2[e_idx] - y1[e_idx])

    # Sort by (row, x); even-odd rings cross each scanline an even number of
    # times, so consecutive pairs within a row bound the fill spans.
    order = np.lexsort((xs, r_idx))
    r_sorted = r_idx[order]
    x_sorted = xs[order]
    row_start = np.r_[0, np.flatnonzero(np.diff(r_sorted)) + 1]
    counts = np.diff(np.r_[row_start, len(r_sorted)])
    pos = np.arange(len(r_sorted)) - np.repeat(row_start, counts)

    lo_mask = pos % 2 == 0
    # Guard an odd trailing crossing (numerically degenerate ring): drop it.
    span_rows = r_sorted[lo_mask]
    lo = np.ceil(x_sorted[lo_mask] - 0.5).astype(np.int64)
    hi_all = np.floor(x_sorted[~lo_mask] - 0.5).astype(np.int64)
    if len(hi_all) < len(lo):
        lo = lo[: len(hi_all)]
        span_rows = span_rows[: len(hi_all)]
    hi = hi_all[: len(lo)]

    ok = (hi >= 0) & (lo < width)
    lo = np.clip(lo[ok], 0, width - 1)
    hi = np.clip(hi[ok], 0, width - 1)
    span_rows = span_rows[ok]
    ok = lo <= hi
    lo, hi, span_rows = lo[ok], hi[ok], span_rows[ok]
    if len(lo) == 0:
        return out

    # Difference-array fill: +1 at span start, -1 past span end, cumsum.
    diff = np.zeros((ymax - ymin + 1, width + 1), dtype=np.int32)
    np.add.at(diff, (span_rows, lo), 1)
    np.add.at(diff, (span_rows, hi + 1), -1)
    inside = np.cumsum(diff[:, :-1], axis=1) > 0
    out[ymin : ymax + 1][inside] = value
    return out


def rasterize_polygons(shapes, out_shape, bounds, dtype=np.uint8):
    """Rasterize (geometry, value) pairs onto a grid over `bounds`.

    Args:
      shapes: iterable of (GeoJSON geometry mapping, burn value); geometry
        coordinates must be in the same CRS as `bounds`.
      out_shape: (height, width) of the output grid.
      bounds: (left, bottom, right, top) world extent of the grid (north-up).

    Returns the burned array (later shapes overwrite earlier ones, like
    rasterio).
    """
    height, width = out_shape
    left, bottom, right, top = bounds
    xres = (right - left) / width
    yres = (top - bottom) / height

    out = np.zeros(out_shape, dtype=dtype)
    for geometry, value in shapes:
        rings = _polygon_rings(geometry)
        pix_rings = []
        for ring in rings:
            cols = (ring[:, 0] - left) / xres
            rows = (top - ring[:, 1]) / yres
            pix_rings.append(np.stack([cols, rows], axis=1))
        mask = fill_rings(pix_rings, np.zeros(out_shape, dtype=bool), value=True)
        out[mask] = value
    return out


def _traverse_cells(x1, y1, x2, y2, mark):
    """Mark every grid cell a segment passes through (supercover DDA)."""
    mark(int(math.floor(x1)), int(math.floor(y1)))
    mark(int(math.floor(x2)), int(math.floor(y2)))
    dx, dy = x2 - x1, y2 - y1
    steps = int(2 * math.ceil(max(abs(dx), abs(dy)))) + 1
    # Dense sampling at half-cell resolution marks every crossed cell for the
    # short edges typical of building/parking footprints; endpoints above
    # anchor degenerate cases.
    for i in range(1, steps):
        t = i / steps
        mark(int(math.floor(x1 + t * dx)), int(math.floor(y1 + t * dy)))


def burn_tiles(feature, zoom):
    """All tiles at `zoom` touched by a GeoJSON Polygon/MultiPolygon feature.

    Returns a list of Tile. Parity target: supermercado.burntiles.burn
    (robosat/tools/cover.py:29-30).
    """
    geometry = feature["geometry"] if feature.get("type") == "Feature" else feature
    rings = _polygon_rings(geometry)
    if not rings:
        return []

    # Rings in continuous tile coordinates.
    tile_rings = []
    for ring in rings:
        pts = [tile_fraction(lng, lat, zoom) for lng, lat in ring[:, :2]]
        tile_rings.append(np.asarray(pts, dtype=np.float64))

    allpts = np.concatenate(tile_rings, axis=0)
    x0 = int(math.floor(allpts[:, 0].min()))
    y0 = int(math.floor(allpts[:, 1].min()))
    x1 = int(math.floor(allpts[:, 0].max()))
    y1 = int(math.floor(allpts[:, 1].max()))
    w, h = x1 - x0 + 1, y1 - y0 + 1

    touched = np.zeros((h, w), dtype=bool)

    def mark(cx, cy):
        if x0 <= cx <= x1 and y0 <= cy <= y1:
            touched[cy - y0, cx - x0] = True

    # Boundary cells.
    for ring in tile_rings:
        n = len(ring)
        for i in range(n):
            ax, ay = ring[i]
            bx, by = ring[(i + 1) % n]
            _traverse_cells(ax, ay, bx, by, mark)

    # Interior cells (center-inside, even-odd, shifted to the local window).
    local = [ring - np.array([x0, y0], dtype=np.float64) for ring in tile_rings]
    fill_rings(local, touched, value=True)

    ys, xs = np.nonzero(touched)
    n = 2**zoom
    return [Tile(int(x + x0) % n, int(y + y0), zoom) for x, y in zip(xs, ys) if 0 <= y + y0 < n]
