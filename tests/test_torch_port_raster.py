"""The port's tile math and rasterizer vs the JAX package's, exactly.

`robosat_tpu_torch.geo.tilemath` and `geo.raster` are copies of
robosat_tpu's: their float order decides which pixel or tile is in, so every
result here must be equal, not close. Inputs are seeded lon/lat points at
several zooms (with the poles, the web-mercator limits and the
antimeridian), seeded polygons (holes, MultiPolygons, degenerate rings) in
pixel space and on the map, and covers across the antimeridian and off the
map's south edge. Counterparts of tests/test_tilemath.py and
tests/test_raster.py.
"""

import math

import numpy as np
import pytest

from robosat_tpu.geo import raster as jraster
from robosat_tpu.geo import tilemath as jtilemath
from robosat_tpu_torch.geo import raster, tilemath

ZOOMS = (0, 1, 7, 14, 18, 22)
EDGE_LATS = (85.05, -85.05, 85.0511287798066, -85.0511287798066, 89.9, -89.9, 0.0)
EDGE_LNGS = (180.0, -180.0, 179.9999999, -179.9999999, 0.0)


def _points(seed, n=200):
    rng = np.random.default_rng(seed)
    lngs = rng.uniform(-180.0, 180.0, n).tolist() + list(EDGE_LNGS) * len(EDGE_LATS)
    lats = rng.uniform(-85.1, 85.1, n).tolist() + [lat for lat in EDGE_LATS for _ in EDGE_LNGS]
    return list(zip(lngs, lats))


def _same(a, b):
    """Equal, with NaN equal to NaN (lnglat of an infinite y)."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("zoom", ZOOMS)
def test_tile_functions_match(zoom):
    for lng, lat in _points(zoom):
        assert tilemath.tile_fraction(lng, lat, zoom) == jtilemath.tile_fraction(lng, lat, zoom)
        t = tilemath.tile(lng, lat, zoom)
        assert t == jtilemath.tile(lng, lat, zoom)
        jt = jtilemath.Tile(*t)
        assert tilemath.bounds(t) == jtilemath.bounds(jt)
        assert tilemath.xy_bounds(t) == jtilemath.xy_bounds(jt)
        assert tilemath.children(t) == jtilemath.children(jt)
        if zoom > 0:
            assert tilemath.parent(t) == jtilemath.parent(jt)
    n = 2**zoom
    for t in (tilemath.Tile(0, 0, zoom), tilemath.Tile(n - 1, n - 1, zoom)):
        assert tilemath.bounds(t) == jtilemath.bounds(t)
        assert tilemath.xy_bounds(t) == jtilemath.xy_bounds(t)
    assert tilemath._lat_from_ty(0.5 * n, n) == jtilemath._lat_from_ty(0.5 * n, n)


def test_xy_and_lnglat_match():
    pts = _points(99) + [(0.0, 90.0), (0.0, -90.0), (12.5, 91.0), (-12.5, -91.0)]
    for lng, lat in pts:
        xy = tilemath.xy(lng, lat)
        assert xy == jtilemath.xy(lng, lat)
        assert _same(tilemath.lnglat(*xy), jtilemath.lnglat(*xy))
    assert tilemath.xy(0.0, 90.0)[1] == math.inf and tilemath.xy(0.0, -90.0)[1] == -math.inf
    assert (tilemath.CE, tilemath.MAX_LAT, tilemath.EARTH_RADIUS) == (jtilemath.CE, jtilemath.MAX_LAT,
                                                                      jtilemath.EARTH_RADIUS)


def _random_ring(rng, cx, cy, radius, k):
    """A star-shaped ring of k vertices around (cx, cy), open (no repeat)."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, k))
    radii = rng.uniform(0.3, 1.0, k) * radius
    return np.stack([cx + radii * np.cos(angles), cy + radii * np.sin(angles)], 1)


def _pixel_rings(seed, size):
    """Seeded pixel-space rings: stars, a star with a hole, rings off the
    grid's edges, and degenerate rings (a line, a point, a horizontal sliver)."""
    rng = np.random.default_rng(seed)
    rings = [_random_ring(rng, *rng.uniform(-0.2 * size, 1.2 * size, 2), rng.uniform(3, size / 2),
                          int(rng.integers(3, 14))) for _ in range(6)]
    outer = _random_ring(rng, size / 2, size / 2, size / 2.5, 24)
    rings += [outer, 0.4 * (outer - size / 2) + size / 2]  # a hole under even-odd
    rings += [np.array([[1.0, 1.0], [size - 1.0, size - 1.0], [1.0, 1.0]]),  # zero area
              np.array([[3.5, 3.5], [3.5, 3.5], [3.5, 3.5]]),  # a point
              np.array([[0.0, 7.5], [size + 0.0, 7.5], [size / 2, 7.5000001]]),  # a sliver on a pixel center row
              np.array([[2.0, 2.0], [9.0, 2.0]])]  # two points
    return rings


@pytest.mark.parametrize("seed", range(4))
def test_fill_rings_matches(seed):
    size = 48 + 16 * seed
    rings = _pixel_rings(seed, size)
    for subset in (rings, rings[:1], rings[6:8], rings[8:]):
        got = raster.fill_rings(subset, np.zeros((size, size + 5), np.uint8), value=3)
        want = jraster.fill_rings(subset, np.zeros((size, size + 5), np.uint8), value=3)
        assert np.array_equal(got, want)
    assert got.dtype == np.uint8 and np.array_equal(
        raster.fill_rings(rings, np.zeros((size, size), bool), value=True),
        jraster.fill_rings(rings, np.zeros((size, size), bool), value=True))
    assert raster.fill_rings([], np.zeros((4, 4), np.uint8)).sum() == 0


def _geo_ring(rng, cx, cy, radius, k):
    ring = _random_ring(rng, cx, cy, radius, k).tolist()
    return ring + [ring[0]]


def _shapes(seed, bounds):
    """(geometry, value) pairs in the coordinates of `bounds`: polygons,
    one with two holes, a MultiPolygon, a degenerate two-point ring and a
    polygon partly outside."""
    rng = np.random.default_rng(seed)
    left, bottom, right, top = bounds
    w, h = right - left, top - bottom
    shapes = []
    for value in range(1, 5):
        cx, cy = left + rng.uniform(0, w), bottom + rng.uniform(0, h)
        shapes.append(({"type": "Polygon", "coordinates": [_geo_ring(rng, cx, cy, 0.3 * w, 9)]}, value))
    cx, cy = left + w / 2, bottom + h / 2
    outer = [[cx - 0.4 * w, cy - 0.4 * h], [cx + 0.4 * w, cy - 0.4 * h], [cx + 0.4 * w, cy + 0.4 * h],
             [cx - 0.4 * w, cy + 0.4 * h], [cx - 0.4 * w, cy - 0.4 * h]]
    holes = [_geo_ring(rng, cx - 0.2 * w, cy, 0.1 * w, 7), _geo_ring(rng, cx + 0.2 * w, cy, 0.1 * w, 5)]
    shapes.append(({"type": "Polygon", "coordinates": [outer] + holes}, 5))
    shapes.append(({"type": "MultiPolygon", "coordinates": [
        [_geo_ring(rng, left + 0.2 * w, bottom + 0.8 * h, 0.15 * w, 6)],
        [_geo_ring(rng, left + 0.8 * w, bottom + 0.2 * h, 0.15 * w, 6), _geo_ring(rng, left + 0.8 * w, bottom + 0.2 * h,
                                                                                 0.05 * w, 4)]]}, 6))
    shapes.append(({"type": "Polygon", "coordinates": [[[left, bottom], [right, top]]]}, 7))
    shapes.append(({"type": "Polygon", "coordinates": [_geo_ring(rng, right, top, 0.3 * w, 8)]}, 8))
    return shapes


@pytest.mark.parametrize("seed, size", [(0, 64), (1, 100), (2, 256)])
def test_rasterize_polygons_matches(seed, size):
    bounds = tilemath.xy_bounds(tilemath.Tile(41920 + seed, 101310, 18))
    shapes = _shapes(seed, bounds)
    got = raster.rasterize_polygons(iter(shapes), (size, size), bounds)
    want = jraster.rasterize_polygons(iter(shapes), (size, size), bounds)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(np.unique(got)) >= 5  # later shapes overwrite earlier ones
    wide = raster.rasterize_polygons(shapes, (size // 2, size), bounds, dtype=np.int32)
    assert np.array_equal(wide, jraster.rasterize_polygons(shapes, (size // 2, size), bounds, dtype=np.int32))


def test_polygon_rings_match_and_reject_other_types():
    geom = {"type": "MultiPolygon", "coordinates": [[[[0, 0], [1, 0], [1, 1], [0, 0]], [[0, 0], [1, 1]]],
                                                    [[[2, 2], [3, 2], [3, 3], [2, 2]]]]}
    got, want = raster._polygon_rings(geom), jraster._polygon_rings(geom)
    assert len(got) == len(want) == 2 and all(np.array_equal(a, b) for a, b in zip(got, want))
    line = {"type": "LineString", "coordinates": [[0, 0], [1, 1]]}
    for module in (raster, jraster):
        with pytest.raises(ValueError, match="cannot rasterize geometry type LineString"):
            module._polygon_rings(line)


def _lnglat_feature(ring_or_rings, multi=False):
    kind = "MultiPolygon" if multi else "Polygon"
    return {"type": "Feature", "properties": {}, "geometry": {"type": kind, "coordinates": ring_or_rings}}


def _cover_features(seed):
    """Seeded lots around 37.7 N, a holed polygon, a MultiPolygon, one ring
    across the antimeridian and one that reaches past the map's south edge."""
    rng = np.random.default_rng(seed)
    feats = []
    for _ in range(8):
        cx, cy = rng.uniform(-122.45, -122.40), rng.uniform(37.70, 37.75)
        feats.append(_lnglat_feature([_geo_ring(rng, cx, cy, rng.uniform(2e-4, 4e-3), int(rng.integers(4, 12)))]))
    outer = [[-122.43, 37.72], [-122.41, 37.72], [-122.41, 37.74], [-122.43, 37.74], [-122.43, 37.72]]
    hole = [[-122.425, 37.725], [-122.415, 37.725], [-122.415, 37.735], [-122.425, 37.735], [-122.425, 37.725]]
    feats.append(_lnglat_feature([outer, hole]))
    feats.append(_lnglat_feature([[_geo_ring(rng, 10.0, 50.0, 0.01, 7)], [_geo_ring(rng, 10.05, 50.02, 0.005, 5)]],
                                 multi=True))
    feats.append(_lnglat_feature([[[179.998, 10.0], [180.003, 10.0], [180.003, 10.004], [179.998, 10.004],
                                   [179.998, 10.0]]]))
    feats.append(_lnglat_feature([[[-179.999, -20.0], [-180.002, -20.0], [-180.002, -20.003], [-179.999, -20.0]]]))
    feats.append(_lnglat_feature([[[30.0, -85.0], [30.2, -85.0], [30.2, -89.0], [30.0, -89.0], [30.0, -85.0]]]))
    feats.append({"type": "Polygon", "coordinates": [_geo_ring(rng, 2.0, 2.0, 0.01, 6)]})  # a bare geometry
    return feats


@pytest.mark.parametrize("zoom", (10, 14, 18))
def test_burn_tiles_matches(zoom):
    feats = _cover_features(zoom)
    n = 2**zoom
    for k, feature in enumerate(feats):
        got = raster.burn_tiles(feature, zoom)
        assert got == jraster.burn_tiles(feature, zoom), k
        assert got and all(0 <= t.x < n and 0 <= t.y < n and t.z == zoom for t in got)
    across = {t.x for t in raster.burn_tiles(feats[10], zoom)}
    assert {0, n - 1} <= across  # the cover wraps x across the antimeridian
    south = raster.burn_tiles(feats[12], zoom)
    assert max(t.y for t in south) == n - 1  # rows past the south edge are dropped
    assert raster.burn_tiles(_lnglat_feature([[[0, 0], [1, 1]]]), zoom) == []
