"""Lightweight planar geometry: shapes, predicates, and measures.

This package's copy of robosat_tpu/geo/geometry.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_geo.py.

Replaces the reference's shapely/GEOS dependency (robosat/spatial/core.py,
robosat/osm/*.py, robosat/tools/{merge,dedupe}.py) for the subset of geometry
the pipeline uses: polygon validity, area, orientation, bounds, containment,
intersection tests, and GeoJSON mapping. Boolean operations (union,
intersection, difference) live in :mod:`robosat_tpu_torch.geo.clip`; buffering in
:mod:`robosat_tpu_torch.geo.buffer`.

Rings are numpy (N, 2) float64 arrays of (x, y) and are stored *unclosed*
(no repeated last vertex); GeoJSON I/O closes/uncloses at the boundary.
"""

import numpy as np


def as_ring(coords):
    """Normalize a coordinate sequence to an unclosed (N, 2) float64 ring."""
    ring = np.asarray(coords, dtype=np.float64)
    if ring.ndim != 2 or ring.shape[1] < 2:
        raise ValueError("ring must be a sequence of (x, y) points")
    ring = ring[:, :2]
    if len(ring) >= 2 and np.array_equal(ring[0], ring[-1]):
        ring = ring[:-1]
    return ring


def ring_area(ring):
    """Signed area via the shoelace formula (positive = counter-clockwise).

    Coordinates are centered on the first vertex before the products: at
    projected-CRS magnitudes (EPSG:3395 / Mollweide x ~ 1.4e7 m) the raw
    shoelace products are ~6e13 with an ulp of ~0.008 m^2 EACH, and a
    ~100-vertex city-block ring accumulates ~1 m^2 of rounding error —
    measured against the overlay engine's slab areas, which are computed in
    a local frame and don't drift. Centering makes the products span-scaled
    and the result exact to ~1e-9 relative."""
    ring = np.asarray(ring, dtype=np.float64)
    if len(ring) < 3:
        return 0.0
    x = ring[:, 0] - ring[0, 0]
    y = ring[:, 1] - ring[0, 1]
    # Shoelace with the wrap term split out (no np.roll copies).
    area2 = np.dot(x[:-1], y[1:]) - np.dot(x[1:], y[:-1]) + x[-1] * y[0] - x[0] * y[-1]
    return 0.5 * float(area2)


def ring_is_simple(ring):
    """True if no two non-adjacent edges of the ring properly intersect.

    Native fast path (geometry.cpp rs_ring_is_simple, same closed-segment
    semantics); numpy all-pairs fallback below doubles as the oracle.
    Adjacent edges sharing a vertex are allowed; any other contact
    (crossing, overlap, touch) makes the ring non-simple.
    """
    n = len(ring)
    if n < 3:
        return False
    pts = np.asarray(ring, dtype=np.float64)

    native_pred = _native_ring_is_simple()
    if native_pred is not None:
        return native_pred(pts)
    p1 = pts
    p2 = np.roll(pts, -1, axis=0)

    if np.any(np.all(p1 == p2, axis=1)):
        return False  # degenerate zero-length edge

    # Adjacent edges: shared endpoint allowed, collinear overlap is not.
    nxt = np.roll(np.arange(n), -1)
    if np.any(_collinear_overlap_rows(p1, p2, p1[nxt], p2[nxt])):
        return False

    # Non-adjacent pairs, chunked to bound the n^2 broadcast memory.
    idx = np.arange(n)
    for start in range(0, n, _PAIR_CHUNK):
        stop = min(start + _PAIR_CHUNK, n)
        hits = _segments_cross_block(p1[start:stop], p2[start:stop], p1, p2)
        gap = np.abs(idx[start:stop, None] - idx[None, :])
        hits &= (gap > 1) & (gap < n - 1)
        if hits.any():
            return False
    return True


def _orient2d(a, b, c):
    """Twice the signed area of triangle abc."""
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


def _on_segment(p, q, r):
    """True if collinear point r lies within segment pq's bounding box."""
    return min(p[0], q[0]) <= r[0] <= max(p[0], q[0]) and min(p[1], q[1]) <= r[1] <= max(p[1], q[1])


def segments_intersect(p1, p2, q1, q2):
    """True if closed segments [p1,p2] and [q1,q2] share any point."""
    d1 = _orient2d(q1, q2, p1)
    d2 = _orient2d(q1, q2, p2)
    d3 = _orient2d(p1, p2, q1)
    d4 = _orient2d(p1, p2, q2)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)) and d1 != 0 and d2 != 0 and d3 != 0 and d4 != 0:
        return True
    if d1 == 0 and _on_segment(q1, q2, p1):
        return True
    if d2 == 0 and _on_segment(q1, q2, p2):
        return True
    if d3 == 0 and _on_segment(p1, p2, q1):
        return True
    if d4 == 0 and _on_segment(p1, p2, q2):
        return True
    return False


def _collinear_overlap(p1, p2, q1, q2):
    """True if two segments are collinear and overlap in more than a point."""
    if _orient2d(p1, p2, q1) != 0 or _orient2d(p1, p2, q2) != 0:
        return False
    # Project onto the dominant axis and test interval overlap length.
    axis = 0 if abs(p2[0] - p1[0]) >= abs(p2[1] - p1[1]) else 1
    a0, a1 = sorted((p1[axis], p2[axis]))
    b0, b1 = sorted((q1[axis], q2[axis]))
    return min(a1, b1) - max(a0, b0) > 0


# Row chunk for the O(n*m) pairwise broadcasts below: caps peak temporary
# memory at ~_PAIR_CHUNK * m * 8B per matrix while keeping numpy throughput.
_PAIR_CHUNK = 512


def _collinear_overlap_rows(p1, p2, q1, q2):
    """Rowwise `_collinear_overlap` over (N, 2) segment arrays -> bool (N,)."""
    d1 = (p2[:, 0] - p1[:, 0]) * (q1[:, 1] - p1[:, 1]) - (p2[:, 1] - p1[:, 1]) * (q1[:, 0] - p1[:, 0])
    d2 = (p2[:, 0] - p1[:, 0]) * (q2[:, 1] - p1[:, 1]) - (p2[:, 1] - p1[:, 1]) * (q2[:, 0] - p1[:, 0])
    collinear = (d1 == 0) & (d2 == 0)

    use_x = np.abs(p2[:, 0] - p1[:, 0]) >= np.abs(p2[:, 1] - p1[:, 1])
    pa = np.where(use_x, p1[:, 0], p1[:, 1])
    pb = np.where(use_x, p2[:, 0], p2[:, 1])
    qa = np.where(use_x, q1[:, 0], q1[:, 1])
    qb = np.where(use_x, q2[:, 0], q2[:, 1])
    overlap = np.minimum(np.maximum(pa, pb), np.maximum(qa, qb)) - np.maximum(np.minimum(pa, pb), np.minimum(qa, qb))
    return collinear & (overlap > 0)


def _segments_cross_block(a1, a2, b1, b2):
    """Pairwise `segments_intersect` over segment arrays, vectorized.

    a1, a2: (na, 2) segment endpoints; b1, b2: (nb, 2). Returns bool
    (na, nb) with semantics identical to the scalar predicate (closed
    segments; touching counts).
    """
    ax1, ay1 = a1[:, 0, None], a1[:, 1, None]
    ax2, ay2 = a2[:, 0, None], a2[:, 1, None]
    bx1, by1 = b1[None, :, 0], b1[None, :, 1]
    bx2, by2 = b2[None, :, 0], b2[None, :, 1]

    # orient(b1, b2, a1) etc., broadcast to (na, nb).
    d1 = (bx2 - bx1) * (ay1 - by1) - (by2 - by1) * (ax1 - bx1)
    d2 = (bx2 - bx1) * (ay2 - by1) - (by2 - by1) * (ax2 - bx1)
    d3 = (ax2 - ax1) * (by1 - ay1) - (ay2 - ay1) * (bx1 - ax1)
    d4 = (ax2 - ax1) * (by2 - ay1) - (ay2 - ay1) * (bx2 - ax1)

    proper = (
        ((d1 > 0) != (d2 > 0))
        & ((d3 > 0) != (d4 > 0))
        & (d1 != 0)
        & (d2 != 0)
        & (d3 != 0)
        & (d4 != 0)
    )

    def on_b(x, y):
        return (
            (np.minimum(bx1, bx2) <= x)
            & (x <= np.maximum(bx1, bx2))
            & (np.minimum(by1, by2) <= y)
            & (y <= np.maximum(by1, by2))
        )

    def on_a(x, y):
        return (
            (np.minimum(ax1, ax2) <= x)
            & (x <= np.maximum(ax1, ax2))
            & (np.minimum(ay1, ay2) <= y)
            & (y <= np.maximum(ay1, ay2))
        )

    touch = (
        ((d1 == 0) & on_b(ax1, ay1))
        | ((d2 == 0) & on_b(ax2, ay2))
        | ((d3 == 0) & on_a(bx1, by1))
        | ((d4 == 0) & on_a(bx2, by2))
    )
    return proper | touch


def _edges_cross(pa_edges, pb_edges):
    """True if any segment of edge set A intersects any of edge set B."""
    a1, a2 = pa_edges
    b1, b2 = pb_edges
    for start in range(0, len(a1), _PAIR_CHUNK):
        stop = min(start + _PAIR_CHUNK, len(a1))
        if _segments_cross_block(a1[start:stop], a2[start:stop], b1, b2).any():
            return True
    return False


def _polygon_edges(poly):
    """All boundary segments of a polygon as ((E, 2) starts, (E, 2) ends)."""
    starts, ends = [], []
    for ring in poly.rings:
        if len(ring) >= 2:
            starts.append(ring)
            ends.append(np.roll(ring, -1, axis=0))
    if not starts:
        empty = np.zeros((0, 2), dtype=np.float64)
        return empty, empty
    return np.concatenate(starts), np.concatenate(ends)


def point_in_ring(point, ring):
    """Even-odd point-in-ring test, vectorized over the ring's edges.
    Points on the boundary count as inside."""
    x, y = float(point[0]), float(point[1])
    ring = np.asarray(ring, dtype=np.float64)
    if len(ring) == 0:
        return False
    x1, y1 = ring[:, 0], ring[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)

    # Boundary check.
    d = (x2 - x1) * (y - y1) - (y2 - y1) * (x - x1)
    on_edge = (
        (d == 0)
        & (np.minimum(x1, x2) <= x)
        & (x <= np.maximum(x1, x2))
        & (np.minimum(y1, y2) <= y)
        & (y <= np.maximum(y1, y2))
    )
    if on_edge.any():
        return True

    crossing = (y1 > y) != (y2 > y)
    if not crossing.any():
        return False
    xint = x1[crossing] + (y - y1[crossing]) * (x2[crossing] - x1[crossing]) / (y2[crossing] - y1[crossing])
    return bool(np.count_nonzero(x < xint) % 2)


class Geometry:
    """Base class for planar geometries.

    Coordinate arrays (Polygon.shell / .holes, LineString.coords) are treated
    as IMMUTABLE once constructed: bounds and native-engine packed-coordinate
    buffers cache on the instance keyed by identity. The first cache access
    marks the arrays read-only (numpy setflags) so an in-place mutation that
    would silently stale those caches raises at write time instead.
    """

    geom_type = None

    @property
    def is_empty(self):
        raise NotImplementedError


class LineString(Geometry):
    geom_type = "LineString"

    def __init__(self, coords):
        self.coords = np.asarray(coords, dtype=np.float64)

    @property
    def is_empty(self):
        return len(self.coords) < 2

    @property
    def is_valid(self):
        return len(self.coords) >= 2

    @property
    def bounds(self):
        b = getattr(self, "_bounds", None)
        if b is None:
            self.coords.setflags(write=False)  # cache staleness guard (see Geometry)
            lo = self.coords.min(axis=0)
            hi = self.coords.max(axis=0)
            b = self._bounds = (float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1]))
        return b

    def __geo_interface__(self):
        return {"type": "LineString", "coordinates": [[float(x), float(y)] for x, y in self.coords]}


class Polygon(Geometry):
    """A polygon with one exterior shell and zero or more holes."""

    geom_type = "Polygon"

    def __init__(self, shell, holes=()):
        self.shell = as_ring(shell)
        self.holes = [as_ring(h) for h in holes]

    @property
    def is_empty(self):
        return len(self.shell) < 3

    @property
    def rings(self):
        return [self.shell] + self.holes

    @property
    def area(self):
        return abs(ring_area(self.shell)) - sum(abs(ring_area(h)) for h in self.holes)

    @property
    def bounds(self):
        # Cached: rings are treated as immutable, and the merge/dedupe graph
        # build calls bounds O(candidate-pairs) times per geometry.
        b = getattr(self, "_bounds", None)
        if b is None:
            self.shell.setflags(write=False)  # cache staleness guard (see Geometry)
            lo = self.shell.min(axis=0)
            hi = self.shell.max(axis=0)
            b = self._bounds = (float(lo[0]), float(lo[1]), float(hi[0]), float(hi[1]))
        return b

    @property
    def is_valid(self):
        """Basic validity: simple rings, >= 3 vertices, holes inside shell.

        A pragmatic subset of the OGC rules; catches the cases the pipeline
        filters on (self-intersecting OSM ways and degenerate simplified
        contours; reference call sites robosat/osm/parking.py:36-39,
        robosat/features/parking.py:94-100).
        """
        if len(self.shell) < 3 or ring_area(self.shell) == 0:
            return False
        if not ring_is_simple(self.shell):
            return False
        for hole in self.holes:
            if len(hole) < 3 or not ring_is_simple(hole):
                return False
            if not all(point_in_ring(p, self.shell) for p in hole):
                return False
        return True

    def contains_point(self, point):
        if not point_in_ring(point, self.shell):
            return False
        for hole in self.holes:
            if point_in_ring(point, hole) and not _point_on_ring_boundary(point, hole):
                return False
        return True

    def __geo_interface__(self):
        rings = []
        for ring in self.rings:
            closed = np.asarray(ring, np.float64).tolist()  # C-speed, same floats
            closed.append(closed[0])
            rings.append(closed)
        return {"type": "Polygon", "coordinates": rings}


class MultiPolygon(Geometry):
    geom_type = "MultiPolygon"

    def __init__(self, polygons):
        self.geoms = [p for p in polygons if not p.is_empty]

    @property
    def is_empty(self):
        return not self.geoms

    @property
    def area(self):
        return sum(p.area for p in self.geoms)

    @property
    def bounds(self):
        b = getattr(self, "_bounds", None)
        if b is not None:
            return b
        bs = [p.bounds for p in self.geoms]
        b = self._bounds = (
            min(bb[0] for bb in bs),
            min(bb[1] for bb in bs),
            max(bb[2] for bb in bs),
            max(bb[3] for bb in bs),
        )
        return b

    @property
    def is_valid(self):
        return all(p.is_valid for p in self.geoms)

    def contains_point(self, point):
        return any(p.contains_point(point) for p in self.geoms)

    def __geo_interface__(self):
        return {"type": "MultiPolygon", "coordinates": [p.__geo_interface__()["coordinates"] for p in self.geoms]}


def _point_on_ring_boundary(point, ring):
    x, y = float(point[0]), float(point[1])
    ring = np.asarray(ring, dtype=np.float64)
    x1, y1 = ring[:, 0], ring[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    d = (x2 - x1) * (y - y1) - (y2 - y1) * (x - x1)
    on_edge = (
        (d == 0)
        & (np.minimum(x1, x2) <= x)
        & (x <= np.maximum(x1, x2))
        & (np.minimum(y1, y2) <= y)
        & (y <= np.maximum(y1, y2))
    )
    return bool(on_edge.any())


def shape(mapping):
    """Build a Geometry from a GeoJSON geometry mapping."""
    gtype = mapping["type"]
    coords = mapping["coordinates"]
    if gtype == "Polygon":
        if not coords:
            return Polygon(np.zeros((0, 2)))
        return Polygon(coords[0], coords[1:])
    if gtype == "MultiPolygon":
        return MultiPolygon([Polygon(c[0], c[1:]) for c in coords if c])
    if gtype == "LineString":
        return LineString(coords)
    if gtype == "Point":
        return PointGeom(coords)
    raise ValueError("unsupported geometry type: {}".format(gtype))


class PointGeom(Geometry):
    geom_type = "Point"

    def __init__(self, coords):
        self.coords = (float(coords[0]), float(coords[1]))

    @property
    def is_empty(self):
        return False

    @property
    def bounds(self):
        x, y = self.coords
        return (x, y, x, y)

    def __geo_interface__(self):
        return {"type": "Point", "coordinates": [self.coords[0], self.coords[1]]}


def mapping(geom):
    """GeoJSON geometry mapping for a Geometry."""
    return geom.__geo_interface__()


def transform_geometry(fn, geom):
    """Apply `fn(xs, ys) -> (xs', ys')` to every coordinate of a geometry."""
    if isinstance(geom, Polygon):
        def tx(ring):
            if len(ring) == 0:
                return ring
            xs, ys = fn(ring[:, 0], ring[:, 1])
            return np.stack([np.asarray(xs), np.asarray(ys)], axis=1)

        return Polygon(tx(geom.shell), [tx(h) for h in geom.holes])
    if isinstance(geom, MultiPolygon):
        return MultiPolygon([transform_geometry(fn, p) for p in geom.geoms])
    if isinstance(geom, LineString):
        xs, ys = fn(geom.coords[:, 0], geom.coords[:, 1])
        return LineString(np.stack([np.asarray(xs), np.asarray(ys)], axis=1))
    if isinstance(geom, PointGeom):
        xs, ys = fn(np.array([geom.coords[0]]), np.array([geom.coords[1]]))
        return PointGeom((float(np.asarray(xs)[0]), float(np.asarray(ys)[0])))
    raise ValueError("unsupported geometry: {}".format(type(geom)))


def transform_multipolygons(geoms, fn):
    """Apply an elementwise (xs, ys) -> (xs', ys') transform to every ring of
    every MultiPolygon in ONE vectorized call — identical values to per-ring
    `transform_geometry` (the projections are elementwise ufunc chains)
    without ~3 numpy dispatches per tiny ring. Used by the merge/dedupe
    finishing passes over city-scale feature collections."""
    rings, layout = [], []
    for mp in geoms:
        per = []
        for p in mp.geoms:
            per.append(1 + len(p.holes))
            rings.append(np.asarray(p.shell, np.float64))
            rings.extend(np.asarray(h, np.float64) for h in p.holes)
        layout.append(per)
    if not rings:
        return list(geoms)
    lens = np.fromiter((len(r) for r in rings), np.int64, len(rings))
    flat = np.concatenate(rings)
    xs, ys = fn(flat[:, 0], flat[:, 1])
    out_rings = np.split(np.stack([np.asarray(xs), np.asarray(ys)], axis=1), np.cumsum(lens)[:-1])
    out, ri = [], 0
    for per in layout:
        polys = []
        for n_rings in per:
            polys.append(Polygon(out_rings[ri], list(out_rings[ri + 1 : ri + n_rings])))
            ri += n_rings
        out.append(MultiPolygon(polys))
    return out


def orient_polygon(poly, sign=1.0):
    """Return the polygon with exterior ring oriented CCW (sign=1) or CW
    (sign=-1) and holes oriented opposite. Parity:
    shapely.geometry.polygon.orient used in robosat/tools/merge.py:68-73."""
    def oriented(ring, want_ccw):
        is_ccw = ring_area(ring) > 0
        return ring if is_ccw == want_ccw else ring[::-1]

    want_ccw = sign > 0
    return Polygon(oriented(poly.shell, want_ccw), [oriented(h, not want_ccw) for h in poly.holes])


def bounds_intersect(a, b):
    """True if two (minx, miny, maxx, maxy) boxes overlap (closed)."""
    return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])


def geometries_intersect(a, b):
    """True if two polygonal geometries share any point.

    Tests boundary segment intersection and mutual containment; used by the
    merge/dedupe graph construction (robosat/tools/merge.py:54-56,
    robosat/tools/dedupe.py:58).
    """
    if not bounds_intersect(a.bounds, b.bounds):
        return False

    a_polys = a.geoms if isinstance(a, MultiPolygon) else [a]
    b_polys = b.geoms if isinstance(b, MultiPolygon) else [b]

    native_pred = _native_polys_intersect()

    for pa in a_polys:
        pa_edges = None
        for pb in b_polys:
            if not bounds_intersect(pa.bounds, pb.bounds):
                continue
            if native_pred is not None:
                if native_pred(pa, pb):
                    return True
                continue
            # Containment (either direction).
            if pb.contains_point(tuple(pa.shell[0])) or pa.contains_point(tuple(pb.shell[0])):
                return True
            # Boundary crossing: one batched all-pairs segment test per
            # polygon pair instead of a Python loop per segment pair.
            if pa_edges is None:
                pa_edges = _polygon_edges(pa)
            if _edges_cross(pa_edges, _polygon_edges(pb)):
                return True
    return False


def _native_ring_is_simple():
    """The C++ ring-simplicity predicate, or None when unavailable."""
    try:
        from robosat_tpu_torch import native
    except Exception:  # pragma: no cover - import cycle safety
        return None
    if native.load() is None:
        return None
    return native.ring_is_simple


def _native_polys_intersect():
    """The C++ polygon-pair predicate (native/geometry.cpp
    rs_polys_intersect, same containment + closed-segment semantics as the
    Python path below it), or None when the native engine is unavailable."""
    try:
        from robosat_tpu_torch import native
    except Exception:  # pragma: no cover - import cycle safety
        return None
    if native.load() is None:
        return None
    return native.polys_intersect


def representative_point(ring):
    """A point strictly inside a simple ring (scanline midpoint heuristic)."""
    ring = np.asarray(ring, dtype=np.float64)
    ys = ring[:, 1]
    # Probe a few horizontal lines to dodge vertex-aligned degeneracies.
    ymin, ymax = float(ys.min()), float(ys.max())
    for frac in (0.5, 0.37, 0.63, 0.29, 0.71):
        y = ymin + (ymax - ymin) * frac
        xs = []
        n = len(ring)
        for i in range(n):
            x1, y1 = ring[i]
            x2, y2 = ring[(i + 1) % n]
            if (y1 > y) != (y2 > y):
                xs.append(x1 + (y - y1) * (x2 - x1) / (y2 - y1))
        xs.sort()
        if len(xs) >= 2:
            return ((xs[0] + xs[1]) / 2.0, y)
    # Fallback: centroid of the first non-degenerate vertex triangle.
    return (float(ring[:, 0].mean()), float(ring[:, 1].mean()))
