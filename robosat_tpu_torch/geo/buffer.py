"""Geometry buffering (Minkowski dilation/erosion by a disc).

This package's copy of robosat_tpu/geo/buffer.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_geo.py.

Replaces shapely's `.buffer` (used for merge distance thresholds,
robosat/tools/merge.py:35-45, and road centerline widths,
robosat/osm/road.py:140-142) with a construction on top of the boolean
engine:

- dilate(G, r)  = union(G, rectangles swept along every edge, discs at every
  vertex) — the exact Minkowski sum of a polygon with a polygonal disc.
- erode(P, r)   = P minus dilate(boundary(P), r).

Discs are approximated by regular polygons with `quad_segs` segments per
quarter circle (default 8, matching GEOS's default fidelity).
"""

import math

import numpy as np

from robosat_tpu_torch.geo import clip
from robosat_tpu_torch.geo.geometry import LineString, MultiPolygon, Polygon, ring_area


def _native_buffer(rings, distance, quad_segs, mode):
    """One-call native buffer (piece generation + overlay + linking in C++,
    robosat_tpu_torch/native/geometry.cpp rs_buffer_rings), or None when the
    native engine is unavailable (callers fall back to the Python pieces
    path, which doubles as the oracle in tests)."""
    try:
        from robosat_tpu_torch import native
    except Exception:  # pragma: no cover - import cycle safety
        return None
    if native.load() is None:
        return None
    out_rings, q = native.buffer_rings(rings, distance, quad_segs, mode)
    return clip._assemble_polygons(out_rings, q, presimplified=True)


def _offset_curve(coords, radius, quad_segs, inward):
    """Raw offset curve (the Chen & McMains / Clipper winding construction)
    of one closed ring: every edge translated by `radius` along its left
    (inward=True, erosion of a canonically-oriented polygon) or right
    (dilation) normal. Consecutive offset edges join at the shared vertex by
    the join the gap demands: gap-OPENING turns (convex for dilation, reflex
    for erosion) get the forward round arc — the same circle samples as
    `_vertex_wedge` (same step cap, same endpoints) — while gap-CLOSING
    turns, where the rails cross, get Clipper's 3-point pinch through the
    original vertex. The pinch (not a backward arc) is what keeps the
    winding rule exact when rails from far-apart edges overlap: backward
    arcs donate a spurious +2*pi of winding per full traversal, which makes
    e.g. an erosion past the inradius report the whole polygon instead of
    vanishing. The winding>0 region of the curves (plus the base rings for
    dilation, intersected with the base for erosion) is exactly the region
    the per-edge quad + vertex wedge pieces cover, but the overlay sees ONE
    ring of ~n + arc vertices instead of ~n overlapping 4-gons + wedges,
    which is what makes large buffers cheap.

    Returns an (M, 2) float64 array, or None when the ring degenerates
    (callers fall back to the pieces construction, whose endpoint discs
    handle it)."""
    coords = np.asarray(coords, dtype=np.float64)
    if len(coords) >= 2 and (coords[0] == coords[-1]).all():
        coords = coords[:-1]
    # Consecutive duplicates create zero-length edges; the disc the pieces
    # path would put there is covered by either neighboring edge's band, so
    # dropping them preserves the covered region exactly.
    if len(coords) >= 2:
        keep = np.any(coords != np.roll(coords, 1, axis=0), axis=1)
        coords = coords[keep]
    n = len(coords)
    if n < 3:
        return None
    delta = np.roll(coords, -1, axis=0) - coords
    length = np.hypot(delta[:, 0], delta[:, 1])
    if np.any(length == 0.0):  # pragma: no cover - deduped above
        return None
    theta = np.arctan2(delta[:, 1], delta[:, 0])
    phi = theta + (0.5 * math.pi if inward else -0.5 * math.pi)
    step_cap = 0.5 * math.pi / max(quad_segs, 1)

    pts = []
    for i in range(n):
        prev = (i - 1) % n
        turn = (theta[i] - theta[prev] + math.pi) % (2.0 * math.pi) - math.pi
        if abs(abs(turn) - math.pi) < 1e-9:
            # Spike / collinear-reversal vertex: the modulo maps a +-pi turn
            # to -pi regardless of which join the gap demands, so a dilation
            # spike tip would get the 3-point pinch instead of the half-disc
            # cap. Degenerate ring: let callers use the pieces construction,
            # whose vertex discs cover the tip exactly.
            return None
        v = coords[i]
        if abs(turn) < 1e-12:
            pts.append(v[None, :] + radius * np.array([[math.cos(phi[i]), math.sin(phi[i])]]))
            continue
        if (turn > 0.0) == inward:
            # Rails cross: pinch through the original vertex (Clipper's
            # "concave join").
            pts.append(
                np.array(
                    [
                        [v[0] + radius * math.cos(phi[prev]), v[1] + radius * math.sin(phi[prev])],
                        [v[0], v[1]],
                        [v[0] + radius * math.cos(phi[i]), v[1] + radius * math.sin(phi[i])],
                    ]
                )
            )
            continue
        steps = max(int(math.ceil(abs(turn) / step_cap)), 1)
        angles = phi[prev] + turn * np.arange(steps + 1) / steps
        pts.append(
            np.stack([v[0] + radius * np.cos(angles), v[1] + radius * np.sin(angles)], axis=1)
        )
    return np.concatenate(pts)


_UNIT_DISCS = {}


def _disc(center, radius, quad_segs):
    n = max(4 * quad_segs, 4)
    unit = _UNIT_DISCS.get(n)
    if unit is None:
        angles = np.arange(n) * (2.0 * math.pi / n)
        unit = _UNIT_DISCS[n] = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    return np.asarray(center, dtype=np.float64) + radius * unit


def _edge_quad(p1, p2, radius):
    """Rectangle covering all points within `radius` of segment [p1, p2]."""
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    length = math.hypot(dx, dy)
    if length == 0.0:
        return None
    nx, ny = -dy / length * radius, dx / length * radius
    return np.array(
        [
            [p1[0] + nx, p1[1] + ny],
            [p2[0] + nx, p2[1] + ny],
            [p2[0] - nx, p2[1] - ny],
            [p1[0] - nx, p1[1] - ny],
        ]
    )


def _vertex_wedge(v, d1, d2, radius, quad_segs):
    """The part of the radius-disc at `v` not covered by the edge quads.

    An edge quad for p->v covers (around v) the half-plane u . d1 <= 0; the
    quad for v->n covers u . d2 >= 0 — so the disc's uncovered directions
    are exactly {u : u . d1 >= 0 and u . d2 <= 0}: a single wedge of angle
    <= pi. Summed over a ring these wedges span the total exterior turn
    (~2*pi), so replacing full discs with wedges cuts the union input from
    ~4*quad_segs points per VERTEX to ~4*quad_segs points per RING with an
    identical covered region (the wedge's straight edges lie on the quad
    boundaries). Returns None when the wedge is (numerically) empty.
    """
    t1 = math.atan2(d1[1], d1[0])
    t2 = math.atan2(d2[1], d2[0])
    turn = (t2 - t1 + math.pi) % (2.0 * math.pi) - math.pi  # signed, (-pi, pi]
    span = abs(turn)
    if span < 1e-9:
        return None
    # The gap sits opposite the turn: right turns (turn < 0) leave the arc
    # [t2 + pi/2, t1 + pi/2] uncovered, left turns the arc [t1 - pi/2,
    # t2 - pi/2]; both have angular width |turn|.
    a_start = (t2 + 0.5 * math.pi) if turn < 0 else (t1 - 0.5 * math.pi)
    steps = max(int(math.ceil(span / (0.5 * math.pi / max(quad_segs, 1)))), 1)
    angles = a_start + span * np.arange(steps + 1) / steps
    arc = np.stack([v[0] + radius * np.cos(angles), v[1] + radius * np.sin(angles)], axis=1)
    return np.concatenate([[v], arc])


def _path_pieces(coords, radius, quad_segs, closed):
    """Convex pieces (edge quads + vertex wedges) covering a path's dilation.

    Vectorized: edge directions, quads, and vertex turn angles are computed
    for the whole path at once; only the per-vertex arc assembly (variable
    length) stays in Python.
    """
    pieces = []
    coords = np.asarray(coords, dtype=np.float64)
    n = len(coords)
    last = n if closed else n - 1
    if last <= 0:
        pieces.append(Polygon(_disc(coords[0], radius, quad_segs)))
        return pieces

    if last < 32:
        # Scalar path: numpy batch overhead beats the loop on small rings
        # (the 2000 7-vertex lots of a merge dominate call counts; the big
        # eroded outlines dominate per-call cost and take the branch below).
        dirs = {}
        for i in range(last):
            quad = _edge_quad(coords[i], coords[(i + 1) % n], radius)
            if quad is not None:
                pieces.append(Polygon(quad))
                d = coords[(i + 1) % n] - coords[i]
                dirs[i] = d / math.hypot(d[0], d[1])
        for i in range(n):
            prev_edge = (i - 1) % n
            if (closed or 0 < i < n - 1) and prev_edge in dirs and i in dirs:
                wedge = _vertex_wedge(coords[i], dirs[prev_edge], dirs[i], radius, quad_segs)
                if wedge is not None:
                    pieces.append(Polygon(wedge))
                continue
            pieces.append(Polygon(_disc(coords[i], radius, quad_segs)))
        return pieces

    p1 = coords[:last]
    p2 = coords[(np.arange(last) + 1) % n]
    delta = p2 - p1
    length = np.hypot(delta[:, 0], delta[:, 1])
    ok = length > 0.0
    # Edge quads: both offset rails at once.
    norm = np.zeros_like(delta)
    norm[ok] = delta[ok] / length[ok, None] * radius
    off = np.stack([-norm[:, 1], norm[:, 0]], axis=1)
    quads = np.stack([p1 + off, p2 + off, p2 - off, p1 - off], axis=1)
    for i in np.nonzero(ok)[0]:
        pieces.append(Polygon(quads[i]))

    dirs = np.zeros_like(delta)
    dirs[ok] = delta[ok] / length[ok, None]
    theta = np.arctan2(dirs[:, 1], dirs[:, 0])

    step_cap = 0.5 * math.pi / max(quad_segs, 1)
    for i in range(n):
        prev_edge = (i - 1) % n
        if (closed or 0 < i < n - 1) and prev_edge < last and i < last and ok[prev_edge] and ok[i]:
            t1, t2 = theta[prev_edge], theta[i]
            turn = (t2 - t1 + math.pi) % (2.0 * math.pi) - math.pi
            span = abs(turn)
            if span < 1e-9:
                continue
            # The gap sits opposite the turn (see _vertex_wedge).
            a_start = (t2 + 0.5 * math.pi) if turn < 0 else (t1 - 0.5 * math.pi)
            steps = max(int(math.ceil(span / step_cap)), 1)
            angles = a_start + span * np.arange(steps + 1) / steps
            arc = np.stack(
                [coords[i, 0] + radius * np.cos(angles), coords[i, 1] + radius * np.sin(angles)], axis=1
            )
            pieces.append(Polygon(np.concatenate([coords[i : i + 1], arc])))
            continue
        # Path ends (open paths) and vertices with degenerate neighbor edges
        # keep the full disc — always a superset of any wedge.
        pieces.append(Polygon(_disc(coords[i], radius, quad_segs)))
    return pieces


def buffer_geometry(geom, distance, quad_segs=8):
    """Buffer a geometry by `distance` (negative erodes polygons).

    LineStrings only support positive distances (road centerline widening).
    Returns a MultiPolygon.
    """
    if distance == 0:
        if isinstance(geom, Polygon):
            return MultiPolygon([geom])
        if isinstance(geom, MultiPolygon):
            return geom
        raise ValueError("zero-distance buffer of a non-areal geometry")

    if isinstance(geom, LineString):
        if distance < 0:
            return MultiPolygon([])
        coords = np.asarray(geom.coords, dtype=np.float64)
        fast = _native_buffer([coords], distance, quad_segs, "dilate_path")
        if fast is not None:
            return fast
        pieces = _path_pieces(coords, distance, quad_segs, closed=False)
        return clip.union_all(pieces)

    polys = geom.geoms if isinstance(geom, MultiPolygon) else [geom]

    if distance > 0:
        # Canonical orientation (shells CCW, holes CW) for the winding union.
        canonical = []
        for p in polys:
            shell = np.asarray(p.shell, np.float64)
            canonical.append(shell if ring_area(shell) > 0 else shell[::-1])
            for h in p.holes:
                h = np.asarray(h, np.float64)
                canonical.append(h if ring_area(h) < 0 else h[::-1])
        fast = _native_buffer(canonical, distance, quad_segs, "dilate")
        if fast is not None:
            return fast
        curves = [_offset_curve(ring, distance, quad_segs, inward=False) for ring in canonical]
        if all(c is not None for c in curves):
            # Raw outward offset curves + the base rings in one winding
            # union — same region as the quad/wedge pieces, ~4x fewer
            # overlay segments.
            return clip.union_winding_rings(canonical + curves)
        pieces = []  # degenerate ring: the pieces path's discs handle it
        for p in polys:
            pieces.append(Polygon(p.shell, p.holes))
            for ring in p.rings:
                pieces.extend(_path_pieces(np.asarray(ring, dtype=np.float64), distance, quad_segs, closed=True))
        return clip.union_all(pieces)

    # Negative buffer: erosion = P \ dilate(boundary(P), |distance|), with
    # base membership and halo/curve winding tested in one overlay
    # (clip.erode / clip.erode_offset). Rings go in canonically oriented
    # (shells CCW, holes CW) — the even-odd base test doesn't care, and the
    # native engine's inward raw-offset-curve construction requires it.
    r = -distance
    canonical = []
    for p in polys:
        shell = np.asarray(p.shell, np.float64)
        canonical.append(shell if ring_area(shell) > 0 else shell[::-1])
        for h in p.holes:
            h = np.asarray(h, np.float64)
            canonical.append(h if ring_area(h) < 0 else h[::-1])
    fast = _native_buffer(canonical, r, quad_segs, "erode")
    if fast is not None:
        return fast
    base = MultiPolygon(list(polys))
    curves = [_offset_curve(ring, r, quad_segs, inward=True) for ring in canonical]
    if all(c is not None for c in curves):
        return clip.erode_offset(base, curves)
    boundary_pieces = []  # degenerate ring: fall back to the pieces halo
    for p in polys:
        for ring in p.rings:
            boundary_pieces.extend(_path_pieces(np.asarray(ring, dtype=np.float64), r, quad_segs, closed=True))
    return clip.erode(base, boundary_pieces)
