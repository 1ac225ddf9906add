"""Polygon boolean operations (union / intersection / difference / xor).

This package's copy of robosat_tpu/geo/clip.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_geo.py.

Replaces GEOS's overlay engine (shapely `.union` / `.intersection` calls in
robosat/spatial/core.py:25-40,56-77 and robosat/tools/{merge,dedupe}.py) with a
slab-decomposition overlay:

1. snap all coordinates to a fine grid scaled to the input extent,
2. split every segment at every segment-segment intersection (including
   collinear overlaps and T-junctions),
3. cut the plane into vertical slabs at every endpoint x; inside a slab no two
   segments cross, so regions stack bottom-to-top and each region's membership
   in either input follows from even-odd parity counting,
4. keep the trapezoids satisfying the boolean predicate; areas are summed
   exactly, and for geometry output the trapezoid boundary edges are emitted
   with interior-on-left orientation, opposite edges cancelled, and the
   remaining edges linked into rings (sharpest-left-turn rule at junctions).

Compared to a Bentley-Ottmann/Martinez-Rueda sweep this is O(n^2) in segment
count but has no sweep-status comparator edge cases; the pipeline's polygons
(OSM ways, simplified mask contours, buffered pieces) are small, and large
collection unions are done divide-and-conquer (`union_all`) so each overlay
stays small.
"""

import math
import os
from collections import defaultdict

import numpy as np

from robosat_tpu_torch.geo.geometry import (
    MultiPolygon,
    Polygon,
    point_in_ring,
    representative_point,
    ring_area,
)

_PREDICATES = {
    "union": lambda a, b: a or b,
    "intersection": lambda a, b: a and b,
    "difference": lambda a, b: a and not b,
    "xor": lambda a, b: a != b,
}

# The C++ engine (robosat_tpu_torch/native/geometry.cpp) implements the identical
# algorithm; this module is the fallback and test oracle. Set
# RS_NATIVE_GEOMETRY=0 to force the Python path.
_USE_NATIVE = os.environ.get("RS_NATIVE_GEOMETRY", "1") != "0"


def _native():
    if not _USE_NATIVE:
        return None
    from robosat_tpu_torch import native

    return native.load()


def _collect_rings(geom):
    """All rings of a Polygon/MultiPolygon as plain coordinate arrays."""
    if geom is None:
        return []
    if isinstance(geom, MultiPolygon):
        rings = []
        for p in geom.geoms:
            rings.extend(p.rings)
        return rings
    if isinstance(geom, Polygon):
        return list(geom.rings)
    raise ValueError("boolean ops support Polygon/MultiPolygon, got {}".format(type(geom)))


def _overlay_frame(rings_a, rings_b):
    """(q, sx, sy): snap quantum + local-origin shift for one overlay.

    Every overlay runs in coordinates translated by (-sx, -sy) — the joint
    bbox center — so the quantum scales with the geometry's EXTENT, not its
    distance from the origin. The old |coordinate|-scaled quantum was ~2 mm
    at web-mercator magnitudes (~2e7 m), coarse enough to break trapezoid
    welding on city-block-sized shapes: erosions randomly collapsed whole
    merged features to empty and flipped output validity (observed on the
    10k synthetic-city benchmark; all paths agree once translated). The
    subtraction is exact where it matters (Sterbenz: inputs within 2x of
    the center), and any residual half-ulp lands far below the quantum.
    Mirrored bit-for-bit by the native engine (geometry.cpp run_overlay).
    """
    lox = loy = math.inf
    hix = hiy = -math.inf
    for rings in (rings_a, rings_b):
        for r in rings:
            if len(r):
                r = np.asarray(r, dtype=np.float64)
                lox = min(lox, float(np.min(r[:, 0])))
                hix = max(hix, float(np.max(r[:, 0])))
                loy = min(loy, float(np.min(r[:, 1])))
                hiy = max(hiy, float(np.max(r[:, 1])))
    if not math.isfinite(lox):
        return 1e-40, 0.0, 0.0
    extent = max(hix - lox, hiy - loy, 1e-30)
    return extent * 1e-10, (lox + hix) / 2, (loy + hiy) / 2


def _segments_from_rings(rings, tag, q, sx=0.0, sy=0.0):
    """Snapped (p, q, tag) segments from rings translated to the overlay
    frame; drops degenerate edges."""
    segs = []
    for ring in rings:
        if len(ring) < 3:
            continue
        snapped = np.round((np.asarray(ring, dtype=np.float64) - [sx, sy]) / q) * q
        n = len(snapped)
        for i in range(n):
            p1 = (snapped[i, 0], snapped[i, 1])
            p2 = (snapped[(i + 1) % n, 0], snapped[(i + 1) % n, 1])
            if p1 != p2:
                segs.append((p1, p2, tag))
    return segs


def _canonical_segments_signed(segs):
    """Merge coincident segments, accumulating signed winding weight.

    The weight of an undirected segment key is (number of input edges running
    key-forward) - (running key-backward); weight 0 edges cancel out. For the
    winding sweep, crossing a span upward adds its weight to the winding
    number W (spans store lo->hi in +x order, matching the key order for
    non-vertical segments).
    """
    weight = defaultdict(int)
    for p1, p2, _ in segs:
        if p1 <= p2:
            weight[(p1, p2)] += 1
        else:
            weight[(p2, p1)] -= 1
    return [(p1, p2, w, 0) for (p1, p2), w in weight.items() if w != 0]


def _canonical_segments_erode(segs):
    """Merge coincident segments for the erode op: even-odd parity for the
    base (tag 0), signed winding weight for the halo (tag 1)."""
    acc = defaultdict(lambda: [0, 0])
    for p1, p2, tag in segs:
        key, direction = ((p1, p2), 1) if p1 <= p2 else ((p2, p1), -1)
        if tag == 0:
            acc[key][0] ^= 1
        else:
            acc[key][1] += direction
    return [(p1, p2, pa, wb) for (p1, p2), (pa, wb) in acc.items() if pa or wb]


def _seg_split_points(a1, a2, b1, b2):
    """Points where segment b should split segment a (and vice versa).

    Returns (pts_on_a, pts_on_b): intersection/touch points interior to each
    segment's parameter range (endpoints excluded by the caller's dedupe).
    """
    ax, ay = a2[0] - a1[0], a2[1] - a1[1]
    bx, by = b2[0] - b1[0], b2[1] - b1[1]
    denom = ax * by - ay * bx

    if denom != 0.0:
        # Non-parallel: parameter-range tests in cross-product form (u, v are
        # t*denom, s*denom) so the common rejected pair costs no division —
        # the division runs only for accepted pairs. native/geometry.cpp's
        # seg_split_points uses the SAME multiply-form comparisons so the
        # accept/reject boundary stays bit-identical across the engines.
        cx, cy = b1[0] - a1[0], b1[1] - a1[1]
        u = cx * by - cy * bx
        if denom > 0.0:
            if u < -1e-12 * denom or u > (1.0 + 1e-12) * denom:
                return [], []
            v = cx * ay - cy * ax
            if v < -1e-12 * denom or v > (1.0 + 1e-12) * denom:
                return [], []
        else:
            if u > -1e-12 * denom or u < (1.0 + 1e-12) * denom:
                return [], []
            v = cx * ay - cy * ax
            if v > -1e-12 * denom or v < (1.0 + 1e-12) * denom:
                return [], []
        t = u / denom
        px = a1[0] + t * ax
        py = a1[1] + t * ay
        return [(px, py)], [(px, py)]

    # Parallel: collinear only if b1 lies on line a.
    if (b1[0] - a1[0]) * ay - (b1[1] - a1[1]) * ax != 0.0:
        return [], []
    # Collinear: each segment splits at the other's endpoints that fall inside.
    return [b1, b2], [a1, a2]


def _param_on_segment(p, s1, s2):
    """Parameter of p along segment [s1, s2] via the dominant axis, or None."""
    dx, dy = s2[0] - s1[0], s2[1] - s1[1]
    if abs(dx) >= abs(dy):
        if dx == 0.0:
            return None
        t = (p[0] - s1[0]) / dx
    else:
        t = (p[1] - s1[1]) / dy
    return t if 0.0 < t < 1.0 else None


def _param_near_segment(p, s1, s2, q):
    """Parameter of p along [s1, s2] if p lies within q of the segment.

    Snap-rounding consistency requires welding vertices onto segments that
    pass within the grid quantum (T-junctions): without it a near-parallel
    pair can interpolate one quantum apart at a shared slab boundary and the
    emitted trapezoid edges fail to link into rings.
    """
    dx, dy = s2[0] - s1[0], s2[1] - s1[1]
    length2 = dx * dx + dy * dy
    if length2 == 0.0:
        return None
    cross = dx * (p[1] - s1[1]) - dy * (p[0] - s1[0])
    if cross * cross > q * q * length2:
        return None
    return _param_on_segment(p, s1, s2)


def _split_all_segments(segs, q):
    """Split every segment at every crossing/touch point, snapping to grid."""
    n = len(segs)
    split_pts = [set() for _ in range(n)]

    # Bounding boxes (inflated by q so near-miss T-junctions are seen) for a
    # cheap prefilter.
    boxes = []
    for p1, p2, _ in segs:
        boxes.append(
            (min(p1[0], p2[0]) - q, min(p1[1], p2[1]) - q, max(p1[0], p2[0]) + q, max(p1[1], p2[1]) + q)
        )

    order = sorted(range(n), key=lambda i: boxes[i][0])
    for oi in range(n):
        i = order[oi]
        bi = boxes[i]
        for oj in range(oi + 1, n):
            j = order[oj]
            bj = boxes[j]
            if bj[0] > bi[2]:
                break
            if bj[2] < bi[0] or bj[1] > bi[3] or bj[3] < bi[1]:
                continue
            a1, a2, _ = segs[i]
            b1, b2, _ = segs[j]
            pts_a, pts_b = _seg_split_points(a1, a2, b1, b2)
            for p in pts_a:
                sp = (round(p[0] / q) * q, round(p[1] / q) * q)
                t = _param_on_segment(sp, a1, a2)
                if t is not None:
                    split_pts[i].add((t, sp))
            for p in pts_b:
                sp = (round(p[0] / q) * q, round(p[1] / q) * q)
                t = _param_on_segment(sp, b1, b2)
                if t is not None:
                    split_pts[j].add((t, sp))
            # Weld each segment's endpoints onto the other segment when they
            # pass within the snap quantum (see _param_near_segment).
            for v in (b1, b2):
                t = _param_near_segment(v, a1, a2, q)
                if t is not None:
                    split_pts[i].add((t, v))
            for v in (a1, a2):
                t = _param_near_segment(v, b1, b2, q)
                if t is not None:
                    split_pts[j].add((t, v))

    out = []
    for i, (p1, p2, tag) in enumerate(segs):
        pts = sorted(split_pts[i])
        prev = p1
        for _, sp in pts:
            if sp != prev:
                out.append((prev, sp, tag))
                prev = sp
        if prev != p2:
            out.append((prev, p2, tag))
    return out


def _canonical_segments(segs):
    """Merge coincident segments, tracking even-odd parity per input tag."""
    parity = defaultdict(lambda: [0, 0])
    for p1, p2, tag in segs:
        key = (p1, p2) if p1 <= p2 else (p2, p1)
        parity[key][tag] ^= 1
    merged = []
    for (p1, p2), (pa, pb) in parity.items():
        if pa or pb:
            merged.append((p1, p2, pa, pb))
    return merged


def _unshift_edges(edges, sx, sy):
    if not edges or (sx == 0.0 and sy == 0.0):
        return edges
    return [((x1 + sx, y1 + sy), (x2 + sx, y2 + sy)) for (x1, y1), (x2, y2) in edges]


def _overlay(geom_a, geom_b, op, want_geometry, frame=None):
    """Core slab overlay. Returns (area, edge soup or None).

    With `frame` (q, sx, sy) the edges come back in the shifted overlay
    frame for the caller to weld/link/assemble there (precision: welding and
    orientation tests stay at extent scale); without it — the standalone /
    oracle-test entry — edges are translated back to input coordinates.
    """
    rings_a = _collect_rings(geom_a)
    rings_b = _collect_rings(geom_b)
    unshift = frame is None
    q, sx, sy = _overlay_frame(rings_a, rings_b) if frame is None else frame

    segs = _segments_from_rings(rings_a, 0, q, sx, sy) + _segments_from_rings(rings_b, 1, q, sx, sy)
    if not segs:
        return 0.0, []
    segs = _split_all_segments(segs, q)
    segs = _canonical_segments(segs)
    area, edges = _sweep(segs, q, op, want_geometry)
    return area, _unshift_edges(edges, sx, sy) if unshift else edges


def _overlay_union(rings, want_geometry, frame=None):
    """N-ary winding-rule union of canonically-oriented rings in ONE overlay.

    Shells arrive CCW, holes CW; the union of all inputs is the region with
    winding number > 0. One slab decomposition over every edge replaces the
    divide-and-conquer tree of pairwise overlays (O(N) boolean_op calls each
    paying Python ring-assembly overhead) that `union_all` used to build.
    """
    unshift = frame is None
    q, sx, sy = _overlay_frame(rings, []) if frame is None else frame
    segs = _segments_from_rings(rings, 0, q, sx, sy)
    if not segs:
        return 0.0, []
    segs = _split_all_segments(segs, q)
    segs = _canonical_segments_signed(segs)
    area, edges = _sweep(segs, q, "nunion", want_geometry)
    return area, _unshift_edges(edges, sx, sy) if unshift else edges


def _overlay_erode(base_rings, halo_rings, want_geometry, frame=None):
    """base (even-odd) minus the winding>0 union of halo rings, ONE overlay.

    Erosion = P \\ dilate(boundary(P), r): instead of materializing the halo
    union (an annulus whose assembly is the most fragile and expensive shape
    in the pipeline) and then differencing, both membership tests run in the
    same sweep: covered where inside-base and halo winding == 0.
    """
    unshift = frame is None
    q, sx, sy = _overlay_frame(base_rings, halo_rings) if frame is None else frame
    segs = _segments_from_rings(base_rings, 0, q, sx, sy) + _segments_from_rings(halo_rings, 1, q, sx, sy)
    if not segs:
        return 0.0, []
    segs = _split_all_segments(segs, q)
    segs = _canonical_segments_erode(segs)
    area, edges = _sweep(segs, q, "erode", want_geometry)
    return area, _unshift_edges(edges, sx, sy) if unshift else edges


def _sweep(segs, q, op, want_geometry):
    """Slab sweep over canonical segments. Returns (area, edge soup or None).

    For the even-odd ops, segment payloads (da, db) are parity toggles per
    operand; for "nunion" da is a signed winding weight (db unused); for
    "erode" da is the base parity toggle and db the halo winding weight.
    """
    winding = op == "nunion"
    erode_mode = op == "erode"
    erode_in_mode = op == "erode_in"
    pred = None if (winding or erode_mode or erode_in_mode) else _PREDICATES[op]

    # Non-vertical spanning segments (lo->hi in +x), sorted by entry x so the
    # slab loop maintains an active list instead of rescanning every span.
    xs = sorted({p[0] for s in segs for p in (s[0], s[1])})
    spans = sorted(
        (
            ((p1, p2, pa, pb) if p1[0] < p2[0] else (p2, p1, pa, pb))
            for p1, p2, pa, pb in segs
            if p1[0] != p2[0]
        ),
        key=lambda s: s[0][0],
    )

    total_area = 0.0
    edges = [] if want_geometry else None  # directed, interior on left
    vertical = defaultdict(list) if want_geometry else None  # x -> (ylo, yhi, sign)

    # Boundary-run coalescing (mirrors native/geometry.cpp): a boundary that
    # rides the same span across consecutive slabs with contiguous snapped
    # endpoints emits ONE edge for the whole run. Coverage nets per slab
    # BEFORE emission (a span covered on both sides emits nothing), so runs
    # on the two sides of an interior span can never partially overlap.
    open_bottom = {}  # span -> [x0, y0, x1, y1] (L->R frame)
    open_top = {}

    def flush_run(open_runs, key, nx0, ny0, nx1, ny1, top):
        run = open_runs.get(key)
        if run is not None:
            if run[2] == nx0 and run[3] == ny0:  # contiguous: extend
                run[2] = nx1
                run[3] = ny1
                return
            if top:
                edges.append(((run[2], run[3]), (run[0], run[1])))
            else:
                edges.append(((run[0], run[1]), (run[2], run[3])))
        open_runs[key] = [nx0, ny0, nx1, ny1]

    ptr = 0
    current = []
    for k in range(len(xs) - 1):
        x0, x1 = xs[k], xs[k + 1]
        if x1 <= x0:
            continue
        while ptr < len(spans) and spans[ptr][0][0] <= x0:
            current.append(spans[ptr])
            ptr += 1
        # A span whose right end is behind x1 never spans a later slab either.
        current = [s for s in current if s[1][0] >= x1]

        xm = 0.5 * (x0 + x1)
        active = []
        for span in current:
            lo, hi, pa, pb = span
            # Slope form (one division per span-slab instead of three);
            # native/geometry.cpp precomputes m per span — same value, so
            # the snapped y0/y1 stay bit-identical across the two engines.
            m = (hi[1] - lo[1]) / (hi[0] - lo[0])
            ym = lo[1] + (xm - lo[0]) * m
            y0 = lo[1] + (x0 - lo[0]) * m
            y1 = lo[1] + (x1 - lo[0]) * m
            active.append((ym, y0, y1, pa, pb, span))
        if not active:
            continue
        active.sort(key=lambda e: e[0])

        in_a = in_b = 0
        covered_gap = [False] * len(active)
        for idx in range(len(active) - 1):
            ym, y0, y1, pa, pb, _ = active[idx]
            if winding:
                in_a += pa
                covered = in_a > 0
            elif erode_mode:
                in_a ^= pa
                in_b += pb
                covered = bool(in_a) and in_b == 0
            elif erode_in_mode:
                # Raw-offset-curve erosion: inside the base (even-odd) AND
                # the inward offset curves wind positively (Chen & McMains).
                # The base test is redundant in exact arithmetic (the curve
                # winds 0 outside the eroded region) but clamps any snapped
                # curve self-cancellation wobble to within the polygon.
                in_a ^= pa
                in_b += pb
                covered = bool(in_a) and in_b > 0
            else:
                in_a ^= pa
                in_b ^= pb
                covered = pred(in_a, in_b)
            if covered:
                covered_gap[idx] = True
                nym, ny0, ny1 = active[idx + 1][:3]
                total_area += (x1 - x0) * (nym - ym)
                if want_geometry:
                    # Snap trapezoid corner ys so edges cancel across slabs.
                    by0 = round(y0 / q) * q
                    by1 = round(y1 / q) * q
                    ty0 = round(ny0 / q) * q
                    ty1 = round(ny1 / q) * q
                    # Right side: upward at x1; left side: downward at x0.
                    if ty1 > by1:
                        vertical[x1].append((by1, ty1, +1))
                    if ty0 > by0:
                        vertical[x0].append((by0, ty0, -1))
        if want_geometry:
            for idx in range(len(active)):
                above = covered_gap[idx]
                below = idx > 0 and covered_gap[idx - 1]
                if above == below:
                    continue
                ym, y0, y1, pa, pb, span = active[idx]
                sy0 = round(y0 / q) * q
                sy1 = round(y1 / q) * q
                if above:  # bottom boundary: left->right (interior above)
                    flush_run(open_bottom, span, x0, sy0, x1, sy1, False)
                else:  # top boundary: right->left
                    flush_run(open_top, span, x0, sy0, x1, sy1, True)

    if not want_geometry:
        return total_area, None

    for run in open_bottom.values():
        edges.append(((run[0], run[1]), (run[2], run[3])))
    for run in open_top.values():
        edges.append(((run[2], run[3]), (run[0], run[1])))

    # Cancel opposite horizontal-ish edges.
    net = defaultdict(int)
    for p1, p2 in edges:
        if p1 == p2:
            continue
        key = (p1, p2) if p1 <= p2 else (p2, p1)
        net[key] += 1 if p1 <= p2 else -1
    directed = []
    for (p1, p2), count in net.items():
        for _ in range(abs(count)):
            directed.append((p1, p2) if count > 0 else (p2, p1))

    # Net vertical boundary intervals per x (cancels partial overlaps exactly).
    # Breakpoints include every interval endpoint, so an elementary interval is
    # covered by a source interval iff it contains the midpoint.
    for x, intervals in vertical.items():
        breaks = sorted({y for lo, hi, _ in intervals for y in (lo, hi)})
        for i in range(len(breaks) - 1):
            lo, hi = breaks[i], breaks[i + 1]
            mid = 0.5 * (lo + hi)
            cover = sum(sign for ilo, ihi, sign in intervals if ilo < mid < ihi)
            if cover > 0:
                directed.append(((x, lo), (x, hi)))
            elif cover < 0:
                directed.append(((x, hi), (x, lo)))

    return total_area, directed


def _weld_edges(directed_edges, q):
    """Weld edge endpoints that landed within ~1.5q of each other.

    The sweep emits each boundary point from up to four trapezoids; snapped
    interpolations can disagree by one grid quantum when near-parallel chains
    interact, leaving junctions that do not link. Clustering endpoints to a
    single representative (greedy grid-hash pass) repairs those junctions;
    representatives move points by O(q), inside the overlay's tolerance.
    Edges welded onto a single point are dropped, and opposite coincident
    pairs created by the weld cancel.
    """
    tol = 1.5 * q
    buckets = defaultdict(list)
    reps = {}

    def rep_for(v):
        r = reps.get(v)
        if r is not None:
            return r
        kx, ky = round(v[0] / tol), round(v[1] / tol)
        for key in ((kx + dx, ky + dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)):
            for u in buckets.get(key, ()):
                if abs(u[0] - v[0]) <= tol and abs(u[1] - v[1]) <= tol:
                    reps[v] = r = reps[u]
                    buckets[(kx, ky)].append(v)
                    return r
        reps[v] = v
        buckets[(kx, ky)].append(v)
        return v

    net = defaultdict(int)
    for p1, p2 in directed_edges:
        r1, r2 = rep_for(p1), rep_for(p2)
        if r1 == r2:
            continue
        if r1 <= r2:
            net[(r1, r2)] += 1
        else:
            net[(r2, r1)] -= 1
    out = []
    for (p1, p2), count in net.items():
        for _ in range(abs(count)):
            out.append((p1, p2) if count > 0 else (p2, p1))
    return out


def _link_rings(directed_edges):
    """Link directed (interior-left) edges into closed rings."""
    out_edges = defaultdict(list)
    for e in directed_edges:
        out_edges[e[0]].append(e)
    used = set()
    rings = []

    def angle(d):
        return math.atan2(d[1], d[0])

    for start_edge in directed_edges:
        if id(start_edge) in used:
            continue
        ring = []
        edge = start_edge
        closed = False
        for _ in range(len(directed_edges) + 1):
            used.add(id(edge))
            ring.append(edge[0])
            v = edge[1]
            if v == start_edge[0]:
                closed = True
                break
            candidates = [e for e in out_edges[v] if id(e) not in used]
            if not candidates:
                break
            d_in = (v[0] - edge[0][0], v[1] - edge[0][1])
            base = angle(d_in)

            def turn(e):
                d_out = (e[1][0] - e[0][0], e[1][1] - e[0][1])
                # CCW angle from incoming direction, in (0, 2*pi].
                a = angle(d_out) - base
                while a <= 0:
                    a += 2 * math.pi
                while a > 2 * math.pi:
                    a -= 2 * math.pi
                return a

            edge = min(candidates, key=turn)
        if closed and len(ring) >= 3:
            rings.append(ring)
    return rings


def _simplify_collinear(ring, q):
    """Drop vertices (nearly) collinear with their neighbors.

    The slab decomposition leaves a vertex on every slanted edge at every slab
    boundary; after grid snapping these deviate from the true line by at most
    the quantum, so anything within 2q perpendicular distance of the running
    chord is a decomposition artifact, not geometry.

    Non-compounding: a vertex is dropped only if it stays within tolerance of
    the chord from the last *kept* vertex to its successor, so total drift
    from the true boundary stays O(q) — an iterate-to-fixpoint variant let
    removals compound and could flatten genuinely curved vertex runs (e.g.
    buffer arcs) far beyond the snap tolerance.
    """
    if len(ring) < 3:
        return ring
    tol = 2.0 * q

    def within(a, b, c):
        """Perpendicular distance of b from chord a-c is <= tol (or a == c)."""
        acx, acy = c[0] - a[0], c[1] - a[1]
        chord = math.hypot(acx, acy)
        if chord == 0:
            return True  # spike a -> b -> a
        cross = (b[0] - a[0]) * acy - (b[1] - a[1]) * acx
        return abs(cross) / chord <= tol

    pts = list(ring)
    n = len(pts)
    kept = [pts[0]]
    for i in range(1, n):
        if not within(kept[-1], pts[i], pts[(i + 1) % n]):
            kept.append(pts[i])

    # Wrap-around: the walk never reconsiders the start vertex (and the last
    # kept vertex's chord now wraps to it); a couple of boundary passes settle it.
    for _ in range(2):
        if len(kept) >= 3 and within(kept[-1], kept[0], kept[1]):
            kept.pop(0)
        if len(kept) >= 3 and within(kept[-2], kept[-1], kept[0]):
            kept.pop()

    return kept if len(kept) >= 3 else []


def _assemble_polygons(rings, q, presimplified=False, shift=(0.0, 0.0)):
    """Group CCW shells with their CW holes into polygons.

    `presimplified` skips the collinear pass for rings the native engine
    already simplified (same tolerance; re-running it is pure overhead).
    `shift` translates rings back from the overlay frame to input
    coordinates — orientation and containment are decided BEFORE the shift,
    at extent scale, where the shoelace/containment arithmetic is exact."""
    shells = []
    holes = []
    for ring in rings:
        if not presimplified:
            ring = _simplify_collinear(ring, q)
        if len(ring) < 3:
            continue
        arr = np.asarray(ring, dtype=np.float64)
        a = ring_area(arr)
        if a > 0:
            shells.append((a, arr))
        elif a < 0:
            holes.append(arr)

    shells.sort(key=lambda t: t[0])  # smallest first => innermost match first
    polys = [[arr, []] for _, arr in shells]
    for hole in holes:
        probe = representative_point(hole)
        for entry in polys:
            if point_in_ring(probe, entry[0]):
                entry[1].append(hole)
                break

    sx, sy = shift
    if sx != 0.0 or sy != 0.0:
        return MultiPolygon(
            [Polygon(shell + [sx, sy], [h + [sx, sy] for h in hs]) for shell, hs in polys]
        )
    return MultiPolygon([Polygon(shell, hs) for shell, hs in polys])


def boolean_op(geom_a, geom_b, op):
    """Boolean overlay of two Polygon/MultiPolygon geometries.

    Returns a MultiPolygon (possibly empty). `geom_b` may be None for
    union-normalization of a single (possibly self-overlapping) geometry.
    """
    rings_a = _collect_rings(geom_a)
    rings_b = _collect_rings(geom_b)

    lib = _native()
    if lib is not None:
        from robosat_tpu_torch import native

        return _assemble_polygons(native.overlay_rings(rings_a, rings_b, op), 0.0, presimplified=True)
    frame = _overlay_frame(rings_a, rings_b)
    _, directed = _overlay(geom_a, geom_b, op, want_geometry=True, frame=frame)
    q, sx, sy = frame
    return _assemble_polygons(_link_rings(_weld_edges(directed, q)), q, shift=(sx, sy))


def overlay_iou_areas(geom_a, geom_b):
    """(intersection_area, union_area) in one sweep (native) or two sweeps
    (Python fallback — correctness path only)."""
    lib = _native()
    if lib is not None:
        from robosat_tpu_torch import native

        return native.overlay_iou_areas(_collect_rings(geom_a), _collect_rings(geom_b))
    inter, _ = _overlay(geom_a, geom_b, "intersection", want_geometry=False)
    union_area, _ = _overlay(geom_a, geom_b, "union", want_geometry=False)
    return inter, union_area


def overlay_area(geom_a, geom_b, op):
    """Area of the boolean overlay without constructing geometry (exact)."""
    lib = _native()
    if lib is not None:
        from robosat_tpu_torch import native

        return native.overlay_area(_collect_rings(geom_a), _collect_rings(geom_b), op)
    area, _ = _overlay(geom_a, geom_b, op, want_geometry=False)
    return area


def union(a, b):
    return boolean_op(a, b, "union")


def intersection(a, b):
    return boolean_op(a, b, "intersection")


def difference(a, b):
    return boolean_op(a, b, "difference")


def _canonical_union_rings(geoms):
    """All rings of the inputs, shells oriented CCW and holes CW."""
    rings = []
    for g in geoms:
        for p in g.geoms if isinstance(g, MultiPolygon) else [g]:
            if p.is_empty:
                continue
            rings.append(p.shell if ring_area(p.shell) > 0 else p.shell[::-1])
            for h in p.holes:
                rings.append(h if ring_area(h) < 0 else h[::-1])
    return rings


def union_all(geoms):
    """Union of many valid polygons in ONE winding-rule overlay.

    Parity: robosat/spatial/core.py:25-40 (functools.reduce of .union), but
    instead of N-1 pairwise GEOS unions (or this engine's former
    divide-and-conquer tree) all edges enter a single slab decomposition and
    the union is the winding>0 region — the overlay, ring linking, and
    polygon assembly run once.
    """
    geoms = [g for g in geoms if g is not None and not g.is_empty]
    if not geoms:
        return MultiPolygon([])
    if len(geoms) == 1:
        # The reference's union is functools.reduce over pairwise .union
        # (robosat/spatial/core.py:25-40): a single element is returned
        # unchanged — valid polygons ARE their own union, no overlay needed.
        g = geoms[0]
        return g if isinstance(g, MultiPolygon) else MultiPolygon([g])
    rings = _canonical_union_rings(geoms)

    lib = _native()
    if lib is not None:
        from robosat_tpu_torch import native

        return _assemble_polygons(native.overlay_rings(rings, [], "nunion"), 0.0, presimplified=True)
    frame = _overlay_frame(rings, [])
    _, directed = _overlay_union(rings, want_geometry=True, frame=frame)
    q, sx, sy = frame
    return _assemble_polygons(_link_rings(_weld_edges(directed, q)), q, shift=(sx, sy))


def erode(geom, halo_pieces):
    """`geom` minus the union of `halo_pieces`, in ONE overlay.

    Semantically identical to difference(geom, union_all(halo_pieces)) for
    valid inputs but skips materializing the halo union — the sweep tests
    base membership (even-odd) and halo winding together.
    """
    base_rings = _collect_rings(geom)
    halo_rings = _canonical_union_rings(halo_pieces)
    if not halo_rings:
        return boolean_op(geom, None, "union")

    lib = _native()
    if lib is not None:
        from robosat_tpu_torch import native

        return _assemble_polygons(native.overlay_rings(base_rings, halo_rings, "erode"), 0.0, presimplified=True)
    frame = _overlay_frame(base_rings, halo_rings)
    _, directed = _overlay_erode(base_rings, halo_rings, want_geometry=True, frame=frame)
    q, sx, sy = frame
    return _assemble_polygons(_link_rings(_weld_edges(directed, q)), q, shift=(sx, sy))


def union_winding_rings(rings):
    """The winding>0 region of directed rings in one overlay.

    Like `union_all` but over raw coordinate rings that may self-intersect —
    the entry point for the raw-offset-curve dilation (geo/buffer.py
    `_offset_curve`): canonical base rings + outward offset curves in, the
    Minkowski dilation out.
    """
    rings = [np.asarray(r, np.float64) for r in rings if len(r) >= 3]
    if not rings:
        return MultiPolygon([])

    lib = _native()
    if lib is not None:
        from robosat_tpu_torch import native

        return _assemble_polygons(native.overlay_rings(rings, [], "nunion"), 0.0, presimplified=True)
    frame = _overlay_frame(rings, [])
    _, directed = _overlay_union(rings, want_geometry=True, frame=frame)
    q, sx, sy = frame
    return _assemble_polygons(_link_rings(_weld_edges(directed, q)), q, shift=(sx, sy))


def erode_offset(geom, offset_curves):
    """`geom` ∩ {winding(inward offset curves) > 0} in ONE overlay.

    The raw-offset-curve erosion (see geo/buffer.py `_offset_curve`):
    identical region to `erode(geom, halo_pieces)` — the curves' arcs sample
    the same circles as the wedge pieces — at a fraction of the overlay's
    segment count.
    """
    base_rings = _collect_rings(geom)
    curves = [np.asarray(c, np.float64) for c in offset_curves if len(c) >= 3]
    if not curves:
        return boolean_op(geom, None, "union")

    lib = _native()
    if lib is not None:
        from robosat_tpu_torch import native

        return _assemble_polygons(
            native.overlay_rings(base_rings, curves, "erode_in"), 0.0, presimplified=True
        )
    q, sx, sy = _overlay_frame(base_rings, curves)
    segs = _segments_from_rings(base_rings, 0, q, sx, sy) + _segments_from_rings(curves, 1, q, sx, sy)
    if not segs:
        return MultiPolygon([])
    segs = _split_all_segments(segs, q)
    segs = _canonical_segments_erode(segs)
    _, directed = _sweep(segs, q, "erode_in", True)
    return _assemble_polygons(_link_rings(_weld_edges(directed, q)), q, shift=(sx, sy))


def union_all_area(geoms):
    """Area of the union of many valid polygons, single winding overlay."""
    geoms = [g for g in geoms if g is not None and not g.is_empty]
    if not geoms:
        return 0.0
    rings = _canonical_union_rings(geoms)
    lib = _native()
    if lib is not None:
        from robosat_tpu_torch import native

        return native.overlay_area(rings, [], "nunion")
    area, _ = _overlay_union(rings, want_geometry=False)
    return area
