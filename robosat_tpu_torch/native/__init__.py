"""Native (C++) geometry engine: build-on-demand + ctypes bindings.

Counterpart of robosat_tpu/native/__init__.py over this package's own copy
of geometry.cpp. The shared library compiles with g++ at first use into
`robosat_tpu_torch/_build/` (rebuilt when the source is newer): each build
writes a file named after its process and renames it into place, so
processes that build at once never read each other's half-written output.
Every entry point has a pure-Python fallback in robosat_tpu_torch.geo.clip,
which also serves as the test oracle for the native engine.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "geometry.cpp")
_LIB = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build", "_geometry.so")

_lib = None
_tried = False

_OPS = {"union": 0, "intersection": 1, "difference": 2, "xor": 3, "nunion": 4, "erode": 5, "erode_in": 7}


def _build():
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = "{}.tmp{}".format(_LIB, os.getpid())
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o", tmp, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def load():
    """The loaded native library, building it if needed; None on failure."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.rs_overlay_area.restype = ctypes.c_double
        lib.rs_overlay_area.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.rs_overlay_edges.restype = ctypes.POINTER(ctypes.c_double)
        lib.rs_overlay_edges.argtypes = lib.rs_overlay_area.argtypes + [ctypes.POINTER(ctypes.c_int64)]
        lib.rs_overlay_rings.restype = ctypes.POINTER(ctypes.c_double)
        lib.rs_overlay_rings.argtypes = lib.rs_overlay_area.argtypes + [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rs_buffer_rings.restype = ctypes.POINTER(ctypes.c_double)
        lib.rs_buffer_rings.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.rs_ring_is_simple.restype = ctypes.c_int32
        lib.rs_ring_is_simple.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int32]
        lib.rs_polys_intersect.restype = ctypes.c_int32
        lib.rs_polys_intersect.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.rs_overlay_iou_areas.restype = None
        lib.rs_overlay_iou_areas.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.rs_buffer_rings_batch.restype = ctypes.POINTER(ctypes.c_double)
        lib.rs_buffer_rings_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_double, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rs_intersect_graph.restype = ctypes.POINTER(ctypes.c_int32)
        lib.rs_intersect_graph.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rs_iou_winding_batch.restype = None
        lib.rs_iou_winding_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
        ]
        lib.rs_polys_valid_batch.restype = None
        lib.rs_polys_valid_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int8),
        ]
        lib.rs_merge_components.restype = ctypes.POINTER(ctypes.c_double)
        lib.rs_merge_components.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rs_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception as exc:  # fall back to pure Python
        print("Warning: native geometry unavailable ({}); using Python engine".format(exc), file=sys.stderr)
        _lib = None
    return _lib


def _pack(rings):
    """Rings (list of (N,2) arrays) -> (coords ptr, lens ptr, n, keepalive)."""
    if not rings:
        null_d = ctypes.POINTER(ctypes.c_double)()
        null_i = ctypes.POINTER(ctypes.c_int32)()
        return null_d, null_i, 0, ()
    coords = np.ascontiguousarray(np.concatenate([np.asarray(r, np.float64).reshape(-1, 2) for r in rings]))
    lens = np.asarray([len(r) for r in rings], np.int32)
    return (
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(rings),
        (coords, lens),
    )


def overlay_area(rings_a, rings_b, op):
    """Native boolean-overlay area; raises if the library is unavailable."""
    lib = load()
    assert lib is not None
    # keep_a/keep_b hold the numpy buffers the pointers reference alive for
    # the duration of the native call.
    ca, la, na, keep_a = _pack(rings_a)  # noqa: F841
    cb, lb, nb, keep_b = _pack(rings_b)  # noqa: F841
    return float(lib.rs_overlay_area(ca, la, na, cb, lb, nb, _OPS[op]))


def overlay_edges(rings_a, rings_b, op):
    """Native boolean-overlay boundary edges as a list of ((x1,y1),(x2,y2))."""
    lib = load()
    assert lib is not None
    ca, la, na, keep_a = _pack(rings_a)  # noqa: F841
    cb, lb, nb, keep_b = _pack(rings_b)  # noqa: F841
    count = ctypes.c_int64(0)
    ptr = lib.rs_overlay_edges(ca, la, na, cb, lb, nb, _OPS[op], ctypes.byref(count))
    try:
        flat = np.ctypeslib.as_array(ptr, shape=(count.value * 4,)).copy() if count.value else np.zeros(0)
    finally:
        lib.rs_free(ptr)
    edges = flat.reshape(-1, 4)
    return [((e[0], e[1]), (e[2], e[3])) for e in edges]


BUFFER_MODES = {"dilate": 0, "dilate_path": 1, "erode": 2}


def buffer_rings(rings, radius, quad_segs, mode):
    """Native Minkowski buffer: piece generation + overlay + ring linking in
    one call. `rings` are closed rings for dilate/erode (shells CCW, holes
    CW for dilate) or open paths for dilate_path. Returns (rings, q) — the
    welded boundary rings and the snap quantum the overlay used."""
    lib = load()
    assert lib is not None
    ca, la, na, keep = _pack(rings)  # noqa: F841
    lens_ptr = ctypes.POINTER(ctypes.c_int32)()
    n_rings = ctypes.c_int64(0)
    q = ctypes.c_double(0.0)
    coords_ptr = lib.rs_buffer_rings(
        ca, la, na, float(radius), int(quad_segs), BUFFER_MODES[mode],
        ctypes.byref(lens_ptr), ctypes.byref(n_rings), ctypes.byref(q),
    )
    try:
        if n_rings.value == 0:
            return [], q.value
        lens = np.ctypeslib.as_array(lens_ptr, shape=(n_rings.value,)).copy()
        total = int(lens.sum())
        coords = np.ctypeslib.as_array(coords_ptr, shape=(total * 2,)).copy().reshape(-1, 2)
    finally:
        lib.rs_free(coords_ptr)
        lib.rs_free(lens_ptr)
    out, off = [], 0
    for n in lens:
        out.append(coords[off : off + int(n)])
        off += int(n)
    return out, q.value


def merge_components(comp_rings, comp_single, radius, quad_segs=8, threads=None):
    """Fused batched merge-component finisher: per component, the N-ary
    winding union of its canonical rings followed by the negative buffer
    (`radius` > 0 is the erosion distance), in ONE native call for the whole
    collection (robosat/tools/merge.py:58-65's per-component loop). Returns a
    list (per component) of lists of welded (N, 2) boundary rings, ready for
    `clip._assemble_polygons(..., presimplified=True)`. Components fan out
    over `threads` workers (default: host CPUs); results are deterministic
    and thread-count independent."""
    lib = load()
    assert lib is not None
    n_comps = len(comp_rings)
    flat_rings = [r for rings in comp_rings for r in rings]
    ca, la, n_rings, keep = _pack(flat_rings)  # noqa: F841
    comp_nrings = np.asarray([len(rings) for rings in comp_rings], np.int32)
    singles = np.asarray([1 if s else 0 for s in comp_single], np.int32)
    if threads is None:
        threads = os.cpu_count() or 1
    out_lens_ptr = ctypes.POINTER(ctypes.c_int32)()
    out_comp_ptr = ctypes.POINTER(ctypes.c_int32)()
    total_rings = ctypes.c_int64(0)
    coords_ptr = lib.rs_merge_components(
        ca, la,
        comp_nrings.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        singles.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_comps, float(radius), int(quad_segs), int(threads),
        ctypes.byref(out_lens_ptr), ctypes.byref(out_comp_ptr), ctypes.byref(total_rings),
    )
    return _unpack_grouped(lib, coords_ptr, out_lens_ptr, out_comp_ptr, total_rings.value, n_comps)


def _unpack_grouped(lib, coords_ptr, lens_ptr, groups_ptr, n_rings, n_groups):
    """Malloc'd (coords, ring lens, per-group ring counts) -> list per group
    of (N, 2) ring arrays; frees the native buffers."""
    try:
        lens = np.ctypeslib.as_array(lens_ptr, shape=(n_rings,)).copy() if n_rings else np.zeros(0, np.int32)
        per = np.ctypeslib.as_array(groups_ptr, shape=(n_groups,)).copy() if n_groups else np.zeros(0, np.int32)
        total = int(lens.sum())
        coords = (
            np.ctypeslib.as_array(coords_ptr, shape=(total * 2,)).copy().reshape(-1, 2)
            if total
            else np.zeros((0, 2))
        )
    finally:
        lib.rs_free(coords_ptr)
        lib.rs_free(lens_ptr)
        lib.rs_free(groups_ptr)
    out, ri, off = [], 0, 0
    for c in range(n_groups):
        rings = []
        for _ in range(int(per[c])):
            n = int(lens[ri])
            rings.append(coords[off : off + n])
            ri += 1
            off += n
        out.append(rings)
    return out


def buffer_rings_batch(geom_rings, radius, quad_segs=8, mode="dilate", threads=None):
    """rs_buffer_rings over many independent geometries in ONE native call
    (`geom_rings`: list per geometry of canonical rings). Returns a list per
    geometry of welded boundary rings. Threaded across host CPUs; results
    are deterministic and thread-count independent."""
    lib = load()
    assert lib is not None
    n_geoms = len(geom_rings)
    flat = [r for rings in geom_rings for r in rings]
    ca, la, _, keep = _pack(flat)  # noqa: F841
    nrings = np.asarray([len(rings) for rings in geom_rings], np.int32)
    if threads is None:
        threads = os.cpu_count() or 1
    out_lens_ptr = ctypes.POINTER(ctypes.c_int32)()
    out_geom_ptr = ctypes.POINTER(ctypes.c_int32)()
    total_rings = ctypes.c_int64(0)
    coords_ptr = lib.rs_buffer_rings_batch(
        ca, la, nrings.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n_geoms,
        float(radius), int(quad_segs), BUFFER_MODES[mode], int(threads),
        ctypes.byref(out_lens_ptr), ctypes.byref(out_geom_ptr), ctypes.byref(total_rings),
    )
    return _unpack_grouped(lib, coords_ptr, out_lens_ptr, out_geom_ptr, total_rings.value, n_geoms)


def _pack_poly_group(geom_polys):
    """Flatten a list (per geometry) of Polygon lists into the flat packed
    arrays rs_intersect_graph consumes: (coords, lens, ring_off, coord_off,
    owner, n_polys). One concatenate over all rings — per-polygon packing
    objects cost more than the whole native call at city scale."""
    rings, nrings_per_poly, owner_l = [], [], []
    for gi, ps in enumerate(geom_polys):
        for p in ps:
            rs = p.rings
            nrings_per_poly.append(len(rs))
            owner_l.append(gi)
            rings.extend(rs)
    n_polys = len(nrings_per_poly)
    owner = np.asarray(owner_l, np.int32)
    lens = np.fromiter((len(r) for r in rings), np.int64, len(rings))
    ring_off = np.zeros(n_polys + 1, np.int64)
    np.cumsum(nrings_per_poly, out=ring_off[1:])
    coord_off = np.zeros(n_polys + 1, np.int64)
    if len(rings):
        pts_per_poly = np.add.reduceat(lens, ring_off[:-1]) if n_polys else np.zeros(0, np.int64)
        np.cumsum(pts_per_poly, out=coord_off[1:])
        coords = np.ascontiguousarray(
            np.concatenate([np.asarray(r, np.float64).reshape(-1, 2) for r in rings])
        )
    else:
        coords = np.zeros((0, 2))
    return coords, np.ascontiguousarray(lens, np.int32), ring_off, coord_off, owner, n_polys


def intersect_graph(grown_polys, shape_polys, exclude_same=True):
    """All (i, j) geometry pairs where a polygon of group-a geometry i
    intersects a polygon of group-b geometry j: the whole merge/dedupe graph
    build (robosat/tools/merge.py:54-56, dedupe.py:45) — grid broad phase +
    predicates — in one native call. Inputs are lists per geometry of
    Polygon lists. `exclude_same` skips i == j pairs (the merge SELF-join;
    dedupe's two distinct collections pass False). Returns (E, 2) int32."""
    lib = load()
    assert lib is not None
    gc, gl, gro, gco, gow, ng = _pack_poly_group(grown_polys)
    sc, sl, sro, sco, sow, ns = _pack_poly_group(shape_polys)
    n_edges = ctypes.c_int64(0)
    ptr = lib.rs_intersect_graph(
        gc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        gl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gro.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gco.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        gow.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ng,
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        sro.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sco.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sow.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ns,
        1 if exclude_same else 0,
        ctypes.byref(n_edges),
    )
    try:
        n = n_edges.value
        edges = np.ctypeslib.as_array(ptr, shape=(n * 2,)).copy().reshape(-1, 2) if n else np.zeros((0, 2), np.int32)
    finally:
        lib.rs_free(ptr)
    return edges


def iou_winding_batch(a_groups, b_groups, threads=None):
    """Per group g: (intersection_area, union_area) of the even-odd region of
    rings `a_groups[g]` vs the winding union of canonically-oriented rings
    `b_groups[g]`, one overlay each, one native call for all groups.
    Returns an (N, 2) float array."""
    lib = load()
    assert lib is not None
    n_groups = len(a_groups)
    ac, al, _, keep_a = _pack([r for rings in a_groups for r in rings])  # noqa: F841
    bc, bl, _, keep_b = _pack([r for rings in b_groups for r in rings])  # noqa: F841
    a_n = np.asarray([len(r) for r in a_groups], np.int32)
    b_n = np.asarray([len(r) for r in b_groups], np.int32)
    out = np.zeros((n_groups, 2), np.float64)
    if threads is None:
        threads = os.cpu_count() or 1
    if n_groups:
        lib.rs_iou_winding_batch(
            ac, al, a_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            bc, bl, b_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n_groups, int(threads),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
    return out


def polys_valid_batch(geom_polys):
    """Batched Polygon.is_valid over a list (per geometry) of Polygon lists;
    returns one bool per GEOMETRY (all its polygons valid — vacuously true
    when empty, mirroring MultiPolygon.is_valid)."""
    lib = load()
    assert lib is not None
    coords, lens, ring_off, coord_off, owner, n_polys = _pack_poly_group(geom_polys)
    out = np.ones(n_polys, np.int8)
    if n_polys:
        lib.rs_polys_valid_batch(
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ring_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            coord_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_polys,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        )
    valid = np.ones(len(geom_polys), bool)
    np.logical_and.at(valid, owner, out.astype(bool))
    return valid


def ring_is_simple(pts):
    """Native ring-simplicity predicate over an (N, 2) float64 ring."""
    lib = load()
    assert lib is not None
    pts = np.ascontiguousarray(pts, np.float64)
    return bool(lib.rs_ring_is_simple(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pts)))


def _pack_polygon_cached(poly):
    """Per-polygon packed-coordinate cache for repeat predicate calls.

    The merge/dedupe graph build tests each geometry against every R-tree
    candidate (O(candidate-pairs) native calls); re-concatenating the ring
    arrays per call was ~8% of `rs merge` wall time. Rings are treated as
    immutable, so the flat (coords, lens) arrays cache on the polygon.
    """
    cached = getattr(poly, "_native_pack", None)
    if cached is None:
        rings = list(poly.rings)
        for r in rings:
            # Cache staleness guard: a later in-place ring mutation would
            # silently leave these packed buffers stale (wrong intersection
            # predicates, no error) — freeze so it raises at write time.
            if isinstance(r, np.ndarray):
                r.setflags(write=False)
        coords = np.ascontiguousarray(np.concatenate([np.asarray(r, np.float64).reshape(-1, 2) for r in rings]))
        lens = np.asarray([len(r) for r in rings], np.int32)
        # The pointer objects are as cacheable as the arrays they reference
        # (kept alive by the same tuple).
        cached = (
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(lens),
            (coords, lens),
        )
        try:
            poly._native_pack = cached
        except AttributeError:  # foreign object without __dict__
            pass
    return cached


def polys_intersect(pa, pb):
    """Native polygon-pair share-any-point predicate (containment either way
    or closed-segment boundary crossing; mirrors geometries_intersect)."""
    lib = load()
    assert lib is not None
    ca, la, na, keep_a = _pack_polygon_cached(pa)  # noqa: F841
    cb, lb, nb, keep_b = _pack_polygon_cached(pb)  # noqa: F841
    return bool(lib.rs_polys_intersect(ca, la, na, cb, lb, nb))


def overlay_iou_areas(rings_a, rings_b):
    """(intersection_area, union_area) of two even-odd ring sets from one
    native slab sweep."""
    lib = load()
    assert lib is not None
    ca, la, na, keep_a = _pack(rings_a)  # noqa: F841
    cb, lb, nb, keep_b = _pack(rings_b)  # noqa: F841
    out = (ctypes.c_double * 2)()
    lib.rs_overlay_iou_areas(ca, la, na, cb, lb, nb, out)
    return float(out[0]), float(out[1])


def overlay_rings(rings_a, rings_b, op):
    """Native overlay -> welded + linked boundary rings as (N, 2) arrays."""
    lib = load()
    assert lib is not None
    ca, la, na, keep_a = _pack(rings_a)  # noqa: F841
    cb, lb, nb, keep_b = _pack(rings_b)  # noqa: F841
    lens_ptr = ctypes.POINTER(ctypes.c_int32)()
    n_rings = ctypes.c_int64(0)
    coords_ptr = lib.rs_overlay_rings(ca, la, na, cb, lb, nb, _OPS[op], ctypes.byref(lens_ptr), ctypes.byref(n_rings))
    try:
        if n_rings.value == 0:
            return []
        lens = np.ctypeslib.as_array(lens_ptr, shape=(n_rings.value,)).copy()
        total = int(lens.sum())
        coords = np.ctypeslib.as_array(coords_ptr, shape=(total * 2,)).copy().reshape(-1, 2)
    finally:
        lib.rs_free(coords_ptr)
        lib.rs_free(lens_ptr)
    rings, off = [], 0
    for n in lens:
        rings.append(coords[off : off + int(n)])
        off += int(n)
    return rings
