"""robosat_tpu_torch's geometry stack vs its JAX-package originals, exact.

The port keeps its own copies of geo/ (tile bounds, projections, GeoJSON,
geometry, the overlay engine, buffers, the STR-tree), graph/, spatial/ and
the C++ geometry engine with its loader. They run the same float operations
as the originals, so every result must be equal, not close: coordinates,
areas, predicates and index answers. The overlay and buffer cases run on
both engines of each package, the native one and the pure-Python one that
`RS_NATIVE_GEOMETRY=0` (or a failed build) selects. The last case builds
the port's engine from an empty build directory in two processes at once.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from robosat_tpu import native as jnative
from robosat_tpu import tiles as jtiles
from robosat_tpu.geo import buffer as jbuffer
from robosat_tpu.geo import clip as jclip
from robosat_tpu.geo import geojson as jgeojson
from robosat_tpu.geo import geometry as jgeometry
from robosat_tpu.geo import index as jindex
from robosat_tpu.geo import proj as jproj
from robosat_tpu.geo import tilemath as jtilemath
from robosat_tpu.graph import UndirectedGraph as JGraph
from robosat_tpu.spatial import core as jspatial
from robosat_tpu_torch import native
from robosat_tpu_torch import tiles
from robosat_tpu_torch.geo import buffer, clip, geojson, geometry, index, proj, tilemath
from robosat_tpu_torch.graph import UndirectedGraph
from robosat_tpu_torch.spatial import core as spatial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def native_engines():
    """Both packages' C++ engines, loaded. The JAX package's first-use build
    writes one shared temporary name (robosat_tpu/native/__init__.py:25-28),
    so test processes that build it at once can spoil each other's output,
    and the loser caches the failure. Where that happened, build it once
    more under a name of this process's own, rename it into place and load
    it, as the port's loader does."""
    if jnative.load() is None:
        tmp = "{}.tmp{}".format(jnative._LIB, os.getpid())
        subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-o", tmp, jnative._SRC],
                       check=True, capture_output=True, timeout=30)
        os.replace(tmp, jnative._LIB)
        jnative._lib, jnative._tried = None, False
    assert jnative.load() is not None, "the JAX package's geometry engine did not load"
    assert native.load() is not None, "the port's geometry engine did not load"


@pytest.fixture(params=["native", "python"])
def engine(request, monkeypatch):
    """Both packages on the named engine."""
    if request.param == "native":
        native_engines()
    else:
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "load", lambda: None)
        for mod in (clip, jclip):
            monkeypatch.setattr(mod, "_USE_NATIVE", False)
    return request.param


def _canon(g):
    """A geometry as nested lists of floats, with its type: equal means the
    same coordinates bit for bit."""
    if isinstance(g, (geometry.MultiPolygon, jgeometry.MultiPolygon)):
        return ("MultiPolygon", [_canon(p)[1] for p in g.geoms])
    if isinstance(g, (geometry.Polygon, jgeometry.Polygon)):
        return ("Polygon", [np.asarray(r, np.float64).tolist() for r in g.rings])
    if isinstance(g, (geometry.LineString, jgeometry.LineString)):
        return ("LineString", np.asarray(g.coords).tolist())
    raise TypeError(type(g))


def _star(rng, cx, cy, r, n):
    """A simple star-shaped ring of n vertices around (cx, cy)."""
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radii = r * rng.uniform(0.5, 1.0, n)
    return np.stack([cx + radii * np.cos(angles), cy + radii * np.sin(angles)], 1)


def _mappings(seed, n=6):
    """GeoJSON polygons: stars, squares with a hole, a bowtie, a multipolygon."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(0, 10, 2)
        ring = _star(rng, cx, cy, rng.uniform(1, 3), int(rng.integers(5, 12)))
        out.append({"type": "Polygon", "coordinates": [ring.tolist() + [ring[0].tolist()]]})
    x, y = rng.uniform(0, 8, 2)
    shell = [[x, y], [x + 4, y], [x + 4, y + 4], [x, y + 4], [x, y]]
    hole = [[x + 1, y + 1], [x + 1, y + 2], [x + 2, y + 2], [x + 2, y + 1], [x + 1, y + 1]]
    out.append({"type": "Polygon", "coordinates": [shell, hole]})
    out.append({"type": "Polygon", "coordinates": [[[0, 0], [2, 2], [2, 0], [0, 2], [0, 0]]]})
    out.append({"type": "MultiPolygon", "coordinates": [out[0]["coordinates"], out[1]["coordinates"]]})
    return out


def _both(mappings):
    return [geometry.shape(m) for m in mappings], [jgeometry.shape(m) for m in mappings]


def test_proj_matches_and_round_trips():
    rng = np.random.default_rng(0)
    lng, lat = rng.uniform(-180, 180, 500), rng.uniform(-84, 84, 500)
    for name in ("wgs_to_webmercator", "wgs_to_worldmercator", "wgs_to_mollweide"):
        ours, ref = getattr(proj, name)(lng, lat), getattr(jproj, name)(lng, lat)
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref), err_msg=name)
    for fwd, inv in (("wgs_to_webmercator", "webmercator_to_wgs"), ("wgs_to_worldmercator", "worldmercator_to_wgs")):
        x, y = getattr(proj, fwd)(lng, lat)
        back, ref = getattr(proj, inv)(x, y), getattr(jproj, inv)(x, y)
        np.testing.assert_array_equal(np.asarray(back), np.asarray(ref), err_msg=inv)
        np.testing.assert_allclose(np.asarray(back), np.stack([lng, lat]), rtol=0, atol=1e-9)


def test_tile_bounds_and_pixel_to_location_match():
    rng = np.random.default_rng(1)
    for z in (0, 5, 18, 22):
        for _ in range(8):
            x, y = (int(v) for v in rng.integers(0, 2**z, 2))
            assert tilemath.bounds(tilemath.Tile(x, y, z)) == tuple(jtilemath.bounds(jtilemath.Tile(x, y, z)))
            dx, dy = (float(v) for v in rng.uniform(0, 1, 2))
            assert tiles.pixel_to_location(tiles.Tile(x, y, z), dx, dy) == jtiles.pixel_to_location(
                jtiles.Tile(x, y, z), dx, dy
            )
    assert tiles.Tile is tilemath.Tile


def test_geojson_matches():
    rings = [[(0, 0), (1, 0), (1, 1)], [(0.2, 0.2), (0.4, 0.2), (0.4, 0.4), (0.2, 0.2)]]
    coll = geojson.feature_collection([geojson.feature(geojson.polygon_geometry(rings), {"area": 3}),
                                       geojson.feature(geojson.linestring_geometry([(0, 1), (2, 3)]))])
    ref = jgeojson.feature_collection([jgeojson.feature(jgeojson.polygon_geometry(rings), {"area": 3}),
                                       jgeojson.feature(jgeojson.linestring_geometry([(0, 1), (2, 3)]))])
    assert geojson.dumps(coll) == jgeojson.dumps(ref)
    assert geojson.loads(geojson.dumps(coll)) == ref


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_predicates_and_measures_match(seed, engine):
    mappings = _mappings(seed)
    ours, refs = _both(mappings)
    rng = np.random.default_rng(seed + 10)
    points = rng.uniform(-1, 12, (20, 2))
    for a, b in zip(ours, refs):
        assert (a.is_valid, a.area, a.bounds) == (b.is_valid, b.area, b.bounds)
        assert geometry.mapping(a) == jgeometry.mapping(b)
        assert [a.contains_point(p) for p in points] == [b.contains_point(p) for p in points]
        if isinstance(a, geometry.Polygon):
            assert geometry.ring_area(a.shell) == jgeometry.ring_area(b.shell)
            assert geometry.ring_is_simple(a.shell) == jgeometry.ring_is_simple(b.shell)
            assert [geometry.point_in_ring(p, a.shell) for p in points] == [
                jgeometry.point_in_ring(p, b.shell) for p in points
            ]
            for sign in (1.0, -1.0):
                assert _canon(geometry.orient_polygon(a, sign)) == _canon(jgeometry.orient_polygon(b, sign))
            if a.is_valid:
                np.testing.assert_array_equal(geometry.representative_point(a.shell),
                                              jgeometry.representative_point(b.shell))
    for i in range(len(ours)):
        for j in range(len(ours)):
            assert geometry.geometries_intersect(ours[i], ours[j]) == jgeometry.geometries_intersect(refs[i], refs[j])
    mps = [g if isinstance(g, geometry.MultiPolygon) else geometry.MultiPolygon([g]) for g in ours]
    jmps = [g if isinstance(g, jgeometry.MultiPolygon) else jgeometry.MultiPolygon([g]) for g in refs]
    for fn in ("wgs_to_mollweide", "wgs_to_worldmercator"):
        got = geometry.transform_multipolygons(mps, getattr(proj, fn))
        want = jgeometry.transform_multipolygons(jmps, getattr(jproj, fn))
        assert [_canon(g) for g in got] == [_canon(g) for g in want]
        got = [geometry.transform_geometry(getattr(proj, fn), g) for g in ours]
        want = [jgeometry.transform_geometry(getattr(jproj, fn), g) for g in refs]
        assert [_canon(g) for g in got] == [_canon(g) for g in want]


@pytest.mark.parametrize("seed", [0, 1])
def test_clip_overlays_match(seed, engine):
    ours, refs = _both([m for m in _mappings(seed, n=4) if m["coordinates"][0][0] != [0, 0]][:5])
    ours, refs = [g for g in ours if g.is_valid], [g for g in refs if g.is_valid]
    for i in range(len(ours) - 1):
        a, b, ja, jb = ours[i], ours[i + 1], refs[i], refs[i + 1]
        for op in ("union", "intersection", "difference", "xor"):
            assert _canon(clip.boolean_op(a, b, op)) == _canon(jclip.boolean_op(ja, jb, op)), op
            assert clip.overlay_area(a, b, op) == jclip.overlay_area(ja, jb, op), op
        assert clip.overlay_iou_areas(a, b) == jclip.overlay_iou_areas(ja, jb)
    assert _canon(clip.union_all(ours)) == _canon(jclip.union_all(refs))
    assert clip.union_all_area(ours) == jclip.union_all_area(refs)
    assert _canon(spatial.union(ours)) == _canon(jspatial.union(refs))


@pytest.mark.parametrize("distance", [0.4, -0.3])
def test_buffers_match(distance, engine):
    mappings = _mappings(2, n=3)[:3] + [_mappings(2)[-3]]
    ours, refs = _both(mappings)
    for a, b in zip(ours, refs):
        assert _canon(buffer.buffer_geometry(a, distance)) == _canon(jbuffer.buffer_geometry(b, distance))
    line = [[0.0, 0.0], [3.0, 1.0], [4.0, 4.0]]
    assert _canon(buffer.buffer_geometry(geometry.LineString(line), abs(distance))) == _canon(
        jbuffer.buffer_geometry(jgeometry.LineString(line), abs(distance))
    )


def test_strtree_queries_match():
    rng = np.random.default_rng(3)
    lo = rng.uniform(0, 100, (300, 2))
    boxes = [tuple(float(v) for v in (x, y, x + w, y + h)) for (x, y), (w, h) in zip(lo, rng.uniform(0, 6, (300, 2)))]
    ours, ref = index.STRtree(boxes), jindex.STRtree(boxes)
    for q in rng.uniform(0, 100, (40, 2)):
        box = (float(q[0]), float(q[1]), float(q[0]) + 9.0, float(q[1]) + 5.0)
        assert list(ours.intersection(box)) == list(ref.intersection(box))


def test_graph_components_match():
    rng = np.random.default_rng(4)
    ours, ref = UndirectedGraph(), JGraph()
    for s, t in rng.integers(0, 60, (45, 2)):
        ours.add_edge(int(s), int(t))
        ref.add_edge(int(s), int(t))
    assert list(ours.components()) == list(ref.components())
    assert list(ours.vertices()) == list(ref.vertices())
    assert all(ours.targets(v) == ref.targets(v) for v in ref.vertices())


def test_spatial_iou_and_projections_match(engine):
    lots = []
    for k, (dx, dy) in enumerate([(0, 0), (4e-5, 3e-5), (2e-4, 0)]):
        x, y = -122.42 + dx, 37.76 + dy
        lots.append({"type": "Polygon", "coordinates": [[[x, y], [x + 1e-4, y], [x + 1e-4, y + 8e-5],
                                                          [x, y + 8e-5], [x, y]]]})
    ours, refs = _both(lots)
    for i in range(3):
        for j in range(3):
            assert spatial.iou(ours[i], ours[j]) == jspatial.iou(refs[i], refs[j])
    for fn in ("project_ea", "project_wgs_el"):
        assert [_canon(getattr(spatial, fn)(g)) for g in ours] == [_canon(getattr(jspatial, fn)(g)) for g in refs]
    el = [spatial.project_wgs_el(g) for g in ours]
    assert [_canon(spatial.project_el_wgs(g)) for g in el] == [
        _canon(jspatial.project_el_wgs(jspatial.project_wgs_el(g))) for g in refs
    ]
    assert [list(spatial.make_index(ours).intersection(g.bounds)) for g in ours] == [
        list(jspatial.make_index(refs).intersection(g.bounds)) for g in refs
    ]


def test_native_batched_wrappers_match():
    native_engines()
    ours, refs = _both(_mappings(5, n=8)[:8])
    rings = [clip._canonical_union_rings([g]) for g in ours]
    jrings = [jclip._canonical_union_rings([g]) for g in refs]
    for mode, r in (("dilate", 0.5), ("erode", 0.2)):
        got = native.buffer_rings_batch(rings, r, 8, mode)
        want = jnative.buffer_rings_batch(jrings, r, 8, mode)
        assert [[x.tolist() for x in g] for g in got] == [[x.tolist() for x in g] for g in want]
    comps = [rings[0] + rings[1], rings[2], rings[3] + rings[4] + rings[5]]
    got = native.merge_components(comps, [False, True, False], 0.3)
    want = jnative.merge_components(comps, [False, True, False], 0.3)
    assert [[x.tolist() for x in g] for g in got] == [[x.tolist() for x in g] for g in want]
    polys = [[g] for g in ours]
    jpolys = [[g] for g in refs]
    np.testing.assert_array_equal(native.intersect_graph(polys, polys), jnative.intersect_graph(jpolys, jpolys))
    np.testing.assert_array_equal(native.intersect_graph(polys, polys[::-1], exclude_same=False),
                                  jnative.intersect_graph(jpolys, jpolys[::-1], exclude_same=False))
    np.testing.assert_array_equal(native.iou_winding_batch(rings[:4], rings[4:]),
                                  jnative.iou_winding_batch(jrings[:4], jrings[4:]))
    np.testing.assert_array_equal(native.polys_valid_batch(polys), jnative.polys_valid_batch(jpolys))
    for a, b in zip(ours[:6], refs[:6]):
        assert native.ring_is_simple(a.shell) == jnative.ring_is_simple(b.shell)
        assert native.polys_intersect(a, ours[0]) == jnative.polys_intersect(b, refs[0])
        assert native.overlay_iou_areas(a.rings, ours[0].rings) == jnative.overlay_iou_areas(b.rings, refs[0].rings)
        assert native.overlay_area(a.rings, ours[1].rings, "xor") == jnative.overlay_area(b.rings, refs[1].rings, "xor")


def test_engine_builds_in_two_processes_at_once(tmp_path):
    """Two processes that find no library build it at the same time into
    the same empty `_build/`; each renames its own output into place, so
    both load a whole library and compute with it."""
    pkg = tmp_path / "robosat_tpu_torch"
    (pkg / "native").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    for name in ("__init__.py", "geometry.cpp"):
        shutil.copy(os.path.join(ROOT, "robosat_tpu_torch", "native", name), pkg / "native" / name)
    go = tmp_path / "go"
    code = textwrap.dedent("""
        import os, time
        while not os.path.exists({go!r}):
            time.sleep(0.01)
        from robosat_tpu_torch import native
        assert native.load() is not None, "engine did not load"
        sq = [[0.0, 0.0], [2.0, 0.0], [2.0, 2.0], [0.0, 2.0]]
        sh = [[1.0, 1.0], [3.0, 1.0], [3.0, 3.0], [1.0, 3.0]]
        print(repr(native.overlay_area([sq], [sh], "union")))
    """).format(go=str(go))
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    go.write_text("")
    try:
        outs = [p.communicate(timeout=45) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert float(out.strip()) == native.overlay_area(
            [[[0.0, 0.0], [2.0, 0.0], [2.0, 2.0], [0.0, 2.0]]], [[[1.0, 1.0], [3.0, 1.0], [3.0, 3.0], [1.0, 3.0]]], "union"
        )
    assert sorted(os.listdir(pkg / "_build")) == ["_geometry.so"]
