"""`rs merge` — merge adjacent GeoJSON features within a distance threshold.

This package's copy of robosat_tpu/tools/merge.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_vector_tools.py.

Contract parity: robosat/tools/merge.py — buffer each shape by the threshold
in EPSG:3395 meters, connect intersecting buffered shapes into components
(R-tree candidates + union-find), union each component, negative-buffer back,
orient exteriors counter-clockwise, attach the equal-area m^2 `area`
property. Built entirely on the in-repo geometry engine.

The hot phases run BATCHED through the native engine — one ctypes call for
all grow buffers, one for all candidate intersection predicates, one fused
union+erode call for all components — with the original per-feature loops
kept as the pure-Python-engine fallback and test oracle.
"""

import argparse
import sys

from tqdm import tqdm

from robosat_tpu_torch.geo import clip, geojson, proj
from robosat_tpu_torch.geo.buffer import buffer_geometry
from robosat_tpu_torch.geo.geometry import (
    MultiPolygon,
    Polygon,
    geometries_intersect,
    mapping,
    orient_polygon,
    ring_area,
    shape,
    transform_multipolygons,
)
from robosat_tpu_torch.graph import UndirectedGraph
from robosat_tpu_torch.spatial.core import make_index, project_wgs_el, union


def _native():
    try:
        from robosat_tpu_torch import native as native_mod

        if native_mod.load() is not None:
            return native_mod
    except Exception:  # pragma: no cover - import cycle safety
        pass
    return None


def grow_all(shapes_el, threshold):
    """Dilate every shape by the threshold (robosat/tools/merge.py:50-52) —
    one batched native call for the whole collection when available."""
    native = _native()
    polygonal = all(isinstance(g, (Polygon, MultiPolygon)) for g in shapes_el)
    if native is None or threshold <= 0 or not polygonal:
        return [buffer_geometry(geom, threshold) for geom in
                tqdm(shapes_el, desc="Growing shapes", unit="shapes", ascii=True)]
    canon = [clip._canonical_union_rings([g]) for g in shapes_el]
    results = native.buffer_rings_batch(canon, threshold, 8, "dilate")
    return [clip._assemble_polygons(rings, 0.0, presimplified=True) for rings in results]


def build_graph(shapes_el, embiggened, graph):
    """Connect every shape to the shapes its grown buffer intersects
    (robosat/tools/merge.py:54-56). The native path runs its own grid broad
    phase + predicates in ONE call; the fallback queries an R-tree per
    feature like the reference."""
    native = _native()
    polygonal = all(isinstance(g, (Polygon, MultiPolygon)) for g in shapes_el)
    if native is None or not polygonal:
        idx = make_index(shapes_el)
        for i, grown in enumerate(tqdm(embiggened, desc="Building graph", unit="shapes", ascii=True)):
            graph.add_edge(i, i)
            if grown.is_empty:
                continue
            for t in idx.intersection(grown.bounds):
                if t != i and geometries_intersect(grown, shapes_el[t]):
                    graph.add_edge(i, t)
        return

    for i in range(len(embiggened)):
        graph.add_edge(i, i)
    grown_polys = [list(g.geoms) if isinstance(g, MultiPolygon) else [g] for g in embiggened]
    shape_polys = [list(g.geoms) if isinstance(g, MultiPolygon) else [g] for g in shapes_el]
    for i, j in native.intersect_graph(grown_polys, shape_polys):
        graph.add_edge(int(i), int(j))


def merge_components(embiggened, components, threshold):
    """Per component: union of the grown members, negative-buffered back —
    still in EPSG:3395 meters (robosat/tools/merge.py:58-65). One fused
    native call finishes ALL components (union overlay -> inward offset-curve
    erode without the Python round trip in between, threaded across host
    cores); the per-component loop below is the pure-Python-engine fallback
    and the test oracle."""
    native = _native()
    if native is not None:
        comp_rings, comp_single = [], []
        for component in components:
            members = [embiggened[v] for v in component]
            nonempty = [g for g in members if g is not None and not g.is_empty]
            # union_all returns a lone element unchanged (the reference's
            # functools.reduce semantics) — the native path must know.
            comp_single.append(len(nonempty) <= 1)
            comp_rings.append(clip._canonical_union_rings(nonempty))
        results = native.merge_components(comp_rings, comp_single, threshold)
        return [
            clip._assemble_polygons(rings, 0.0, presimplified=True)
            for rings in tqdm(results, desc="Merging components", unit="component", ascii=True)
        ]
    return [
        buffer_geometry(union([embiggened[v] for v in component]), -threshold)
        for component in tqdm(components, desc="Merging components", unit="component", ascii=True)
    ]


# Batched per-ring projection (shared with rs dedupe's finishing pass).
_project_multipolygons = transform_multipolygons


def add_parser(subparser):
    parser = subparser.add_parser(
        "merge", help="fuses GeoJSON features that sit close together", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )

    parser.add_argument("features", type=str, help="GeoJSON features to merge")
    parser.add_argument("--threshold", type=int, required=True, help="merge features closer than this many meters")
    parser.add_argument("out", type=str, help="GeoJSON file for the merged features")

    parser.set_defaults(func=main)


def main(args):
    with open(args.features) as fp:
        collection = geojson.load(fp)

    shapes = [shape(feature["geometry"]) for feature in collection["features"]]
    del collection

    # Project into EPSG:3395 ONCE and run the whole grow/graph/union/erode
    # pipeline in meters; World Mercator is separable and monotone per axis,
    # so bounding boxes and intersection predicates agree with their WGS84
    # counterparts, and only the final merged outlines project back. All
    # polygonal collections project in one vectorized pass (identical
    # values — the projection is an elementwise ufunc chain).
    if all(isinstance(g, (Polygon, MultiPolygon)) for g in shapes):
        shapes_el = transform_multipolygons(
            [g if isinstance(g, MultiPolygon) else MultiPolygon([g]) for g in shapes],
            proj.wgs_to_worldmercator,
        )
    else:
        shapes_el = [project_wgs_el(geom) for geom in shapes]

    graph = UndirectedGraph()

    embiggened = grow_all(shapes_el, args.threshold)
    build_graph(shapes_el, embiggened, graph)

    components = list(graph.components())
    assert sum(len(v) for v in components) == len(shapes), "components capture all shape indices"

    eroded = merge_components(embiggened, components, args.threshold)
    merged_all = _project_multipolygons(eroded, proj.worldmercator_to_wgs)

    native = _native()
    if native is not None:
        valid = native.polys_valid_batch([list(mp.geoms) for mp in merged_all])
    else:
        valid = [mp.is_valid for mp in merged_all]

    features = []
    oriented_all = []
    for merged, ok in zip(merged_all, valid):
        if not ok or merged.is_empty:
            print("Warning: merged feature is not valid, skipping", file=sys.stderr)
            continue

        polys = merged.geoms if isinstance(merged, MultiPolygon) else [merged]
        oriented = [orient_polygon(p, sign=1.0) for p in polys]
        oriented_all.append(oriented[0] if len(oriented) == 1 else MultiPolygon(oriented))

    # Equal-area areas, rounded to full m^2 (robosat/tools/merge.py:79) —
    # the Mollweide projection of every ring in one vectorized call.
    as_mps = [g if isinstance(g, MultiPolygon) else MultiPolygon([g]) for g in oriented_all]
    for geometry, ea in zip(oriented_all, _project_multipolygons(as_mps, proj.wgs_to_mollweide)):
        area = int(round(sum(
            abs(ring_area(p.shell)) - sum(abs(ring_area(h)) for h in p.holes) for p in ea.geoms
        )))
        features.append(geojson.feature(mapping(geometry), properties={"area": area}))

    with open(args.out, "w") as fp:
        geojson.dump(geojson.feature_collection(features), fp)
