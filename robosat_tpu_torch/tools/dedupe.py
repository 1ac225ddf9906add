"""`rs dedupe` — drop predicted features that OpenStreetMap already has.

This package's copy of robosat_tpu/tools/dedupe.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_vector_tools.py.

Contract parity: robosat/tools/dedupe.py. A prediction survives when nothing
in OSM is near it (R-tree candidates), nothing intersects it, or its IoU
against the union of intersecting OSM shapes stays under the threshold.

The native path batches the whole run: ONE call finds every intersecting
(prediction, OSM) pair (grid broad phase + predicates), both collections
project to the equal-area CRS in one vectorized pass, and ONE call scores
every overlapping prediction's IoU — each score is a single overlay of the
prediction against the WINDING union of its overlapping OSM shapes, so
union(overlapping) is never materialized. The per-prediction loop below is
the pure-Python-engine fallback and the behavioral oracle.
"""

import argparse
import json
from collections import defaultdict

from tqdm import tqdm

from robosat_tpu_torch.geo import clip, geojson, proj
from robosat_tpu_torch.geo.geometry import (
    MultiPolygon,
    Polygon,
    geometries_intersect,
    mapping,
    shape,
    transform_multipolygons,
)
from robosat_tpu_torch.spatial.core import iou, make_index, union


def add_parser(subparser):
    parser = subparser.add_parser(
        "dedupe",
        help="removes predictions that duplicate OpenStreetMap features",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

    parser.add_argument("osm", type=str, help="GeoJSON ground truth extracted from OpenStreetMap")
    parser.add_argument("predicted", type=str, help="GeoJSON predictions to thin out")
    parser.add_argument(
        "--threshold", type=float, required=True, help="IoU above which a prediction counts as a duplicate"
    )
    parser.add_argument("out", type=str, help="GeoJSON file for the surviving predictions")

    parser.set_defaults(func=main)


def _load_shapes(path):
    with open(path) as fp:
        return [shape(feature["geometry"]) for feature in json.load(fp)["features"]]


def _is_novel(predicted, osm_shapes, index, threshold):
    nearby = [osm_shapes[i] for i in index.intersection(predicted.bounds)]
    if not nearby:
        return True

    overlapping = [geom for geom in nearby if geometries_intersect(predicted, geom)]
    if not overlapping:
        return True

    return iou(predicted, union(overlapping)) < threshold


def _novel_flags(predicted_shapes, osm_shapes, threshold):
    """One bool per prediction: batched native path, or the per-prediction
    reference loop when the native engine is unavailable."""
    try:
        from robosat_tpu_torch import native
    except Exception:  # pragma: no cover - import cycle safety
        native = None
    if native is None or native.load() is None or not all(
        isinstance(g, (Polygon, MultiPolygon)) for g in predicted_shapes + osm_shapes
    ):
        index = make_index(osm_shapes)
        return [
            _is_novel(predicted, osm_shapes, index, threshold)
            for predicted in tqdm(predicted_shapes, desc="Deduplicating", unit="shapes", ascii=True)
        ]

    pred_polys = [list(g.geoms) if isinstance(g, MultiPolygon) else [g] for g in predicted_shapes]
    osm_polys = [list(g.geoms) if isinstance(g, MultiPolygon) else [g] for g in osm_shapes]
    overlapping = defaultdict(list)
    for i, j in native.intersect_graph(pred_polys, osm_polys, exclude_same=False):
        overlapping[int(i)].append(int(j))

    # Equal-area projection of BOTH collections in one vectorized pass each
    # (spatial.core.iou projected per call); the IoU itself is one overlay of
    # the prediction vs the winding union of its overlapping OSM shapes —
    # same measure as iou(predicted, union(overlapping)) without building
    # the union (values agree to overlay snap tolerance).
    as_mp = lambda g: g if isinstance(g, MultiPolygon) else MultiPolygon([g])  # noqa: E731
    pred_ea = transform_multipolygons([as_mp(g) for g in predicted_shapes], proj.wgs_to_mollweide)
    osm_ea = transform_multipolygons([as_mp(g) for g in osm_shapes], proj.wgs_to_mollweide)

    scored = sorted(overlapping)
    a_groups = [clip._collect_rings(pred_ea[i]) for i in scored]
    b_groups = [
        clip._canonical_union_rings([osm_ea[j] for j in overlapping[i]]) for i in scored
    ]
    areas = native.iou_winding_batch(a_groups, b_groups)
    novel = [True] * len(predicted_shapes)
    for k, i in enumerate(scored):
        inter, union_area = areas[k]
        rv = inter / union_area if union_area > 0 else 0.0
        novel[i] = min(max(rv, 0.0), 1.0) < threshold
    return novel


def main(args):
    osm_shapes = _load_shapes(args.osm)
    predicted_shapes = _load_shapes(args.predicted)

    flags = _novel_flags(predicted_shapes, osm_shapes, args.threshold)
    kept = [
        geojson.feature(mapping(predicted))
        for predicted, novel in zip(predicted_shapes, flags)
        if novel
    ]

    with open(args.out, "w") as fp:
        geojson.dump(geojson.feature_collection(kept), fp)
