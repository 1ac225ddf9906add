"""The port's `features`, `merge` and `dedupe` vs the JAX package's tools.

A small slippy map of label masks at z18 (3 x 3 tiles of 128 px, classes
background/parking/building) holds blobs drawn on the whole block, so they
cross tile edges, with holes and pepper noise. Both packages run features
(parking and building; chunks of 4, so the last chunk is padded), then merge
and dedupe on the same GeoJSON, and must write the same bytes. The port runs
its morphology on the CPU here (`device=`), as a caller without a card asks.
The port's batched native merge and dedupe paths are also held against its
per-feature fallbacks (as tests/test_vector_batched.py does for the JAX tools).
"""

import argparse
import json

import numpy as np
import pytest
import torch
from PIL import Image

from robosat_tpu.tools import dedupe as jdedupe
from robosat_tpu.tools import features as jfeatures
from robosat_tpu.tools import merge as jmerge
from robosat_tpu_torch.config import save_config
from robosat_tpu_torch.spatial.core import make_index
from robosat_tpu_torch.tools import dedupe, features, merge
from test_torch_port_geo import native_engines

CPU = torch.device("cpu")
SIZE, X0, Y0 = 128, 41920, 101310  # z18 tiles around 37.7 N


def _labels(seed, n=3):
    """(n*SIZE)^2 label canvas: parking (1) rectangles with holes, building
    (2) squares, pepper noise; cut into n x n tiles."""
    rng = np.random.default_rng(seed)
    side = n * SIZE
    canvas = np.zeros((side, side), np.uint8)
    for _ in range(7):
        x, y = rng.integers(0, side - 60, 2)
        w, h = rng.integers(40, 110, 2)
        canvas[y : y + h, x : x + w] = 1
        if w > 70 and h > 70:
            canvas[y + 25 : y + 45, x + 25 : x + 45] = 0
    for _ in range(12):
        x, y = rng.integers(0, side - 20, 2)
        s = int(rng.integers(12, 26))
        canvas[y : y + s, x : x + s] = 2
    noise = rng.random((side, side)) < 0.01
    canvas[noise] = rng.integers(0, 3, int(noise.sum()))
    return canvas


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    # Both packages' tools on their native engines (the batched paths).
    native_engines()
    root = tmp_path_factory.mktemp("vector")
    canvas = _labels(0)
    n = canvas.shape[0] // SIZE
    for i in range(n):
        for j in range(n):
            d = root / "labels" / "18" / str(X0 + i)
            d.mkdir(parents=True, exist_ok=True)
            img = Image.fromarray(canvas[j * SIZE : (j + 1) * SIZE, i * SIZE : (i + 1) * SIZE], mode="P")
            img.putpalette([0, 0, 0, 255, 165, 0, 255, 0, 0])
            img.save(d / "{}.png".format(Y0 + j))
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking", "building"],
                            "colors": ["denim", "orange", "red"]}}, str(root / "dataset.toml"))
    return root


def _features_args(root, kind, out):
    return argparse.Namespace(type=kind, masks=str(root / "labels"), out=str(out), dataset=str(root / "dataset.toml"),
                              chunk=4)


@pytest.mark.parametrize("kind", ["parking", "building"])
def test_features_merge_dedupe_write_jax_bytes(flow, kind):
    root = flow
    jfeatures.main(_features_args(root, kind, root / "j_{}.geojson".format(kind)))
    features.main(_features_args(root, kind, root / "p_{}.geojson".format(kind)), device=CPU)
    found = (root / "j_{}.geojson".format(kind)).read_bytes()
    assert (root / "p_{}.geojson".format(kind)).read_bytes() == found
    assert len(json.loads(found)["features"]) >= 4

    merged = {}
    for name, tool in (("j", jmerge), ("p", merge)):
        out = root / "{}_{}_merged.geojson".format(name, kind)
        tool.main(argparse.Namespace(features=str(root / "j_{}.geojson".format(kind)), threshold=2, out=str(out)))
        merged[name] = out.read_bytes()
    assert merged["p"] == merged["j"]
    merged_features = json.loads(merged["j"])["features"]
    assert 1 <= len(merged_features) < len(json.loads(found)["features"])

    # "OSM": every other merged feature as is (a duplicate), the rest nudged
    # by a fraction of their size (partial overlaps on both sides of 0.5).
    osm = []
    for k, f in enumerate(merged_features):
        geom = json.loads(json.dumps(f["geometry"]))
        if k % 2:
            rings = geom["coordinates"] if geom["type"] == "Polygon" else geom["coordinates"][0]
            xs = [p[0] for p in rings[0]]
            shift = (max(xs) - min(xs)) * (0.2 if k % 4 == 1 else 0.7)
            for ring in rings:
                for p in ring:
                    p[0] += shift
        osm.append({"type": "Feature", "properties": {}, "geometry": geom})
    (root / "osm_{}.geojson".format(kind)).write_text(json.dumps({"type": "FeatureCollection", "features": osm}))
    deduped = {}
    for name, tool in (("j", jdedupe), ("p", dedupe)):
        out = root / "{}_{}_deduped.geojson".format(name, kind)
        tool.main(argparse.Namespace(osm=str(root / "osm_{}.geojson".format(kind)),
                                     predicted=str(root / "j_{}_merged.geojson".format(kind)), threshold=0.5,
                                     out=str(out)))
        deduped[name] = out.read_bytes()
    assert deduped["p"] == deduped["j"]
    assert len(json.loads(deduped["j"])["features"]) < len(merged_features)


def test_features_per_tile_apply_matches_batched(flow):
    """The handler's per-tile `apply` (morphology per mask on the handler's
    device) gives the batched tool's features."""
    from robosat_tpu_torch.features.parking import ParkingHandler
    from robosat_tpu_torch.tiles import tiles_from_slippy_map

    handler = ParkingHandler(CPU)
    for tile, path in tiles_from_slippy_map(str(flow / "labels")):
        handler.apply(tile, (np.array(Image.open(path)) == 1).astype(np.uint8))
    handler.save(str(flow / "per_tile.geojson"))
    features.main(_features_args(flow, "parking", flow / "batched.geojson"), device=CPU)
    assert (flow / "per_tile.geojson").read_bytes() == (flow / "batched.geojson").read_bytes()


def test_merge_and_dedupe_native_match_fallbacks(flow, tmp_path, monkeypatch):
    src = tmp_path / "features.geojson"
    features.main(_features_args(flow, "parking", src), device=CPU)
    merge.main(argparse.Namespace(features=str(src), threshold=2, out=str(tmp_path / "batched.geojson")))
    shapes = [merge.shape(f["geometry"]) for f in json.loads(src.read_text())["features"]]
    flags = dedupe._novel_flags(shapes[::2], shapes[1::2] + shapes[:4], 0.3)

    index = make_index(shapes[1::2] + shapes[:4])
    loop = [dedupe._is_novel(p, shapes[1::2] + shapes[:4], index, 0.3) for p in shapes[::2]]
    assert flags == loop and not all(flags)

    monkeypatch.setattr(merge, "_native", lambda: None)
    merge.main(argparse.Namespace(features=str(src), threshold=2, out=str(tmp_path / "loop.geojson")))
    a = json.loads((tmp_path / "batched.geojson").read_text())["features"]
    b = json.loads((tmp_path / "loop.geojson").read_text())["features"]
    assert len(a) == len(b) >= 1
    assert sorted(f["properties"]["area"] for f in a) == sorted(f["properties"]["area"] for f in b)


def test_features_without_device_takes_the_card(flow, monkeypatch):
    """With no `device` the tool asks for the card; without one it raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.main(_features_args(flow, "parking", flow / "none.geojson"))
