"""The port's OSM readers, way handlers and `extract` vs the JAX package's.

A hand-encoded .osm.pbf (chip_smoke.py's encoder, which phase 10 writes
its map with: varints, zigzag, raw and zlib blobs, dense and plain nodes,
a header blob) and the same map as .osm XML go through both packages'
readers, which must give equal ways and node locations. The parking,
building and road handlers, and `extract` on both files, must write equal
chunk contents: the chunk names are random (uuid4), so the comparison is
over the sorted chunk texts and their number. Counterparts of
tests/test_osm_pbf.py, tests/test_osm_handlers.py and
tests/test_pipeline.py::test_extract_from_osm_xml.
"""

import argparse

import numpy as np
import pytest

from chip_smoke import _field, _packed, _varint, _zigzag, encode_pbf, encode_xml
from robosat_tpu.geo import geojson as jgeojson
from robosat_tpu.osm import building as jbuilding
from robosat_tpu.osm import core as jcore
from robosat_tpu.osm import parking as jparking
from robosat_tpu.osm import pbf as jpbf
from robosat_tpu.osm import road as jroad
from robosat_tpu.tools import extract as jextract
from robosat_tpu_torch.geo import geojson
from robosat_tpu_torch.osm import building, core, parking, pbf, road
from robosat_tpu_torch.tools import extract
from test_torch_port_geo import native_engines

# ------------------------------------------------------------------ the map


def make_map(seed):
    """Seeded nodes (on a 1e-7 degree grid, as OSM stores them) and ways:
    parking lots (some invisible, some unclosed, a bow-tie), buildings of
    visible and hidden kinds, and roads with every override."""
    rng = np.random.default_rng(seed)
    nodes, ways = {}, []
    nid = [1000]

    def node(lon, lat):
        nid[0] += int(rng.integers(1, 40))
        nodes[nid[0]] = (round(float(lon), 7), round(float(lat), 7))
        return nid[0]

    def quad(cx, cy, w, h, closed=True):
        refs = [node(cx, cy), node(cx + w, cy), node(cx + w, cy + h), node(cx, cy + h)]
        return refs + [refs[0]] if closed else refs

    def spot():
        return rng.uniform(13.40, 13.42), rng.uniform(52.50, 52.52)

    wid = 100
    for k in range(16):
        tags = {"amenity": "parking"}
        if k % 5 == 1:
            tags["parking"] = ["underground", "surface", "sheds", "multi-storey"][k % 4]
        ways.append((wid, tags, quad(*spot(), *rng.uniform(1e-4, 8e-4, 2), closed=k % 7 != 3)))
        wid += 1
    cx, cy = spot()
    a, b, c, d = node(cx, cy), node(cx + 1e-3, cy + 1e-3), node(cx + 1e-3, cy), node(cx, cy + 1e-3)
    ways.append((wid, {"amenity": "parking"}, [a, b, c, d, a]))  # a bow-tie: invalid
    wid += 1
    for k, kind in enumerate(("yes", "house", "construction", "yes", "greenhouse", "retail", "yes", "garage", "ruins")):
        tags = {"building": kind}
        if k % 4 == 3:
            tags["location"] = "underground"
        ways.append((wid, tags, quad(*spot(), *rng.uniform(5e-5, 3e-4, 2))))
        wid += 1
    roads = [{"highway": "residential"}, {"highway": "motorway", "oneway": "yes"}, {"highway": "primary", "lanes": "6"},
             {"highway": "service", "lanes": "many"}, {"highway": "trunk_link", "width": "20"},
             {"highway": "tertiary", "width": "wide"}, {"highway": "secondary", "lanes": "0", "width": "0.2"},
             {"highway": "footway"}, {"highway": "unclassified", "oneway": "no"}]
    for tags in roads:
        x, y = spot()
        refs = [node(x + 2e-3 * t, y + 1e-3 * np.sin(3 * t)) for t in np.linspace(0, 1, int(rng.integers(2, 6)))]
        ways.append((wid, tags, refs))
        wid += 1
    ways.append((wid, {"highway": "residential"}, [node(*spot())]))  # one node: warned and skipped
    return nodes, ways


@pytest.fixture(scope="module")
def osm_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("osm")
    nodes, ways = make_map(0)
    (root / "map.osm.pbf").write_bytes(encode_pbf(nodes, ways, gran=100, lat_off=5000, lon_off=3000))
    (root / "map.osm").write_text(encode_xml(nodes, ways))
    return root, nodes, ways


def _way_tuples(ways):
    return [(w.id, w.tags, [(n.ref, n.lon, n.lat) for n in w.nodes], w.is_closed()) for w in ways]


@pytest.mark.parametrize("name", ["map.osm.pbf", "map.osm"])
def test_readers_match(osm_files, name):
    root, nodes, ways = osm_files
    got = _way_tuples(pbf.iter_ways(str(root / name)))
    assert got == _way_tuples(jpbf.iter_ways(str(root / name)))
    assert [w[0] for w in got] == [w[0] for w in ways]
    for (_, _, refs), (_, _, locs, _) in zip(ways, got):
        assert [r for r, _, _ in locs] == refs
        for r, lon, lat in locs:
            assert lon == pytest.approx(nodes[r][0], abs=1e-9) and lat == pytest.approx(nodes[r][1], abs=1e-9)


def test_pbf_reader_parts_match():
    """The wire-format helpers and the plain and dense node parsers."""
    for n in (0, 1, 127, 128, 300, 2**35 + 7):
        assert pbf._read_varint(_varint(n), 0) == jpbf._read_varint(_varint(n), 0) == (n, len(_varint(n)))
    for n in (0, 1, -1, 2**40, -(2**40)):
        assert pbf._zigzag(_zigzag(n)) == jpbf._zigzag(_zigzag(n)) == n
    msg = _field(1, 0, 7) + _field(2, 2, b"abc") + _field(3, 1, b"12345678")[:1] + b"12345678" + _field(4, 5, b"")[:1] \
        + b"wxyz"
    assert list(pbf._iter_fields(msg)) == list(jpbf._iter_fields(msg))
    with pytest.raises(ValueError):
        list(pbf._iter_fields(_varint((1 << 3) | 3)))
    plain = _field(1, 0, _zigzag(-5)) + _field(8, 0, _zigzag(525200000)) + _field(9, 0, _zigzag(-134000000))
    dense = (_field(1, 2, _packed([3, 1, 1], True)) + _field(8, 2, _packed([100, -7, 3], True))
             + _field(9, 2, _packed([-50, 9, 0], True)))
    for parse, buf in ((pbf._parse_plain_node, plain), (pbf._parse_dense_nodes, dense)):
        got, want = {}, {}
        parse(buf, [], 100, 11, -13, got)
        getattr(jpbf, parse.__name__)(buf, [], 100, 11, -13, want)
        assert got == want and got


def _chunks(root, stem):
    return sorted(p.read_text() for p in root.glob(stem + "-*.geojson"))


def _run_handler(cls, ways, out, batch):
    handler = cls(str(out), batch)
    for w in ways:
        handler.way(w)
    handler.flush()


HANDLERS = {"parking": (parking.ParkingHandler, jparking.ParkingHandler),
            "building": (building.BuildingHandler, jbuilding.BuildingHandler),
            "road": (road.RoadHandler, jroad.RoadHandler)}


@pytest.mark.parametrize("kind", sorted(HANDLERS))
def test_handlers_write_equal_chunks(osm_files, tmp_path, capsys, kind):
    native_engines()
    root = osm_files[0]
    ours, theirs = HANDLERS[kind]
    _run_handler(ours, pbf.iter_ways(str(root / "map.osm.pbf")), tmp_path / "p.geojson", 3)
    err_p = capsys.readouterr().err
    _run_handler(theirs, jpbf.iter_ways(str(root / "map.osm.pbf")), tmp_path / "j.geojson", 3)
    err_j = capsys.readouterr().err
    got, want = _chunks(tmp_path, "p"), _chunks(tmp_path, "j")
    assert got == want and len(got) >= 2
    assert err_p == err_j
    if kind != "building":  # the bow-tie lot, and the roads' bad tags and one-node way
        assert "Warning: invalid feature: https://www.openstreetmap.org/way/" in err_p


@pytest.mark.parametrize("tags", [
    {"highway": "residential"}, {"highway": "residential", "oneway": "yes"}, {"highway": "motorway", "lanes": "3"},
    {"highway": "primary", "lanes": "-2"}, {"highway": "residential", "lanes": "many", "width": "wide"},
    {"highway": "trunk", "width": "12.5"}, {"highway": "service", "width": "0.1"}], ids=lambda t: ",".join(
        "{}={}".format(*kv) for kv in t.items()))
def test_road_overrides_match(tmp_path, tags):
    native_engines()
    line = [(13.40, 52.52), (13.405, 52.521), (13.41, 52.52)]
    ways = [(pbf.Way(1, dict(tags), [pbf.Node(i + 1, lon, lat) for i, (lon, lat) in enumerate(line)]),
             jpbf.Way(1, dict(tags), [jpbf.Node(i + 1, lon, lat) for i, (lon, lat) in enumerate(line)]))]
    _run_handler(road.RoadHandler, [w for w, _ in ways], tmp_path / "p.geojson", 10)
    _run_handler(jroad.RoadHandler, [w for _, w in ways], tmp_path / "j.geojson", 10)
    assert _chunks(tmp_path, "p") == _chunks(tmp_path, "j") and len(_chunks(tmp_path, "p")) == 1
    assert road.RoadHandler.highway_attributes == jroad.RoadHandler.highway_attributes
    assert road.RoadHandler.EARTH_MEAN_RADIUS == jroad.RoadHandler.EARTH_MEAN_RADIUS == 6371004.0


def test_invalid_ring_is_dropped_with_the_jax_warning(capsys):
    bowtie = [(13.40, 52.52), (13.401, 52.521), (13.401, 52.52), (13.40, 52.521), (13.40, 52.52)]
    ok = [(13.40, 52.52), (13.401, 52.52), (13.401, 52.521), (13.40, 52.521), (13.40, 52.52)]
    for coords, valid in ((bowtie, False), (ok, True)):
        refs = list(range(1, len(coords))) + [1]
        w = pbf.Way(7, {"amenity": "parking"}, [pbf.Node(r, lon, lat) for r, (lon, lat) in zip(refs, coords)])
        jw = jpbf.Way(7, {"amenity": "parking"}, [jpbf.Node(r, lon, lat) for r, (lon, lat) in zip(refs, coords)])
        assert core.is_polygon(w) and jcore.is_polygon(jw)
        got = core.way_to_polygon_feature(w)
        err = capsys.readouterr().err
        assert got == jcore.way_to_polygon_feature(jw)
        assert capsys.readouterr().err == err
        assert (got is not None) == valid
        assert (err == "Warning: invalid feature: https://www.openstreetmap.org/way/7\n") == (not valid)


def test_feature_storage_chunks(tmp_path):
    for name, mod, gj in (("p", core, geojson), ("j", jcore, jgeojson)):
        storage = mod.FeatureStorage(str(tmp_path / (name + ".geojson")), batch=2)
        for i in range(5):
            storage.add(gj.feature({"type": "Point", "coordinates": [float(i), 0.0]}))
        storage.flush()
        storage.flush()  # nothing left: no empty chunk
    got = _chunks(tmp_path, "p")
    assert len(got) == 3 and got == _chunks(tmp_path, "j")
    with pytest.raises(AssertionError):
        core.FeatureStorage(str(tmp_path / "x.geojson"), batch=0)


@pytest.mark.parametrize("kind", ["parking", "building", "road"])
@pytest.mark.parametrize("name", ["map.osm.pbf", "map.osm"])
def test_extract_matches(osm_files, tmp_path, kind, name):
    native_engines()
    root = osm_files[0]
    for stem, tool in (("p", extract), ("j", jextract)):
        tool.main(argparse.Namespace(type=kind, batch=4, map=str(root / name), out=str(tmp_path / (stem + ".geojson"))))
    got = _chunks(tmp_path, "p")
    assert got == _chunks(tmp_path, "j") and got


def test_extract_pbf_and_xml_agree(osm_files, tmp_path):
    """One map, two encodings: the same parking features."""
    root = osm_files[0]
    for stem, name in (("pbf", "map.osm.pbf"), ("xml", "map.osm")):
        extract.main(argparse.Namespace(type="parking", batch=100, map=str(root / name),
                                        out=str(tmp_path / (stem + ".geojson"))))
    (pbf_chunk,), (xml_chunk,) = _chunks(tmp_path, "pbf"), _chunks(tmp_path, "xml")
    a, b = geojson.loads(pbf_chunk)["features"], geojson.loads(xml_chunk)["features"]
    assert len(a) == len(b) >= 8
    for fa, fb in zip(a, b):
        assert np.allclose(fa["geometry"]["coordinates"][0], fb["geometry"]["coordinates"][0], rtol=0, atol=1e-9)
