"""The port's data tools vs the JAX package's: `cover`, `download`,
`rasterize`, `subset`, `weights` and `compare`, plus the tile helpers they
share, byte for byte on the same generated inputs.

Inputs are made from a seed: parking-lot polygons over a 4 x 4 block of
z18 tiles around 52.5 N (some across tile edges, one with a hole, one a
MultiPolygon), imagery served by a local `http.server` (one tile answers
404), and label trees. A small workflow, .osm XML -> `extract` -> `cover` ->
`rasterize` -> `subset` -> `weights` at 64 px, runs through both packages
and must agree at each stage (`extract` has its own tests in
tests/test_torch_port_osm.py). Finally the port's command line lists its 15
tools and loads without `requests`.
"""

import argparse
import contextlib
import functools
import http.server
import io
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from chip_smoke import encode_xml
from robosat_tpu import tiles as jtiles
from robosat_tpu.tools import compare as jcompare
from robosat_tpu.tools import cover as jcover
from robosat_tpu.tools import download as jdownload
from robosat_tpu.tools import extract as jextract
from robosat_tpu.tools import rasterize as jrasterize
from robosat_tpu.tools import subset as jsubset
from robosat_tpu.tools import weights as jweights
from robosat_tpu_torch import tiles
from robosat_tpu_torch.config import save_config
from robosat_tpu_torch.geo import tilemath
from robosat_tpu_torch.tools import compare, cover, download, extract, rasterize, subset, weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z, X0, Y0, SIDE = 18, 140846, 86034, 4  # a 4 x 4 block of z18 tiles around 13.4 E, 52.5 N


def _block_bounds():
    west, _, _, north = tilemath.bounds(tilemath.Tile(X0, Y0, Z))
    _, south, east, _ = tilemath.bounds(tilemath.Tile(X0 + SIDE - 1, Y0 + SIDE - 1, Z))
    return west, south, east, north


def _lots(seed, n=10):
    """Seeded quadrilateral lots inside the block, a holed lot and a
    MultiPolygon, as a GeoJSON FeatureCollection dict."""
    rng = np.random.default_rng(seed)
    west, south, east, north = _block_bounds()
    w, h = east - west, north - south
    feats = []
    for _ in range(n):
        cx, cy = west + rng.uniform(0.05, 0.85) * w, south + rng.uniform(0.05, 0.85) * h
        dx, dy = rng.uniform(0.02, 0.15, 2) * (w, h)
        ring = [[cx, cy], [cx + dx, cy + 0.2 * dy], [cx + dx, cy + dy], [cx - 0.1 * dx, cy + dy], [cx, cy]]
        feats.append({"type": "Feature", "properties": {}, "geometry": {"type": "Polygon", "coordinates": [ring]}})
    cx, cy = west + 0.5 * w, south + 0.5 * h
    outer = [[cx, cy], [cx + 0.2 * w, cy], [cx + 0.2 * w, cy + 0.2 * h], [cx, cy + 0.2 * h], [cx, cy]]
    hole = [[cx + 0.05 * w, cy + 0.05 * h], [cx + 0.15 * w, cy + 0.05 * h], [cx + 0.15 * w, cy + 0.15 * h],
            [cx + 0.05 * w, cy + 0.05 * h]]
    feats.append({"type": "Feature", "properties": {}, "geometry": {"type": "Polygon", "coordinates": [outer, hole]}})
    square = [[west, south], [west + 0.03 * w, south], [west + 0.03 * w, south + 0.03 * h], [west, south]]
    moved = [[x + 0.5 * w, y] for x, y in square]
    feats.append({"type": "Feature", "properties": {},
                  "geometry": {"type": "MultiPolygon", "coordinates": [[square], [moved]]}})
    return {"type": "FeatureCollection", "features": feats}


def _write_dataset(path, root, classes=("background", "parking"), colors=("denim", "orange")):
    save_config({"common": {"dataset": str(root), "classes": list(classes), "colors": list(colors)},
                 "weights": {"values": [1.0, 1.0]}}, str(path))
    return str(path)


def _tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _block_csv(path, tiles_xy):
    with open(path, "w") as f:
        f.writelines("{},{},{}\n".format(x, y, Z) for x, y in tiles_xy)
    return str(path)


def _all_block_tiles():
    return [(X0 + i, Y0 + j) for i in range(SIDE) for j in range(SIDE)]


@pytest.fixture(scope="module")
def lots(tmp_path_factory):
    root = tmp_path_factory.mktemp("lots")
    path = root / "lots.geojson"
    path.write_text(json.dumps(_lots(0)))
    return root, str(path)


@pytest.mark.parametrize("zoom", (16, 18, 19))
def test_cover_matches(lots, tmp_path, zoom):
    for stem, tool in (("p", cover), ("j", jcover)):
        tool.main(argparse.Namespace(zoom=zoom, features=lots[1], out=str(tmp_path / (stem + ".csv"))))
    got = (tmp_path / "p.csv").read_bytes()
    assert got == (tmp_path / "j.csv").read_bytes() and got.count(b"\n") >= 3


@pytest.mark.parametrize("size", (64, 100))
def test_rasterize_matches_and_merges(lots, tmp_path, size):
    dataset = _write_dataset(tmp_path / "dataset.toml", tmp_path)
    csv = _block_csv(tmp_path / "tiles.csv", _all_block_tiles())
    second = tmp_path / "second.geojson"
    second.write_text(json.dumps(_lots(1, n=6)))
    for stem, tool in (("p", rasterize), ("j", jrasterize)):
        for features in (lots[1], str(second)):  # the second pass merges into the first's tiles
            tool.main(argparse.Namespace(features=features, tiles=csv, out=str(tmp_path / stem), dataset=dataset,
                                         zoom=Z, size=size))
            if features == lots[1]:
                first = _tree(tmp_path / stem)
        merged = _tree(tmp_path / stem)
        assert merged.keys() == first.keys() and merged != first
    got, want = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert got == want and len(got) == SIDE * SIDE
    masks = [np.array(Image.open(io.BytesIO(b))) for b in got.values()]
    assert all(m.shape == (size, size) for m in masks)
    assert sum(m.any() for m in masks) >= 4 and sum(not m.any() for m in masks) >= 1


def test_rasterize_second_pass_keeps_bytes(lots, tmp_path):
    """The same features over the same tree: np.maximum leaves every byte."""
    dataset = _write_dataset(tmp_path / "dataset.toml", tmp_path)
    csv = _block_csv(tmp_path / "tiles.csv", _all_block_tiles())
    args = argparse.Namespace(features=lots[1], tiles=csv, out=str(tmp_path / "p"), dataset=dataset, zoom=Z, size=64)
    rasterize.main(args)
    first = _tree(tmp_path / "p")
    rasterize.main(args)
    assert _tree(tmp_path / "p") == first


@pytest.mark.parametrize("case, message", [
    ("classes", "Error: dataset classes and colors must pair up"),
    ("colors", "Error: rasterize handles binary (two-class) datasets only"),
    ("zoom", "Error: tiles.csv contains tiles outside zoom 18"),
])
def test_rasterize_error_exits_match(lots, tmp_path, case, message):
    classes, colors = ("background", "parking"), ("denim", "orange")
    if case == "classes":
        classes = classes + ("building",)
    if case == "colors":
        classes, colors = classes + ("building",), colors + ("red",)
    dataset = _write_dataset(tmp_path / "dataset.toml", tmp_path, classes, colors)
    csv = _block_csv(tmp_path / "tiles.csv", _all_block_tiles())
    if case == "zoom":
        with open(csv, "a") as f:
            f.write("{},{},{}\n".format(X0 // 2, Y0 // 2, Z - 1))
    for tool in (rasterize, jrasterize):
        with pytest.raises(SystemExit) as exc:
            tool.main(argparse.Namespace(features=lots[1], tiles=csv, out=str(tmp_path / "out"), dataset=dataset,
                                         zoom=Z, size=64))
        assert exc.value.code == message


def _write_images(root, tiles_xy, size, seed, ext="png"):
    rng = np.random.default_rng(seed)
    for x, y in tiles_xy:
        os.makedirs(os.path.join(root, str(Z), str(x)), exist_ok=True)
        img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, str(Z), str(x), "{}.{}".format(y, ext)))


class _QuietHandler(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@contextlib.contextmanager
def _serve(directory):
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(_QuietHandler,
                                                                                  directory=str(directory)))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield "http://127.0.0.1:{}/{{z}}/{{x}}/{{y}}.png".format(server.server_address[1])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
        assert not thread.is_alive()


def test_download_matches_and_skips_missing(tmp_path, capsys, monkeypatch):
    for key in ("no_proxy", "NO_PROXY"):  # requests reads proxies from the environment
        monkeypatch.setenv(key, "127.0.0.1,localhost")
    served = _all_block_tiles()[:7]
    _write_images(tmp_path / "upstream", served, 32, seed=3)
    missing = (X0 + 3, Y0 + 3)
    csv = _block_csv(tmp_path / "tiles.csv", served + [missing])
    with _serve(tmp_path / "upstream") as url:
        for stem, tool in (("p", download), ("j", jdownload)):
            tool.main(argparse.Namespace(url=url, ext="png", rate=8, tiles=csv, out=str(tmp_path / stem)))
            err = capsys.readouterr().err
            assert "Warning: Tile(x={}, y={}, z={}) failed, skipping".format(*missing, Z) in err
        got = _tree(tmp_path / "p")
        assert got == _tree(tmp_path / "j") and len(got) == len(served)
        for x, y in served:
            rel = os.path.join(str(Z), str(x), "{}.png".format(y))
            with Image.open(tmp_path / "upstream" / rel) as want:
                assert np.array_equal(np.asarray(Image.open(io.BytesIO(got[rel]))), np.asarray(want))
        # Files already on disk are kept, not fetched again.
        download.main(argparse.Namespace(url=url, ext="png", rate=8, tiles=csv, out=str(tmp_path / "p")))
    assert _tree(tmp_path / "p") == got


def test_subset_matches(tmp_path):
    _write_images(tmp_path / "images", _all_block_tiles()[:10], 16, seed=4)
    _write_images(tmp_path / "images", _all_block_tiles()[10:12], 16, seed=5, ext="webp")
    (tmp_path / "images" / "notes").mkdir()
    csv = _block_csv(tmp_path / "tiles.csv", _all_block_tiles()[5:14])  # two listed tiles are absent
    for stem, tool in (("p", subset), ("j", jsubset)):
        tool.main(argparse.Namespace(images=str(tmp_path / "images"), tiles=csv, out=str(tmp_path / stem)))
    got = _tree(tmp_path / "p")
    assert got == _tree(tmp_path / "j") and len(got) == 7
    assert sum(k.endswith(".webp") for k in got) == 2


def _write_labels(root, tiles_xy, size, seed, p=0.2):
    rng = np.random.default_rng(seed)
    for x, y in tiles_xy:
        os.makedirs(os.path.join(root, str(Z), str(x)), exist_ok=True)
        img = Image.fromarray((rng.random((size, size)) < p).astype(np.uint8), mode="P")
        img.putpalette([0, 0, 0, 255, 165, 0])
        img.save(os.path.join(root, str(Z), str(x), "{}.png".format(y)))


def test_weights_stdout_matches(tmp_path, capsys):
    _write_labels(tmp_path / "training" / "labels", _all_block_tiles()[:9], 48, seed=6, p=0.137)
    dataset = _write_dataset(tmp_path / "dataset.toml", tmp_path)
    outs = []
    for tool in (weights, jweights):
        tool.main(argparse.Namespace(dataset=dataset))
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith("[") and outs[0].count(",") == 1
    empty = _write_dataset(tmp_path / "empty.toml", tmp_path / "nowhere")
    for tool in (weights, jweights):
        with pytest.raises(AssertionError, match="dataset with masks must not be empty"):
            tool.main(argparse.Namespace(dataset=empty))


@pytest.mark.parametrize("minimum, maximum", [(0.0, 1.0), (0.05, 1.0), (0.0, 0.3)])
def test_compare_matches(tmp_path, minimum, maximum):
    block = _all_block_tiles()[:6]
    _write_images(tmp_path / "images", block, 32, seed=7)
    _write_labels(tmp_path / "labels", block, 32, seed=8)
    for k, share in enumerate((0.0, 0.5)):  # two mask trees: one blank, one half full
        rng = np.random.default_rng(9 + k)
        for i, (x, y) in enumerate(block):
            os.makedirs(tmp_path / "masks{}".format(k) / str(Z) / str(x), exist_ok=True)
            m = (rng.random((32, 32)) < share * (i % 3) / 2).astype(np.uint8)
            img = Image.fromarray(m, mode="P")
            img.putpalette([0, 0, 0, 255, 255, 255])
            img.save(tmp_path / "masks{}".format(k) / str(Z) / str(x) / "{}.png".format(y))
    for stem, tool in (("p", compare), ("j", jcompare)):
        tool.main(argparse.Namespace(out=str(tmp_path / stem), images=str(tmp_path / "images"),
                                     labels=str(tmp_path / "labels"),
                                     masks=[str(tmp_path / "masks0"), str(tmp_path / "masks1")], minimum=minimum,
                                     maximum=maximum))
    got = _tree(tmp_path / "p")
    assert got == _tree(tmp_path / "j")
    assert (len(got) == len(block)) == (minimum == 0.0)  # a minimum above 0 drops the tiles blank in both masks
    assert all(Image.open(io.BytesIO(b)).size == (4 * 32, 32) for b in got.values())


def test_tiles_from_csv_matches(tmp_path):
    path = tmp_path / "tiles.csv"
    path.write_text("1,2,3\n\n{},{},{}\n7,8,9\n".format(X0, Y0, Z))
    got = list(tiles.tiles_from_csv(str(path)))
    assert got == list(jtiles.tiles_from_csv(str(path))) and len(got) == 3
    assert all(type(t) is tilemath.Tile for t in got)


def test_unbuffer_and_stitch_image_match():
    rng = np.random.default_rng(11)
    probs = rng.random((2, 40, 40)).astype(np.float32)
    for overlap in (0, 1, 8):
        assert np.array_equal(tiles.unbuffer(probs, overlap), jtiles.unbuffer(probs, overlap))
    assert tiles.unbuffer(probs, 8).shape == (2, 24, 24)
    image = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    into = [np.zeros((25, 25, 3), np.uint8) for _ in range(2)]
    for canvas, fn in zip(into, (tiles.stitch_image, jtiles.stitch_image)):
        fn(canvas, (2, 3, 12, 18), image, (5, 1, 15, 16))
        fn(canvas, (20, 0, 25, 4), image, (25, 16, 30, 20))
    assert np.array_equal(into[0], into[1]) and into[0].any()


def test_fetch_image_matches():
    class Response:
        def __init__(self, status, content):
            self.status, self.content = status, content

        def raise_for_status(self):
            if self.status >= 400:
                raise OSError(self.status)

    class Session:
        def __init__(self):
            self.calls = []

        def get(self, url, timeout):
            self.calls.append((url, timeout))
            if "boom" in url:
                raise ConnectionError(url)
            return Response(404 if "missing" in url else 200, b"PNGDATA")

    for name in ("ok", "missing", "boom"):
        s, js = Session(), Session()
        got, want = tiles.fetch_image(s, name), jtiles.fetch_image(js, name)
        assert s.calls == js.calls == [(name, 10)]
        assert (got is None) == (want is None) == (name != "ok")
        if got is not None:
            assert isinstance(got, io.BytesIO) and got.read() == want.read() == b"PNGDATA"


def _workflow_map(seed):
    """A generated map over the block: lots as closed ways (one underground,
    one unclosed), for `extract`."""
    feats = _lots(seed, n=8)["features"][:8]
    nodes, ways = {}, []
    nid = 1
    for k, f in enumerate(feats):
        refs = []
        for lon, lat in f["geometry"]["coordinates"][0][:-1]:
            nodes[nid] = (round(float(lon), 7), round(float(lat), 7))
            refs.append(nid)
            nid += 1
        tags = {"amenity": "parking", **({"parking": "underground"} if k == 2 else {})}
        ways.append((100 + k, tags, refs + ([refs[0]] if k != 5 else [])))
    return nodes, ways


def test_workflow_matches_at_64_px(tmp_path):
    """.osm XML -> extract -> cover -> rasterize -> subset (training and
    validation) -> weights through both packages, equal at each stage."""
    nodes, ways = _workflow_map(21)
    (tmp_path / "map.osm").write_text(encode_xml(nodes, ways))
    out = {}
    for stem, ext, cov, ras, sub, wts in (("p", extract, cover, rasterize, subset, weights),
                                          ("j", jextract, jcover, jrasterize, jsubset, jweights)):
        root = tmp_path / stem
        root.mkdir()
        ext.main(argparse.Namespace(type="parking", batch=100, map=str(tmp_path / "map.osm"),
                                    out=str(root / "parking.geojson")))
        (chunk,) = [p for p in os.listdir(root) if p.startswith("parking-")]
        os.rename(root / chunk, root / "parking.geojson")
        cov.main(argparse.Namespace(zoom=Z, features=str(root / "parking.geojson"), out=str(root / "tiles.csv")))
        rows = (root / "tiles.csv").read_text().splitlines()
        dataset = _write_dataset(root / "dataset.toml", root / "dataset")
        ras.main(argparse.Namespace(features=str(root / "parking.geojson"), tiles=str(root / "tiles.csv"),
                                    out=str(root / "labels"), dataset=dataset, zoom=Z, size=64))
        _write_images(root / "images", [tuple(map(int, r.split(",")[:2])) for r in rows], 64, seed=12)
        (root / "train.csv").write_text("\n".join(rows[::2]) + "\n")
        (root / "val.csv").write_text("\n".join(rows[1::2]) + "\n")
        for split, csv in (("training", "train.csv"), ("validation", "val.csv")):
            for kind in ("images", "labels"):
                sub.main(argparse.Namespace(images=str(root / kind), tiles=str(root / csv),
                                            out=str(root / "dataset" / split / kind)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            wts.main(argparse.Namespace(dataset=dataset))
        out[stem] = {"features": (root / "parking.geojson").read_bytes(), "csv": (root / "tiles.csv").read_bytes(),
                     "labels": _tree(root / "labels"), "dataset": _tree(root / "dataset"), "weights": buf.getvalue()}
    for stage in out["p"]:
        assert out["p"][stage] == out["j"][stage], stage
    assert len(json.loads(out["p"]["features"])["features"]) == 6  # underground and unclosed dropped
    assert len(out["p"]["labels"]) >= 4 and out["p"]["weights"].startswith("[")


@pytest.fixture(scope="module")
def cli():
    """One fresh interpreter: the modules `robosat_tpu_torch.tools.__main__`
    loads, then its --help."""
    code = ("import sys\n"
            "import robosat_tpu_torch.tools.__main__ as m\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in ('requests', 'robosat_tpu', 'jax')))\n"
            "sys.argv = ['x', '--help']\n"
            "m.main()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=20, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_cli_loads_without_requests(cli):
    assert cli.splitlines()[0] == "[]"


def test_cli_lists_thirteen_tools(cli):
    """The data tools' thirteen among the CLI's 15, all in the reference's
    order (robosat_tpu/tools/__main__.py), `export` and `serve` included."""
    names = ("extract", "cover", "download", "rasterize", "train", "export", "predict", "masks", "features", "merge",
             "dedupe", "serve", "weights", "compare", "subset")
    listed = [line.split()[0] for line in cli.splitlines() if line.startswith("    ") and line.split()
              and line.split()[0] in names]
    assert listed == list(names)
