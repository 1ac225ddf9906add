"""robosat_tpu_torch's `serve` vs the JAX package's, on the CPU.

The tile server's HTTP contract (the cases of tests/test_serve.py: index,
swipe viewer, tile, z17 404, missing upstream 500, garbage path 404, plus
`/index.html`, an unparsable tile path and CORS on every answer) runs
against local servers only: an upstream `http.server` over one generated
64-px z18 tile and the port's handler in front of a full-width U-Net
checkpoint (the JAX package's `unet.init(0)`, BN var + eps == 1 so that the
fold is exact in both packages: README, "Known deviations of the port").
The port's `Predictor.segment` answers the same PNG bytes as the JAX
tool's for that checkpoint and image, and the port's `make_segment_step`
the same uint8 classes as the JAX package's for each of the four families
at 64 px.
"""

import argparse
import functools
import http.server
import io
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from robosat_tpu.checkpoint import save_checkpoint
from robosat_tpu.config import save_config
from robosat_tpu.models.registry import get_model as jax_get_model
from robosat_tpu.parallel.steps import make_segment_step as jax_make_segment_step
from robosat_tpu.tools import serve as jserve
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.config import load_config
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.parallel.steps import make_segment_step
from robosat_tpu_torch.tools import serve

TILE = 64
TOKEN = "testtoken"


def _exact_var(tree):
    """The tree with every BN `var` at 1 - 1e-5 in float32 (var + eps == 1)."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, np.float32(1.0) - np.float32(1e-5)) if k == "var" else _exact_var(v))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_exact_var(v) for v in tree)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """(checkpoint, model TOML, dataset TOML, image): a full-width U-Net npz
    of the JAX package's init, configs pinning the CPU, a 64-px image."""
    root = tmp_path_factory.mktemp("serve_configs")
    params, state = jax_get_model("unet").init(0, num_classes=2)
    ckpt = str(root / "unet.npz")
    save_checkpoint(ckpt, {"params": jax.tree_util.tree_map(np.asarray, params), "state": _exact_var(state)},
                    {"epoch": 1})
    model_toml, dataset_toml = str(root / "model.toml"), str(root / "dataset.toml")
    save_config({"common": {"cuda": False, "model": "unet"}}, model_toml)
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, dataset_toml)
    image = Image.fromarray(np.random.default_rng(3).integers(0, 256, (TILE, TILE, 3), dtype=np.uint8))
    return ckpt, model_toml, dataset_toml, image


@pytest.fixture(scope="module")
def predictor(configs):
    ckpt, model_toml, dataset_toml, _ = configs
    return serve.Predictor(ckpt, load_config(model_toml), load_config(dataset_toml), TILE)


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def served(tmp_path_factory, configs, predictor):
    """The port's tile server behind a local upstream holding 18/1/2.png;
    yields its base URL."""
    import requests

    upstream_dir = tmp_path_factory.mktemp("upstream")
    (upstream_dir / "18" / "1").mkdir(parents=True)
    configs[3].save(upstream_dir / "18" / "1" / "2.png")

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def log_message(self, *args):
            pass

    upstream = http.server.ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(Quiet, directory=str(upstream_dir)))
    session = requests.Session()
    session.trust_env = False  # no proxy from the environment for the loopback upstream
    handler = serve.make_handler(predictor, session, "http://127.0.0.1:{}/{{z}}/{{x}}/{{y}}.png".format(
        upstream.server_address[1]), token=TOKEN, tile_size=TILE, port=0)
    server = http.server.HTTPServer(("127.0.0.1", 0), handler)
    threads = [_start(upstream), _start(server)]
    yield "http://127.0.0.1:{}".format(server.server_address[1])
    for s in (server, upstream):
        s.shutdown()
        s.server_close()
    for thread in threads:
        thread.join(timeout=10)


def _get(url):
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(url) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), b""


@pytest.mark.parametrize("path", ["/", "/index.html"])
def test_index(served, path):
    status, headers, body = _get(served + path)
    assert status == 200
    assert headers["Content-Type"] == "text/html"
    assert TOKEN.encode() in body
    assert headers["Access-Control-Allow-Origin"] == "*"


def test_index_is_swipe_compare_viewer(served):
    """Two synced map panes, a draggable divider clipping the mask overlay
    served by this server, and an opacity slider."""
    _, _, body = _get(served + "/")
    html = body.decode()
    assert 'id="before"' in html and 'id="after"' in html
    assert 'id="swipe"' in html and "pointerdown" in html
    assert "clipPath" in html
    assert "/{z}/{x}/{y}.png" in html
    assert 'id="slider"' in html


def test_map_template_equals_jax():
    assert serve.MAP_TEMPLATE == jserve.MAP_TEMPLATE


def test_tile_segmentation(served, predictor, configs):
    status, headers, body = _get(served + "/18/1/2.png")
    assert status == 200
    assert headers["Content-Type"] == "image/png"
    img = Image.open(io.BytesIO(body))
    assert img.mode == "P"
    assert img.size == (TILE, TILE)
    assert np.asarray(img).max() <= 1  # binary class indices
    assert body == predictor.segment(configs[3])


@pytest.mark.parametrize("path,code", [("/17/1/2.png", 404), ("/18/9/9.png", 500), ("/foo/bar", 404),
                                       ("/18/a/2.png", 404), ("/18/1/2.png", 200)],
                         ids=["wrong-zoom", "missing-upstream", "garbage-path", "unparsable-tile", "tile"])
def test_answer_codes_carry_cors(served, path, code):
    """Every answer: its status and the CORS header (the z18 guard, a tile
    the upstream lacks, paths that are no tile)."""
    status, headers, _ = _get(served + path)
    assert status == code
    assert headers["Access-Control-Allow-Origin"] == "*"


def test_segment_png_bytes_equal_jax(configs, predictor):
    """The JAX tool's Predictor and the port's on one checkpoint and image:
    the same palette PNG, byte for byte."""
    ckpt, model_toml, dataset_toml, image = configs
    from robosat_tpu.config import load_config as jax_load_config

    jax_predictor = jserve.Predictor(ckpt, jax_load_config(model_toml), jax_load_config(dataset_toml), TILE)
    got = predictor.segment(image)
    assert got == jax_predictor.segment(image)
    assert Image.open(io.BytesIO(got)).mode == "P"


@pytest.mark.parametrize("family", ["unet", "fast", "deeplabv3plus", "segformer"])
def test_segment_step_matches_jax(family):
    """make_segment_step of each family at 64 px, float32, batch 2: the
    folded forward (SegFormer: `apply` in eval mode) and the argmax give the
    JAX step's uint8 classes; where the family folds, `step.folded` over
    params folded once gives the same classes."""
    params, state = jax_get_model(family).init(0, num_classes=2)
    params, state = jax.tree_util.tree_map(np.asarray, params), _exact_var(state)
    raw = np.random.default_rng(5).integers(0, 256, (2, TILE, TILE, 3), dtype=np.uint8)
    want = np.asarray(jax_make_segment_step(jax_get_model(family))(params, state, raw))
    tp, ts = from_jax(params, state)
    step = make_segment_step(get_model(family))
    got = step(tp, ts, raw)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (2, TILE, TILE)
    np.testing.assert_array_equal(got.numpy(), want)
    assert hasattr(step, "folded") == (family != "segformer")
    if family != "segformer":
        assert torch.equal(step.folded(get_model(family).fold(tp, ts), raw), got)


def test_missing_token_exits(configs, monkeypatch):
    ckpt, model_toml, dataset_toml, _ = configs
    monkeypatch.delenv("MAPBOX_ACCESS_TOKEN", raising=False)
    args = argparse.Namespace(model=model_toml, dataset=dataset_toml, url="http://127.0.0.1:1/{z}/{x}/{y}.png",
                              checkpoint=ckpt, tile_size=TILE, host="127.0.0.1", port=0)
    with pytest.raises(SystemExit) as exit_info:
        serve.main(args)
    assert str(exit_info.value) == "Error: map token needed visualizing results; export MAPBOX_ACCESS_TOKEN"


def test_parser_takes_the_jax_tools_flags():
    """`serve` parses the JAX tool's flags with the same defaults."""
    def parse(tool, argv):
        parser = argparse.ArgumentParser()
        tool.add_parser(parser.add_subparsers())
        return vars(parser.parse_args(["serve", *argv]))

    argv = ["--model", "m.toml", "--dataset", "d.toml", "--checkpoint", "c.npz"]
    got, want = parse(serve, argv), parse(jserve, argv)
    assert {k: v for k, v in got.items() if k != "func"} == {k: v for k, v in want.items() if k != "func"}
