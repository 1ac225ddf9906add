"""robosat_tpu_torch's own host modules vs their JAX-package originals.

The port keeps copies of the host code `predict` needs (config, colors,
tiles, the data loader, the native image codec, the npz checkpoint format
and the reference-.pth converter) instead of importing `robosat_tpu`. Each
copy is held against its original on the same inputs: equal arrays,
metadata, trees and decoded pixels.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from robosat_tpu import checkpoint as jcheckpoint
from robosat_tpu import colors as jcolors
from robosat_tpu import config as jconfig
from robosat_tpu.data import datasets as jdatasets
from robosat_tpu.data import loader as jloader
from robosat_tpu.models.layers import space_to_depth4 as jax_space_to_depth4
from robosat_tpu.native import imagecodec as jimagecodec
from robosat_tpu_torch import checkpoint, colors, config
from robosat_tpu_torch.data import datasets, loader
from robosat_tpu_torch.models.layers import space_to_depth4
from robosat_tpu_torch.native import imagecodec
from test_torch_checkpoint import _reference_style_state_dict


def _assert_trees_equal(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], "{}/{}".format(path, k))
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, "{}/#{}".format(path, i))
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), path


_CONFIG = {
    "common": {"cuda": False, "batch_size": 2, "image_size": 512, "int8": True, "pallas_tail": "sep",
               "int8_calibration": 99.8, "checkpoint": 'c:\\ckpt "a"'},
    "opt": {"lr": 1e-4, "loss": "lovasz", "weight": [0.25, 4.0]},
}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_config_round_trip(tmp_path, writer, reader):
    modules = {"port": config, "jax": jconfig}
    path = str(tmp_path / "model.toml")
    modules[writer].save_config(_CONFIG, path)
    assert modules[reader].load_config(path) == _CONFIG
    assert config.dumps_config(_CONFIG) == jconfig.dumps_config(_CONFIG)


@pytest.mark.parametrize("color,bins", [("pink", 256), ("pink", 16), ("denim", 256)])
def test_continuous_palette(color, bins):
    assert colors.continuous_palette_for_color(color, bins) == jcolors.continuous_palette_for_color(color, bins)


def _write_slippy_map(root, size=64):
    """A 3 x 3 block of tiles at z18 (one a JPEG) with a gap, plus a
    non-numeric entry the walk skips."""
    rng = np.random.default_rng(3)
    for i in range(3):
        for j in range(3):
            if (i, j) == (2, 0):
                continue
            x, y = 100 + i, 200 + j
            (root / "18" / str(x)).mkdir(parents=True, exist_ok=True)
            img = Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
            ext = "jpg" if (i, j) == (1, 1) else "png"
            img.save(str(root / "18" / str(x) / "{}.{}".format(y, ext)))
    (root / "18" / "notes").mkdir()


@pytest.mark.parametrize("s2d", [False, True], ids=["raw", "s2d"])
@pytest.mark.parametrize("shard", [None, (1, 3)], ids=["all", "shard1of3"])
def test_buffered_directory_and_batches(tmp_path, s2d, shard):
    _write_slippy_map(tmp_path / "tiles")
    port_tf = (lambda im: space_to_depth4(im[None])[0]) if s2d else None
    jax_tf = (lambda im: np.asarray(jax_space_to_depth4(im[None])[0])) if s2d else None
    port = datasets.BufferedSlippyMapDirectory(str(tmp_path / "tiles"), size=64, overlap=16, transform=port_tf,
                                               shard=shard)
    ref = jdatasets.BufferedSlippyMapDirectory(str(tmp_path / "tiles"), size=64, overlap=16, transform=jax_tf,
                                               shard=shard)
    assert len(port) == len(ref) == (3 if shard else 8)
    got = list(loader.batches(port, 2, workers=2))
    want = list(jloader.batches(ref, 2, workers=2))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.valid == w.valid and [tuple(t) for t in g.meta] == [tuple(t) for t in w.meta]
        assert len(g.arrays) == len(w.arrays) == 1
        assert g.arrays[0].dtype == w.arrays[0].dtype and np.array_equal(g.arrays[0], w.arrays[0])
    side = (64 + 32) // (4 if s2d else 1)
    assert got[0].arrays[0].shape == (2, side, side, 48 if s2d else 3)
    assert datasets._shard_slice(list(range(10)), (2, 3)) == jdatasets._shard_slice(list(range(10)), (2, 3))


@pytest.mark.parametrize("kind", ["decode_png", "decode_jpeg", "encode", "encode_d2s"])
def test_image_codec(tmp_path, kind):
    assert (imagecodec.load() is None) == (jimagecodec.load() is None)
    rng = np.random.default_rng(5)
    if kind.startswith("decode"):
        path = str(tmp_path / ("tile.png" if kind == "decode_png" else "tile.jpg"))
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)).save(path)
        got, want = imagecodec.decode_rgb(path), jimagecodec.decode_rgb(path)
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(got, want)
        return
    palette = colors.continuous_palette_for_color("pink", 256)
    if kind == "encode":
        data = rng.integers(0, 256, (40, 24), dtype=np.uint8)
        results = [m.encode_palette_png(str(tmp_path / "{}.png".format(i)), data, palette)
                   for i, m in enumerate((imagecodec, jimagecodec))]
    else:
        data = rng.integers(0, 256, (20, 12, 4), dtype=np.uint8)
        results = [m.encode_palette_png_d2s(str(tmp_path / "{}.png".format(i)), data, palette)
                   for i, m in enumerate((imagecodec, jimagecodec))]
    assert results[0] == results[1]
    if results[0]:
        decoded = [np.asarray(Image.open(str(tmp_path / "{}.png".format(i)))) for i in range(2)]
        assert decoded[0].shape == (40, 24) and np.array_equal(decoded[0], decoded[1])
        assert Image.open(str(tmp_path / "0.png")).getpalette()[:768] == palette


def _trees(seed):
    rng = np.random.default_rng(seed)
    return {
        "params": {"encoder": {"layer1": [{"conv1": {"w": rng.normal(size=(1, 1, 4, 8)).astype(np.float32)}},
                                          {"conv1": {"w": rng.normal(size=(1, 1, 8, 8)).astype(np.float32)}}]},
                   "final": {"w": rng.normal(size=(1, 1, 8, 2)).astype(np.float32), "b": np.zeros(2, np.float32)}},
        "state": {"count": np.arange(3, dtype=np.int32)},
    }


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_checkpoint_cross_load(tmp_path, writer, reader):
    modules = {"port": checkpoint, "jax": jcheckpoint}
    trees, meta = _trees(1), {"epoch": 3, "qat_amaxes": [1.5, 2.0]}
    modules[writer].save_checkpoint(str(tmp_path / "ckpt"), trees, meta=meta)
    got, got_meta = modules[reader].load_checkpoint(str(tmp_path / "ckpt.npz"))
    _assert_trees_equal(got, trees)
    assert got_meta == meta


def test_convert_torch_unet_matches_jax():
    sd = _reference_style_state_dict()
    got = checkpoint.convert_torch_unet(sd)
    want = jcheckpoint.convert_torch_unet(sd)
    _assert_trees_equal(got, want)
    enc = {k[len("module.resnet."):]: v for k, v in sd.items() if k.startswith("module.resnet.")}
    _assert_trees_equal(checkpoint.convert_torch_resnet50(enc), jcheckpoint.convert_torch_resnet50(enc))
    # Numpy values convert as tensors do.
    _assert_trees_equal(checkpoint.convert_torch_unet({k: v.numpy() for k, v in sd.items()}), want)
    assert isinstance(sd["module.final.weight"], torch.Tensor)
