"""robosat_tpu_torch's `train` and `predict` run as 2 processes of a gloo group.

Each tool's `main` runs on 2 ranks launched with RS_* set
(tests/torch_mesh_workers.py), against the same tool in one process on
one CPU thread.

- `train` for one epoch (config/model-unet.toml's keys on the CPU: float32,
  Lovasz, `sync_bn = true`, augmentation on; 4 training and 2 validation
  64-px tiles, batch 2, so each rank takes one row of each global batch):
  rank 0 alone writes the log, the checkpoint and the chart, the log holds
  each line once, both ranks return the same history and step count (2),
  and the history is the one-process run's within the training-agreement
  bound of 5% (PERF.md section 2: Adam's first updates are ~lr * sign(grad),
  and float-level sign flips move the second step's loss; the first step
  agrees to 1e-5, tests/test_torch_port_mesh_steps.py); the checkpoint
  holds epoch 1 and the optimizer's count of 2 steps.
- int8 `predict` over 3 tiles at batch 2 (the second global batch is one
  tile and its padding: rank 1's row there is padding and writes nothing),
  and with `--shard 0/2` (one tile: rank 1 holds only padding): each
  rank writes the PNGs of its rows, and the set of PNGs equals the one-process run's, byte for byte in the
  palette indices or within one bin on at most 0.1% of the pixels (the
  calibration is the whole first batch's in both).
"""

import argparse
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import torch_mesh_workers as workers
from robosat_tpu.checkpoint import save_checkpoint
from robosat_tpu.config import save_config
from robosat_tpu.models import unet as junet
from robosat_tpu_torch.checkpoint import load_checkpoint
from robosat_tpu_torch.tools import predict, train
from test_torch_port_predict import MAX_FLIP_SHARE, _bin_distance
from test_torch_port_train_tool import _args, _configs, _write_split
from torch_port_refs import exact_var

SIZE = 64


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_slippy"))
    _write_split(root, "training", 4, seed=20, size=SIZE)
    _write_split(root, "validation", 2, seed=21, size=SIZE)
    return root


def test_train_on_two_ranks(dataset):
    single = train.main(_args(*_configs(dataset, "single", 1, image_size=SIZE)))
    ranks = workers.launch(workers.tool_main, 2, "train", _args(*_configs(dataset, "mesh", 1, image_size=SIZE)),
                           timeout=120)
    assert ranks[0]["history"] == ranks[1]["history"]
    assert [r["steps"] for r in ranks] == [2, 2] and single["steps"] == 2
    for key, want in single["history"].items():
        got = ranks[0]["history"][key]
        print("{}: {} vs one process {}".format(key, got, want))
        if "loss" in key:
            assert got == pytest.approx(want, rel=0.05)
    files = sorted(os.listdir(os.path.join(dataset, "mesh")))
    assert files == sorted(os.listdir(os.path.join(dataset, "single")))
    assert "checkpoint-00001-of-00001.npz" in files and "log" in files
    with open(os.path.join(dataset, "mesh", "log")) as f:
        lines = f.read().splitlines()
    assert lines.count("Epoch: 1/1") == 1 and len(lines) == len(set(lines))

    trees, meta = load_checkpoint(os.path.join(dataset, "mesh", "checkpoint-00001-of-00001.npz"))
    assert meta["epoch"] == 1 and int(trees["opt_state"][0]) == 2


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """3 tiles of 64 px, an exact-variance checkpoint and the configs."""
    root = tmp_path_factory.mktemp("mesh_predict")
    rng = np.random.default_rng(12)
    for y in (104945, 104946, 104947):
        d = root / "tiles" / "18" / "69623"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)).save(d / "{}.png".format(y))
    params, state = jax.tree_util.tree_map(np.asarray, junet.init(0, num_classes=2))
    save_checkpoint(str(root / "model.npz"), {"params": params, "state": exact_var(state)}, meta={"epoch": 1})
    save_config({"common": {"cuda": False, "batch_size": 2, "image_size": SIZE, "checkpoint": str(root),
                            "bf16": True, "int8": True}}, str(root / "model.toml"))
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(root / "dataset.toml"))
    return root


def _predict_args(root, probs, shard):
    return argparse.Namespace(batch_size=2, checkpoint=str(root / "model.npz"), overlap=0, strip=1, tile_size=SIZE,
                              workers=2, shard=shard, tiles=str(root / "tiles"), probs=str(probs),
                              model=str(root / "model.toml"), dataset=str(root / "dataset.toml"), profile=None,
                              png_optimize=False)


def _pngs(probs):
    return {str(p.relative_to(probs)): np.asarray(Image.open(p)) for p in probs.rglob("*.png")}


@pytest.mark.parametrize("shard", [None, "0/2"], ids=["all", "shard-0-of-2"])
def test_predict_on_two_ranks(tiles, shard):
    name = "all" if shard is None else "shard"
    single = predict.main(_predict_args(tiles, tiles / ("single_" + name), shard))
    ranks = workers.launch(workers.tool_main, 2, "predict", _predict_args(tiles, tiles / ("mesh_" + name), shard))
    assert [r["tiles"] for r in ranks] == [single["tiles"]] * 2 == [3 if shard is None else 1] * 2
    got, want = _pngs(tiles / ("mesh_" + name)), _pngs(tiles / ("single_" + name))
    assert sorted(got) == sorted(want) and len(got) == single["tiles"]
    for rel, ref in want.items():
        d = _bin_distance(got[rel], ref)
        print("{}: {} of {} bins differ".format(rel, int((d != 0).sum()), d.size))
        assert d.max() <= 1 and (d != 0).sum() <= MAX_FLIP_SHARE * d.size
