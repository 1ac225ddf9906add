"""robosat_tpu_torch's SegFormer through the registry, the train step, the
checkpoint converter and the `train` and `predict` tools, on the CPU.

- `get_model("segformer")` is the port's models/segformer.py; a name the
  registry does not hold raises the JAX registry's ValueError.
- `make_train_step` over `segformer.apply` (CrossEntropy with
  dataset-parking's weights, augmentation off, 64 px, batch 2) for 3 steps
  from the JAX package's init against the JAX package's step, computed with
  XLA:CPU capped at AVX2 (`test_torch_port_train.run_capped`): step 0's
  loss (taken before any update) within 1e-4 relative, steps 1-2 within 5%
  (the bound of tests/test_torch_port_train.py: Adam's first updates are
  ~lr * sign(grad)), the fuse's BN statistics after 3 steps within 5e-3.
- `convert_torch_segformer` on the state dict of the raw-torch oracle of
  tests/test_torch_segformer_parity.py: the JAX converter's trees exactly,
  and `from_jax` carries them leaf for leaf.
- `train.main` with `model = 'segformer'` (config/model-unet.toml's
  settings on the CPU, float32, batch 2 at 64 px) for one epoch, then
  `--teacher` with a fast-family checkpoint (`--teacher_model` a TOML of
  `model = 'fast'`: SegFormer has no folded forward to teach with): two
  steps each, checkpoints the JAX package loads into SegFormer's tree with
  optax's state, the JAX tool's log line for the teacher; `--qat` exits
  with the JAX tool's message in both tools.
- `predict.main` with the model key on two 128-px tiles, overlap 16, from
  the trained checkpoint: int8 as configured (host-blocked input) and
  float32, every PNG's palette indices equal to the port's predict step
  run on the tool's own batches.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from robosat_tpu import checkpoint as jcheckpoint
from robosat_tpu.models import registry as jregistry
from robosat_tpu.models import segformer as jsegformer
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel import steps as jsteps
from robosat_tpu.tools import predict as jpredict
from robosat_tpu.tools import train as jtrain
from robosat_tpu_torch import checkpoint, optim
from robosat_tpu_torch.config import load_config, save_config
from robosat_tpu_torch.data.loader import batches as load_batches
from robosat_tpu_torch.models import fastnet, segformer
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.parallel import steps
from robosat_tpu_torch.tools import predict, train
from test_torch_port_train import run_capped
from test_torch_port_train_forward import WEIGHT, learnable_batch, torch_threads  # noqa: F401
from test_torch_port_train_tool import _args, _write_split
from test_torch_segformer_parity import TorchSegFormer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
SIZE = 64
STEPS = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_registry_returns_segformer():
    assert get_model("segformer") is segformer
    for name in ("segformer-b5", "SegFormer"):
        with pytest.raises(ValueError) as want:
            jregistry.get_model(name)
        with pytest.raises(ValueError) as got:
            get_model(name)
        assert str(got.value) == str(want.value)


def _jax_steps(params, state, batches):
    """The JAX package's first STEPS steps: (losses, the fuse's BN state)."""
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    step = jsteps.make_train_step(jsegformer, jax_get_loss("CrossEntropy"), optimizer, weight=WEIGHT, augment=False)
    losses = []
    for images, masks in batches:
        params, state, opt_state, loss, _ = step(params, state, opt_state, jax.random.PRNGKey(0), images, masks)
        losses.append(float(loss))
    return losses, _np(state["fuse_bn"])


def test_train_step_matches_jax():
    params, state = _np(jsegformer.init(0, num_classes=2))
    batches = [learnable_batch(40 + i) for i in range(STEPS)]
    want_losses, want_bn = run_capped(_jax_steps, params, state, batches)
    tparams, tstate = checkpoint.from_jax(params, state)
    step = steps.make_train_step(segformer, get_loss("CrossEntropy"), optim.adam(tparams, LR), weight=WEIGHT,
                                 augment=False)
    losses = []
    for images, masks in batches:
        tstate, loss, counts = step(tparams, tstate, images, masks)
        losses.append(float(loss))
        assert int(counts.sum()) == masks.size
    print("SegFormer steps: port losses {} vs JAX {}".format(losses, want_losses))
    assert abs(losses[0] - want_losses[0]) <= 1e-4 * abs(want_losses[0])
    np.testing.assert_allclose(losses[1:], want_losses[1:], rtol=5e-2)
    for k in ("mean", "var"):
        np.testing.assert_allclose(tstate["fuse_bn"][k].numpy(), want_bn[k], rtol=5e-3, atol=5e-3)


def test_convert_torch_segformer_matches_jax():
    torch.manual_seed(3)
    sd = TorchSegFormer().state_dict()
    want = jcheckpoint.convert_torch_segformer(sd)
    got = checkpoint.convert_torch_segformer(sd)
    for w, g in zip(want, got):
        want_leaves, want_def = jax.tree_util.tree_flatten_with_path(w)
        got_leaves, got_def = jax.tree_util.tree_flatten_with_path(g)
        assert got_def == want_def
        for (path, a), (_, b) in zip(got_leaves, want_leaves):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), jax.tree_util.keystr(path)
    tparams, tstate = checkpoint.from_jax(*want)
    assert jax.tree_util.tree_structure(_np(jsegformer.init(0, 2))) == jax.tree_util.tree_structure(want)
    for t, a in zip(checkpoint.tree_leaves(tparams) + checkpoint.tree_leaves(tstate),
                    jax.tree_util.tree_leaves(want[0]) + jax.tree_util.tree_leaves(want[1])):
        assert np.array_equal(t.numpy(), a)


def _configs(root, name, model="segformer", **common):
    """(model TOML, dataset TOML): config/model-unet.toml with `model` on
    the CPU, float32, batch 2 at 64 px, one epoch."""
    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    config = {**base, "common": {**base["common"], "model": model, "cuda": False, "bf16": False, "batch_size": 2,
                                 "image_size": SIZE, "checkpoint": os.path.join(root, name), **common},
              "opt": {**base["opt"], "epochs": 1}}
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = root
    paths = os.path.join(root, name + ".toml"), os.path.join(root, name + "-dataset.toml")
    save_config(config, paths[0])
    save_config(dataset, paths[1])
    return paths


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`train` for one epoch, then `--teacher` with a fast-family teacher."""
    root = str(tmp_path_factory.mktemp("slippy_segformer"))
    _write_split(root, "training", 4, seed=80, size=SIZE)
    _write_split(root, "validation", 2, seed=81, size=SIZE)
    teacher = os.path.join(root, "fast-teacher.npz")
    t_params, t_state = fastnet.init(0, num_classes=2)
    checkpoint.save_checkpoint(teacher, {"params": checkpoint.to_jax(t_params), "state": checkpoint.to_jax(t_state)},
                               meta={"epoch": 1})
    teacher_toml, _ = _configs(root, "fast-teacher-config", model="fast")
    runs = {}
    for name, flags in (("plain", {}), ("teacher", {"teacher": teacher, "teacher_model": teacher_toml})):
        out = train.main(_args(*_configs(root, name), workers=2, **flags))
        runs[name] = (out, os.path.join(root, name))
    return root, os.path.join(root, "plain", "checkpoint-00001-of-00001.npz"), teacher, runs


@pytest.mark.parametrize("name", ["plain", "teacher"])
def test_train_tool_segformer(trained, name):
    _, _, teacher, runs = trained
    out, run_dir = runs[name]
    assert (out["steps"], out["count"]) == (2, 2)
    path = os.path.join(run_dir, "checkpoint-00001-of-00001.npz")
    params, state, _ = jcheckpoint.load_model_checkpoint(path, num_classes=2)
    want_params, want_state = jsegformer.init(0, num_classes=2)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(want_params)
    assert jax.tree_util.tree_structure(state) == jax.tree_util.tree_structure(want_state)
    trees, _ = jcheckpoint.load_checkpoint(path)
    opt_state = jcheckpoint.leaves_to_opt_state(optax.adam(LR).init(params), trees["opt_state"])
    assert int(opt_state[0].count) == 2
    for leaf in jax.tree_util.tree_leaves(params) + jax.tree_util.tree_leaves(state):
        assert np.all(np.isfinite(np.asarray(leaf)))
    if name == "teacher":
        lines = open(os.path.join(run_dir, "log")).read().splitlines()
        assert "Distilling from: {} (alpha 0.9, T 2.0)".format(teacher) in lines


def test_qat_exits_as_jax(trained):
    root, first, _, _ = trained
    message = "Error: --qat needs a family with a fake-quant forward (apply_logits_fake_quant): unet or fast"
    for tool in (train, jtrain):
        with pytest.raises(SystemExit, match=message.replace("(", r"\(").replace(")", r"\)")):
            tool.main(_args(*_configs(root, "qat"), workers=2, qat=True, checkpoint=first))


def test_predict_tool_side_multiple_as_jax(trained, tmp_path):
    """A buffered side that is no multiple of 32 exits with the JAX tool's
    message, before anything is loaded."""
    root, first, _, _ = trained
    model_toml, dataset_toml = _configs(str(tmp_path), "side", int8=True)
    parser_args = dict(batch_size=2, checkpoint=first, overlap=8, strip=1, tile_size=128, workers=2, shard=None,
                       tiles=str(tmp_path / "tiles"), probs=str(tmp_path / "probs"), model=model_toml,
                       dataset=dataset_toml, profile=None, png_optimize=False)
    for tool in (predict, jpredict):
        with pytest.raises(SystemExit, match=r"multiple of 32 \(got 144\)"):
            tool.main(type("Args", (), parser_args)())


@pytest.mark.parametrize("mode", ["int8", "float32"])
def test_predict_tool_segformer_matches_step(tmp_path, trained, mode):
    root, first, _, _ = trained
    rng = np.random.default_rng(90)
    d = tmp_path / "tiles" / "18" / "69623"
    d.mkdir(parents=True)
    for y in (104945, 104946):
        Image.fromarray(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(d / "{}.png".format(y))
    model_toml, dataset_toml = _configs(str(tmp_path), "predict", int8=mode == "int8", int8_calibration=99.8)
    parser_args = dict(batch_size=2, checkpoint=first, overlap=16, strip=1, tile_size=128, workers=2, shard=None,
                       tiles=str(tmp_path / "tiles"), probs=str(tmp_path / "probs"), model=model_toml,
                       dataset=dataset_toml, profile=None, png_optimize=False)
    args = type("Args", (), parser_args)()
    predict.main(args)

    common = load_config(model_toml)["common"]
    use_host_s2d = predict.host_s2d_input(common, args)
    assert use_host_s2d == (mode == "int8")
    directory, _ = predict.input_directory(args, use_host_s2d)
    params, state, _ = checkpoint.load_model_checkpoint(first)
    batch = next(iter(load_batches(directory, 2, workers=2)))
    (images,) = batch.arrays
    if mode == "int8":
        step, qtree = steps.make_int8_predict_step(segformer, params, state, images, overlap=16, host_s2d=True,
                                                   calib_percentile=99.8)
        want = step(qtree, images)
    else:
        want = steps.make_predict_step(segformer, overlap=16, fused_head=True)(params, state, images)
    assert tuple(want.shape) == (2, 128, 128) and want.dtype == torch.uint8
    for (x, y, z), q in zip(batch.meta, want.numpy()):
        png = Image.open(tmp_path / "probs" / str(z) / str(x) / "{}.png".format(y))
        assert png.mode == "P" and np.array_equal(np.asarray(png), q)
