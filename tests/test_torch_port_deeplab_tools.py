"""robosat_tpu_torch's DeepLabv3+ through the registry, the train step, the
checkpoint converter and the `train` and `predict` tools, on the CPU.

- `get_model("deeplabv3plus")` is the port's models/deeplab.py; a name
  the registry does not hold raises the JAX registry's ValueError, which
  lists the four families.
- One `make_train_step` step over `deeplab.apply` (CrossEntropy with
  dataset-parking's weights, augmentation off, 64 px, batch 2) from the
  JAX package's init against the JAX package's step, computed with
  XLA:CPU capped at AVX2 (`torch_port_refs.run_capped`: its AVX-512
  code is 1.8e-4 from a float64 run of this loss, the port 9e-5, its AVX2
  code 8e-5): the loss (taken before the update) within 1e-4 relative, the
  stem's new BN statistics within 5e-3.
- `convert_torch_deeplab` on a generated torch-layout state dict: the JAX
  converter's trees exactly, and `from_jax` carries them leaf for leaf.
- `train.main` with `model = 'deeplabv3plus'` (config/model-unet.toml's
  settings on the CPU, float32, batch 2 at 64 px) for one epoch, then
  `--teacher` with its checkpoint (the family distils itself): two steps
  each, checkpoints the JAX package loads into DeepLab's tree with
  optax's state, the JAX tool's log line for the teacher; `--qat` exits
  with the JAX tool's message (DeepLab has no fake-quant forward).
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
from robosat_tpu.models import deeplab as jdeeplab
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel import steps as jsteps
from robosat_tpu.tools import train as jtrain
from robosat_tpu_torch import checkpoint, optim
from robosat_tpu_torch.config import load_config, save_config
from robosat_tpu_torch.data.loader import batches as load_batches
from robosat_tpu_torch.models import deeplab
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.parallel import steps
from robosat_tpu_torch.tools import predict, train
from test_torch_port_train_forward import WEIGHT, learnable_batch
from test_torch_port_train_tool import _args, _write_split
from torch_port_refs import run_capped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
SIZE = 64
# The capped child's limit: about three times its time in tier-1's run.
STEP_TIMEOUT = 180
HEADS = ("aspp1", "aspp_d0", "aspp_d1", "aspp_d2", "aspp_pool", "aspp_proj", "lowlevel", "dec1", "dec2")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    return _np(jdeeplab.init(0, num_classes=2))


def test_registry_returns_deeplab():
    assert get_model("deeplabv3plus") is deeplab
    with pytest.raises(ValueError, match="unknown model 'deeplabv3'; available: deeplabv3plus, fast, segformer, unet"):
        get_model("deeplabv3")


def _jax_step(params, state, images, masks):
    """The JAX package's first step: (loss, the stem's new BN state)."""
    jstep = jsteps.make_train_step(jdeeplab, jax_get_loss("CrossEntropy"), optax.adam(LR), weight=WEIGHT,
                                   augment=False)
    _, new_state, _, loss, _ = jstep(params, state, optax.adam(LR).init(params), jax.random.PRNGKey(0), images, masks)
    return float(loss), _np(new_state["encoder"]["bn1"])


def test_train_step_matches_jax(weights):
    images, masks = learnable_batch(30)
    params, state = weights
    want_loss, want_bn1 = run_capped(_jax_step, params, state, images, masks, timeout=STEP_TIMEOUT)
    tparams, tstate = checkpoint.from_jax(params, state)
    step = steps.make_train_step(deeplab, get_loss("CrossEntropy"), optim.adam(tparams, LR), weight=WEIGHT,
                                 augment=False)
    new_state, loss, counts = step(tparams, tstate, images, masks)
    print("DeepLab step: port loss {} vs JAX {}".format(float(loss), float(want_loss)))
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    assert int(counts.sum()) == masks.size
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state["encoder"]["bn1"][k].numpy(), want_bn1[k], rtol=5e-3, atol=5e-3)


def _torch_deeplab_state_dict():
    """A torch-layout DeepLabv3+ state_dict ("module." prefixes, a
    torchvision resnet50 backbone, `<name>.0`/`<name>.1` conv/BN pairs),
    random-valued."""
    g = torch.Generator().manual_seed(3)
    sd = {}

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    def add_bn(key, c):
        sd[key + ".weight"] = 1 + t(c)
        sd[key + ".bias"] = t(c)
        sd[key + ".running_mean"] = t(c)
        sd[key + ".running_var"] = 1 + t(c).abs()
        sd[key + ".num_batches_tracked"] = torch.tensor(1)

    p = "module.resnet."
    sd[p + "conv1.weight"] = t(64, 3, 7, 7)
    add_bn(p + "bn1", 64)
    cin = 64
    for si, (blocks, mid) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for bi in range(blocks):
            base = "{}layer{}.{}".format(p, si + 1, bi)
            for ci, (i, o, k) in enumerate(((cin, mid, 1), (mid, mid, 3), (mid, 4 * mid, 1)), start=1):
                sd["{}.conv{}.weight".format(base, ci)] = t(o, i, k, k)
                add_bn("{}.bn{}".format(base, ci), o)
            if bi == 0:
                sd[base + ".downsample.0.weight"] = t(4 * mid, cin, 1, 1)
                add_bn(base + ".downsample.1", 4 * mid)
            cin = 4 * mid
    shapes = {"aspp1": (2048, 1), "aspp_d0": (2048, 3), "aspp_d1": (2048, 3), "aspp_d2": (2048, 3),
              "aspp_pool": (2048, 1), "aspp_proj": (1280, 1), "lowlevel": (256, 1), "dec1": (304, 3), "dec2": (256, 3)}
    for name in HEADS:
        ci, k = shapes[name]
        co = 48 if name == "lowlevel" else 256
        sd["module.{}.0.weight".format(name)] = t(co, ci, k, k)
        add_bn("module.{}.1".format(name), co)
    sd["module.final.weight"] = t(2, 256, 1, 1)
    sd["module.final.bias"] = t(2)
    return sd


def test_convert_torch_deeplab_matches_jax():
    sd = _torch_deeplab_state_dict()
    want = jcheckpoint.convert_torch_deeplab(sd)
    got = checkpoint.convert_torch_deeplab(sd)
    for w, g in zip(want, got):
        want_leaves, want_def = jax.tree_util.tree_flatten_with_path(w)
        got_leaves, got_def = jax.tree_util.tree_flatten_with_path(g)
        assert got_def == want_def
        for (path, a), (_, b) in zip(got_leaves, want_leaves):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), jax.tree_util.keystr(path)
    tparams, tstate = checkpoint.from_jax(*want)
    assert sorted(tparams) == sorted(jdeeplab.init(0, 2)[0]) == sorted(HEADS + ("encoder", "final"))
    for t, a in zip(checkpoint.tree_leaves(tparams) + checkpoint.tree_leaves(tstate),
                    jax.tree_util.tree_leaves(want[0]) + jax.tree_util.tree_leaves(want[1])):
        assert np.array_equal(t.numpy(), a)


def _configs(root, name, **common):
    """(model TOML, dataset TOML): config/model-unet.toml with model =
    'deeplabv3plus' on the CPU, float32, batch 2 at 64 px, one epoch."""
    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    model = {**base, "common": {**base["common"], "model": "deeplabv3plus", "cuda": False, "bf16": False,
                                "batch_size": 2, "image_size": SIZE, "checkpoint": os.path.join(root, name),
                                **common},
             "opt": {**base["opt"], "epochs": 1}}
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = root
    paths = os.path.join(root, name + ".toml"), os.path.join(root, name + "-dataset.toml")
    save_config(model, paths[0])
    save_config(dataset, paths[1])
    return paths


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`train` for one epoch, then `--teacher` from its checkpoint."""
    root = str(tmp_path_factory.mktemp("slippy_deeplab"))
    _write_split(root, "training", 4, seed=60, size=SIZE)
    _write_split(root, "validation", 2, seed=61, size=SIZE)
    first = os.path.join(root, "plain", "checkpoint-00001-of-00001.npz")
    runs = {}
    for name, flags in (("plain", {}), ("teacher", {"teacher": first})):
        out = train.main(_args(*_configs(root, name), workers=2, **flags))
        runs[name] = (out, os.path.join(root, name))
    return root, first, runs


@pytest.mark.parametrize("name", ["plain", "teacher"])
def test_train_tool_deeplab(trained, name):
    _, first, runs = trained
    out, run_dir = runs[name]
    assert (out["steps"], out["count"]) == (2, 2)
    path = os.path.join(run_dir, "checkpoint-00001-of-00001.npz")
    params, state, _ = jcheckpoint.load_model_checkpoint(path, num_classes=2)
    want_params, want_state = jdeeplab.init(0, num_classes=2)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(want_params)
    assert jax.tree_util.tree_structure(state) == jax.tree_util.tree_structure(want_state)
    trees, _ = jcheckpoint.load_checkpoint(path)
    opt_state = jcheckpoint.leaves_to_opt_state(optax.adam(LR).init(params), trees["opt_state"])
    assert int(opt_state[0].count) == 2
    for leaf in jax.tree_util.tree_leaves(params) + jax.tree_util.tree_leaves(state):
        assert np.all(np.isfinite(np.asarray(leaf)))
    if name == "teacher":
        lines = open(os.path.join(run_dir, "log")).read().splitlines()
        assert "Distilling from: {} (alpha 0.9, T 2.0)".format(first) in lines


def test_train_tool_qat_exits_as_jax(trained):
    root, first, _ = trained
    message = "Error: --qat needs a family with a fake-quant forward (apply_logits_fake_quant): unet or fast"
    for tool in (train, jtrain):
        with pytest.raises(SystemExit, match=message.replace("(", r"\(").replace(")", r"\)")):
            tool.main(_args(*_configs(root, "qat"), workers=2, qat=True, checkpoint=first))


@pytest.mark.parametrize("mode", ["int8", "float32"])
def test_predict_tool_deeplab_matches_step(tmp_path, trained, mode):
    root, first, _ = trained
    rng = np.random.default_rng(70)
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
        step, qtree = steps.make_int8_predict_step(deeplab, params, state, images, overlap=16, host_s2d=True,
                                                   calib_percentile=99.8)
        want = step(qtree, images)
    else:
        want = steps.make_predict_step(deeplab, overlap=16, fused_head=True)(params, state, images)
    assert tuple(want.shape) == (2, 128, 128) and want.dtype == torch.uint8
    for (x, y, z), q in zip(batch.meta, want.numpy()):
        png = Image.open(tmp_path / "probs" / str(z) / str(x) / "{}.png".format(y))
        assert png.mode == "P" and np.array_equal(np.asarray(png), q)
