"""robosat_tpu_torch's fast-family training (`train` with `model = 'fast'`) vs the JAX package, on the CPU.

The JAX package's weights (`fastnet.init(0)`, and `unet.init(0)` as the
teacher, BN state with var + eps == 1) cross through the npz bridge; 64-px
batches of 2 with a bright square as class 1, float32, augmentation off,
as tests/test_torch_port_train.py holds the U-Net's step:

- `make_train_step` (`fastnet.apply`: the family has no `apply_s2d`) with
  CrossEntropy (dataset-parking's class weights) and with Lovasz over 3
  steps from the same weights: step 0's loss within 1e-4 relative, steps
  1-2 within 5%, the stem's BN running statistics within 5e-3, each step
  optax.adam's on the port's own gradients (`check_optax_step`), and step
  1's update at cosine >= 0.98 to JAX's over all weights, its norm within
  1%;
- `make_distill_train_step` of a fast student from a U-Net teacher
  (`unet.apply_folded` on its fold; CrossEntropy, alpha 0.9, T 2) over 3
  steps, held the same way;
- `make_qat_train_step` (`fastnet.apply_logits_fake_quant`, Lovasz) over 3
  steps on the JAX package's 99.8-percentile scales, every step's 15 site
  inputs forced to the JAX program's at JAX's weights before that step
  (tests/test_torch_port_qat.py's technique: run free, the two forwards
  part at bins flipped by float summation order): step 0's site inputs
  within 1e-5 of their largest, the losses within 1e-4 at step 0 and 1e-3
  after, each step optax's, the update after step 1 at cosine >= 0.98,
  the BN state the object passed in, unchanged bit for bit;
- the `train` tool with `model = 'fast'` for one epoch (4 training and 2
  validation tiles of 64 px, batch 2), then `--teacher` from a U-Net
  checkpoint with `--teacher_model` a U-Net TOML, then `--qat` from the
  first run's checkpoint: the log lines, checkpoints that the JAX
  package's `load_model_checkpoint` and `leaves_to_opt_state` read (the
  same params and state, optax's count), and 15 `qat_amaxes` within 1e-5
  relative of the JAX package's calibration of the same weights on the
  same first shuffled batch.
"""

import os

import jax
import numpy as np
import optax
import pytest
import torch

from robosat_tpu import checkpoint as jcheckpoint
from robosat_tpu.models import fastnet as jfastnet
from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import unet as junet
from robosat_tpu.ops.augment import normalize as jax_normalize
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel import steps as jsteps
from robosat_tpu_torch import checkpoint, optim
from robosat_tpu_torch.config import load_config, save_config
from robosat_tpu_torch.data.datasets import SlippyMapTilesConcatenation
from robosat_tpu_torch.data.loader import batches as load_batches
from robosat_tpu_torch.models import fastnet, unet
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.parallel import steps
from robosat_tpu_torch.tools import train
from test_torch_port_qat import forcing
from test_torch_port_train import _flat, check_optax_step, update_agreement
from test_torch_port_train_forward import WEIGHT, learnable_batch
from test_torch_port_train_tool import _args, _write_split
from torch_port_refs import exact_var, family_calibration, family_calibration_raw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
STEPS = 3
SIZE = 64
ALPHA, TEMP = 0.9, 2.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    params, state = _np(jfastnet.init(0, num_classes=2))
    return params, exact_var(state)


@pytest.fixture(scope="module")
def batches():
    return [learnable_batch(40 + i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def teacher():
    params, state = _np(junet.init(0, num_classes=2))
    return params, exact_var(state)


def _jax_run(weights, batches, step, extra=()):
    """(losses, params after step 1, final state) of a JAX step."""
    params, state = weights
    opt_state = optax.adam(LR).init(params)
    losses, after = [], None
    for images, masks in batches:
        params, state, opt_state, loss, _ = step(params, state, opt_state, *extra, jax.random.PRNGKey(0), images,
                                                 masks)
        losses.append(float(loss))
        after = _np(params) if after is None else after
    return losses, after, _np(state)


def _port_run(weights, batches, make_step, extra=()):
    """(losses, state, optimizer, params after step 1) of the port's step,
    each step replayed by optax on the port's own gradients."""
    params, state = checkpoint.from_jax(*weights)
    optimizer = optim.adam(params, LR)
    step = make_step(optimizer)
    opt_state = optax.adam(LR).init(_flat(jax.tree_util.tree_leaves(weights[0])))
    losses, first = [], None
    for images, masks in batches:
        before = _flat([p.detach().numpy() for p in checkpoint.tree_leaves(params)])
        state, loss, counts = step(params, state, *extra, images, masks)
        opt_state = check_optax_step(params, optimizer, before, opt_state)
        losses.append(float(loss))
        assert counts.dtype == torch.int32 and int(counts.sum()) == masks.size
        first = first or [p.detach().numpy().copy() for p in checkpoint.tree_leaves(params)]
    return losses, state, optimizer, first


def _check_run(label, weights, want, got):
    want_losses, want_after, want_state = want
    losses, state, optimizer, first = got
    print("{} losses: port {} JAX {}".format(label, losses, want_losses))
    assert abs(losses[0] - want_losses[0]) <= 1e-4 * abs(want_losses[0])
    for i in (1, 2):
        assert abs(losses[i] - want_losses[i]) <= 0.05 * abs(want_losses[i])
    for k in ("mean", "var"):
        np.testing.assert_allclose(state["stem_bn"][k].numpy(), want_state["stem_bn"][k], atol=5e-3, rtol=5e-3)
    assert optimizer.count == STEPS
    cos, ratio = update_agreement(first, jax.tree_util.tree_leaves(want_after), jax.tree_util.tree_leaves(weights[0]))
    print("{}: step-1 update vs JAX cosine {}, norm ratio {}".format(label, cos, ratio))
    assert cos >= 0.98 and abs(ratio - 1) <= 0.01, (cos, ratio)


@pytest.mark.parametrize("name", ["CrossEntropy", "Lovasz"])
def test_train_step_matches_jax(weights, batches, name):
    weight = WEIGHT if name == "CrossEntropy" else None
    jstep = jsteps.make_train_step(jfastnet, jax_get_loss(name), optax.adam(LR), weight=weight, augment=False)
    got = _port_run(weights, batches, lambda opt: steps.make_train_step(fastnet, get_loss(name), opt, weight=weight,
                                                                          augment=False))
    _check_run(name, weights, _jax_run(weights, batches, jstep), got)


def test_distill_fast_student_from_unet_teacher_matches_jax(weights, teacher, batches):
    jfolded = jax.jit(junet.fold)(*teacher)
    x = np.asarray(jax_normalize(batches[0][0]))
    want_logits = np.asarray(jax.jit(junet.apply_folded)(jfolded, x))
    tparams, tstate = checkpoint.from_jax(*teacher)
    with torch.no_grad():
        folded = unet.fold(tparams, tstate)
        t_logits = unet.apply_folded(folded, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(t_logits, want_logits, rtol=0, atol=5e-4 * np.abs(want_logits).max())

    jstep = jsteps.make_distill_train_step(jfastnet, junet, jax_get_loss("CrossEntropy"), optax.adam(LR),
                                           weight=WEIGHT, augment=False, alpha=ALPHA, temp=TEMP)
    got = _port_run(weights, batches, lambda opt: steps.make_distill_train_step(
        fastnet, unet, get_loss("CrossEntropy"), opt, weight=WEIGHT, augment=False, alpha=ALPHA, temp=TEMP),
        extra=(folded,))
    _check_run("distillation", weights, _jax_run(weights, batches, jstep, extra=(jfolded,)), got)


@pytest.fixture(scope="module")
def scales(weights, batches):
    folded = jax.jit(jfastnet.fold)(*weights)
    x = np.asarray(jax_normalize(batches[0][0]))
    amaxes = family_calibration(folded, x, family=jfastnet, blocked=False, percentile=99.8)
    return [float(s) for s in jq8.scales_from_amaxes(np.asarray(amaxes))]


@pytest.fixture(scope="module")
def jax_site_inputs(weights, scales):
    """taps(params, images): every site's input to `fake_quant_act` in the
    JAX package's fake-quant forward (one program, traced once)."""
    state = weights[1]
    real = jq8.fake_quant_act

    def forward(p, x):
        taps = []

        def tap(xx, scale):
            taps.append(xx)
            return real(xx, scale)

        jq8.fake_quant_act = tap  # traced once, inside this function only
        try:
            jfastnet.apply_logits_fake_quant(p, state, scales, x)
        finally:
            jq8.fake_quant_act = real
        return taps

    program = jax.jit(forward)
    return lambda params, images: [np.array(t) for t in program(params, np.asarray(jax_normalize(images)))]


def test_qat_train_step_matches_jax(weights, scales, batches, jax_site_inputs, monkeypatch):
    jstep = jsteps.make_qat_train_step(jfastnet, jax_get_loss("Lovasz"), optax.adam(LR), scales, augment=False)
    params, state = weights
    opt_state = optax.adam(LR).init(params)
    want_losses, want_params = [], [params]
    for images, masks in batches:
        params, new_state, opt_state, loss, _ = jstep(params, state, opt_state, jax.random.PRNGKey(0), images, masks)
        want_losses.append(float(loss))
        want_params.append(_np(params))
        for got, want in zip(jax.tree_util.tree_leaves(new_state), jax.tree_util.tree_leaves(state)):
            assert np.array_equal(got, want)

    params, state = checkpoint.from_jax(*weights)
    state_bits = [t.clone() for t in checkpoint.tree_leaves(state)]
    optimizer = optim.adam(params, LR)
    step = steps.make_qat_train_step(fastnet, get_loss("Lovasz"), optimizer, scales, augment=False)
    opt_state = optax.adam(LR).init(_flat(jax.tree_util.tree_leaves(weights[0])))
    losses, errs, first = [], [], None
    for i, (images, masks) in enumerate(batches):
        before = _flat([p.detach().numpy() for p in checkpoint.tree_leaves(params)])
        with monkeypatch.context() as patch:
            site_errs = forcing(patch, jax_site_inputs(want_params[i], images))
            new_state, loss, counts = step(params, state, images, masks)
        assert len(site_errs) == 15 and new_state is state
        errs.append(max(site_errs))
        opt_state = check_optax_step(params, optimizer, before, opt_state)
        losses.append(float(loss))
        assert counts.dtype == torch.int32 and int(counts.sum()) == masks.size
        first = first or [p.detach().numpy().copy() for p in checkpoint.tree_leaves(params)]
    print("QAT losses: port {} JAX {}; site inputs within {} of JAX's by step".format(losses, want_losses, errs))
    assert errs[0] <= 1e-5
    assert abs(losses[0] - want_losses[0]) <= 1e-4 * abs(want_losses[0])
    for i in (1, 2):
        assert abs(losses[i] - want_losses[i]) <= 1e-3 * abs(want_losses[i])
    assert optimizer.count == STEPS
    for got, want in zip(checkpoint.tree_leaves(state), state_bits):
        assert got.view(torch.int32).equal(want.view(torch.int32))
    cos, ratio = update_agreement(first, jax.tree_util.tree_leaves(want_params[1]),
                                  jax.tree_util.tree_leaves(weights[0]))
    print("QAT: step-1 update vs JAX cosine {}, norm ratio {}".format(cos, ratio))
    assert cos >= 0.98 and abs(ratio - 1) <= 0.01, (cos, ratio)


def _fast_configs(root, name):
    """(model TOML, dataset TOML): config/model-fast.toml on the CPU,
    float32, batch 2 at 64 px, one epoch, checkpoints under root/name."""
    base = load_config(os.path.join(ROOT, "config", "model-fast.toml"))
    model = {**base, "common": {**base["common"], "cuda": False, "bf16": False, "batch_size": 2, "image_size": SIZE,
                                "checkpoint": os.path.join(root, name)},
             "opt": {**base["opt"], "epochs": 1}}
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = root
    paths = os.path.join(root, name + ".toml"), os.path.join(root, name + "-dataset.toml")
    save_config(model, paths[0])
    save_config(dataset, paths[1])
    return paths


@pytest.fixture(scope="module")
def tool_runs(tmp_path_factory, teacher):
    """`train` with model = 'fast' for one epoch, then `--teacher` (a U-Net
    checkpoint and TOML), then `--qat` from the first run's checkpoint."""
    root = str(tmp_path_factory.mktemp("slippy_fast"))
    _write_split(root, "training", 4, seed=50, size=SIZE)
    _write_split(root, "validation", 2, seed=51, size=SIZE)
    teacher_ckpt = os.path.join(root, "teacher.npz")
    jcheckpoint.save_checkpoint(teacher_ckpt, {"params": teacher[0], "state": teacher[1]}, meta={"epoch": 1})
    unet_toml = os.path.join(root, "unet.toml")
    save_config(load_config(os.path.join(ROOT, "config", "model-unet.toml")), unet_toml)
    runs = {}
    for name, flags in (("plain", {}), ("teacher", {"teacher": teacher_ckpt, "teacher_model": unet_toml}),
                        ("qat", {"qat": True, "checkpoint": os.path.join(root, "plain", "checkpoint-00001-of-00001.npz")})):
        model_toml, dataset_toml = _fast_configs(root, name)
        out = train.main(_args(model_toml, dataset_toml, workers=2, **flags))
        runs[name] = (out, os.path.join(root, name))
    return root, teacher_ckpt, runs


@pytest.mark.parametrize("name", ["plain", "teacher", "qat"])
def test_train_tool_fast(tool_runs, name):
    root, teacher_ckpt, runs = tool_runs
    out, run_dir = runs[name]
    assert (out["steps"], out["count"]) == (2, 2)
    lines = open(os.path.join(run_dir, "log")).read().splitlines()
    path = os.path.join(run_dir, "checkpoint-00001-of-00001.npz")
    params, state, meta = jcheckpoint.load_model_checkpoint(path, num_classes=2)
    trees, _ = jcheckpoint.load_checkpoint(path)
    opt_state = jcheckpoint.leaves_to_opt_state(optax.adam(LR).init(params), trees["opt_state"])
    assert int(opt_state[0].count) == 2
    assert sorted(params) == sorted(jfastnet.init(0, num_classes=2)[0]) and sorted(state) == sorted(
        "{}_bn".format(n) for n in jfastnet._ENC)
    tparams, tstate, _ = checkpoint.load_model_checkpoint(path)
    for got, want in zip(checkpoint.tree_leaves(tparams) + checkpoint.tree_leaves(tstate),
                         jax.tree_util.tree_leaves(params) + jax.tree_util.tree_leaves(state)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    if name == "teacher":
        assert "Distilling from: {} (alpha 0.9, T 2.0)".format(teacher_ckpt) in lines
    if name != "qat":
        assert "qat_amaxes" not in meta
        return
    assert "QAT finetune: 15 int8 sites, int8_calibration = 99.8 (frozen)" in lines
    assert meta["qat_calibration"] == "99.8" and len(meta["qat_amaxes"]) == 15
    # The JAX package's calibration of the finetuned checkpoint's weights on the tool's first shuffled batch.
    start, start_state, _ = jcheckpoint.load_model_checkpoint(os.path.join(root, "plain",
                                                                           "checkpoint-00001-of-00001.npz"))
    dataset = SlippyMapTilesConcatenation([os.path.join(root, "training", "images")],
                                          os.path.join(root, "training", "labels"), size=SIZE)
    images = next(iter(load_batches(dataset, 2, shuffle=True, drop_last=True, workers=2, seed=0))).arrays[0]
    want = family_calibration_raw(jax.jit(jfastnet.fold)(start, start_state), images, family=jfastnet, percentile=99.8)
    np.testing.assert_allclose(meta["qat_amaxes"], np.asarray(want), rtol=1e-5)
    for got, want in zip(jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(start_state)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
