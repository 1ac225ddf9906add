"""robosat_tpu_torch's `train` tool on the CPU, and its checkpoints in the JAX package.

- `train.main` for one epoch on a generated 32-px slippy-map dataset (P
  labels), then `--resume` from its checkpoint to epoch 2 (under
  `--profile`): the JAX tool's log lines, one checkpoint and one history
  chart per epoch, the restored step count, a `train_step` range per step
  in the trace. The JAX package's `load_model_checkpoint` and
  `leaves_to_opt_state` load the port's checkpoint: the same params and
  state, and optax's state with the port's count and moments.
- `sync_bn = false` trains exactly as `sync_bn = true` (one device: the
  batch is the global batch).
- Without matplotlib the history chart is not written and the log says so
  once.
- `--qat` from a checkpoint on a 64-px dataset (at 32 px enc4 is 1 x 1
  and the center site's input is empty): the log line, 59 `qat_amaxes`
  within 1e-5 relative of the JAX tool's on the same checkpoint and
  dataset (the same first shuffled batch, a float32 calibration whose
  convolutions sum in other orders), `qat_calibration` "99.8", the BN
  state of the checkpoint unchanged. The QAT checkpoints cross: the JAX
  tool's `--qat --resume` and int8 `predict` run from the port's, and
  the port's int8 `predict` quantizes with the JAX tool's `qat_amaxes`
  and calibrates nothing.
- `--teacher` (the tool's defaults alpha 0.9, T 2): JAX's log line, and a
  checkpoint the JAX package loads with its optimizer state.
- The parser's flags and defaults are the JAX tool's; `--qat` without
  `--checkpoint`, `--qat` with `--teacher` and a per-channel
  `int8_calibration` exit with the JAX tool's messages, and a
  `--teacher_model` of a family without a folded forward (SegFormer)
  exits before its checkpoint loads; CrossEntropy without
  class weights exits with the JAX tool's message; `cuda = true` without
  a GPU raises.
- One bfloat16 train step (the configured dtype) against the JAX
  package's, the loss within 2%.
"""

import argparse
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from robosat_tpu import checkpoint as jcheckpoint
from robosat_tpu.checkpoint import convert_torch_unet
from robosat_tpu.models import unet as junet
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel import steps as jsteps
from robosat_tpu.parallel.steps import make_train_step as jax_make_train_step
from robosat_tpu.tools import predict as jpredict
from robosat_tpu.tools import train as jtrain
from robosat_tpu_torch import checkpoint, optim
from robosat_tpu_torch.config import load_config, save_config
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import unet
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.parallel.steps import make_train_step
from robosat_tpu_torch.tools import predict, train
from test_torch_checkpoint import _reference_style_state_dict
from test_torch_port_train_forward import learnable_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32


def _write_split(root, split, n, seed, size=SIZE):
    """n aligned image/label tiles at z18: RGB PNGs and palette ("P") label
    PNGs with a bright square as class 1."""
    images, masks = learnable_batch(seed, batch=n, size=size)
    for i in range(n):
        x, y = 300 + i % 4, 400 + i // 4
        for sub, img in (("images", Image.fromarray(images[i])),
                         ("labels", Image.fromarray(masks[i].astype(np.uint8), mode="P"))):
            if sub == "labels":
                img.putpalette([0, 0, 0, 255, 255, 255])
            os.makedirs(os.path.join(root, split, sub, "18", str(x)), exist_ok=True)
            img.save(os.path.join(root, split, sub, "18", str(x), "{}.png".format(y)))


def _configs(root, name, epochs, weights=True, **common):
    """(model TOML, dataset TOML) paths: config/model-unet.toml on the CPU,
    float32, batch 2 at 32 px, checkpoints under root/name."""
    base = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    model = {**base, "common": {**base["common"], "cuda": False, "bf16": False, "batch_size": 2, "image_size": SIZE,
                                "checkpoint": os.path.join(root, name), **common},
             "opt": {**base["opt"], "epochs": epochs}}
    dataset = load_config(os.path.join(ROOT, "config", "dataset-parking.toml"))
    dataset["common"]["dataset"] = root
    if not weights:
        del dataset["weights"]
    model_toml = os.path.join(root, "{}-{}.toml".format(name, epochs))
    dataset_toml = os.path.join(root, "{}-dataset.toml".format(name))
    save_config(model, model_toml)
    save_config(dataset, dataset_toml)
    return model_toml, dataset_toml


def _args(model_toml, dataset_toml, **flags):
    """The tool parser's arguments for `train --model --dataset` with its
    defaults, then `flags` set on them."""
    parser = argparse.ArgumentParser()
    train.add_parser(parser.add_subparsers())
    args = parser.parse_args(["train", "--model", model_toml, "--dataset", dataset_toml])
    for key, value in flags.items():
        setattr(args, key, value)
    return args


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slippy"))
    _write_split(root, "training", 4, seed=20)
    _write_split(root, "validation", 2, seed=21)
    return root


@pytest.fixture(scope="module")
def trained(dataset):
    """Epoch 1, then --resume to epoch 2 under --profile."""
    out1 = train.main(_args(*_configs(dataset, "run", 1)))
    first = os.path.join(dataset, "run", "checkpoint-00001-of-00001.npz")
    trace_dir = os.path.join(dataset, "trace")
    out2 = train.main(_args(*_configs(dataset, "run", 2), checkpoint=first, resume=True, profile=trace_dir))
    return out1, out2, trace_dir


def test_train_then_resume_writes_the_jax_tools_files(dataset, trained):
    out1, out2, trace_dir = trained
    run = os.path.join(dataset, "run")
    assert (out1["resume_epoch"], out1["restored_count"], out1["steps"], out1["count"]) == (0, 0, 2, 2)
    assert (out2["resume_epoch"], out2["restored_count"], out2["steps"], out2["count"]) == (1, 2, 2, 4)
    assert {"checkpoint-00001-of-00001.npz", "checkpoint-00002-of-00002.npz", "log"} <= set(os.listdir(run))
    charts = {"history-00001-of-00001.png", "history-00002-of-00002.png"}
    assert charts <= set(os.listdir(run))
    lines = open(os.path.join(run, "log")).read().splitlines()
    header = ["--- Hyper Parameters on Dataset: {} ---".format(dataset), "Batch Size:\t 2", "Image Size:\t 32",
              "Learning Rate:\t 0.0001", "Loss function:\t Lovasz", "Weights :\t [1.6248, 5.762827]", "---"]
    assert lines[:7] == header and lines[10:17] == header
    assert lines[7] == "Epoch: 1/1" and lines[17] == "Epoch: 2/2"
    for line in (lines[8], lines[18]):
        assert line.startswith("Train    loss: ") and ", parking IoU: " in line and ", MCC: " in line
    for line in (lines[9], lines[19]):
        assert line.startswith("Validate loss: ")
    assert len(lines) == 20
    assert np.isfinite(out2["history"]["train loss"][0])

    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    events = json.load(open(os.path.join(trace_dir, traces[0])))["traceEvents"]
    assert sum(e.get("name") == "train_step" and e.get("cat") == "user_annotation" for e in events) == 2


def test_port_checkpoint_loads_in_jax(dataset, trained):
    """The JAX package reads the port's epoch-2 checkpoint as its own: the
    same params and state, and optax.adam's state with count 4."""
    path = os.path.join(dataset, "run", "checkpoint-00002-of-00002.npz")
    params, state, meta = jcheckpoint.load_model_checkpoint(path)
    trees, _ = jcheckpoint.load_checkpoint(path)
    assert meta == {"epoch": 2}
    optimizer = optax.adam(1e-4)
    opt_state = jcheckpoint.leaves_to_opt_state(optimizer.init(params), trees["opt_state"])
    assert int(opt_state[0].count) == 4
    assert jax.tree_util.tree_structure(opt_state[0].mu) == jax.tree_util.tree_structure(params)

    tparams, tstate, _ = checkpoint.load_model_checkpoint(path)
    for got, want in zip(checkpoint.tree_leaves(tparams) + checkpoint.tree_leaves(tstate),
                         jax.tree_util.tree_leaves(params) + jax.tree_util.tree_leaves(state)):
        assert np.array_equal(got.numpy(), want)
    # The checkpoint's moments are those of an optimizer resumed from it.
    resumed = checkpoint.leaves_to_opt_state(optim.adam(tparams, 1e-4), trees["opt_state"])
    for got, want in zip(checkpoint.opt_state_to_leaves(resumed), jcheckpoint.opt_state_to_leaves(opt_state)):
        assert np.array_equal(got, want)
    # And the JAX package's Adam takes a step from it.
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    updates, _ = jax.jit(optimizer.update)(grads, opt_state, params)
    assert all(np.all(np.isfinite(np.asarray(u))) for u in jax.tree_util.tree_leaves(updates))


def test_sync_bn_false_trains_the_same(dataset, trained):
    """One device: `sync_bn = false` (per-replica statistics on a mesh) has
    no replicas to differ, and the checkpoint equals sync_bn = true's."""
    train.main(_args(*_configs(dataset, "local-bn", 1, sync_bn=False)))
    got, _ = checkpoint.load_checkpoint(os.path.join(dataset, "local-bn", "checkpoint-00001-of-00001.npz"))
    want, _ = checkpoint.load_checkpoint(os.path.join(dataset, "run", "checkpoint-00001-of-00001.npz"))
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(jax.tree_util.tree_leaves(want)) > 3 * 160
    for g, w in zip(leaves, jax.tree_util.tree_leaves(want)):
        assert np.array_equal(g, w)


def test_history_chart_without_matplotlib(dataset, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    train.main(_args(*_configs(dataset, "no-chart", 2)))
    run = os.path.join(dataset, "no-chart")
    assert not [f for f in os.listdir(run) if f.startswith("history-")]
    lines = open(os.path.join(run, "log")).read().splitlines()
    assert lines.count("History chart not written: matplotlib is not installed") == 1
    assert "checkpoint-00002-of-00002.npz" in os.listdir(run)


QAT_SIZE = 64


def _parser_defaults(module):
    parser = argparse.ArgumentParser()
    module.add_parser(parser.add_subparsers())
    sub = parser._subparsers._group_actions[0].choices["train"]
    return {a.dest: (a.default, a.help, type(a).__name__) for a in sub._actions if a.dest != "help"}


def test_parser_flags_and_defaults_are_the_jax_tools():
    got, want = _parser_defaults(train), _parser_defaults(jtrain)
    assert got == want
    assert (got["distill_alpha"][0], got["distill_temp"][0], got["qat"][0]) == (0.9, 2.0, False)


@pytest.fixture(scope="module")
def dataset64(tmp_path_factory):
    """4 training and 2 validation tiles of 64 px, and a checkpoint of the
    reference-layout weights (meta epoch 1) to finetune and to teach from;
    removed with the checkpoints the tests write there (~450 MB each)."""
    root = str(tmp_path_factory.mktemp("slippy64"))
    _write_split(root, "training", 4, seed=30, size=QAT_SIZE)
    _write_split(root, "validation", 2, seed=31, size=QAT_SIZE)
    params, state = jax.tree_util.tree_map(np.asarray, convert_torch_unet(_reference_style_state_dict()))
    jcheckpoint.save_checkpoint(os.path.join(root, "trained"), {"params": params, "state": state}, meta={"epoch": 1})
    yield root
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("case", ["no_checkpoint", "with_teacher", "per_channel", "teacher_family"])
def test_qat_and_teacher_error_paths(dataset64, case):
    trained = os.path.join(dataset64, "trained.npz")
    model_toml, dataset_toml = _configs(dataset64, "errors", 1, image_size=QAT_SIZE,
                                        int8_calibration="pc99.8" if case == "per_channel" else 99.8)
    flags = {"no_checkpoint": {"qat": True}, "with_teacher": {"qat": True, "checkpoint": trained, "teacher": trained},
             "per_channel": {"qat": True, "checkpoint": trained}}.get(case)
    if case == "teacher_family":
        teacher_toml = os.path.join(dataset64, "teacher-segformer.toml")
        config = load_config(model_toml)
        config["common"]["model"] = "segformer"
        save_config(config, teacher_toml)
        with pytest.raises(SystemExit) as exc:
            train.main(_args(model_toml, dataset_toml, teacher=trained, teacher_model=teacher_toml))
        assert str(exc.value) == ("Error: --teacher needs a teacher family with a folded forward (apply_folded): "
                                  "unet, fast or deeplabv3plus")
        return
    message = {"no_checkpoint": "Error: --qat finetunes a trained model; provide --checkpoint",
               "with_teacher": "Error: --qat and --teacher are mutually exclusive",
               "per_channel": "Error: --qat uses per-tensor site scales; set int8_calibration to a "
                              "percentile/mse/mae/amax"}[case]
    with pytest.raises(SystemExit) as exc:
        train.main(_args(model_toml, dataset_toml, **flags))
    assert str(exc.value) == message


@pytest.fixture(scope="module")
def qat_runs(dataset64):
    """`train --qat` for one epoch from the trained checkpoint, by the port
    and by the JAX tool (float32, batch 2, 64 px); their checkpoints."""
    trained = os.path.join(dataset64, "trained.npz")
    out = {}
    for name, tool in (("port", train), ("jax", jtrain)):
        model_toml, dataset_toml = _configs(dataset64, "qat-" + name, 1, image_size=QAT_SIZE)
        tool.main(_args(model_toml, dataset_toml, checkpoint=trained, qat=True, workers=2))
        out[name] = os.path.join(dataset64, "qat-" + name, "checkpoint-00001-of-00001.npz")
    return out


def test_qat_checkpoint_matches_the_jax_tools(dataset64, qat_runs):
    got_trees, got = checkpoint.load_checkpoint(qat_runs["port"])
    _, want = jcheckpoint.load_checkpoint(qat_runs["jax"])
    assert set(got) == set(want) == {"epoch", "qat_amaxes", "qat_calibration"}
    assert got["epoch"] == want["epoch"] == 1 and got["qat_calibration"] == want["qat_calibration"] == "99.8"
    assert len(got["qat_amaxes"]) == len(want["qat_amaxes"]) == 59
    rel = np.max(np.abs(np.subtract(got["qat_amaxes"], want["qat_amaxes"])) / np.asarray(want["qat_amaxes"]))
    print("qat_amaxes port vs JAX tool: max relative difference {}".format(rel))
    np.testing.assert_allclose(got["qat_amaxes"], want["qat_amaxes"], rtol=1e-5)
    lines = open(os.path.join(dataset64, "qat-port", "log")).read().splitlines()
    want_lines = open(os.path.join(dataset64, "qat-jax", "log")).read().splitlines()
    assert "QAT finetune: 59 int8 sites, int8_calibration = 99.8 (frozen)" in lines

    def without_values(log):
        return [line for line in log if not line.startswith(("Train ", "Validate "))]

    assert without_values(lines) == without_values(want_lines)
    # Batch norm is frozen: the state is the trained checkpoint's, bit for bit.
    trained, _ = checkpoint.load_checkpoint(os.path.join(dataset64, "trained.npz"))
    for g, w in zip(jax.tree_util.tree_leaves(got_trees["state"]), jax.tree_util.tree_leaves(trained["state"])):
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


def test_qat_checkpoints_cross_packages(dataset64, qat_runs, monkeypatch):
    """The JAX tool resumes the port's QAT checkpoint (`--qat --resume`,
    epoch 2) and runs int8 predict from it; the port's int8 predict from
    the JAX tool's QAT checkpoint quantizes with its qat_amaxes."""
    port_qat, jax_qat = qat_runs["port"], qat_runs["jax"]
    _, port_meta = checkpoint.load_checkpoint(port_qat)
    model_toml, dataset_toml = _configs(dataset64, "qat-resume-jax", 2, image_size=QAT_SIZE)
    jtrain.main(_args(model_toml, dataset_toml, checkpoint=port_qat, resume=True, qat=True, workers=2))
    trees, meta = jcheckpoint.load_checkpoint(os.path.join(dataset64, "qat-resume-jax", "checkpoint-00002-of-00002.npz"))
    assert meta["epoch"] == 2 and len(meta["qat_amaxes"]) == 59 and int(trees["opt_state"][0]) == 4

    tiles = os.path.join(dataset64, "training", "images")
    model = load_config(os.path.join(ROOT, "config", "model-unet.toml"))
    model["common"].update(cuda=False, bf16=False)
    model_predict = os.path.join(dataset64, "predict.toml")
    save_config(model, model_predict)
    jax_meta = checkpoint.load_checkpoint(jax_qat)[1]
    monkeypatch.setattr(q8, "calibration_amaxes", None)  # the port's predict must not calibrate
    seen = {}
    for name, module, steps_module, ckpt, want in ((("jax", jpredict, jsteps, port_qat, port_meta["qat_amaxes"]),
                                                    ("port", predict, predict, jax_qat, jax_meta["qat_amaxes"]))):
        def spy(*args, real=steps_module.make_int8_predict_step, name=name, **kwargs):
            seen[name] = kwargs["calib_amaxes"]
            return real(*args, **kwargs)

        monkeypatch.setattr(steps_module, "make_int8_predict_step", spy)
        probs = os.path.join(dataset64, "probs-{}".format(name))
        module.main(argparse.Namespace(batch_size=2, checkpoint=ckpt, overlap=32, strip=1, tile_size=QAT_SIZE,
                                       workers=2, shard=None, tiles=tiles, probs=probs, model=model_predict,
                                       dataset=dataset_toml, profile=None, png_optimize=False))
        pngs = [f for _, _, files in os.walk(probs) for f in files if f.endswith(".png")]
        assert len(pngs) == 4, (name, pngs)
        np.testing.assert_array_equal(np.asarray(seen[name], np.float64), np.asarray(want, np.float64))


def test_teacher_writes_the_jax_tools_log_and_checkpoint(dataset64):
    trained = os.path.join(dataset64, "trained.npz")
    model_toml, dataset_toml = _configs(dataset64, "distilled", 1, image_size=QAT_SIZE)
    out = train.main(_args(model_toml, dataset_toml, teacher=trained, workers=2))
    assert (out["steps"], out["count"]) == (2, 2)
    lines = open(os.path.join(dataset64, "distilled", "log")).read().splitlines()
    assert lines[5] == "Distilling from: {} (alpha 0.9, T 2.0)".format(trained)
    assert lines[4] == "Loss function:\t Lovasz" and lines[6].startswith("Weights :\t ") and lines[7] == "---"
    path = os.path.join(dataset64, "distilled", "checkpoint-00001-of-00001.npz")
    params, state, meta = jcheckpoint.load_model_checkpoint(path)
    trees, _ = jcheckpoint.load_checkpoint(path)
    assert meta == {"epoch": 1}
    opt_state = jcheckpoint.leaves_to_opt_state(optax.adam(1e-4).init(params), trees["opt_state"])
    assert int(opt_state[0].count) == 2
    want, _, _ = checkpoint.load_model_checkpoint(trained)
    moved = [not np.array_equal(a, b.numpy()) for a, b in zip(jax.tree_util.tree_leaves(params),
                                                              checkpoint.tree_leaves(want))]
    assert sum(moved) > 150


def test_cuda_true_without_a_gpu_raises(dataset):
    """`cuda = true` trains on the card or not at all: no fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(_args(*_configs(dataset, "card", 1, cuda=True)))


def test_cross_entropy_without_weights_exits(dataset):
    model_toml, dataset_toml = _configs(dataset, "no-weights", 1, weights=False)
    config = load_config(model_toml)
    config["opt"]["loss"] = "CrossEntropy"
    save_config(config, model_toml)
    with pytest.raises(SystemExit, match="need dataset weights values"):
        train.main(_args(model_toml, dataset_toml))


def test_bf16_train_step_matches_jax():
    """One bfloat16 step (the configured dtype; parameters float32, cast at
    each conv) at 64 px: bf16 rounds in other places under oneDNN and XLA,
    so the loss is held to 2%."""
    params, state = jax.tree_util.tree_map(np.asarray, convert_torch_unet(_reference_style_state_dict()))
    images, masks = learnable_batch(6)
    optimizer = optax.adam(1e-4)
    step = jax_make_train_step(junet, jax_get_loss("Lovasz"), optimizer, compute_dtype=jnp.bfloat16, augment=False)
    _, want_state, _, want_loss, _ = step(params, state, optimizer.init(params), jax.random.PRNGKey(0), images, masks)

    tparams, tstate = checkpoint.from_jax(params, state)
    tstep = make_train_step(unet, get_loss("Lovasz"), optim.adam(tparams, 1e-4), compute_dtype=torch.bfloat16,
                            augment=False)
    got_state, got_loss, _ = tstep(tparams, tstate, images, masks)
    assert got_loss.dtype == torch.float32 and tparams["final"]["w"].dtype == torch.float32
    print("bf16 step loss: port {} JAX {}".format(float(got_loss), float(want_loss)))
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=0.02)
    np.testing.assert_allclose(got_state["encoder"]["bn1"]["mean"].numpy(),
                               np.asarray(want_state["encoder"]["bn1"]["mean"]), rtol=0.02, atol=5e-3)
