"""`train` — fit the U-Net, the fast family, DeepLabv3+ or SegFormer to a slippy-map dataset.

The port of `rs train` (robosat_tpu/tools/train.py), with its flags,
messages, log lines and files: the two-TOML configuration, the four
losses, class weights required for CrossEntropy/mIoU/Focal, per-epoch
`checkpoint-EEEEE-of-TTTTT.npz` (params, state, the optimizer state as
optax.adam's leaves, meta epoch) and `history-EEEEE-of-TTTTT.png` files,
and `--checkpoint`/`--resume`. Checkpoints cross between the packages: the
JAX tool resumes this one's, and this one resumes the JAX tool's.

It trains on the config's device (`cuda = true`: the GPU, or an error
without one; `cuda = false`: the CPU). Each step (parallel/steps.py)
augments, normalizes, runs the forward in the compute dtype (`bf16`), the
loss, the backward and the port's optax Adam on the device; `remat`
recomputes the forward in the backward. Input is copied from pinned host
memory without waiting, and the loop keeps a one-step-deep value pipeline
as the JAX tool does: step k's loss and confusion counts start back to the
host behind an event and are read once step k + 1 is issued. `--profile
DIR` records the epochs with torch.profiler, one `train_step` range per
step, and writes a trace for TensorBoard's profile plugin to DIR.

`--qat` finetunes `--checkpoint` through the int8 datapath's rounding
(parallel/steps.make_qat_train_step): the site scales (the U-Net's 59,
the fast family's 15, from `calibration_amaxes_int8` where the model has
it) are calibrated once,
on the first shuffled training batch, at the config's per-tensor
`int8_calibration`, frozen into the step, and written into every
checkpoint's meta (`qat_amaxes`, `qat_calibration`), which `predict`
quantizes with; `--resume` calibrates again from the loaded weights, as
the JAX tool does. `--teacher` distills from a trained checkpoint of
`--teacher_model`'s family (default `--model`'s), folded once
(make_distill_train_step): a U-Net teacher distils a fast student, as
config/model-fast.toml's header trains it. DeepLabv3+ and SegFormer
train and distil through their `apply`; neither has a fake-quant forward,
so `--qat` exits with the JAX tool's message. SegFormer has no folded
forward either: as a `--teacher_model` family it exits here, where the JAX
tool fails in its step. A reference `.pth` converts as
a U-Net whatever `model` says, as the JAX loader does. Validation runs the float eval step in either
mode.

Several devices: launched as N processes with RS_COORDINATOR,
RS_NUM_PROCESSES and RS_PROCESS_ID set (parallel/mesh.py; one process per
GPU, NCCL, or gloo with `cuda = false`), the batch size is rounded up to a
multiple of N as the global batch, every rank walks the same shuffled order
and loads its rows of each batch, and the steps take the JAX package's
mesh semantics: `sync_bn = true` (the default) global batch statistics, a
global loss and summed gradients; `sync_bn = false` per-rank statistics
and averaged gradients, losses and statistics; `--qat` per-rank, and
`--teacher` and validation global. Rank 0 alone writes the log, the
checkpoints and the chart. Without RS_COORDINATOR it trains on one device.

The augmentation draws from a torch.Generator seeded per epoch from the
config's `seed` (and, where each rank augments its rows alone, the rank):
other flips and rotations than the JAX tool's for the same seed, from the
same distribution. Without matplotlib the history chart is not written,
and the log says so once.
"""

import argparse
import collections
import os
import sys

import numpy as np
import torch
from tqdm import tqdm

from robosat_tpu_torch.checkpoint import (
    from_jax,
    leaves_to_opt_state,
    load_checkpoint,
    load_model_checkpoint,
    opt_state_to_leaves,
    save_checkpoint,
    to_jax,
)
from robosat_tpu_torch.config import load_config
from robosat_tpu_torch.data.datasets import SlippyMapTilesConcatenation
from robosat_tpu_torch.data.loader import batches
from robosat_tpu_torch.device import Dispatched, configure_device, profiler
from robosat_tpu_torch.log import Log
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.ops.augment import normalize
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.ops.metrics import Metrics
from robosat_tpu_torch.optim import adam
from robosat_tpu_torch.parallel.mesh import create_mesh
from robosat_tpu_torch.parallel.steps import (
    make_distill_train_step,
    make_eval_step,
    make_qat_train_step,
    make_train_step,
)
from robosat_tpu_torch.utils.plot import plot


def add_parser(subparser):
    parser = subparser.add_parser(
        "train", help="fits the segmentation model to a dataset", formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )

    parser.add_argument("--model", type=str, required=True, help="path to model configuration file")
    parser.add_argument("--dataset", type=str, required=True, help="path to dataset configuration file")
    parser.add_argument("--checkpoint", type=str, required=False, help="warm-start weights from this checkpoint")
    parser.add_argument("--resume", type=bool, default=False, help="also restore optimizer state and epoch counter")
    parser.add_argument("--workers", type=int, default=0, help="decode worker threads")
    parser.add_argument("--profile", type=str, default=None, help="write a TensorBoard device trace to this directory")
    parser.add_argument(
        "--teacher",
        type=str,
        default=None,
        help="distill from this trained checkpoint (e.g. a flagship U-Net) instead of training from labels alone",
    )
    parser.add_argument(
        "--teacher_model",
        type=str,
        default=None,
        help="model TOML of the teacher checkpoint (defaults to --model, i.e. same family)",
    )
    parser.add_argument("--distill_alpha", type=float, default=0.9, help="soft-target weight in the distillation loss")
    parser.add_argument("--distill_temp", type=float, default=2.0, help="distillation softmax temperature")
    parser.add_argument(
        "--qat",
        action="store_true",
        help="quantization-aware finetune of --checkpoint: the forward fake-quantizes every int8 "
        "site (frozen calibrated scales, straight-through gradients) so the optimizer descends "
        "the int8 datapath's own loss; the scales ship in checkpoint meta for `rs predict`",
    )

    parser.set_defaults(func=main)


def _epoch_generator(seed, epoch, device, rank=None):
    """The augmentation stream of one epoch (of one `rank`, where each rank
    augments its rows alone): a resumed run draws what an uninterrupted one
    would."""
    seq = np.random.SeedSequence([int(seed), int(epoch)] + ([] if rank is None else [int(rank)]))
    return torch.Generator(device=device).manual_seed(int(seq.generate_state(1, np.uint64)[0]))


def main(args):
    model_config = load_config(args.model)
    dataset_config = load_config(args.dataset)
    common = model_config["common"]

    device = configure_device(common["cuda"])
    mesh = create_mesh(device)
    if mesh is not None:
        device = mesh.device
    writer = mesh is None or mesh.rank == 0

    num_classes = len(dataset_config["common"]["classes"])
    os.makedirs(common["checkpoint"], exist_ok=True)

    loss_name = model_config["opt"]["loss"]
    weight = None
    try:
        weight = np.asarray(dataset_config["weights"]["values"], np.float32)
    except KeyError:
        if loss_name in ("CrossEntropy", "mIoU", "Focal"):
            sys.exit("Error: The loss function used, need dataset weights values")

    try:
        loss_fn = get_loss(loss_name)
    except ValueError:
        sys.exit("Error: Unknown [opt][loss] value !")

    model = get_model(common.get("model", "unet"))
    params, state = model.init(common.get("seed", 0), num_classes)
    params, state = from_jax(to_jax(params), to_jax(state), device)

    resume_epoch = 0
    opt_leaves = None
    if args.checkpoint:
        params, state, meta = load_model_checkpoint(args.checkpoint, num_classes, device=device)
        if args.resume:
            trees, meta = load_checkpoint(args.checkpoint)
            opt_leaves = trees.get("opt_state")
            resume_epoch = int(meta.get("epoch", 0))

    optimizer = adam(params, model_config["opt"]["lr"])
    if opt_leaves is not None:
        leaves_to_opt_state(optimizer, opt_leaves)
    restored_count = optimizer.count

    num_epochs = model_config["opt"]["epochs"]
    if resume_epoch >= num_epochs:
        sys.exit("Error: Epoch {} set in {} already reached by the checkpoint provided".format(num_epochs, args.model))

    size = 1 if mesh is None else mesh.size
    batch_size = -(-common["batch_size"] // size) * size
    sync_bn = common.get("sync_bn", True)
    image_size = common["image_size"]
    compute_dtype = torch.bfloat16 if common.get("bf16", False) else torch.float32
    teacher_folded = None
    # getattr: callers may drive main() with bare Namespaces without these flags.
    teacher_path = getattr(args, "teacher", None)
    distill_alpha = getattr(args, "distill_alpha", 0.9)
    distill_temp = getattr(args, "distill_temp", 2.0)
    qat_mode = getattr(args, "qat", False)
    if qat_mode:
        if not args.checkpoint:
            sys.exit("Error: --qat finetunes a trained model; provide --checkpoint")
        if teacher_path:
            sys.exit("Error: --qat and --teacher are mutually exclusive")
        if not hasattr(model, "apply_logits_fake_quant"):
            sys.exit("Error: --qat needs a family with a fake-quant forward (apply_logits_fake_quant): unet or fast")
        train_step = None  # built below: calibration needs one real training batch
    elif teacher_path:
        teacher_model_path = getattr(args, "teacher_model", None)
        teacher_config = load_config(teacher_model_path) if teacher_model_path else model_config
        teacher_model = get_model(teacher_config["common"].get("model", "unet"))
        if not hasattr(teacher_model, "apply_folded"):
            sys.exit("Error: --teacher needs a teacher family with a folded forward (apply_folded): "
                     "unet, fast or deeplabv3plus")
        t_params, t_state, _ = load_model_checkpoint(teacher_path, num_classes, device=device)
        with torch.no_grad():
            teacher_folded = teacher_model.fold(t_params, t_state)
        del t_params, t_state
        train_step = make_distill_train_step(model, teacher_model, loss_fn, optimizer, weight=weight,
                                             compute_dtype=compute_dtype, remat=common.get("remat", False),
                                             alpha=distill_alpha, temp=distill_temp, mesh=mesh)
    else:
        train_step = make_train_step(model, loss_fn, optimizer, weight=weight, compute_dtype=compute_dtype,
                                     remat=common.get("remat", False), mesh=mesh, sync_bn=sync_bn)
    eval_step = make_eval_step(model, loss_fn, weight=weight, compute_dtype=compute_dtype, mesh=mesh)

    path = dataset_config["common"]["dataset"]
    train_dataset = SlippyMapTilesConcatenation(
        [os.path.join(path, "training", "images")], os.path.join(path, "training", "labels"), size=image_size
    )
    val_dataset = SlippyMapTilesConcatenation(
        [os.path.join(path, "validation", "images")], os.path.join(path, "validation", "labels"), size=image_size
    )
    assert len(train_dataset) > 0, "at least one tile in training dataset"
    assert len(val_dataset) > 0, "at least one tile in validation dataset"

    history = collections.defaultdict(list)
    log = Log(os.path.join(common["checkpoint"], "log")) if writer else Log(os.devnull, out=None)

    log.log("--- Hyper Parameters on Dataset: {} ---".format(dataset_config["common"]["dataset"]))
    log.log("Batch Size:\t {}".format(common["batch_size"]))
    log.log("Image Size:\t {}".format(image_size))
    log.log("Learning Rate:\t {}".format(model_config["opt"]["lr"]))
    log.log("Loss function:\t {}".format(loss_name))
    if teacher_path:
        log.log("Distilling from: {} (alpha {}, T {})".format(teacher_path, distill_alpha, distill_temp))
    if weight is not None:
        log.log("Weights :\t {}".format(dataset_config["weights"]["values"]))
    log.log("---")

    qat_meta = {}
    if qat_mode:
        # Calibrate once on one real training batch, freeze the scales into
        # the step and record them in checkpoint meta: predict quantizes
        # with exactly these, not a fresh calibration of the moved weights.
        calib_spec = common.get("int8_calibration", 99.8)
        if q8.is_per_channel(calib_spec):
            sys.exit("Error: --qat uses per-tensor site scales; set int8_calibration to a percentile/mse/mae/amax")
        pct = q8.calibration_spec(calib_spec)
        # With several ranks: the whole first global batch, on rank 0,
        # broadcast, so every rank freezes the same scales.
        amaxes = None
        if writer:
            calib_images = next(iter(batches(train_dataset, batch_size, shuffle=True, drop_last=True, workers=2,
                                             seed=0))).arrays[0]
            calibrate = getattr(model, "calibration_amaxes_int8", q8.calibration_amaxes)
            with torch.no_grad():
                folded = model.fold(params, state)
                amaxes = calibrate(folded, normalize(torch.as_tensor(calib_images).to(device)),
                                   percentile=pct).numpy()
                del folded
        if mesh is not None:
            amaxes = mesh.broadcast_object(amaxes)
        qat_meta = {"qat_amaxes": [float(a) for a in amaxes], "qat_calibration": str(calib_spec)}
        train_step = make_qat_train_step(model, loss_fn, optimizer, list(q8.scales_from_amaxes(amaxes)),
                                         weight=weight, compute_dtype=compute_dtype, mesh=mesh)
        log.log("QAT finetune: {} int8 sites, int8_calibration = {} (frozen)".format(len(amaxes), calib_spec))

    def host(array):
        """A batch array as a tensor, pinned on the card's machine so that
        the step's copy does not wait."""
        t = torch.from_numpy(array)
        return t.pin_memory() if device.type == "cuda" else t

    def dispatch(loss, counts, valid):
        # float64 holds the float32 loss and the int32 counts exactly. The
        # loaders drop short batches, so every rank holds `valid` real rows.
        return Dispatched(torch.cat([loss.double().view(1), counts.double()])), valid * size

    # Each rank augments its rows alone where the step is the JAX package's
    # shard_map (sync_bn = false, --qat), from the global batch's draws otherwise.
    local_augment = mesh is not None and (qat_mode or (not sync_bn and not teacher_path))

    steps = 0
    chart_missing_logged = False
    with profiler(args.profile, device):
        for epoch in range(resume_epoch, num_epochs):
            log.log("Epoch: {}/{}".format(epoch + 1, num_epochs))

            metrics = Metrics(range(num_classes))
            running_loss, num_samples = 0.0, 0

            def drain(pending):
                nonlocal running_loss, num_samples
                handle, valid = pending
                values = handle.fetch()
                running_loss += float(values[0])
                metrics.add_counts(values[1:].astype(np.int64))
                num_samples += valid

            # Train pass, one step deep: step k's values are read once step
            # k + 1 is issued (robosat_tpu/tools/train.py).
            generator = _epoch_generator(common.get("seed", 0), epoch, device, mesh.rank if local_augment else None)
            pending = None
            for batch in tqdm(
                batches(train_dataset, batch_size, shuffle=True, drop_last=True, workers=max(args.workers, 2),
                        seed=epoch, mesh=mesh),
                total=len(train_dataset) // batch_size,
                desc="Train",
                unit="batch",
                ascii=True,
                disable=not writer,
            ):
                images, masks = batch.arrays
                with torch.profiler.record_function("train_step"):
                    if teacher_folded is not None:
                        state, loss, counts = train_step(params, state, teacher_folded, host(images), host(masks),
                                                         generator)
                    else:
                        state, loss, counts = train_step(params, state, host(images), host(masks), generator)
                if pending is not None:
                    drain(pending)
                pending = dispatch(loss, counts, batch.valid)
                steps += 1
            if pending is not None:
                drain(pending)

            train_hist = {
                "loss": running_loss / max(num_samples, 1),
                "miou": metrics.get_miou(),
                "fg_iou": metrics.get_fg_iou(),
                "mcc": metrics.get_mcc(),
            }
            log.log(
                "Train    loss: {:.4f}, mIoU: {:.3f}, {} IoU: {:.3f}, MCC: {:.3f}".format(
                    train_hist["loss"],
                    train_hist["miou"],
                    dataset_config["common"]["classes"][1],
                    train_hist["fg_iou"],
                    train_hist["mcc"],
                )
            )
            for k, v in train_hist.items():
                history["train " + k].append(v)

            # Validation pass, the same pipeline.
            metrics = Metrics(range(num_classes))
            running_loss, num_samples = 0.0, 0
            pending = None
            for batch in tqdm(
                batches(val_dataset, batch_size, drop_last=True, workers=max(args.workers, 2), mesh=mesh),
                total=len(val_dataset) // batch_size,
                desc="Validate",
                unit="batch",
                ascii=True,
                disable=not writer,
            ):
                images, masks = batch.arrays
                loss, counts = eval_step(params, state, host(images), host(masks))
                if pending is not None:
                    drain(pending)
                pending = dispatch(loss, counts, batch.valid)
            if pending is not None:
                drain(pending)

            val_hist = {
                "loss": running_loss / max(num_samples, 1),
                "miou": metrics.get_miou(),
                "fg_iou": metrics.get_fg_iou(),
                "mcc": metrics.get_mcc(),
            }
            log.log(
                "Validate loss: {:.4f}, mIoU: {:.3f}, {} IoU: {:.3f}, MCC: {:.3f}".format(
                    val_hist["loss"], val_hist["miou"], dataset_config["common"]["classes"][1], val_hist["fg_iou"],
                    val_hist["mcc"]
                )
            )
            for k, v in val_hist.items():
                history["val " + k].append(v)

            if not writer:
                continue
            visual = "history-{:05d}-of-{:05d}.png".format(epoch + 1, num_epochs)
            try:
                plot(os.path.join(common["checkpoint"], visual), history)
            except ImportError:
                if not chart_missing_logged:
                    log.log("History chart not written: matplotlib is not installed")
                    chart_missing_logged = True

            checkpoint_name = "checkpoint-{:05d}-of-{:05d}.npz".format(epoch + 1, num_epochs)
            save_checkpoint(
                os.path.join(common["checkpoint"], checkpoint_name),
                {"params": to_jax(params), "state": to_jax(state), "opt_state": opt_state_to_leaves(optimizer)},
                meta=dict({"epoch": epoch + 1}, **qat_meta),
            )
    log.close()

    return {"resume_epoch": resume_epoch, "restored_count": restored_count, "steps": steps,
            "count": optimizer.count, "history": dict(history)}


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    add_parser(parser.add_subparsers())
    main(parser.parse_args(sys.argv[1:]))
