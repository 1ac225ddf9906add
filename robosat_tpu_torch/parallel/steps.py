"""The train, QAT, distillation, eval, predict and segment steps of the four families.

The families are the U-Net, the fast family, DeepLab and SegFormer.
Counterpart of robosat_tpu/parallel/steps.py's make_train_step,
make_qat_train_step, make_distill_train_step, make_eval_step,
make_predict_step, make_int8_predict_step, make_segment_step and
make_spatial_predict_step. PyTorch runs eagerly, so a step is a plain
function. With a `mesh` (parallel/mesh.py: one process per device) each
rank's step takes its rows of the global batch, and the steps keep the JAX
package's mesh semantics: the train step with `sync_bn` (pjit), the
distillation and eval steps take the global batch's statistics and loss;
the train step without `sync_bn` and the QAT step each rank's (shard_map),
averaged once at the end; the predict steps run each rank's rows, the int8
one on the whole first batch's calibration. The spatial step splits one
raster's height over the ranks instead, with halo exchanges.

The train step augments on the device, normalizes, runs the forward in the
compute dtype (the space-to-depth tail, `unet.apply_s2d`), takes
the loss on float32 logits, backpropagates, and updates with the port's
optax Adam (`optim.py`). The QAT step runs the fake-quant forward
(`unet.apply_logits_fake_quant`) with batch norm frozen; the distillation
step adds the soft targets of a folded teacher to the loss. The eval step
runs the forward with frozen batch norm. All return the loss and the
confusion counts on the device. The
predict steps run the forward with the BN fold. The float step runs the folded
forward as torch (cuDNN) convolutions and ends in the margin head, kernel
K1 (`fused_head`), or in the final 1x1 conv, a softmax and the digitize;
the segment step (`serve`) runs the same folded forward to the logits and
takes their argmax. The int8 step's stem stays bf16 (fine, or on 4x4 host-blocked input its
space-to-depth form); every int8 site after it is a CUDA kernel on the
GPU: K3/K4 for the 16 bottleneck blocks, K5 for the up-blocks, and per
`pallas_tail` the decoder's end:

- None or "full": K6 (dec4 + dec5 + head; for fine output, from fine
  input or with an odd overlap, at overlap 0, then the depth-to-space and
  the fine crop); without `fused_head`, K7 (dec4 + dec5), then the final
  1x1 conv, softmax and digitize on the fine grid;
- "tail": K7, then K1 on the blocked grid;
- "sep": dec3 through K8 into parity planes, K9 (dec4 + dec5 on the
  planes), then K1 on the doubly-blocked grid.

The fast family (models/fastnet.py) trains through `apply` (it has no
`apply_s2d`), QAT through its own `apply_logits_fake_quant`, and as a
distillation student of a U-Net teacher. Its float predict takes fine
input into its own sub-pixel head (`predict_quantized_folded`); its int8
predict is the model-owned protocol (`_model_int8_predict_step`): the
dense convs through rs_int8_conv (models/qconv.py), the up-convs through
K5, the head in torch ops. DeepLabv3+ (models/deeplab.py) takes the same
branches: it trains through `apply`, its float predict is its own
margin-then-resize head on fine input, and its int8 predict the
model-owned protocol (K3/K4 for the encoder, layer4 at dilation 2,
rs_int8_conv for ASPP and the decoder), returning fine uint8. SegFormer
(models/segformer.py) takes them too: its `fold` is the identity pair
(params, state), its float predict the same margin-then-resize head, its
int8 predict K2's dequant epilogue for its 51 dense and spatial-reduction
sites and rs_int8_conv for its 3 patch embeds.

A step copies its uint8 input to the device without waiting for it (from
pinned memory the copy is asynchronous), so a caller can issue the next
batch while the device runs this one.
"""

import inspect

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from robosat_tpu_torch.checkpoint import tree_leaves
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qdec, qtail
from robosat_tpu_torch.models.layers import depth_to_space2, height_sharded, sync_batch_norm
from robosat_tpu_torch.ops import head
from robosat_tpu_torch.ops.augment import IMAGENET_MEAN, IMAGENET_STD, augment_batch, normalize
from robosat_tpu_torch.ops.metrics import confusion_counts
from robosat_tpu_torch.ops.quantize import softmax_quantize

PALLAS_TAILS = (None, "full", "tail", "sep")


def _normalize_s2d4(raw48):
    """Normalize 4x4 space-to-depth uint8 input (N, H/4, W/4, 48): channel c
    is fine channel c % 3, so the statistics repeat 16 times (tuple
    repetition, not multiplication)."""
    return normalize(raw48, mean=IMAGENET_MEAN * 16, std=IMAGENET_STD * 16)


def _to_device(raw, device):
    """The uint8 batch on `device`, copied without waiting for the device."""
    return torch.as_tensor(raw).to(device, non_blocking=True)


def _class_weights(weight):
    """weight_on(device): the class weights as float32 on `device`, copied
    there once (a copy from pageable host memory waits for the device)."""
    copies = {}

    def weight_on(device):
        if weight is None:
            return None
        if device not in copies:
            copies[device] = torch.as_tensor(np.asarray(weight, np.float32)).to(device)
        return copies[device]

    return weight_on


def make_train_step(model, loss_fn, optimizer, weight=None, compute_dtype=torch.float32, augment=True, remat=False,
                    mesh=None, sync_bn=True):
    """One training step on the device of the params.

    `optimizer` is the port's Adam over the leaves of the params the step
    is given (`optim.adam(params, lr)`). Returns step(params, state,
    images_u8, masks, generator=None) -> (new_state, loss, counts): the
    params and the optimizer's state update in place; loss (float32) and
    counts ([tn, fn, fp, tp] int32) stay on the device, so a caller can
    fetch them after issuing the next step. Host inputs are copied to the
    device without waiting (asynchronous from pinned memory).

    `augment` draws flips and rotations from `generator`, a torch.Generator
    on the params' device. The forward is `model.apply_s2d` (the JAX
    package's default space-to-depth tail) where the model has it, else
    `model.apply`. `remat` recomputes the forward
    during the backward (torch.utils.checkpoint, non-reentrant, over the
    whole forward, as jax.checkpoint(forward)); the new BN statistics are
    those of the first forward, since the recomputation's outputs are
    discarded.

    With a `mesh` (parallel/mesh.py) each rank is given its rows of the
    global batch, and `sync_bn` picks the JAX package's semantics:

    - True (pjit over the global batch): augmentation draws the global
      batch's flips and turns from the generator, which every rank seeds
      alike; batch norm takes the global batch's statistics
      (`layers.sync_batch_norm`); the loss is the global batch's, taken on
      the logits and masks gathered from every rank (a class-weighted mean
      is not the mean of the ranks' means); the gradients and the counts
      are summed over ranks.
    - False (shard_map, the reference's DataParallel): each rank augments
      from its own generator and runs its rows alone, batch norm on its
      rows; then one trailing round averages the gradients, the loss and
      the BN running statistics over ranks and sums the counts.
    """
    weight_on = _class_weights(weight)
    global_batch = mesh is not None and sync_bn
    forward = _train_forward(model, remat, mesh if global_batch else None)

    def step(params, state, images, masks, generator=None):
        x, masks, device = _train_input(params, images, masks, augment, generator, compute_dtype,
                                        mesh if global_batch else None)
        optimizer.zero_grad(set_to_none=True)
        logits, new_state = forward(params, state, x)
        loss = loss_fn(*_loss_rows(mesh if global_batch else None, logits, masks), weight_on(device))
        loss.backward()
        counts = confusion_counts(logits.detach(), masks)
        loss = loss.detach()
        if mesh is not None:
            _reduce_step(mesh, params, counts, loss if not sync_bn else None,
                         new_state if not sync_bn else None)
        optimizer.step()
        return new_state, loss, counts

    return step


def _loss_rows(mesh, logits, masks):
    """The float32 logits and the masks the loss is taken on: this rank's,
    or with a mesh every rank's gathered (the logits with their gradient)."""
    if mesh is None:
        return logits.float(), masks
    return mesh.gather_rows(logits.float()), mesh.gather(masks)


def _reduce_step(mesh, params, counts, local_loss=None, local_state=None):
    """A mesh step's collectives after the backward: the gradients summed
    over ranks (a global loss) or averaged (`local_loss` given: each rank's
    own loss, then averaged too), the counts summed, and `local_state`'s
    running statistics averaged, all in place."""
    mesh.sum_grads_(tree_leaves(params), mean=local_loss is not None)
    mesh.sum_(counts)
    if local_loss is not None:
        mesh.mean_([local_loss] + ([] if local_state is None else tree_leaves(local_state)))


def _model_forward(model):
    """The model's train/eval forward, as the JAX steps pick it: the
    space-to-depth tail `apply_s2d` where the model has one (the U-Net),
    else `apply` (the fast family)."""
    return getattr(model, "apply_s2d", model.apply)


def _train_forward(model, remat, mesh=None):
    """forward(params, state, x) -> (logits, new_state): `_model_forward`
    in training mode, batch norm over `mesh`'s global batch where one is
    given, recomputed in the backward with `remat` (the recomputation
    enters the same context)."""
    forward = _model_forward(model)

    def run_forward(params, state, x):
        with sync_batch_norm(mesh):
            return forward(params, state, x, True)

    if not remat:
        return run_forward
    return lambda params, state, x: checkpoint(run_forward, params, state, x, use_reentrant=False)


def _train_input(params, images, masks, augment, generator, compute_dtype, mesh=None):
    """A uint8 batch and its masks on the params' device, augmented from
    `generator` (with `mesh`, this rank's share of the global batch's
    draws), normalized and cast: (x, masks, device)."""
    device = params["final"]["w"].device
    images, masks = _to_device(images, device), _to_device(masks, device)
    if augment:
        if generator is None:
            raise ValueError("augment draws from a torch.Generator: pass generator=")
        images, masks = augment_batch(generator, images, masks, mesh=mesh)
    return normalize(images).to(compute_dtype), masks, device


def make_qat_train_step(model, loss_fn, optimizer, scales, weight=None, compute_dtype=torch.float32, augment=True,
                        mesh=None):
    """One quantization-aware finetune step (`train --qat`) on the device
    of the params, with make_train_step's call shape: step(params, state,
    images_u8, masks, generator=None) -> (state, loss, counts).

    The forward is `model.apply_logits_fake_quant` in the compute dtype:
    batch norm folded in the graph at the running statistics, which stay
    frozen (the step returns the state it was given), and every int8 site
    quantize-dequantized with the static per-site `scales` (a host
    sequence fixed when the step is built: the calibration that `predict`
    must use) and live per-output-channel weight grids, through the
    straight-through estimator. The loss is taken on float32 logits, then
    the port's Adam updates the ordinary params in place.

    With a `mesh` each rank runs its rows alone (augmented from its own
    generator), then the gradients and the loss are averaged over ranks
    and the counts summed: the JAX package's shard_map step (BN is frozen,
    so there are no statistics to share).
    """
    weight_on = _class_weights(weight)
    scales = [float(s) for s in scales]

    def step(params, state, images, masks, generator=None):
        x, masks, device = _train_input(params, images, masks, augment, generator, compute_dtype)
        optimizer.zero_grad(set_to_none=True)
        logits = model.apply_logits_fake_quant(params, state, scales, x)
        loss = loss_fn(logits.float(), masks, weight_on(device))
        loss.backward()
        counts = confusion_counts(logits.detach(), masks)
        loss = loss.detach()
        if mesh is not None:
            _reduce_step(mesh, params, counts, loss)
        optimizer.step()
        return state, loss, counts

    return step


def distillation_loss(logits32, t_logits, masks, loss_fn, weight, alpha, temp):
    """The distillation loss of float32 student and teacher logits, summed
    in the JAX package's order: alpha * kd + (1 - alpha) * hard with

      kd = -mean(sum(softmax(teacher / T) * log_softmax(student / T))) * T^2

    (the KL divergence up to the teacher's entropy, which has no gradient;
    T^2 keeps the soft targets' gradients comparable across temperatures)
    and hard = loss_fn(student, masks, weight)."""
    soft_t = torch.softmax(t_logits / temp, dim=-1)
    log_s = torch.log_softmax(logits32 / temp, dim=-1)
    kd = -torch.mean(torch.sum(soft_t * log_s, dim=-1)) * (temp * temp)
    return alpha * kd + (1.0 - alpha) * loss_fn(logits32, masks, weight)


def make_distill_train_step(model, teacher_model, loss_fn, optimizer, weight=None, compute_dtype=torch.float32,
                            augment=True, remat=False, alpha=0.9, temp=2.0, mesh=None):
    """One knowledge-distillation step (`train --teacher`) on the device of
    the params: step(params, state, teacher_folded, images_u8, masks,
    generator=None) -> (new_state, loss, counts).

    The teacher (`teacher_model.apply_folded` over its BN-folded params
    `teacher_folded`) sees the same augmented, normalized batch as the
    student, without gradients, and its logits are cast to float32. The
    student, of this family or another, trains as in make_train_step
    (`apply_s2d` or `apply`, `remat`) on `distillation_loss`. With a
    `mesh`, the global batch's semantics of make_train_step's `sync_bn`
    (the JAX package's pjit step): shared augmentation draws, global batch
    statistics, the loss on the gathered student and teacher logits and
    masks, gradients and counts summed over ranks.
    """
    weight_on = _class_weights(weight)
    forward = _train_forward(model, remat, mesh)

    def step(params, state, teacher_folded, images, masks, generator=None):
        x, masks, device = _train_input(params, images, masks, augment, generator, compute_dtype, mesh)
        with torch.no_grad():
            t_logits = teacher_model.apply_folded(teacher_folded, x).float()
        optimizer.zero_grad(set_to_none=True)
        logits, new_state = forward(params, state, x)
        logits32, all_masks = _loss_rows(mesh, logits, masks)
        if mesh is not None:
            t_logits = mesh.gather(t_logits)
        loss = distillation_loss(logits32, t_logits, all_masks, loss_fn, weight_on(device), alpha, temp)
        loss.backward()
        counts = confusion_counts(logits.detach(), masks)
        if mesh is not None:
            _reduce_step(mesh, params, counts)
        optimizer.step()
        return new_state, loss.detach(), counts

    return step


def make_eval_step(model, loss_fn, weight=None, compute_dtype=torch.float32, mesh=None):
    """Validation on the device of the params, batch norm frozen at the
    running statistics: step(params, state, images_u8, masks) -> (loss,
    counts), both on the device. With a `mesh`, each rank's rows of the
    global batch: the loss on the logits and masks gathered from every
    rank, the counts summed over ranks."""
    weight_on = _class_weights(weight)
    forward = _model_forward(model)

    def step(params, state, images, masks):
        device = params["final"]["w"].device
        with torch.no_grad():
            images, masks = _to_device(images, device), _to_device(masks, device)
            logits, _ = forward(params, state, normalize(images).to(compute_dtype), False)
            loss = loss_fn(*_loss_rows(mesh, logits, masks), weight_on(device))
            counts = confusion_counts(logits, masks)
            if mesh is not None:
                mesh.sum_(counts)
            return loss, counts

    return step


def _crop(q, overlap):
    return q[:, overlap:-overlap, overlap:-overlap] if overlap else q


def make_predict_step(model, overlap=0, compute_dtype=torch.float32, fused_head=False, fold_bn=True, s2d=True,
                      host_s2d=False):
    """Float prediction: raw uint8 -> quantized foreground uint8.

    The forward runs in `compute_dtype` (float32 or bfloat16) over the
    BN-folded params, folded inside every call against the params passed.
    Without `fused_head` (the JAX package's default) it takes fine input
    and runs `model.apply_folded` to the logits, then the float32 softmax,
    the digitize and the crop (N, H - 2o, W - 2o). With `fused_head`, a
    model with its own fused head (`predict_quantized_folded`: the fast
    family's sub-pixel head) takes fine input and returns its fine uint8;
    for the U-Net `s2d` runs dec4 and dec5 on the parity-blocked
    half-resolution grid, and `host_s2d` (with `s2d`) takes 4x4
    host-blocked input (N, H/4, W/4, 48) and runs the blocked stem. Outputs:

    - host_s2d with an even overlap: blocked (N, H/2 - o, W/2 - o, 4);
    - otherwise fine (N, H - 2o, W - 2o), through the blocked head and a
      depth-to-space when `s2d` is on, the fine-grid head when it is off.

    Without `fold_bn` the forward runs over the params as they are, batch
    norm in eval mode, on fine input (`s2d` and `host_s2d` do not apply):
    with `fused_head`, a model's `apply_features` (the U-Net's) goes through
    the fine-grid head (N, H - 2o, W - 2o); otherwise `model.apply`, the
    softmax, the digitize and the crop.

    Returns step(params, state, raw, plain=False); `plain=True` runs the
    head's plain version instead of kernel K1. `step.folded(folded, raw,
    plain=False)` is the same step over params folded beforehand
    (`model.fold`) and a uint8 batch already on their device: what `export`
    traces, so that its program holds folded weights and runs no fold.

    On a mesh each rank gives the step its rows of the global batch
    (`data.loader.batches(mesh=)`) and gets its rows' output: a float step
    needs no collective, so it takes no mesh.
    """
    if not fold_bn:
        return _unfolded_predict_step(model, overlap, compute_dtype, fused_head)
    own_head = fused_head and hasattr(model, "predict_quantized_folded")
    use_s2d = s2d and fused_head and hasattr(model, "apply_features_folded_s2d")
    use_host_s2d = host_s2d and use_s2d
    blocked_out = use_host_s2d and overlap % 2 == 0

    def step(params, state, raw, plain=False):
        with torch.no_grad():
            return predict_folded(model.fold(params, state), _to_device(raw, params["final"]["w"].device), plain)

    def predict_folded(folded, raw, plain=False):
        margin = head.margin_head_plain if plain else head.margin_head
        with torch.no_grad():
            if not fused_head:
                return _crop(softmax_quantize(model.apply_folded(folded, normalize(raw).to(compute_dtype))), overlap)
            if own_head:
                return model.predict_quantized_folded(folded, normalize(raw).to(compute_dtype), overlap=overlap)
            w, b = folded["final"]["w"], folded["final"]["b"]
            if use_host_s2d:
                features = model.apply_features_folded_s2d_from48(folded, _normalize_s2d4(raw).to(compute_dtype))
            else:
                x = normalize(raw).to(compute_dtype)
                if not s2d:
                    return margin(model.apply_features_folded(folded, x), w, b, overlap, 1)
                features = model.apply_features_folded_s2d(folded, x)
            if blocked_out:
                return margin(features, w, b, overlap, 4)
            return head.fine_from_blocked(margin(features, w, b, 0, 4), overlap)

    step.folded = predict_folded
    return step


def _unfolded_predict_step(model, overlap, compute_dtype, fused_head):
    """make_predict_step's forward without folding batch norm."""
    features_head = fused_head and hasattr(model, "apply_features")

    def step(params, state, raw, plain=False):
        with torch.no_grad():
            x = normalize(_to_device(raw, params["final"]["w"].device)).to(compute_dtype)
            if features_head:
                features, _ = model.apply_features(params, state, x, train=False)
                margin = head.margin_head_plain if plain else head.margin_head
                return margin(features, params["final"]["w"], params["final"]["b"], overlap, 1)
            logits, _ = model.apply(params, state, x, train=False)
            return _crop(softmax_quantize(logits), overlap)

    return step


def make_spatial_predict_step(model, mesh, overlap=0, compute_dtype=torch.float32):
    """Whole-raster prediction with the raster's HEIGHT split over the ranks
    of `mesh`: the JAX package's make_spatial_predict_step, whose GSPMD
    partition inserts the halo exchanges every convolution needs at the
    splits, so that no rank sees a seam and the result is the unsplit
    forward's.

    step(params, state, raw u8 (N, H, W, 3)) -> quantized foreground
    uint8 (N, H - 2 overlap, W - 2 overlap), the whole raster on every
    rank: the U-Net's folded float forward with the space-to-depth tail
    (`apply_features_folded_s2d`, in `compute_dtype`) on this rank's
    H / size rows, its convolutions, max pools and transposed convolutions
    taking their halo rows from the neighbouring ranks
    (`layers.height_sharded`); then K1 (`head.margin_head`, groups 4) on
    the rank's blocked features, the blocked uint8 gathered from every
    rank, the depth-to-space and the crop. H must be a multiple of 64 times
    the world size, so that every rank's rows pool to whole rows down to
    the center block's 2x2 pool. Equal to make_predict_step(fused_head=True,
    fold_bn=True, s2d=True) on one process, up to float summation order.

    `step.head_inputs(params, state, raw)` is K1's input on this rank,
    (blocked features, final conv's w, b), for holding K1 against its
    plain version at this step's shape.
    """
    def head_inputs(params, state, raw):
        h = raw.shape[1]
        if h % (64 * mesh.size):
            raise ValueError("the raster's height {} must be a multiple of 64 x {} ranks".format(h, mesh.size))
        with torch.no_grad():
            folded = model.fold(params, state)
            x = normalize(_to_device(raw[:, mesh.rows(h)], params["final"]["w"].device)).to(compute_dtype)
            with height_sharded(mesh):
                features = model.apply_features_folded_s2d(folded, x)
        return features, folded["final"]["w"], folded["final"]["b"]

    def step(params, state, raw):
        with torch.no_grad():
            blocked = head.margin_head(*head_inputs(params, state, raw), 0, 4)
            return head.fine_from_blocked(mesh.gather(blocked, dim=1), overlap)

    step.head_inputs = head_inputs
    return step


def make_segment_step(model, compute_dtype=torch.float32):
    """Hard-mask prediction for serving on the device of the params:
    step(params, state, raw uint8 (N, H, W, 3)) -> argmax class uint8
    (N, H, W), the forward in `compute_dtype`. It runs the BN-folded
    forward (`model.apply_folded(model.fold(...))`) where the model has
    both, else `model.apply` in eval mode (SegFormer); for a binary model
    the argmax is the fused head's probability >= 0.5. torch.argmax, as
    jnp.argmax, takes the first class of a tie.

    Where the model folds, `step.folded(folded, raw)` is the same step over
    params folded beforehand (`model.fold`), so that a server folds once."""
    use_fold = hasattr(model, "fold") and hasattr(model, "apply_folded")

    def step(params, state, raw):
        with torch.no_grad():
            if use_fold:
                return segment_folded(model.fold(params, state), raw)
            x = normalize(_to_device(raw, params["final"]["w"].device)).to(compute_dtype)
            logits, _ = model.apply(params, state, x, train=False)
            return torch.argmax(logits, dim=-1).to(torch.uint8)

    def segment_folded(folded, raw):
        with torch.no_grad():
            x = normalize(_to_device(raw, folded["final"]["w"].device)).to(compute_dtype)
            return torch.argmax(model.apply_folded(folded, x), dim=-1).to(torch.uint8)

    if use_fold:
        step.folded = segment_folded
    return step


def make_int8_predict_step(
    model,
    params,
    state,
    calib_raw,
    overlap=0,
    fused_head=True,
    host_s2d=False,
    calib_percentile=None,
    calib_amaxes=None,
    pallas_tail=None,
    pallas_enc=False,
    mesh=None,
):
    """Hybrid-int8 prediction on the device of `params`: the U-Net's walk,
    or the walk of a model that owns one (`predict_quantized_int8`, the fast
    family: see `_model_int8_predict_step`).

    Folds BN, calibrates per-site activation scales on `calib_raw` (one
    uint8 batch as the steps take it) and quantizes the weights. The steps
    take fine uint8 input (N, H, W, 3), which the fine stem runs, or with
    `host_s2d` 4x4 host-blocked input (N, H/4, W/4, 48) for the blocked
    stem. `calib_amaxes` (a host per-site amax vector) skips calibration
    and uses those exact scales: the QAT contract of the JAX package.

    `pallas_tail` picks the decoder's end as the JAX package's key does
    (None/"full", "tail" or "sep"; see the module docstring); "full",
    "tail" and "sep" need blocked output (`host_s2d`, `fused_head` and an
    even overlap), "sep" an overlap that is a multiple of 4. `pallas_enc`
    changes nothing: the port always runs the encoder through K3/K4, which
    the JAX package pins bit-equal to its XLA walk.

    A per-channel `calib_percentile` ("pc", "pcamax", "pc<p>") calibrates
    one vector per site and folds the balanced scales into the weights
    (`q8.quantize_unet_folded(folded, act_amaxes)`); the same kernels then
    quantize with per-channel reciprocal vectors. As in the JAX package it
    refuses `calib_amaxes` (a per-tensor QAT vector), `pallas_tail` and
    `pallas_enc`, and a model whose `quantize_folded_int8` takes no
    `act_amaxes` (SegFormer), each with a ValueError.

    Returns (step, qtree): step(qtree, raw) -> quantized foreground uint8 on
    the device:

    - blocked output (`host_s2d`, `fused_head`, even overlap):
      parity-blocked (N, H/2 - overlap, W/2 - overlap, 4), for "sep"
      doubly-blocked (N, H/4 - overlap/2, W/4 - overlap/2, 16), channel
      p288 * 4 + p576;
    - otherwise fine (N, H - 2 overlap, W - 2 overlap): with `fused_head`
      K6 at overlap 0, then the depth-to-space and the fine crop; without
      it from the bf16 logits of the final 1x1 conv.

    step(qtree, raw, plain=True) runs the kernels' plain versions instead,
    with the same qtree and scales.

    With a `mesh`, `calib_raw` and every step's batch are this rank's rows
    of the global batch. The calibration is the JAX package's, of the whole
    first global batch: the ranks' rows are gathered, rank 0 calibrates and
    broadcasts the amaxes, so every rank quantizes alike (`calib_amaxes`
    skips it on every rank).
    """
    per_channel = q8.is_per_channel(calib_percentile)
    if per_channel and calib_amaxes is not None:
        raise ValueError(
            "calib_amaxes carries a per-tensor QAT vector; per-channel ('pc...') calibration "
            "would misread it — set int8_calibration to a percentile for QAT checkpoints"
        )
    if per_channel and (pallas_tail or pallas_enc):
        raise ValueError("per-channel calibration ('pc...') is XLA-walk only: disable pallas_tail/pallas_enc")
    if hasattr(model, "predict_quantized_int8"):
        return _model_int8_predict_step(model, params, state, calib_raw, overlap, host_s2d, calib_percentile,
                                        calib_amaxes, mesh)
    if pallas_tail not in PALLAS_TAILS:
        raise ValueError("pallas_tail must be one of {} (got {!r})".format(PALLAS_TAILS, pallas_tail))
    blocked_out = host_s2d and fused_head and overlap % 2 == 0
    if pallas_tail and not blocked_out:
        raise ValueError("pallas_tail requires host_s2d + fused_head with an even overlap")
    if pallas_tail == "sep" and overlap % 4:
        raise ValueError("pallas_tail='sep' crops on the coarse-coarse grid: overlap must be a multiple of 4")
    device = params["final"]["w"].device
    norm = _normalize_s2d4 if host_s2d else normalize

    with torch.no_grad():
        folded = model.fold(params, state)
        if calib_amaxes is None:
            calib_amaxes = _calibrate(mesh, calib_raw, device, lambda raw: q8.calibration_amaxes(
                folded, norm(raw), blocked=host_s2d, percentile=calib_percentile))
        if per_channel:
            qtree, scale_list = q8.quantize_unet_folded(folded, act_amaxes=calib_amaxes)
            scales = q8.host_scales(scale_list)
        else:
            scales = tuple(q8.scales_from_amaxes(calib_amaxes))
            qtree = q8.quantize_unet_folded(folded)

    def step(qtree, raw, plain=False):
        w, b = qtree["final"]["w"], qtree["final"]["b"]
        margin = head.margin_head_plain if plain else head.margin_head
        with torch.no_grad():
            x = norm(_to_device(raw, device)).to(torch.bfloat16)
            if pallas_tail == "sep":
                cat3, s3, s4, s5 = q8.apply_features_int8_to_dec3_input(qtree, scales, x, blocked=True, plain=plain)
                up = qdec.parity_up_conv_separated_plain if plain else qdec.parity_up_conv_separated
                tail = qtail.fused_tail_features_sep_plain if plain else qtail.fused_tail_features_sep
                feats = tail(up(cat3, qtree["dec3"], s3), qtree["dec4"], s4, qtree["dec5"], s5)
                return margin(feats, w, b, overlap, 16)
            dec3, s4, s5 = q8.apply_features_int8_to_dec3(qtree, scales, x, blocked=host_s2d, plain=plain)
            if pallas_tail == "tail" or not fused_head:
                tail = qtail.fused_tail_features_plain if plain else qtail.fused_tail_features
                feats = tail(dec3, qtree["dec4"], s4, qtree["dec5"], s5)
                if fused_head:
                    return margin(feats, w, b, overlap, 4)
                return _crop(softmax_quantize(model.final_logits(qtree["final"], depth_to_space2(feats))), overlap)
            tail = qtail.fused_tail_plain if plain else qtail.fused_tail
            if blocked_out:
                return tail(dec3, qtree["dec4"], s4, qtree["dec5"], s5, w, b, overlap)
            # The head works per pixel: the blocked head at overlap 0, then
            # the fine crop, is the JAX package's fused_prediction_head_s2d.
            return head.fine_from_blocked(tail(dec3, qtree["dec4"], s4, qtree["dec5"], s5, w, b, 0), overlap)

    return step, qtree


def _calibrate(mesh, calib_raw, device, calibration):
    """calibration(uint8 batch on `device`) of the first batch: this
    process's, or with a `mesh` the global batch gathered from the ranks'
    rows, calibrated on rank 0 and broadcast (host amaxes)."""
    raw = _to_device(calib_raw, device)
    if mesh is None:
        return calibration(raw)
    raw = mesh.gather(raw)
    return mesh.broadcast_object(calibration(raw) if mesh.rank == 0 else None)


def _model_int8_predict_step(model, params, state, calib_raw, overlap, host_s2d, calib_percentile, calib_amaxes,
                             mesh=None):
    """The JAX package's protocol of a model that owns its int8 walk: the
    model folds, calibrates (`calibration_amaxes_int8`, in float32; skipped
    for `calib_amaxes`), quantizes (`quantize_folded_int8`, with the
    per-channel calibrations' vectors `act_amaxes` where it takes them,
    else a ValueError as in the JAX package) and runs its own head
    (`predict_quantized_int8`). `pallas_tail` and `pallas_enc` are the
    U-Net's and change nothing here. On the GPU the sites' packed weights
    and scale products are made once, here (`model.prepare_int8`). The
    output is the model's: for the fast family 4x4-blocked uint8 (N,
    (H - 2o) / 4, (W - 2o) / 4, 16) with `host_s2d` and an overlap that is a
    multiple of its BLOCK, else fine (N, H - 2o, W - 2o). Returns (step,
    qtree) as `make_int8_predict_step`, whose `mesh` calibration it
    shares; step(qtree, raw, plain=True) runs the kernels' plain
    versions."""
    per_channel = q8.is_per_channel(calib_percentile)
    if per_channel and "act_amaxes" not in inspect.signature(model.quantize_folded_int8).parameters:
        raise ValueError("{} does not support per-channel ('pc...') calibration; use a percentile".format(
            getattr(model, "__name__", model)))
    device = params["final"]["w"].device
    norm = _normalize_s2d4 if host_s2d else normalize
    with torch.no_grad():
        folded = model.fold(params, state)
        if calib_amaxes is None:
            calib_amaxes = _calibrate(mesh, calib_raw, device, lambda raw: model.calibration_amaxes_int8(
                folded, norm(raw), blocked=host_s2d, percentile=calib_percentile))
        if per_channel:
            qtree, scale_list = model.quantize_folded_int8(folded, act_amaxes=calib_amaxes)
            scales = q8.host_scales(scale_list)
        else:
            scales = tuple(q8.scales_from_amaxes(calib_amaxes))
            qtree = model.quantize_folded_int8(folded)
        if device.type == "cuda":
            model.prepare_int8(qtree, scales)

    def step(qtree, raw, plain=False):
        with torch.no_grad():
            x = norm(_to_device(raw, device)).to(torch.bfloat16)
            return model.predict_quantized_int8(qtree, scales, x, overlap=overlap, blocked=host_s2d, plain=plain)

    return step, qtree
