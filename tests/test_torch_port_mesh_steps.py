"""robosat_tpu_torch's mesh steps (`mesh=`) vs the JAX package's on its 2-device CPU mesh.

The port's counterparts of tests/test_parallel.py's cases, and the QAT,
distillation and int8 predict steps, on 2 gloo ranks, one process each
(tests/torch_mesh_workers.py); the JAX train steps run in one child
process capped at AVX2 (`run_capped`, tests/torch_port_refs.py) on
the suite's 2-device mesh, the JAX predict and eval steps in this one.

- The sync-BN train step (CrossEntropy with weight [1, 2], SGD 1e-3, the
  global batch of 8 at 64 px split 4/4): the loss within 5e-5 relative of
  the JAX mesh step's and of the port's one-process step on the whole
  batch, the counts equal to the JAX step's and to the one-process step's
  up to test_parallel.py's 8 pixels at the argmax margin (measured: one
  flipped), the update at cosine >= 0.999 to both, layer 0's BN running mean within 1e-5; both ranks hold the same
  weights. (A class-weighted loss averaged per rank would miss: the ranks'
  weight sums differ.)
- The local-BN step (`sync_bn=False`, the reference's DataParallel) with
  one shard's 2 samples on each rank: the one-process step on the shard,
  exactly as test_parallel.py holds the JAX step (loss 1e-5, counts twice
  the shard's, BN mean 1e-5, cosine 0.999), and the JAX local mesh step
  (loss 5e-5, counts equal, cosine 0.999).
- The eval step: the JAX mesh step's loss within 1e-5 relative and its
  counts; the float predict step (overlap 32): within one bin on at most
  0.1% of the pixels of the JAX mesh step's.
- The augmented train step (Lovasz, the port's Adam): the two ranks' step
  from one generator seed equals the one-process step on the whole batch
  (loss 1e-4, counts equal): the ranks apply their share of the global
  batch's flips and turns.
- The QAT step (the fast family, the JAX package's scales) with one
  shard's samples on each rank: the one-process step on the shard (loss
  1e-5, counts twice, cosine 0.999), and the loss within 1e-4 of the JAX
  mesh step's (measured 6e-7; the U-Net's fake-quant forwards part at
  flipped bins, tests/test_torch_port_qat.py, the fast family's do not
  here).
- The distillation step (fast student and teacher, CrossEntropy [1, 2]):
  the one-process step on the whole batch (loss 5e-5, counts equal,
  cosine 0.999) and the JAX mesh step's loss within 1e-4.
- The int8 predict step on a padded batch, 3 tiles on 2 ranks: calibrated
  on the whole first global batch (the ranks' rows gathered, rank 0's
  amaxes broadcast), its output equals the one-process step's on that
  batch; on the JAX package's amaxes it gives the JAX mesh step's bins
  (one bin on at most 0.1%).
"""

import jax
import numpy as np
import optax
import pytest
import torch

import torch_mesh_workers as workers
from robosat_tpu.models import fastnet as jfastnet
from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import unet as junet
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel import steps as jsteps
from robosat_tpu.parallel.mesh import create_mesh, replicate, shard_batch
from robosat_tpu_torch.checkpoint import tree_leaves
from test_torch_port_predict import MAX_FLIP_SHARE, _bin_distance
from test_torch_port_train_forward import learnable_batch
from torch_port_refs import exact_var, family_calibration_raw, run_capped, unet_calibration

WEIGHT = np.array([1.0, 2.0], np.float32)
LR = 1e-3
# The capped child's limit: about three times its time in tier-1's run.
REFERENCES_TIMEOUT = 350


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in tree_leaves(tree)])


def _cosine(a, b):
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _assert_update(got, want, start, floor=0.999):
    cos = _cosine(_flat(got) - _flat(start), _flat(want) - _flat(start))
    print("update cosine {:.6f}".format(cos))
    assert cos >= floor


def _jax_references(unet_weights, fast_weights, teacher_folded, scales, batch, tiled, fast_batch):
    """The JAX package's mesh train, local-BN, QAT and distillation steps
    on its 2-device mesh: {name: (loss, counts, params[, state])}."""
    mesh = create_mesh()
    assert len(mesh.devices) == 2
    out = {}

    def run(step, params, state, *rest, teacher=None):
        opt = optax.sgd(LR)
        args = [replicate(mesh, params), replicate(mesh, state), replicate(mesh, opt.init(params))]
        if teacher is not None:
            args.append(replicate(mesh, teacher))
        args += [jax.random.PRNGKey(0)] + [shard_batch(mesh, a) for a in rest]
        p, s, _, loss, counts = step(*args)
        return float(loss), np.asarray(counts), _np(p), _np(s)

    ce, lovasz = jax_get_loss("CrossEntropy"), jax_get_loss("Lovasz")
    out["sync"] = run(jsteps.make_train_step(junet, ce, optax.sgd(LR), weight=WEIGHT, mesh=mesh, augment=False),
                      *unet_weights, *batch)
    out["local"] = run(jsteps.make_train_step(junet, ce, optax.sgd(LR), mesh=mesh, augment=False, sync_bn=False),
                       *unet_weights, *tiled)
    out["qat"] = run(jsteps.make_qat_train_step(jfastnet, lovasz, optax.sgd(LR), scales, mesh=mesh, augment=False),
                     *fast_weights, *fast_batch[0])
    out["distill"] = run(jsteps.make_distill_train_step(jfastnet, jfastnet, ce, optax.sgd(LR), weight=WEIGHT,
                                                        mesh=mesh, augment=False),
                         *fast_weights, *fast_batch[1], teacher=teacher_folded)
    return out


@pytest.fixture(autouse=True)
def one_thread():
    """The one-process references on one CPU thread, as each rank runs:
    float sums then follow the same order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unet_weights():
    return _np(junet.init(0, num_classes=2))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, (8, 64, 64, 3), dtype=np.uint8), rng.integers(0, 2, (8, 64, 64)).astype(np.int32)


@pytest.fixture(scope="module")
def tiled(batch):
    """One shard's 2 samples on each of the 2 ranks (test_parallel.py)."""
    images, masks = batch
    return np.concatenate([images[:2]] * 2), np.concatenate([masks[:2]] * 2)


@pytest.fixture(scope="module")
def fast_setup():
    params, state = _np(jfastnet.init(0, num_classes=2))
    t_params, t_state = _np(jfastnet.init(1, num_classes=2))
    teacher_folded = _np(jax.jit(jfastnet.fold)(t_params, t_state))
    qat_images, qat_masks = learnable_batch(30, batch=2, size=64)
    amaxes = np.asarray(family_calibration_raw(jax.jit(jfastnet.fold)(params, state), qat_images, family=jfastnet,
                                               percentile=99.8))
    scales = [float(s) for s in jq8.scales_from_amaxes(amaxes)]
    qat_tiled = (np.concatenate([qat_images] * 2), np.concatenate([qat_masks] * 2))
    return (params, state), teacher_folded, scales, (qat_tiled, learnable_batch(31, batch=4, size=64))


@pytest.fixture(scope="module")
def jax_refs(unet_weights, fast_setup, batch, tiled):
    fast_weights, teacher_folded, scales, fast_batches = fast_setup
    return run_capped(_jax_references, unet_weights, fast_weights, teacher_folded, scales, batch, tiled, fast_batches,
                      timeout=REFERENCES_TIMEOUT)


def test_train_step_mesh_matches_jax(unet_weights, batch, jax_refs):
    images, masks = batch
    want_loss, want_counts, want_params, want_state = jax_refs["sync"]
    ranks = workers.launch(workers.train_step, 2, *unet_weights, images, masks, "CrossEntropy", WEIGHT, True)
    single = workers.train_step(*unet_weights, images, masks, "CrossEntropy", WEIGHT, True, mesh_on=False)
    (loss,), (counts,), params, state = ranks[0]
    assert np.array_equal(_flat(ranks[1][2]), _flat(params))
    print("loss {} vs JAX mesh {} vs one process {}".format(loss, want_loss, single[0][0]))
    assert loss == pytest.approx(want_loss, rel=5e-5) and loss == pytest.approx(single[0][0], rel=5e-5)
    np.testing.assert_array_equal(counts, want_counts)
    # test_parallel.py's rule between its mesh and one-device steps: a pixel
    # at the argmax margin may flip with the order of the statistics' sums.
    assert counts.sum() == single[1][0].sum() and np.abs(counts - single[1][0]).sum() <= 8
    _assert_update(params, want_params, unet_weights[0])
    _assert_update(params, single[2], unet_weights[0])
    np.testing.assert_allclose(state["encoder"]["bn1"]["mean"], want_state["encoder"]["bn1"]["mean"], atol=1e-5)
    np.testing.assert_allclose(state["encoder"]["bn1"]["mean"], single[3]["encoder"]["bn1"]["mean"], atol=1e-5)


def test_local_bn_train_step_reference_semantics(unet_weights, batch, tiled, jax_refs):
    images, masks = batch
    want_loss, want_counts, want_params, want_state = jax_refs["local"]
    ranks = workers.launch(workers.train_step, 2, *unet_weights, *tiled, "CrossEntropy", None, False)
    single = workers.train_step(*unet_weights, images[:2], masks[:2], "CrossEntropy", None, True, mesh_on=False)
    (loss,), (counts,), params, state = ranks[0]
    assert np.array_equal(_flat(ranks[1][2]), _flat(params))
    assert loss == pytest.approx(single[0][0], rel=1e-5) and loss == pytest.approx(want_loss, rel=5e-5)
    np.testing.assert_array_equal(counts, 2 * single[1][0])
    np.testing.assert_array_equal(counts, want_counts)
    for ref in (single[3], want_state):
        np.testing.assert_allclose(state["encoder"]["bn1"]["mean"], ref["encoder"]["bn1"]["mean"], atol=1e-5)
    _assert_update(params, single[2], unet_weights[0])
    _assert_update(params, want_params, unet_weights[0])


def test_eval_and_predict_steps_on_mesh(unet_weights, batch):
    images, masks = batch
    params, state = unet_weights[0], exact_var(unet_weights[1])
    raw = np.random.default_rng(5).integers(0, 256, (8, 128, 128, 3), dtype=np.uint8)
    mesh = create_mesh()
    weight = np.array([1.0, 1.0], np.float32)
    jloss, jcounts = jsteps.make_eval_step(junet, jax_get_loss("CrossEntropy"), weight=weight, mesh=mesh)(
        replicate(mesh, params), replicate(mesh, state), shard_batch(mesh, images), shard_batch(mesh, masks))
    jout = np.asarray(jsteps.make_predict_step(junet, mesh=mesh, overlap=32)(
        replicate(mesh, params), replicate(mesh, state), shard_batch(mesh, raw)))
    ranks = workers.launch(workers.eval_and_predict, 2, params, state, images, masks, weight, raw, 32)
    for loss, counts, _ in ranks:
        assert loss == pytest.approx(float(jloss), rel=1e-5)
        np.testing.assert_array_equal(counts, np.asarray(jcounts))
        assert int(counts.sum()) == 8 * 64 * 64
    out = np.concatenate([r[2] for r in ranks])
    assert out.shape == jout.shape == (8, 64, 64) and out.dtype == np.uint8
    d = _bin_distance(out, jout)
    print("predict: {} of {} bins differ".format(int((d != 0).sum()), d.size))
    assert d.max() <= 1 and (d != 0).sum() <= MAX_FLIP_SHARE * d.size


def test_augmented_train_step_runs_on_mesh(unet_weights):
    images, masks = learnable_batch(40, batch=4, size=64)
    args = (*unet_weights, images, masks, "Lovasz", None, True, True, 7)
    ranks = workers.launch(workers.train_step, 2, *args, True, "adam", 1e-4)
    single = workers.train_step(*args, mesh_on=False, optimizer="adam", lr=1e-4)
    for (loss,), (counts,), _, _ in ranks:
        assert np.isfinite(loss) and loss == pytest.approx(single[0][0], rel=1e-4)
        np.testing.assert_array_equal(counts, single[1][0])


def test_qat_train_step_on_mesh(fast_setup, jax_refs):
    weights, _, scales, ((images, masks), _) = fast_setup
    ranks = workers.launch(workers.qat_step, 2, "fast", *weights, scales, images, masks)
    single = workers.qat_step("fast", *weights, scales, images[:2], masks[:2], mesh_on=False)
    want_loss = jax_refs["qat"][0]
    for loss, counts, params in ranks:
        print("QAT loss {} vs one process {} vs JAX mesh {}".format(loss, single[0], want_loss))
        assert loss == pytest.approx(single[0], rel=1e-5) and loss == pytest.approx(want_loss, rel=1e-4)
        np.testing.assert_array_equal(counts, 2 * single[1])
        _assert_update(params, single[2], weights[0])


def test_distill_train_step_on_mesh(fast_setup, jax_refs):
    weights, teacher_folded, _, (_, (images, masks)) = fast_setup
    ranks = workers.launch(workers.distill_step, 2, "fast", *weights, teacher_folded, images, masks, WEIGHT)
    single = workers.distill_step("fast", *weights, teacher_folded, images, masks, WEIGHT, mesh_on=False)
    want_loss = jax_refs["distill"][0]
    for loss, counts, params, _ in ranks:
        assert loss == pytest.approx(single[0], rel=5e-5) and loss == pytest.approx(want_loss, rel=1e-4)
        np.testing.assert_array_equal(counts, single[1])
        _assert_update(params, single[2], weights[0])


def test_int8_predict_step_on_mesh_with_a_padded_batch(unet_weights):
    params, state = unet_weights[0], exact_var(unet_weights[1])
    tiles = np.random.default_rng(7).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    raw = np.concatenate([tiles, tiles[-1:]])  # the loader's padding of a short global batch
    ranks = workers.launch(workers.int8_predict, 2, params, state, raw)
    single = workers.int8_predict(params, state, raw, mesh_on=False)
    np.testing.assert_array_equal(np.concatenate(ranks), single)

    amaxes = np.asarray(unet_calibration(jax.jit(junet.fold)(params, state), raw, blocked=False, percentile=99.8))
    mesh = create_mesh()
    jstep, jqt = jsteps.make_int8_predict_step(junet, params, state, raw, mesh=mesh, calib_amaxes=amaxes)
    want = np.asarray(jstep(replicate(mesh, jqt), shard_batch(mesh, raw)))
    got = np.concatenate(workers.launch(workers.int8_predict, 2, params, state, raw, amaxes))
    assert got.shape == want.shape == (4, 64, 64)
    d = _bin_distance(got[:3], want[:3])
    print("int8: {} of {} bins differ".format(int((d != 0).sum()), d.size))
    assert d.max() <= 1 and (d != 0).sum() <= MAX_FLIP_SHARE * d.size
