"""robosat_tpu_torch's losses, metrics and augmentation vs the JAX package.

- The four losses (CrossEntropy, Focal, mIoU with and without class
  weights, Lovasz), value and gradient with respect to the logits, on the
  same seeded NHWC logits and NHW targets at (2, 16, 16, 2): rtol 1e-5.
  Lovasz's autograd.Function also on logits with tied errors, where only a
  stable sort in the reference's NCHW flatten order gives JAX's gradient.
- `confusion_counts` (ties go to the first class, as jnp.argmax) and
  `Metrics`: equal counts and equal reported metrics.
- `apply_dihedral`: all 8 (flip, quarter turns) cases bit-equal to the JAX
  package's `_apply_dihedral` on images and masks.
- `augment_batch`: over 4096 draws, the flip share and the rotation counts
  follow Bernoulli(0.5) and Binomial(3, 0.5) mod 4, the JAX package's
  distribution (the stream itself differs: a torch.Generator, not
  jax.random).
- Lovasz through `make_train_step`, remat on and off: 3 steps against the
  JAX package's, as tests/test_torch_port_train.py holds CrossEntropy.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.ops import augment as jaugment
from robosat_tpu.ops import losses as jlosses
from robosat_tpu.ops import metrics as jmetrics
from robosat_tpu_torch.ops import augment, losses, metrics
from test_torch_port_train import (  # noqa: F401
    batches, check_train_step, jax_trajectory, port_trajectories, weights)

WEIGHT = np.asarray([1.6248, 5.762827], np.float32)  # config/dataset-parking.toml
RTOL = 1e-5


def _inputs(seed, shape=(2, 16, 16, 2), scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape) * scale).astype(np.float32)
    targets = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    return logits, targets


@functools.partial(jax.jit, static_argnames="name")
def _jax_loss_value_and_grad(logits, targets, weight, name):
    return jax.value_and_grad(lambda x: jlosses.get_loss(name)(x, targets, weight))(logits)


def _jax_value_and_grad(name, logits, targets, weight):
    value, grad = _jax_loss_value_and_grad(logits, targets, weight, name=name)
    return float(value), np.asarray(grad)


def _port_value_and_grad(name, logits, targets, weight):
    x = torch.from_numpy(logits).requires_grad_(True)
    value = losses.get_loss(name)(x, torch.from_numpy(targets), None if weight is None else torch.from_numpy(weight))
    value.backward()
    return float(value.detach()), x.grad.numpy()


@pytest.mark.parametrize("name,weighted", [
    ("CrossEntropy", True), ("CrossEntropy", False), ("Focal", True), ("Focal", False), ("mIoU", True),
    ("mIoU", False), ("Lovasz", False),
])
def test_loss_value_and_gradient_match_jax(name, weighted):
    logits, targets = _inputs(1)
    weight = WEIGHT if weighted else None
    want_value, want_grad = _jax_value_and_grad(name, logits, targets, weight)
    got_value, got_grad = _port_value_and_grad(name, logits, targets, weight)
    np.testing.assert_allclose(got_value, want_value, rtol=RTOL)
    np.testing.assert_allclose(got_grad, want_grad, rtol=RTOL, atol=RTOL * np.abs(want_grad).max())


@pytest.mark.parametrize("case", ["quantized", "constant"])
def test_lovasz_ties_follow_the_stable_sort(case):
    """Logits on a coarse grid (many equal errors), or all equal: the
    gradient's coefficients depend on the order of the ties, which both
    packages break by position in the NCHW flattening."""
    logits, targets = _inputs(2, scale=1.0)
    logits = np.round(logits * 2) / 2 if case == "quantized" else np.full_like(logits, 0.25)
    want_value, want_grad = _jax_value_and_grad("Lovasz", logits, targets, None)
    got_value, got_grad = _port_value_and_grad("Lovasz", logits, targets, None)
    np.testing.assert_allclose(got_value, want_value, rtol=RTOL)
    np.testing.assert_allclose(got_grad, want_grad, rtol=RTOL, atol=RTOL * np.abs(want_grad).max())
    assert len(np.unique(1 - (2 * np.eye(2)[targets] - 1) * logits)) < logits.size // 4


def test_unknown_loss_raises():
    with pytest.raises(ValueError, match="Unknown"):
        losses.get_loss("Dice")
    assert sorted(losses.LOSSES) == sorted(jlosses.LOSSES)


def test_confusion_counts_match_jax():
    logits, targets = _inputs(3, shape=(3, 8, 8, 2))
    logits[0, :4, :, 1] = logits[0, :4, :, 0]  # ties: class 0 wins, as jnp.argmax picks the first index
    got = metrics.confusion_counts(torch.from_numpy(logits), torch.from_numpy(targets))
    want = np.asarray(jmetrics.confusion_counts(jnp.asarray(logits), jnp.asarray(targets)))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert int(got.sum()) == targets.size


def test_metrics_tracker_matches_jax():
    port, ref = metrics.Metrics(range(2)), jmetrics.Metrics(range(2))
    for seed in (4, 5):
        logits, targets = _inputs(seed, shape=(2, 8, 8, 2))
        port.add(targets, logits)
        ref.add(targets, logits)
    port.add(targets[0], logits[0])  # one HW observation
    ref.add(targets[0], logits[0])
    port.add_counts([3, 0, 1, 7])
    ref.add_counts([3, 0, 1, 7])
    assert (port.tn, port.fn, port.fp, port.tp) == (ref.tn, ref.fn, ref.fp, ref.tp)
    assert (port.get_miou(), port.get_fg_iou(), port.get_mcc()) == (ref.get_miou(), ref.get_fg_iou(), ref.get_mcc())
    empty = metrics.Metrics()
    assert np.isnan(empty.get_fg_iou()) and np.isnan(empty.get_mcc())


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_dihedral_cases_bit_equal(flip, k):
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    masks = rng.integers(0, 2, (3, 8, 8)).astype(np.int32)
    flips = np.asarray([flip, not flip, flip])
    rots = np.asarray([k, (k + 1) % 4, k], np.int32)
    want = jax.vmap(jaugment._apply_dihedral)(images, masks, flips, rots)
    got = augment.apply_dihedral(torch.from_numpy(images), torch.from_numpy(masks), torch.from_numpy(flips),
                                 torch.from_numpy(rots))
    for g, w in zip(got, want):
        w = np.array(w)
        assert g.dtype == torch.from_numpy(w).dtype and np.array_equal(g.numpy(), w)


def test_augment_batch_distribution():
    """4096 draws: flips ~ Bernoulli(0.5) and rotation counts ~ Binomial(3,
    0.5) mod 4, i.e. k = 0, 1, 2, 3 with 1/8, 3/8, 3/8, 1/8, in the port as in
    the JAX package's `augment_batch` (each read back from the output the
    same way); each sample's image and mask turn together."""
    n = 4096
    images = np.broadcast_to(np.arange(4, dtype=np.uint8).reshape(1, 2, 2, 1), (n, 2, 2, 1)).copy()
    masks = images[..., 0].astype(np.int32)
    # The 8 dihedral images of [[0, 1], [2, 3]] are distinct: read (flip, k) back.
    cases = {}
    for f in (False, True):
        for k in range(4):
            one = augment.apply_dihedral(torch.from_numpy(images[:1]), torch.from_numpy(masks[:1]),
                                         torch.tensor([f]), torch.tensor([k]))[1]
            cases[tuple(one.flatten().tolist())] = (f, k)
    assert len(cases) == 8

    port = augment.augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(images), torch.from_numpy(masks))
    ref = jaugment.augment_batch(jax.random.PRNGKey(0), images, masks)
    for out_images, out_masks in ((port[0].numpy(), port[1].numpy()), (np.asarray(ref[0]), np.asarray(ref[1]))):
        assert np.array_equal(out_images[..., 0].astype(np.int32), out_masks)
        drawn = np.asarray([cases[tuple(m.flatten().tolist())] for m in out_masks])
        assert abs(drawn[:, 0].mean() - 0.5) < 0.03
        np.testing.assert_allclose(np.bincount(drawn[:, 1], minlength=4) / n, np.asarray([1, 3, 3, 1]) / 8.0,
                                   atol=0.03)


@pytest.fixture(scope="module")
def lovasz_jax_run(weights, batches):  # noqa: F811
    return jax_trajectory(weights, batches, "Lovasz")


@pytest.fixture(scope="module")
def lovasz_port_runs(weights, batches):  # noqa: F811
    return port_trajectories(weights, batches, "Lovasz")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_lovasz_train_step_matches_jax(weights, lovasz_jax_run, lovasz_port_runs, remat):  # noqa: F811
    check_train_step(lovasz_jax_run, lovasz_port_runs, remat, weights[0])
