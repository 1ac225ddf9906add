"""robosat_tpu_torch's distillation (`train --teacher`) vs the JAX package, on the CPU.

The student is the reference-layout U-Net of tests/test_torch_port_train.py;
the teacher the same layout with every conv kernel scaled elementwise by
U(0.8, 1.2) (seeded), BN state with var + eps == 1 (the fold then agrees
bit for bit: XLA:CPU's rsqrt and torch's differ in the last bit
elsewhere). At 64 px, batch 2, float32, CrossEntropy with
dataset-parking's class weights, alpha 0.9 and T 2 (the tool's defaults):

- the teacher's logits (`unet.apply_folded` on its fold) within 5e-4 of
  their largest value (measured 3.3e-6; the convolutions sum in other
  orders);
- `distillation_loss` on the same student and teacher logits against the
  JAX package's expression (parallel/steps.py's make_distill_train_step):
  the KD term and the total within 1e-6 relative (measured 1.9e-7), and
  the gradient on the student's logits within 1e-5 of its largest
  (measured 1.3e-6: softmax and log-softmax round in other places);
- `make_distill_train_step` (augmentation off) over 3 steps against the
  JAX package's, as tests/test_torch_port_train.py holds the train step:
  step 0's loss within 1e-4 relative (measured 2.7e-5), steps 1-2 within
  5% (0.1%), bn1's running statistics within 5e-3, each step optax.adam's
  on the port's own gradients (`check_optax_step`), and step 1's update
  at cosine >= 0.98 to JAX's over all weights (0.9949), its norm within
  1%. With `remat` the same losses, weights and state bit for bit. The
  teacher's folded params collect no gradient and stay as they were.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robosat_tpu.checkpoint import convert_torch_unet
from robosat_tpu.models import unet as junet
from robosat_tpu.ops.augment import normalize as jax_normalize
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel.steps import make_distill_train_step as jax_make_distill_train_step
from robosat_tpu_torch import checkpoint, optim
from robosat_tpu_torch.models import unet
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.parallel.steps import distillation_loss, make_distill_train_step
from test_torch_checkpoint import _reference_style_state_dict
from test_torch_port_train import _flat, check_optax_step, update_agreement
from test_torch_port_train_forward import WEIGHT, learnable_batch
from torch_port_refs import exact_var

LR = 1e-4
STEPS = 3
ALPHA, TEMP = 0.9, 2.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    params, state = convert_torch_unet(_reference_style_state_dict())
    return _np(params), exact_var(_np(state))


@pytest.fixture(scope="module")
def teacher(weights):
    """(teacher params, state): the student's with every conv kernel scaled."""
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32) if a.ndim == 4 else a, weights[0])
    return params, weights[1]


@pytest.fixture(scope="module")
def batches():
    return [learnable_batch(20 + i) for i in range(STEPS)]


def test_teacher_logits_match_jax(teacher, batches):
    x = np.array(jax_normalize(batches[0][0]))
    want = np.asarray(jax.jit(junet.apply_folded)(jax.jit(junet.fold)(*teacher), x))
    params, state = checkpoint.from_jax(*teacher)
    with torch.no_grad():
        got = unet.apply_folded(unet.fold(params, state), torch.from_numpy(x)).numpy()
    scale = np.abs(want).max()
    print("teacher logits: max |diff| {} of their max".format(np.abs(got - want).max() / scale))
    assert got.shape == want.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * scale)


def _jax_distillation_loss(logits32, t_logits, masks, alpha):
    """The JAX package's loss of make_distill_train_step (steps.py:631-637)."""
    soft_t = jax.nn.softmax(t_logits / TEMP, axis=-1)
    log_s = jax.nn.log_softmax(logits32 / TEMP, axis=-1)
    kd = -jnp.mean(jnp.sum(soft_t * log_s, axis=-1)) * (TEMP * TEMP)
    hard = jax_get_loss("CrossEntropy")(logits32, masks, WEIGHT)
    return alpha * kd + (1.0 - alpha) * hard


_jax_distillation_value_and_grad = jax.jit(jax.value_and_grad(_jax_distillation_loss), static_argnums=3)


@pytest.mark.parametrize("alpha", [1.0, ALPHA], ids=["kd", "total"])
def test_distillation_loss_matches_jax(batches, alpha):
    """alpha = 1 gives the KD term alone."""
    rng = np.random.default_rng(6)
    masks = batches[0][1]
    logits = (rng.normal(size=masks.shape + (2,)) * 4).astype(np.float32)
    t_logits = (rng.normal(size=masks.shape + (2,)) * 4).astype(np.float32)
    want, want_grad = _jax_distillation_value_and_grad(logits, t_logits, masks, alpha)
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = distillation_loss(tl, torch.from_numpy(t_logits), torch.from_numpy(masks), get_loss("CrossEntropy"),
                            torch.from_numpy(WEIGHT), alpha, TEMP)
    got.backward()
    print("distillation loss (alpha {}): port {} JAX {}".format(alpha, float(got.detach()), float(want)))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(tl.grad.numpy(), want_grad, rtol=0, atol=1e-5 * np.abs(want_grad).max())


@pytest.fixture(scope="module")
def jax_run(weights, teacher, batches):
    """The JAX package's distillation step over `batches`: (losses, params
    after step 1, the final state)."""
    params, state = weights
    teacher_folded = jax.jit(junet.fold)(*teacher)
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    step = jax_make_distill_train_step(junet, junet, jax_get_loss("CrossEntropy"), optimizer, weight=WEIGHT,
                                       augment=False, alpha=ALPHA, temp=TEMP)
    losses, after = [], None
    for images, masks in batches:
        params, state, opt_state, loss, _ = step(params, state, opt_state, teacher_folded, jax.random.PRNGKey(0),
                                                 images, masks)
        losses.append(float(loss))
        after = _np(params) if after is None else after
    return losses, after, _np(state)


def _port_run(weights, teacher, batches, remat):
    params, state = checkpoint.from_jax(*weights)
    tparams, tstate = checkpoint.from_jax(*teacher)
    with torch.no_grad():
        teacher_folded = unet.fold(tparams, tstate)
    optimizer = optim.adam(params, LR)
    step = make_distill_train_step(unet, unet, get_loss("CrossEntropy"), optimizer, weight=WEIGHT, augment=False,
                                   remat=remat, alpha=ALPHA, temp=TEMP)
    opt_state = optax.adam(LR).init(_flat(jax.tree_util.tree_leaves(weights[0])))
    losses, first = [], None
    for images, masks in batches:
        before = _flat([p.detach().numpy() for p in checkpoint.tree_leaves(params)])
        state, loss, counts = step(params, state, teacher_folded, images, masks)
        if not remat:
            opt_state = check_optax_step(params, optimizer, before, opt_state)
        losses.append(float(loss))
        assert counts.dtype == torch.int32 and int(counts.sum()) == masks.size
        first = first or [p.detach().numpy().copy() for p in checkpoint.tree_leaves(params)]
    return losses, params, state, optimizer, first


@pytest.fixture(scope="module")
def port_run(weights, teacher, batches):
    return _port_run(weights, teacher, batches, remat=False)


def test_distill_train_step_matches_jax(weights, jax_run, port_run):
    want_losses, want_after, want_state = jax_run
    losses, params, state, optimizer, first = port_run
    print("distillation losses: port {} JAX {}".format(losses, want_losses))
    assert abs(losses[0] - want_losses[0]) <= 1e-4 * abs(want_losses[0])
    for i in (1, 2):
        assert abs(losses[i] - want_losses[i]) <= 0.05 * abs(want_losses[i])
    for k in ("mean", "var"):
        np.testing.assert_allclose(state["encoder"]["bn1"][k].numpy(), want_state["encoder"]["bn1"][k], atol=5e-3,
                                   rtol=5e-3)
    assert optimizer.count == STEPS
    cos, ratio = update_agreement(first, jax.tree_util.tree_leaves(want_after), jax.tree_util.tree_leaves(weights[0]))
    print("step-1 update vs JAX: cosine {}, norm ratio {}".format(cos, ratio))
    assert cos >= 0.98 and abs(ratio - 1) <= 0.01, (cos, ratio)


def test_distill_train_step_remat_is_bit_equal(weights, teacher, batches, port_run):
    losses, params, state, _, _ = _port_run(weights, teacher, batches, remat=True)
    want_losses, want_params, want_state, _, _ = port_run
    assert losses == want_losses
    for got, want in zip(checkpoint.tree_leaves(params) + checkpoint.tree_leaves(state),
                         checkpoint.tree_leaves(want_params) + checkpoint.tree_leaves(want_state)):
        assert torch.equal(got, want)


def test_teacher_gets_no_gradient(weights, teacher, batches):
    """The teacher's folded params stay as they were and collect no
    gradient, even when they require one."""
    params, state = checkpoint.from_jax(*weights)
    tparams, tstate = checkpoint.from_jax(*teacher)
    teacher_folded = unet.fold(tparams, tstate)
    leaves = checkpoint.tree_leaves(teacher_folded)
    for t in leaves:
        t.requires_grad_(True)
    copies = [t.detach().clone() for t in leaves]
    step = make_distill_train_step(unet, unet, get_loss("CrossEntropy"), optim.adam(params, LR), weight=WEIGHT,
                                   augment=False)
    step(params, state, teacher_folded, *batches[0])
    assert all(t.grad is None for t in leaves)
    assert all(torch.equal(t, c) for t, c in zip(leaves, copies))
