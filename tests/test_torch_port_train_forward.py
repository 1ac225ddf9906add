"""robosat_tpu_torch's training forward vs the JAX package, on the CPU.

The same weights (a reference-layout U-Net state_dict, converted by the
JAX package and passed to the port through `from_jax`) and the same
seeded uint8 batches go through both packages:

- `bn_apply` in training and eval mode, float32 and bfloat16: output and
  new running statistics;
- the U-Net's `apply` and `apply_s2d` in training mode (batch statistics)
  at 64 px: logits, the new BN state, and the gradients of the weighted
  cross entropy at five leaves from the head to the stem, by cosine, at or
  above the floors of tests/test_torch_train_parity.py;
- `apply_s2d` in eval mode at 32 px, where enc4 is 1 x 1 and the JAX
  package's center block reads only zero padding;
- `make_eval_step`: the loss and the confusion counts.

Batch 2 at 64 px, not 32: in training mode at 32 px layer4's batch norm
normalizes two values per channel, whose difference is decided by float
summation order, so both packages' (faithful) forwards part there. At 64
px the float32 logits agree to 1.6e-4 of their largest value (the 53
batch norms and 70 convolutions sum in other orders); they are held to
5e-4 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robosat_tpu.checkpoint import convert_torch_unet
from robosat_tpu.models import layers as jlayers
from robosat_tpu.models import unet as junet
from robosat_tpu.ops.augment import normalize as jax_normalize
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel.steps import make_eval_step as jax_make_eval_step
from robosat_tpu.parallel.steps import make_train_step as jax_make_train_step
from robosat_tpu_torch import optim
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models import layers, unet
from robosat_tpu_torch.ops.augment import normalize
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.parallel.steps import make_eval_step, make_train_step
from test_torch_checkpoint import _reference_style_state_dict

WEIGHT = np.asarray([1.6248, 5.762827], np.float32)  # config/dataset-parking.toml
# (leaf path, floor): tests/test_torch_train_parity.py's representative leaves.
COSINE_FLOORS = (
    (("final", "w"), 0.9999),
    (("dec3", "w"), 0.999),
    (("encoder", "layer3", 0, "conv2", "w"), 0.995),
    (("encoder", "conv1", "w"), 0.99),
    (("encoder", "bn1", "scale"), 0.99),
)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads in the modules that train the full-width U-Net
    on the CPU: tier-1 runs six xdist workers, and a full OpenMP pool in
    each oversubscribes the cores (a 3-step run then takes minutes instead
    of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def learnable_batch(seed, batch=2, size=64):
    """uint8 images and int32 masks: a bright square on noise per sample."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    masks = np.zeros((batch, size, size), np.int32)
    for b in range(batch):
        cy, cx = rng.integers(size // 4, size - size // 4, 2)
        lo = size // 6
        masks[b, max(cy - lo, 0):cy + lo, max(cx - lo, 0):cx + lo] = 1
        images[b][masks[b] == 1] = np.clip(images[b][masks[b] == 1].astype(np.int32) + 80, 0, 255)
    return images, masks


@pytest.fixture(scope="module")
def weights():
    params, state = convert_torch_unet(_reference_style_state_dict())
    return jax.tree_util.tree_map(np.asarray, params), jax.tree_util.tree_map(np.asarray, state)


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _assert_states_close(got, want, rtol, atol):
    for g, w in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.detach().numpy(), got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_apply_matches_jax(train, dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 5, 4, 6)) * 2 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32), "bias": rng.normal(size=6).astype(np.float32)}
    state = {"mean": rng.normal(size=6).astype(np.float32), "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    jx = jnp.asarray(x, dtype)
    want, want_state = jax.jit(jlayers.bn_apply, static_argnums=3)(params, state, jx, train)
    tparams, tstate = from_jax(params, state)
    got, got_state = layers.bn_apply(tparams, tstate, torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype)), train)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    # bfloat16: one rounding of the same float32 value, up to an ulp apart.
    rtol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=rtol, atol=rtol)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_state[k].numpy(), np.asarray(want_state[k]), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def train_forward(weights):
    """The JAX package's training forward and weighted-CE gradients of
    `apply` and `apply_s2d` on one 64-px batch."""
    params, state = weights
    images, masks = learnable_batch(3)
    x = np.asarray(jax_normalize(images))
    loss_fn = jax_get_loss("CrossEntropy")
    out = {}
    for name in ("apply", "apply_s2d"):
        forward = getattr(junet, name)

        def loss(p, forward=forward):
            logits, new_state = forward(p, state, x, True)
            return loss_fn(logits.astype(jnp.float32), masks, WEIGHT), (logits, new_state)

        (value, (logits, new_state)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[name] = float(value), np.asarray(logits), new_state, grads
    return images, masks, out


@pytest.mark.parametrize("name", ["apply", "apply_s2d"])
def test_unet_train_forward_and_gradients_match_jax(weights, train_forward, name):
    images, masks, out = train_forward
    want_loss, want_logits, want_state, want_grads = out[name]
    params, state = from_jax(*weights)
    leaves = optim.adam(params, 1e-4).param_groups[0]["params"]  # requires_grad on every leaf
    logits, new_state = getattr(unet, name)(params, state, normalize(torch.from_numpy(images)), True)
    loss = get_loss("CrossEntropy")(logits.float(), torch.from_numpy(masks), torch.from_numpy(WEIGHT))
    loss.backward()

    scale = np.abs(want_logits).max()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-4, atol=5e-4 * scale)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
    _assert_states_close(new_state, want_state, rtol=1e-3, atol=1e-4)
    for path, floor in COSINE_FLOORS:
        c = _cosine(_leaf(params, path).grad.numpy(), _leaf(want_grads, path))
        print("{}: gradient cosine {:.8f}".format("/".join(map(str, path)), c))
        assert c >= floor, "gradient drifted at {}: cosine {} < {}".format(path, c, floor)
    assert all(p.grad is not None for p in leaves)


def test_unet_eval_forward_at_32px_matches_jax(weights):
    """enc4 is 1 x 1 at 32 px: its 2 x 2 pool is empty, and the JAX
    package's center block is relu(0) over one pixel of padding."""
    params, state = weights
    images, _ = learnable_batch(4, size=32)
    x = np.asarray(jax_normalize(images))
    want, _ = jax.jit(junet.apply_s2d, static_argnums=3)(params, state, x, False)
    tparams, tstate = from_jax(params, state)
    with torch.no_grad():
        got, got_state = unet.apply_s2d(tparams, tstate, torch.from_numpy(x), False)
    assert got_state is not None and got.shape == want.shape == (2, 32, 32, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_eval_step_matches_jax(weights):
    params, state = weights
    images, masks = learnable_batch(5)
    want_loss, want_counts = jax_make_eval_step(junet, jax_get_loss("CrossEntropy"), weight=WEIGHT)(
        params, state, images, masks)
    tparams, tstate = from_jax(params, state)
    got_loss, got_counts = make_eval_step(unet, get_loss("CrossEntropy"), weight=WEIGHT)(tparams, tstate, images,
                                                                                      masks)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    assert got_counts.dtype == torch.int32 and np.array_equal(got_counts.numpy(), np.asarray(want_counts))
