"""robosat_tpu_torch's QAT (`train --qat`) vs the JAX package, on the CPU.

- `fake_quant_act` and `fake_quant_weight` in float32 and bfloat16 on
  values that include exact bin edges (r = k + 1/2, rounded half to even)
  and values past +-127: the forward bit-equal to the JAX package's, and
  the gradient too up to the sign of its zeros (XLA:CPU writes the clipped
  STE's gate as a select in float32, +0, and as a multiply in bfloat16, -0
  where the gradient is negative; the port selects). The weight grid is
  the one `_quantize_weight` gives predict.
- `unet.apply_logits_fake_quant` at 64 px, batch 2, float32, with the
  site scales of one 99.8-percentile calibration. Run free, the two
  packages' forwards part: one bin flipped by float summation order at
  site 9 of 59 (a 6e-7 relative difference at a bin edge) flips more bins
  at every later site, a third of dec5's in the end, and the logits differ
  by ~1% of their largest on average. So the walk is held site by site:
  every site's input is forced to the JAX program's own (value from JAX,
  gradient straight through), and then each site's input before the
  forcing is within 1e-5 of its largest value (measured 1.7e-6), the
  logits within 1e-5 of theirs (5.1e-7), the loss within 1e-4 (7.8e-7
  relative), and every gradient leaf at cosine >= 0.99999 (min 0.9999996).
  Run free, the logits are held to a mean |diff| of 3% of their largest
  (measured 1.2%) and the gradient cosines to floors under the measured
  (0.861-0.99999 at tests/test_torch_train_parity.py's five leaves).
  Both with Lovasz, the configured loss.
- The QAT contract against the port's plain int8 walk (as the JAX
  package's tests/test_int8.py holds its own): the port's int8 kernels
  round every epilogue to bfloat16, and each rounding moves a bin at the
  next site as above, so the port holds mean |diff| / max < 0.03, max <
  0.2 and decisions agreeing on > 99.5% of pixels (measured 0.0154-0.0183,
  0.103-0.127, 0.9971-0.9982 in float32 and bfloat16, at amax and 99.8
  calibration; the JAX package's own float32 contract at 99.8 measures
  0.012, 0.089 and 0.9985 on these inputs).
- `make_qat_train_step` (Lovasz, augmentation off) against the JAX
  package's over 3 steps from the same weights, every step's site inputs
  forced to those of the JAX program at JAX's weights before that step:
  step 0's within 1e-5 (measured 1.7e-6), steps 1-2's printed (2.8e-3:
  the port's weights have moved by its own updates); the losses within
  1e-4 at step 0 and 1e-3 after (measured 7.8e-7, 7e-7, 0); each step
  optax.adam's on the port's own gradients (tests/test_torch_port_train.py's
  `check_optax_step`); the update after step 1 pointing where JAX's does
  (cosine >= 0.98 over all weights, norm within 1%; measured 0.99971);
  and the BN state returned unchanged, bit for bit, the very object
  passed in.

BN state with var + eps == 1 (XLA:CPU's rsqrt and torch's differ in the
last bit elsewhere, and the fold then moves int8 bins).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robosat_tpu.checkpoint import convert_torch_unet
from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import unet as junet
from robosat_tpu.ops.augment import normalize as jax_normalize
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel.steps import make_qat_train_step as jax_make_qat_train_step
from robosat_tpu_torch import checkpoint, optim
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qtail, unet
from robosat_tpu_torch.models.layers import depth_to_space2
from robosat_tpu_torch.ops.augment import normalize
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.parallel.steps import make_qat_train_step
from test_torch_checkpoint import _reference_style_state_dict
from test_torch_port_bridge import _exact_var
from test_torch_port_train import _flat, check_optax_step, update_agreement
from test_torch_port_train_forward import COSINE_FLOORS, learnable_batch, torch_threads  # noqa: F401

LR = 1e-4
STEPS = 3
# Free-running gradient cosines at COSINE_FLOORS' leaves (measured 0.99999,
# 0.9997, 0.899, 0.865, 0.884: the forwards part at bin flips).
FREE_COSINE_FLOORS = (0.9999, 0.999, 0.8, 0.8, 0.8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    params, state = convert_torch_unet(_reference_style_state_dict())
    return _np(params), _exact_var(_np(state))


@pytest.fixture(scope="module")
def batches():
    return [learnable_batch(10 + i) for i in range(STEPS)]


@pytest.fixture(scope="module")
def scales(weights, batches):
    """The site scales of the JAX package's 99.8-percentile calibration on
    the first batch."""
    folded = jax.jit(junet.fold)(*weights)
    x = np.asarray(jax_normalize(batches[0][0]))
    amaxes = jax.jit(lambda f, xx: jq8.calibration_amaxes(f, xx, percentile=99.8))(folded, x)
    return [float(s) for s in jq8.scales_from_amaxes(np.asarray(amaxes))]


@pytest.fixture(scope="module")
def jax_recorder(weights, scales):
    """record(params, images, masks) -> (loss, logits, site inputs, grads):
    the JAX package's fake-quant forward, Lovasz loss (the configured one)
    and gradient on one batch, as one program that also returns every
    site's input to `fake_quant_act`."""
    state = weights[1]
    loss_fn = jax_get_loss("Lovasz")
    real = jq8.fake_quant_act

    def loss(p, x, masks):
        taps = []

        def tap(xx, scale):
            taps.append(xx)
            return real(xx, scale)

        jq8.fake_quant_act = tap  # traced once, inside this function only
        try:
            logits = junet.apply_logits_fake_quant(p, state, scales, x)
        finally:
            jq8.fake_quant_act = real
        return loss_fn(logits.astype(jnp.float32), masks, None), (logits, taps)

    program = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def record(params, images, masks):
        (value, (logits, taps)), grads = program(params, np.asarray(jax_normalize(images)), masks)
        return float(value), np.asarray(logits), [np.array(t) for t in taps], _np(grads)

    return record


class _Forced(torch.autograd.Function):
    """The value of `forced`, the gradient passed straight to x."""

    @staticmethod
    def forward(ctx, x, forced):
        return forced

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def forcing(monkeypatch, taps):
    """Patch the port's `fake_quant_act` so that site i quantizes the JAX
    program's input `taps[i]` (gradients pass straight through); returns
    the list that collects, per site, |port input - JAX input| max over the
    JAX input's |max|."""
    errs = []
    real = q8.fake_quant_act

    def forced(xx, scale):
        want = torch.from_numpy(taps[len(errs)]).to(xx.dtype)
        errs.append(float((xx.detach() - want).abs().max() / want.abs().max()))
        return real(_Forced.apply(xx, want), scale)

    monkeypatch.setattr(q8, "fake_quant_act", forced)
    return errs


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _fq_inputs(seed, dtype, scale=0.0371):
    """Normal values, every bin edge r = k + 1/2 for |k| <= 130 (half to
    even), zeros of both signs, and values far past +-127 bins, as `dtype`
    (numpy float32 holding them)."""
    rng = np.random.default_rng(seed)
    inv = np.float32(1.0) / np.float32(scale)
    edges = (np.arange(-130, 131) + 0.5).astype(np.float32) / inv
    x = np.concatenate([rng.normal(size=4000).astype(np.float32) * 3, edges, -edges,
                        np.float32([0.0, -0.0, 1e-4, -1e-4, 200.0, -200.0, 4.7, -4.7])])
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32)), scale


def _bits(a):
    """float32 bits with zeros of either sign as +0."""
    return (np.asarray(a, np.float32) + np.float32(0.0)).view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_act_matches_jax(dtype):
    x, scale = _fq_inputs(1, dtype)
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jax.jit(lambda a: jq8.fake_quant_act(a, scale))(jx).astype(jnp.float32))
    want_grad = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(jq8.fake_quant_act(a, scale).astype(jnp.float32) * g)))(
        jx).astype(jnp.float32))

    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = q8.fake_quant_act(tx, scale)
    (got.float() * torch.from_numpy(g)).sum().backward()
    assert got.dtype == tx.dtype and tx.grad.dtype == tx.dtype
    got, got_grad = got.detach().float().numpy(), tx.grad.float().numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(_bits(got_grad), _bits(want_grad))
    # The gate: zero past +-127 bins, the gradient itself inside.
    r = np.abs(x * np.float32(np.float32(1.0) / np.float32(scale)))
    g_dtype = np.asarray(jnp.asarray(g, dtype).astype(jnp.float32))
    assert np.all(got_grad[r > 128] == 0) and np.array_equal(got_grad[r < 126], g_dtype[r < 126])
    assert np.all(np.abs(got) <= 127 * scale * 1.01)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 3, 8, 16), (1, 1, 64, 256), (4, 4, 320, 128), (3, 3, 128, 128)],
                         ids=["3x3", "1x1", "k4", "s2d"])
def test_fake_quant_weight_matches_jax(dtype, shape):
    """Forward bit-equal (an all-zero output channel included), the
    gradient the identity, and in float32 the grid `_quantize_weight`
    gives predict."""
    rng = np.random.default_rng(sum(shape))
    w = (rng.normal(size=shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0
    g = rng.normal(size=shape).astype(np.float32)
    jw = jnp.asarray(w, dtype)
    want = np.asarray(jax.jit(jq8.fake_quant_weight)(jw).astype(jnp.float32))
    want_grad = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(jq8.fake_quant_weight(a).astype(jnp.float32) * g)))(
        jw).astype(jnp.float32))

    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(getattr(torch, dtype)).requires_grad_(True)
    got = q8.fake_quant_weight(tw)
    (got.float() * torch.from_numpy(g)).sum().backward()
    got, got_grad = got.detach().float().numpy(), tw.grad.float().numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(_bits(got_grad), _bits(want_grad))
    if dtype == "float32":
        wq, ws = q8._quantize_weight(torch.from_numpy(w))
        assert np.array_equal((wq.float() * ws).numpy(), got)


@pytest.fixture(scope="module")
def recorded(weights, batches, jax_recorder):
    return jax_recorder(weights[0], *batches[0])


@pytest.mark.parametrize("mode", ["forced", "free"])
def test_apply_logits_fake_quant_matches_jax(weights, scales, batches, recorded, monkeypatch, mode):
    want_loss, want_logits, taps, want_grads = recorded
    assert len(taps) == 59
    errs = forcing(monkeypatch, taps) if mode == "forced" else None
    images, masks = batches[0]
    params, state = checkpoint.from_jax(*weights)
    leaves = optim.adam(params, LR).param_groups[0]["params"]  # requires_grad on every leaf
    logits = unet.apply_logits_fake_quant(params, state, scales, normalize(torch.from_numpy(images)))
    loss = get_loss("Lovasz")(logits.float(), torch.from_numpy(masks), None)
    loss.backward()
    logits = logits.detach().numpy()
    assert logits.shape == want_logits.shape == (2, 64, 64, 2) and logits.dtype == np.float32

    scale = np.abs(want_logits).max()
    diff = np.abs(logits - want_logits)
    loss = float(loss.detach())
    print("{}: loss port {} JAX {}; logits |diff| max {} mean {} of their max".format(
        mode, loss, want_loss, diff.max() / scale, diff.mean() / scale))
    if mode == "forced":
        assert len(errs) == 59 and max(errs) <= 1e-5, max(errs)
        assert diff.max() <= 1e-5 * scale
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
        cosines = [_cosine(p.grad.numpy(), g) for p, g in zip(leaves, jax.tree_util.tree_leaves(want_grads))]
        print("forced: gradient cosines, min over {} leaves {}".format(len(cosines), min(cosines)))
        assert min(cosines) >= 0.99999
    else:
        assert diff.mean() <= 0.03 * scale
        for (path, _), floor in zip(COSINE_FLOORS, FREE_COSINE_FLOORS):
            c = _cosine(_leaf(params, path).grad.numpy(), _leaf(want_grads, path))
            print("free: {} gradient cosine {:.8f}".format("/".join(map(str, path)), c))
            assert c >= floor, (path, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("percentile", [None, 99.8], ids=["amax", "p99.8"])
def test_qat_contract_against_the_plain_int8_walk(dtype, percentile):
    """Train what ships: the fake-quant logits against the int8 walk's
    (plain versions of K3/K4/K5 and K7, the depth-to-space and the final
    1x1 conv, bf16 epilogues) on the same scales, with the JAX package's
    weights and inputs of tests/test_int8.py's contract test."""
    params, state = junet.init(0, num_classes=2)
    params, state = checkpoint.from_jax(_np(params), _np(state))
    raw = np.random.default_rng(11).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    x = normalize(torch.from_numpy(raw))
    with torch.no_grad():
        folded = unet.fold(params, state)
        scales = q8.scales_from_amaxes(q8.calibration_amaxes(folded, x, percentile=percentile))
        fq = unet.apply_logits_fake_quant(params, state, scales, x.to(dtype)).float().numpy()
        qtree = q8.quantize_unet_folded(folded)
        dec3, s4, s5 = q8.apply_features_int8_to_dec3(qtree, scales, x.to(torch.bfloat16), plain=True)
        feats = qtail.fused_tail_features_plain(dec3, qtree["dec4"], s4, qtree["dec5"], s5)
        int8 = unet.final_logits(qtree["final"], depth_to_space2(feats)).float().numpy()
    scale = np.abs(int8).max()
    mean, worst = np.abs(fq - int8).mean() / scale, np.abs(fq - int8).max() / scale
    agree = ((fq[..., 1] > fq[..., 0]) == (int8[..., 1] > int8[..., 0])).mean()
    print("contract: mean {} max {} of the int8 logits' max, decisions agree {}".format(mean, worst, agree))
    assert mean < 0.03 and worst < 0.2 and agree > 0.995


@pytest.fixture(scope="module")
def jax_run(weights, scales, batches):
    """The JAX package's QAT step over `batches`: (losses, the params before
    each step, the state it returned)."""
    params, state = weights
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    step = jax_make_qat_train_step(junet, jax_get_loss("Lovasz"), optimizer, scales, augment=False)
    losses, before = [], []
    for images, masks in batches:
        before.append(_np(params))
        params, new_state, opt_state, loss, _ = step(params, state, opt_state, jax.random.PRNGKey(0), images, masks)
        losses.append(float(loss))
    return losses, before + [_np(params)], _np(new_state)


def test_qat_train_step_matches_jax(weights, scales, batches, recorded, jax_recorder, jax_run, monkeypatch):
    want_losses, want_params, want_state = jax_run
    for got, want in zip(jax.tree_util.tree_leaves(want_state), jax.tree_util.tree_leaves(weights[1])):
        assert np.array_equal(got, want)  # JAX's QAT step passes the state through too

    params, state = checkpoint.from_jax(*weights)
    state_bits = [t.clone() for t in checkpoint.tree_leaves(state)]
    optimizer = optim.adam(params, LR)
    step = make_qat_train_step(unet, get_loss("Lovasz"), optimizer, scales, augment=False)
    opt_state = optax.adam(LR).init(_flat(jax.tree_util.tree_leaves(weights[0])))
    losses, errs, first = [], [], None
    for i, (images, masks) in enumerate(batches):
        taps = recorded[2] if i == 0 else jax_recorder(want_params[i], images, masks)[2]
        before = _flat([p.detach().numpy() for p in checkpoint.tree_leaves(params)])
        with monkeypatch.context() as patch:
            site_errs = forcing(patch, taps)
            new_state, loss, counts = step(params, state, images, masks)
        assert len(site_errs) == 59
        errs.append(max(site_errs))
        assert new_state is state
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
        assert torch.equal(got, want) and got.view(torch.int32).equal(want.view(torch.int32))
    cos, ratio = update_agreement(first, jax.tree_util.tree_leaves(want_params[1]),
                                  jax.tree_util.tree_leaves(weights[0]))
    print("step-1 update vs JAX: cosine {}, norm ratio {}".format(cos, ratio))
    assert cos >= 0.98 and abs(ratio - 1) <= 0.01, (cos, ratio)
