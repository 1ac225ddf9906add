"""robosat_tpu_torch's train step, Adam and optimizer checkpoints vs the JAX package.

- `make_train_step` (CrossEntropy with dataset-parking's class weights
  here, Lovasz in tests/test_torch_port_losses.py, each file compiling one
  JAX step; augmentation off) over 3 steps from the same weights on the
  same 64-px batches as the JAX package's: step 0's loss within 1e-4
  relative (one forward, no update yet), steps 1-2 within 5% (Adam's first
  updates are ~lr * sign(grad), so float-level sign flips of tiny gradients
  move both faithful trajectories apart; the bound of
  tests/test_torch_train_parity.py), the BN running statistics within
  5e-3. Each step's update is optax.adam's on the port's own gradients
  from its moments (optax replays every step: moments within 1 ulp or
  1e-6 relative, weights too or within 1e-6 * lr), and step 1's update, from the same weights as
  the JAX package's, points where JAX's does: cosine over all 37M weights
  >= 0.98 (measured 0.995), norm within 1%. JAX's trajectory is computed
  in a child process whose XLA:CPU code is capped at AVX2
  (`jax_trajectory`): XLA's AVX-512 code for this step agrees with a
  float64 run of the step less well (step-1 update cosine 0.986, against
  0.995 for its AVX2 code and for the port), and moves with the host's
  instruction set, which put the reference at the bound's edge
  (`run_capped` serves the other modules' JAX train steps too). Per leaf the
  updates cannot be held tighter: ~lr * sign(grad) flips with the float
  summation order wherever a gradient is near zero (per-leaf cosines down
  to 0.88 after step 1, 0.65 after step 2). With `remat` the port gives
  the same losses, weights and BN state bit for bit: the statistics come
  from the first forward.
- `Adam` against optax.adam over 3 steps: weights and both moments within
  1 ulp or 1e-6 relative; a parameter without a gradient moves as optax's
  zero-gradient leaf does.
- The optimizer state's leaves: optax's order (count, then mu, then nu, in
  the params' JAX tree order), round-tripped through the JAX package's
  `leaves_to_opt_state`/`opt_state_to_leaves`.
- A JAX step-1 checkpoint (params, state, opt_state) resumed by the port
  for step 2: the JAX package's step-2 loss; the update over all weights
  at cosine >= 0.999 to JAX's (measured 0.9997) with its norm within 1%;
  and optax's update, from the checkpoint's own optimizer state on the
  port's gradients, to 1 ulp or 1e-6 relative (a resume that dropped the
  moments gives per-leaf cosines down to 0.35, one that kept the count at
  0 a norm 34% too large).
"""

import os
import pickle
import subprocess
import sys
import tempfile

import jax
import numpy as np
import optax
import pytest
import torch

from robosat_tpu import checkpoint as jcheckpoint
from robosat_tpu.checkpoint import convert_torch_unet
from robosat_tpu.models import unet as junet
from robosat_tpu.ops.losses import get_loss as jax_get_loss
from robosat_tpu.parallel.steps import make_train_step as jax_make_train_step
from robosat_tpu_torch import checkpoint, optim
from robosat_tpu_torch.models import unet
from robosat_tpu_torch.ops.losses import get_loss
from robosat_tpu_torch.parallel.steps import make_train_step
from test_torch_checkpoint import _reference_style_state_dict
from test_torch_port_train_forward import WEIGHT, learnable_batch, torch_threads  # noqa: F401

LR = 1e-4
STEPS = 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    params, state = convert_torch_unet(_reference_style_state_dict())
    return _np(params), _np(state)


@pytest.fixture(scope="module")
def batches():
    return [learnable_batch(10 + i) for i in range(STEPS)]


# XLA:CPU's instruction-set cap for the JAX reference trajectory (see the
# module docstring): the same code on every x86-64 host the suite runs on.
REFERENCE_ISA = "AVX2"


def run_capped(func, *args):
    """func(*args) in a child process whose XLA:CPU code is capped at
    REFERENCE_ISA (it starts its own XLA backend): `func` is a module-level
    function of a test module, its arguments and result pickled."""
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "args.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(args, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="{} --xla_cpu_max_isa={}".format(os.environ.get("XLA_FLAGS", ""), REFERENCE_ISA))
        here = os.path.dirname(os.path.abspath(__file__))
        code = "import sys; sys.path[:0] = {!r}; import test_torch_port_train as t; t._child({!r}, {!r}, {!r}, {!r})"
        subprocess.run([sys.executable, "-c", code.format([here, os.path.dirname(here)], func.__module__,
                                                          func.__name__, inp, out)], env=env, check=True, timeout=900)
        with open(out, "rb") as f:
            return pickle.load(f)


def _child(module, name, inp, out):
    import importlib

    jax.config.update("jax_platforms", "cpu")
    with open(inp, "rb") as f:
        args = pickle.load(f)
    result = getattr(importlib.import_module(module), name)(*args)
    with open(out, "wb") as f:
        pickle.dump(result, f)


def jax_trajectory(weights, batches, name):
    """The JAX package's train step over `batches` from `weights`: (losses,
    the params, state and opt_state leaves after steps 1 and 2, the final
    state), computed under `run_capped`."""
    return run_capped(_jax_trajectory, weights, batches, name)


def _jax_trajectory(weights, batches, name):
    params, state = weights
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    step = jax_make_train_step(junet, jax_get_loss(name), optimizer, weight=WEIGHT if name == "CrossEntropy" else None,
                               augment=False)
    losses, after = [], []
    for i, (images, masks) in enumerate(batches):
        params, state, opt_state, loss, _ = step(params, state, opt_state, jax.random.PRNGKey(0), images, masks)
        losses.append(float(loss))
        if i < 2:
            after.append((_np(params), _np(state), [np.asarray(a) for a in jcheckpoint.opt_state_to_leaves(opt_state)]))
    return losses, after, _np(state)


def port_trajectory(weights, batches, name, remat):
    """The port's train step over `batches` from `weights`, each step
    without remat replayed by optax on the port's own gradients
    (`check_optax_step`; remat is held bit-equal to that run): (losses,
    params, state, optimizer, the params after step 1 as numpy leaves, None
    with remat)."""
    params, state = checkpoint.from_jax(*weights)
    optimizer = optim.adam(params, LR)
    step = make_train_step(unet, get_loss(name), optimizer, weight=WEIGHT if name == "CrossEntropy" else None,
                           augment=False, remat=remat)
    opt_state = optax.adam(LR).init(_flat(jax.tree_util.tree_leaves(weights[0])))
    losses, first = [], None
    for images, masks in batches:
        before = None if remat else _flat([p.detach().numpy() for p in checkpoint.tree_leaves(params)])
        state, loss, counts = step(params, state, images, masks)
        if not remat:
            opt_state = check_optax_step(params, optimizer, before, opt_state)
        losses.append(float(loss))
        assert counts.dtype == torch.int32 and int(counts.sum()) == masks.size
        if first is None and not remat:
            first = [p.detach().numpy().copy() for p in checkpoint.tree_leaves(params)]
    return losses, params, state, optimizer, first


def _flat(leaves):
    return np.concatenate([np.asarray(a, np.float32).ravel() for a in leaves])


def check_optax_step(params, optimizer, before, opt_state):
    """The port's step just taken is optax.adam's on the gradients it left
    on `params`, from `before` (the weights' leaves before the step as one
    vector: optax's arithmetic is elementwise) and optax's `opt_state` over
    that vector: both moments within 1 ulp or 1e-6 relative, the weights
    too or within 1e-6 * lr (the update, at most ~lr, one ulp apart: where
    a weight is near zero the sum cancels and that ulp is a large share of
    the weight), the same count. Returns optax's new state."""
    leaves = checkpoint.tree_leaves(params)
    grads = _flat([np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy() for p in leaves])
    updates, opt_state = optax.adam(LR).update(grads, opt_state, before)
    _assert_ulp_or_rtol(_flat([p.detach().numpy() for p in leaves]), optax.apply_updates(before, updates),
                        atol=1e-6 * LR)
    got = checkpoint.opt_state_to_leaves(optimizer)
    want = opt_state[0]
    assert int(got[0]) == int(want.count) == optimizer.count
    _assert_ulp_or_rtol(_flat(got[1:1 + len(leaves)]), want.mu)
    _assert_ulp_or_rtol(_flat(got[1 + len(leaves):]), want.nu)
    return opt_state


def optax_state(leaves):
    """optax.adam's state over the flat weights from a checkpoint's optimizer
    leaves [count, mu..., nu...]."""
    n = (len(leaves) - 1) // 2
    mu, nu = _flat(leaves[1:1 + n]), _flat(leaves[1 + n:])
    state = optax.adam(LR).init(mu)
    return (state[0]._replace(count=np.asarray(leaves[0], np.int32), mu=mu, nu=nu),) + tuple(state[1:])


def update_agreement(got, want, start):
    """(cosine, norm ratio) of the update `got - start` against `want -
    start`, each a list of leaves, over all of them together."""
    u = np.concatenate([(np.asarray(g, np.float64) - np.asarray(s, np.float64)).ravel() for g, s in zip(got, start)])
    w = np.concatenate([(np.asarray(g, np.float64) - np.asarray(s, np.float64)).ravel() for g, s in zip(want, start)])
    return float(u @ w / (np.linalg.norm(u) * np.linalg.norm(w) + 1e-30)), float(np.linalg.norm(u) / np.linalg.norm(w))


def port_trajectories(weights, batches, name):
    """port_trajectory by `remat`, computed on first use."""
    cache = {}

    def get(remat):
        if remat not in cache:
            cache[remat] = port_trajectory(weights, batches, name, remat)
        return cache[remat]

    return get


def check_train_step(want, port, remat, start):
    """The port's trajectory (remat on or off) against the JAX package's
    `want` from the params `start`; with remat, bit-equal to the port's
    plain trajectory too."""
    want_losses, want_after, want_state = want
    losses, params, state, optimizer, first = port(remat)
    context = "port {} vs JAX {}".format(losses, want_losses)
    assert abs(losses[0] - want_losses[0]) <= 1e-4 * abs(want_losses[0]), context
    for i in (1, 2):
        assert abs(losses[i] - want_losses[i]) <= 0.05 * abs(want_losses[i]), context
    for k in ("mean", "var"):
        np.testing.assert_allclose(state["encoder"]["bn1"][k].numpy(), want_state["encoder"]["bn1"][k], atol=5e-3,
                                   rtol=5e-3)
    assert optimizer.count == STEPS
    if remat:
        ref_losses, ref_params, ref_state, _, _ = port(False)
        assert losses == ref_losses
        for got, ref in zip(checkpoint.tree_leaves(params) + checkpoint.tree_leaves(state),
                            checkpoint.tree_leaves(ref_params) + checkpoint.tree_leaves(ref_state)):
            assert torch.equal(got, ref)
    else:
        cos, ratio = update_agreement(first, jax.tree_util.tree_leaves(want_after[0][0]),
                                      jax.tree_util.tree_leaves(start))
        print("step-1 update vs JAX: cosine {}, norm ratio {}".format(cos, ratio))
        assert cos >= 0.98 and abs(ratio - 1) <= 0.01, (cos, ratio)


@pytest.fixture(scope="module")
def jax_run(weights, batches):
    return jax_trajectory(weights, batches, "CrossEntropy")


@pytest.fixture(scope="module")
def port_runs(weights, batches):
    return port_trajectories(weights, batches, "CrossEntropy")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_train_step_matches_jax(weights, jax_run, port_runs, remat):
    """CrossEntropy with dataset-parking's weights (Lovasz:
    tests/test_torch_port_losses.py::test_lovasz_train_step_matches_jax)."""
    check_train_step(jax_run, port_runs, remat, weights[0])


def _assert_ulp_or_rtol(got, want, rtol=1e-6, atol=0.0):
    got, want = np.asarray(got, np.float32).ravel(), np.asarray(want, np.float32).ravel()
    differ = np.flatnonzero(got != want)
    got, want = got[differ], want[differ]
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    err = np.abs(got.astype(np.float64) - want)
    rel = err / np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    assert np.all((ulps <= 1) | (rel <= rtol) | (err <= atol)), "max ulps {}, max rel {}, max abs {}".format(
        ulps.max(initial=0), rel.max(initial=0), err.max(initial=0))


def test_adam_matches_optax():
    rng = np.random.default_rng(11)
    params = {"b": [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=5).astype(np.float32)],
              "a": {"w": rng.normal(size=(2, 2, 3, 4)).astype(np.float32)}, "frozen": np.ones(3, np.float32)}
    optimizer = optax.adam(LR)
    opt_state = optimizer.init(params)
    want = params
    tparams, _ = checkpoint.from_jax(params, {})
    adam = optim.adam(tparams, LR)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * 10.0 ** rng.integers(-6, 1)).astype(
            np.float32), params)
        grads["frozen"] = np.zeros(3, np.float32)  # the port's parameter has no gradient at all
        updates, opt_state = optimizer.update(grads, opt_state, want)
        want = optax.apply_updates(want, updates)
        adam.zero_grad(set_to_none=True)
        for p, g in zip(checkpoint.tree_leaves(tparams), jax.tree_util.tree_leaves(grads)):
            if p is not tparams["frozen"]:
                p.grad = torch.from_numpy(g)
        adam.step()
    for got, ref in zip(checkpoint.tree_leaves(tparams), jax.tree_util.tree_leaves(want)):
        _assert_ulp_or_rtol(got.detach().numpy(), ref)
    got_leaves = checkpoint.opt_state_to_leaves(adam)
    want_leaves = jcheckpoint.opt_state_to_leaves(opt_state)
    assert len(got_leaves) == len(want_leaves) == 1 + 2 * 4
    assert got_leaves[0].dtype == want_leaves[0].dtype == np.int32 and int(got_leaves[0]) == int(want_leaves[0]) == 3
    for got, ref in zip(got_leaves[1:], want_leaves[1:]):
        _assert_ulp_or_rtol(got, ref)


def test_opt_state_leaves_round_trip(weights):
    """The port's leaves rebuild optax's state with each moment at its own
    parameter (a marker value per leaf), and back."""
    params, state = weights
    tparams, _ = checkpoint.from_jax(params, state)
    adam = optim.adam(tparams, LR)
    adam.count = 7
    leaves = checkpoint.tree_leaves(tparams)
    for i, p in enumerate(leaves):
        mu, nu = adam.moments(p)
        mu.fill_(i)
        nu.fill_(-i)
    port_leaves = checkpoint.opt_state_to_leaves(adam)

    template = optax.adam(LR).init(params)
    opt_state = jcheckpoint.leaves_to_opt_state(template, port_leaves)
    adam_state = opt_state[0]
    assert int(adam_state.count) == 7

    def at(tree, path):
        for key in path:
            tree = tree[key.key if hasattr(key, "key") else key.idx]
        return tree

    paths = [path for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert len(paths) == len(leaves)
    for i, path in enumerate(paths):
        assert at(tparams, path) is leaves[i]
        assert np.all(np.asarray(at(adam_state.mu, path)) == i) and np.all(np.asarray(at(adam_state.nu, path)) == -i)

    fresh = optim.adam(checkpoint.from_jax(params, state)[0], LR)
    checkpoint.leaves_to_opt_state(fresh, jcheckpoint.opt_state_to_leaves(opt_state))
    assert fresh.count == 7
    for got, ref in zip(checkpoint.opt_state_to_leaves(fresh)[1:], port_leaves[1:]):
        assert np.array_equal(got, ref)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.leaves_to_opt_state(fresh, port_leaves[:-1])


def test_jax_checkpoint_resumes_in_port(tmp_path, jax_run, batches):
    """JAX's step-1 checkpoint (its npz, opt_state included) takes the
    port's step 2 to the JAX package's step-2 loss and update (cosine >=
    0.999, norm within 1%), and to optax's update from the checkpoint's
    optimizer state on the port's gradients."""
    want_losses, want_after, _ = jax_run
    params, state, opt_leaves = want_after[0]
    jcheckpoint.save_checkpoint(str(tmp_path / "step1"), {"params": params, "state": state, "opt_state": opt_leaves},
                                meta={"epoch": 1})
    trees, meta = checkpoint.load_checkpoint(str(tmp_path / "step1.npz"))
    tparams, tstate, leaves = checkpoint.from_jax(trees["params"], trees["state"], opt_state=trees["opt_state"])
    optimizer = checkpoint.leaves_to_opt_state(optim.adam(tparams, LR), leaves)
    assert optimizer.count == 1 and meta == {"epoch": 1}
    step = make_train_step(unet, get_loss("CrossEntropy"), optimizer, weight=WEIGHT, augment=False)
    tstate, loss, _ = step(tparams, tstate, *batches[1])
    assert optimizer.count == 2
    np.testing.assert_allclose(float(loss), want_losses[1], rtol=1e-4)
    check_optax_step(tparams, optimizer, _flat(jax.tree_util.tree_leaves(params)), optax_state(opt_leaves))
    cos, ratio = update_agreement([p.detach().numpy() for p in checkpoint.tree_leaves(tparams)],
                                  jax.tree_util.tree_leaves(want_after[1][0]), jax.tree_util.tree_leaves(params))
    print("step-2 update vs JAX: cosine {}, norm ratio {}".format(cos, ratio))
    assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (cos, ratio)
