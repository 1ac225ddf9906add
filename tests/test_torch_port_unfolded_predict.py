"""robosat_tpu_torch's float predict step without folding batch norm
(`make_predict_step(..., fold_bn=False)`) vs the JAX package's, on the CPU.

The JAX package's weights cross through the npz bridge (`checkpoint.from_jax`);
the input is one seeded 64-px uint8 tile, in float32. The step runs the
params as they are, batch norm in eval mode:

- the fast family (no `apply_features`): `apply`, the softmax, the digitize
  and the crop, with `fused_head` false and true (the JAX step takes the same
  branch for both);
- the U-Net with `fused_head`: `apply_features` through the fine-grid head
  (K1's plain version here), the kernel and plain forms equal.

Held as the other predict-parity tests hold the float32 step: at most 0.1%
of the pixels differ, by one bin (the convolutions and batch norms sum in
other orders than XLA's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.models import fastnet as jfastnet
from robosat_tpu.models import unet as junet
from robosat_tpu.parallel.steps import make_predict_step as jax_make_predict_step
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models import fastnet, unet
from robosat_tpu_torch.parallel.steps import make_predict_step
from test_torch_port_predict import _assert_close_bins

FAMILIES = {"fast": (jfastnet, fastnet), "unet": (junet, unet)}


@pytest.fixture(scope="module")
def raw():
    return np.random.default_rng(11).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def weights():
    return {name: jmodel.init(0, num_classes=2) for name, (jmodel, _) in FAMILIES.items()}


@pytest.mark.parametrize("family,fused_head,overlap", [("fast", False, 8), ("fast", True, 0), ("unet", True, 8)])
def test_unfolded_predict_step_matches_jax(raw, weights, family, fused_head, overlap):
    jmodel, model = FAMILIES[family]
    params, state = weights[family]
    jstep = jax_make_predict_step(jmodel, overlap=overlap, compute_dtype=jnp.float32, fused_head=fused_head,
                                  fold_bn=False)
    ref = np.asarray(jstep(params, state, raw))
    step = make_predict_step(model, overlap=overlap, compute_dtype=torch.float32, fused_head=fused_head,
                             fold_bn=False)
    tp, ts = from_jax(params, state)
    got = step(tp, ts, raw)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape == (1, 64 - 2 * overlap, 64 - 2 * overlap)
    assert torch.equal(step(tp, ts, raw, plain=True), got)
    _assert_close_bins(got.numpy(), ref)


def test_unfolded_predict_step_runs_the_params_unfolded(raw, weights):
    """The unfolded step reads the batch norms' running statistics from
    `state` at every call: a changed state changes the bins, as it does for
    the JAX step."""
    params, state = weights["fast"]
    tp, ts = from_jax(params, state)
    step = make_predict_step(fastnet, compute_dtype=torch.float32, fold_bn=False)
    before = step(tp, ts, raw)
    ts["stem_bn"]["mean"] = ts["stem_bn"]["mean"] + 1.0
    assert not torch.equal(step(tp, ts, raw), before)
