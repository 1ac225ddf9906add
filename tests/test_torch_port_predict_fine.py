"""robosat_tpu_torch: the int8 step on fine input and the float predict steps vs the JAX package.

- The int8 step on fine input (`host_s2d=False`: the fine stem; fine output
  through K6 at overlap 0, or K7 and the unfused head) gives the JAX
  package's bins on the same weights and amaxes.
- The float step (fp32 and bf16; host_s2d, s2d, fine-grid and unfused
  forms) holds the tolerances stated in its test.

Split from tests/test_torch_port_predict.py (whose `model` fixture and bin
helpers it takes), so that the test runner's per-file workers share the
cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.models import unet as junet
from robosat_tpu.models.layers import space_to_depth4 as jax_space_to_depth4
from robosat_tpu.parallel.steps import make_int8_predict_step as jax_make_int8_predict_step
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models import unet
from robosat_tpu_torch.parallel.steps import make_int8_predict_step
from test_torch_port_predict import MAX_FLIP_SHARE, _assert_close_bins, _bin_distance, model  # noqa: F401
from torch_port_refs import unet_calibration


@pytest.fixture(scope="module")
def fine_model(model):
    """Fine uint8 input and the JAX package's amaxes from a fine-stem
    calibration of it (blocked=False)."""
    params, state, _, _ = model
    raw = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    folded = jax.jit(junet.fold)(params, state)
    amaxes = np.asarray(unet_calibration(folded, raw, blocked=False, percentile=99.8))
    return params, state, raw, amaxes


@pytest.mark.parametrize("overlap", [0, 2, 3])
@pytest.mark.parametrize("fused_head", [True, False], ids=["fused", "unfused"])
def test_int8_predict_step_fine_input_matches_jax(fine_model, fused_head, overlap):
    """`host_s2d=False`: the fine bf16 stem (7x7/s2 conv and max pool), the
    int8 walk, then K6 at overlap 0 and the fine crop (fused head) or K7
    and the unfused head, against the JAX step with `host_s2d=False` on the
    same amaxes. Bit-equal uint8 is the target; the allowance is one bin on
    at most 0.1% of the pixels, counted and printed (measured on the CPU: 0
    differ)."""
    params, state, raw, amaxes = fine_model
    jstep, jqt = jax_make_int8_predict_step(
        junet, params, state, raw, overlap=overlap, fused_head=fused_head, host_s2d=False, calib_amaxes=amaxes
    )
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(unet, tp, ts, raw, overlap=overlap, fused_head=fused_head,
                                         calib_amaxes=amaxes)
    got = step(qtree, raw)
    assert tuple(got.shape) == (2, 64 - 2 * overlap, 64 - 2 * overlap)
    _assert_close_bins(got.numpy(), np.asarray(jstep(jqt, raw)))
    assert torch.equal(step(qtree, raw, plain=True), got)


@pytest.fixture(scope="module")
def float_model(model):
    params, state, _, _ = model
    raw = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    return params, state, raw, from_jax(params, state)


@pytest.mark.parametrize(
    "fused_head,host_s2d,s2d,overlap,shape",
    [(True, True, True, 8, (2, 24, 24, 4)), (True, False, True, 8, (2, 48, 48)), (True, False, False, 8, (2, 48, 48)),
     (False, True, True, 8, (2, 48, 48))],
    ids=["host_s2d", "s2d", "fine", "unfused"],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_step_matches_jax(float_model, fused_head, host_s2d, s2d, overlap, shape, dtype):
    """The float step (K1 at G = 4 blocked or before the depth-to-space, at
    G = 1 on the fine grid; unfused, the final conv, softmax and digitize
    on the fine forward, which ignores host_s2d as the JAX step does)
    against the JAX step. float32: at most 0.1% of pixels differ, by one bin
    (the convolutions sum in other orders than XLA's). bfloat16: the bf16
    intermediates then differ by an ulp here and there and the bins move
    with them; >= 99% of pixels are within one bin (measured on the CPU:
    99.74% blocked, 99.76% for both fine forms and unfused; all float32
    pixels equal)."""
    from robosat_tpu.parallel.steps import make_predict_step as jax_make_predict_step
    from robosat_tpu_torch.parallel.steps import make_predict_step

    params, state, raw, (tp, ts) = float_model
    raw_in = jax_space_to_depth4(raw) if host_s2d and fused_head else raw
    jstep = jax_make_predict_step(junet, overlap=overlap, compute_dtype=getattr(jnp, dtype), fused_head=fused_head,
                                  s2d=s2d, host_s2d=host_s2d)
    ref = np.asarray(jstep(params, state, raw_in))
    step = make_predict_step(unet, overlap=overlap, compute_dtype=getattr(torch, dtype), fused_head=fused_head,
                             s2d=s2d, host_s2d=host_s2d)
    got = step(tp, ts, raw_in)
    assert got.dtype == torch.uint8 and tuple(got.shape) == ref.shape == shape
    assert torch.equal(step(tp, ts, raw_in, plain=True), got)
    d = _bin_distance(got.numpy(), ref)
    within = float((d <= 1).mean())
    print("{} {}: {:.4%} of pixels within one bin, {} of {} differ".format(dtype, shape, within, int((d != 0).sum()),
                                                                          d.size))
    if dtype == "float32":
        assert d.max() <= 1 and (d != 0).sum() <= MAX_FLIP_SHARE * d.size
    else:
        assert within >= 0.99
