"""robosat_tpu_torch: the int8 walk and the int8 predict step vs the JAX package.

- The walk (every int8 site through the kernels' plain versions on the
  CPU), fed the JAX stem's output and the JAX qtree, equals
  q8.apply_features_int8_to_dec3 bit for bit on a full-width U-Net.
- The whole int8 step on host-blocked input, on the same weights and the
  same per-site amaxes (a fresh calibration agrees only to float32
  summation order, which int8 rounding amplifies), gives equal uint8 or
  differs by one bin on at most 0.1% of the pixels (the bf16 stem's
  summation order is the only allowed source; the distance is taken modulo
  256, since p == 1.0 wraps to 0). With `pallas_tail = "tail"` or `"sep"`
  no bin differs. The unfused head (`fused_head = false`: the final 1x1
  conv, softmax and digitize) gives the JAX package's bins.

The int8 step on fine input and the float steps are in
tests/test_torch_port_predict_fine.py, the `predict` tool in
tests/test_torch_port_predict_tool.py; both take this module's `model`
fixture and bin helpers.

The BN state has var + eps == 1 in float32, where rsqrt is exact in both
packages: XLA:CPU's rsqrt and torch's differ in the last bit elsewhere, and
int8 rounding amplifies a 1-ulp change of every folded weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import resnet as jresnet
from robosat_tpu.models import unet as junet
from robosat_tpu.models.layers import space_to_depth4 as jax_space_to_depth4
from robosat_tpu.parallel.steps import _normalize_s2d4 as jax_normalize_s2d4
from robosat_tpu.parallel.steps import make_int8_predict_step as jax_make_int8_predict_step
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import unet
from robosat_tpu_torch.parallel.steps import make_int8_predict_step

MAX_FLIP_SHARE = 0.001


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _exact_var(tree):
    if isinstance(tree, dict):
        return {k: (np.full_like(v, np.float32(1.0) - np.float32(1e-5)) if k == "var" else _exact_var(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_exact_var(v) for v in tree]
    return tree


def _bin_distance(a, b):
    d = (a.astype(np.int32) - b.astype(np.int32)) % 256
    return np.minimum(d, 256 - d)


def _assert_close_bins(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = _bin_distance(got, ref)
    flips = int((d != 0).sum())
    print("uint8 bins differing: {} of {} (max distance {})".format(flips, d.size, d.max(initial=0)))
    assert d.max(initial=0) <= 1
    assert flips <= MAX_FLIP_SHARE * d.size


@pytest.fixture(scope="module")
def model():
    params, state = junet.init(0, num_classes=2)
    state = _exact_var(state)
    raw48 = jax_space_to_depth4(np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    folded = jax.jit(junet.fold)(params, state)
    amaxes = np.asarray(
        jax.jit(lambda f, r: jq8.calibration_amaxes(f, jax_normalize_s2d4(r), blocked=True, percentile=99.8))(
            folded, raw48
        )
    )
    return params, state, raw48, amaxes


def test_walk_from_jax_stem_bit_equal(model):
    params, state, raw48, amaxes = model
    jqt = jax.jit(jq8.quantize_unet_folded)(jax.jit(junet.fold)(params, state))
    scales = jq8.scales_from_amaxes(amaxes)
    x = jax_normalize_s2d4(raw48).astype(jnp.bfloat16)
    ref = jax.jit(lambda q, xx: jq8.apply_features_int8_to_dec3(q, scales, xx, blocked=True)[0])(jqt, x)
    stem = jresnet.stem_folded_s2d4(jqt["encoder"]["conv1"], x)

    tq, _ = from_jax(_np(jqt), {})
    sites = q8._Sites(scales=list(scales))
    got = q8._walk_from_stem(tq, torch.from_numpy(np.asarray(stem, np.float32)).to(torch.bfloat16), sites,
                             stop_at="dec3")
    assert sites.idx == len(scales) - 2
    assert tuple(got.shape) == ref.shape == (2, 32, 32, 128)
    assert int((np.asarray(ref, np.float32) != got.float().numpy()).sum()) == 0


def test_int8_predict_step_matches_jax(model):
    params, state, raw48, amaxes = model
    jstep, jqt = jax_make_int8_predict_step(
        junet, params, state, raw48, overlap=0, fused_head=True, host_s2d=True, calib_amaxes=amaxes
    )
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=0, host_s2d=True, calib_amaxes=amaxes)
    got = step(qtree, raw48)
    assert tuple(got.shape) == (2, 32, 32, 4)
    _assert_close_bins(got.numpy(), np.asarray(jstep(jqt, raw48)))
    assert torch.equal(step(qtree, raw48, plain=True), got)


def test_int8_predict_step_crops_overlap(model):
    """An even overlap crops the blocked output on its grid; an odd one
    gives the fine output, cropped on the fine grid (K6 at overlap 0, then
    the depth-to-space)."""
    from robosat_tpu_torch.ops.head import fine_from_blocked

    params, state, raw48, amaxes = model
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=8, host_s2d=True, calib_amaxes=amaxes)
    full, _ = make_int8_predict_step(unet, tp, ts, raw48, overlap=0, host_s2d=True, calib_amaxes=amaxes)
    cropped = step(qtree, raw48)
    assert tuple(cropped.shape) == (2, 24, 24, 4)
    assert torch.equal(cropped, full(qtree, raw48)[:, 4:-4, 4:-4])
    odd, _ = make_int8_predict_step(unet, tp, ts, raw48, overlap=3, host_s2d=True, calib_amaxes=amaxes)
    fine = odd(qtree, raw48)
    assert tuple(fine.shape) == (2, 58, 58)
    assert torch.equal(fine, fine_from_blocked(full(qtree, raw48), 3))


@pytest.mark.parametrize("pallas_tail,overlap,shape", [("tail", 8, (2, 24, 24, 4)), ("sep", 8, (2, 12, 12, 16))])
def test_int8_predict_step_pallas_tail_matches_jax(model, pallas_tail, overlap, shape):
    """`pallas_tail = "tail"` (K7 + K1 at G = 4) and `"sep"` (K8 + K9 + K1 at
    G = 16, doubly blocked) against the JAX step with the same key: 0
    differing bins."""
    params, state, raw48, amaxes = model
    jstep, jqt = jax_make_int8_predict_step(
        junet, params, state, raw48, overlap=overlap, fused_head=True, host_s2d=True, calib_amaxes=amaxes,
        pallas_tail=pallas_tail,
    )
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=overlap, host_s2d=True, calib_amaxes=amaxes,
                                         pallas_tail=pallas_tail)
    got = step(qtree, raw48)
    assert tuple(got.shape) == shape
    ref = np.asarray(jstep(jqt, raw48))
    assert ref.shape == shape
    assert int((_bin_distance(got.numpy(), ref) != 0).sum()) == 0
    assert torch.equal(step(qtree, raw48, plain=True), got)


@pytest.mark.parametrize("overlap,shape", [(0, (2, 64, 64)), (8, (2, 48, 48)), (3, (2, 58, 58))])
def test_int8_predict_step_unfused_matches_jax(model, overlap, shape):
    """`fused_head=False` on host-blocked input: K7's dec5 features, the
    depth-to-space, the bf16 final 1x1 conv, softmax and digitize on the
    fine grid (any overlap) against the JAX step's; within one bin on at
    most 0.1% of the pixels (measured on the CPU: 0 differ)."""
    params, state, raw48, amaxes = model
    jstep, jqt = jax_make_int8_predict_step(
        junet, params, state, raw48, overlap=overlap, fused_head=False, host_s2d=True, calib_amaxes=amaxes
    )
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=overlap, fused_head=False, host_s2d=True,
                                         calib_amaxes=amaxes)
    got = step(qtree, raw48)
    assert tuple(got.shape) == shape
    _assert_close_bins(got.numpy(), np.asarray(jstep(jqt, raw48)))
    assert torch.equal(step(qtree, raw48, plain=True), got)


def test_int8_predict_step_rejects_blocked_input_on_the_fine_stem(model):
    """A 4x4-blocked batch fed to the fine stem fails on its 48 channels."""
    params, state, raw48, amaxes = model
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=0, calib_amaxes=amaxes)
    with pytest.raises(RuntimeError):
        step(qtree, raw48)


def test_int8_predict_step_pallas_tail_errors(model):
    params, state, raw48, amaxes = model
    tp, ts = from_jax(params, state)
    with pytest.raises(ValueError, match="even overlap"):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=3, host_s2d=True, calib_amaxes=amaxes, pallas_tail="tail")
    with pytest.raises(ValueError, match="multiple of 4"):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=6, host_s2d=True, calib_amaxes=amaxes, pallas_tail="sep")
    with pytest.raises(ValueError, match="pallas_tail"):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=0, host_s2d=True, calib_amaxes=amaxes,
                               pallas_tail="strips")
    with pytest.raises(ValueError, match="fused_head"):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=0, fused_head=False, host_s2d=True, calib_amaxes=amaxes,
                               pallas_tail="tail")
    # "full", "tail" and "sep" need blocked output, which fine input never gives.
    with pytest.raises(ValueError, match="host_s2d"):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=0, calib_amaxes=amaxes, pallas_tail="full")
