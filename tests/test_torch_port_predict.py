"""robosat_tpu_torch: the int8 walk, the predict steps and `predict` vs the JAX package.

- The walk (every int8 site through the kernels' plain versions on the
  CPU), fed the JAX stem's output and the JAX qtree, equals
  q8.apply_features_int8_to_dec3 bit for bit on a full-width U-Net.
- The whole int8 step and the `predict` tool, on the same weights and the
  same per-site amaxes (for the tool, a QAT checkpoint's `qat_amaxes`: a
  fresh calibration agrees only to float32 summation order, which int8
  rounding amplifies), give equal uint8 or differ by one bin on at most
  0.1% of the pixels (the bf16 stem's summation order is the only allowed
  source; the distance is taken modulo 256, since p == 1.0 wraps to 0).
  With `pallas_tail = "tail"` or `"sep"` no bin differs.
- The float step (fp32 and bf16; host_s2d, s2d and fine-grid forms) and
  the bf16 `predict` hold the tolerances stated in their tests.

The BN state has var + eps == 1 in float32, where rsqrt is exact in both
packages: XLA:CPU's rsqrt and torch's differ in the last bit elsewhere, and
int8 rounding amplifies a 1-ulp change of every folded weight.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from robosat_tpu.checkpoint import save_checkpoint
from robosat_tpu.config import save_config
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
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=0, calib_amaxes=amaxes)
    got = step(qtree, raw48)
    assert tuple(got.shape) == (2, 32, 32, 4)
    _assert_close_bins(got.numpy(), np.asarray(jstep(jqt, raw48)))
    assert torch.equal(step(qtree, raw48, plain=True), got)


def test_int8_predict_step_crops_overlap(model):
    params, state, raw48, amaxes = model
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=8, calib_amaxes=amaxes)
    full, _ = make_int8_predict_step(unet, tp, ts, raw48, overlap=0, calib_amaxes=amaxes)
    cropped = step(qtree, raw48)
    assert tuple(cropped.shape) == (2, 24, 24, 4)
    assert torch.equal(cropped, full(qtree, raw48)[:, 4:-4, 4:-4])
    with pytest.raises(NotImplementedError):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=3, calib_amaxes=amaxes)


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
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=overlap, calib_amaxes=amaxes,
                                         pallas_tail=pallas_tail)
    got = step(qtree, raw48)
    assert tuple(got.shape) == shape
    ref = np.asarray(jstep(jqt, raw48))
    assert ref.shape == shape
    assert int((_bin_distance(got.numpy(), ref) != 0).sum()) == 0
    assert torch.equal(step(qtree, raw48, plain=True), got)


def test_int8_predict_step_pallas_tail_errors(model):
    params, state, raw48, amaxes = model
    tp, ts = from_jax(params, state)
    with pytest.raises(ValueError, match="even overlap"):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=3, calib_amaxes=amaxes, pallas_tail="tail")
    with pytest.raises(ValueError, match="multiple of 4"):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=6, calib_amaxes=amaxes, pallas_tail="sep")
    with pytest.raises(ValueError, match="pallas_tail"):
        make_int8_predict_step(unet, tp, ts, raw48, overlap=0, calib_amaxes=amaxes, pallas_tail="strips")


@pytest.fixture(scope="module")
def float_model(model):
    params, state, _, _ = model
    raw = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    return params, state, raw, from_jax(params, state)


@pytest.mark.parametrize(
    "host_s2d,s2d,overlap,shape",
    [(True, True, 8, (2, 24, 24, 4)), (False, True, 8, (2, 48, 48)), (False, False, 8, (2, 48, 48))],
    ids=["host_s2d", "s2d", "fine"],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_step_matches_jax(float_model, host_s2d, s2d, overlap, shape, dtype):
    """The float step (K1 at G = 4 blocked or before the depth-to-space, at
    G = 1 on the fine grid) against the JAX step. float32: at most 0.1% of
    pixels differ, by one bin (the convolutions sum in other orders than
    XLA's). bfloat16: the bf16 intermediates then differ by an ulp here and
    there and the bins move with them; >= 99% of pixels are within one bin
    (measured on the CPU: 99.74% blocked, 99.76% for both fine forms; all
    float32 pixels equal)."""
    from robosat_tpu.parallel.steps import make_predict_step as jax_make_predict_step
    from robosat_tpu_torch.parallel.steps import make_predict_step

    params, state, raw, (tp, ts) = float_model
    raw_in = jax_space_to_depth4(raw) if host_s2d else raw
    jstep = jax_make_predict_step(junet, overlap=overlap, compute_dtype=getattr(jnp, dtype), fused_head=True,
                                  s2d=s2d, host_s2d=host_s2d)
    ref = np.asarray(jstep(params, state, raw_in))
    step = make_predict_step(unet, overlap=overlap, compute_dtype=getattr(torch, dtype), s2d=s2d, host_s2d=host_s2d)
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


def _predict_args(tmp_path, tiles, probs, checkpoint, **overrides):
    args = dict(
        batch_size=2, checkpoint=checkpoint, overlap=0, strip=1, tile_size=64, workers=2, shard=None,
        tiles=str(tiles), probs=str(probs), model=str(tmp_path / "model.toml"),
        dataset=str(tmp_path / "dataset.toml"), profile=None, png_optimize=False,
    )
    args.update(overrides)
    return argparse.Namespace(**args)


@pytest.fixture(scope="module")
def predict_fixture(tmp_path_factory, model):
    """Two 64-px tiles, a checkpoint and the model/dataset configs."""
    params, state, _, amaxes = model
    root = tmp_path_factory.mktemp("port_predict")
    rng = np.random.default_rng(11)
    for y in (104945, 104946):
        d = root / "tiles" / "18" / "69623"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(d / "{}.png".format(y))
    checkpoint = str(root / "model.npz")
    save_checkpoint(checkpoint, {"params": params, "state": state}, meta={"epoch": 1})
    qat_checkpoint = str(root / "model_qat.npz")
    save_checkpoint(qat_checkpoint, {"params": params, "state": state},
                    meta={"epoch": 1, "qat_amaxes": [float(a) for a in amaxes]})
    save_config({"common": {"cuda": False, "batch_size": 2, "image_size": 64, "checkpoint": str(root),
                            "bf16": True, "int8": True}}, str(root / "model.toml"))
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(root / "dataset.toml"))
    return root, checkpoint, qat_checkpoint


def test_predict_tool_calibrates_on_first_batch(predict_fixture):
    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    out = predict.main(_predict_args(root, root / "tiles", root / "probs_calibrated", checkpoint))
    assert out["tiles"] == 2 and out["steady_s"] >= 0.0
    pngs = list((root / "probs_calibrated").rglob("*.png"))
    assert len(pngs) == 2
    for path in pngs:
        img = Image.open(path)
        assert img.mode == "P" and img.size == (64, 64)


def test_predict_tool_matches_jax(predict_fixture):
    from robosat_tpu.tools import predict as jax_predict
    from robosat_tpu_torch.tools import predict

    root, _, checkpoint = predict_fixture
    out = predict.main(_predict_args(root, root / "tiles", root / "probs_torch", checkpoint))
    assert out["tiles"] == 2
    jax_predict.main(_predict_args(root, root / "tiles", root / "probs_jax", checkpoint))
    pngs = sorted(p.relative_to(root / "probs_jax") for p in (root / "probs_jax").rglob("*.png"))
    assert len(pngs) == 2
    for rel in pngs:
        ref_img, got_img = Image.open(root / "probs_jax" / rel), Image.open(root / "probs_torch" / rel)
        assert got_img.mode == "P" and got_img.size == (64, 64)
        assert got_img.getpalette() == ref_img.getpalette()
        _assert_close_bins(np.asarray(got_img), np.asarray(ref_img))


@pytest.mark.parametrize(
    "common,min_within",
    [({"int8": True, "pallas_tail": "sep"}, None), ({"int8": False, "bf16": True}, 0.99)],
    ids=["sep", "bf16"],
)
def test_predict_tool_model_keys_match_jax(tmp_path, predict_fixture, common, min_within):
    """`rs predict` through a `pallas_tail = "sep"` TOML (the doubly-blocked
    output, peeled once by the writer) and an `int8 = false` TOML (the bf16
    float predict) against the JAX tool: the int8 PNGs equal, the bf16 ones
    within one bin on >= 99% of pixels."""
    from robosat_tpu.tools import predict as jax_predict
    from robosat_tpu_torch.tools import predict

    root, _, checkpoint = predict_fixture
    save_config({"common": {"cuda": False, "batch_size": 2, "image_size": 64, "checkpoint": str(root), **common}},
                str(tmp_path / "model.toml"))
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(tmp_path / "dataset.toml"))
    assert predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs_torch", checkpoint))["tiles"] == 2
    jax_predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs_jax", checkpoint))
    pngs = sorted(p.relative_to(tmp_path / "probs_jax") for p in (tmp_path / "probs_jax").rglob("*.png"))
    assert len(pngs) == 2
    for rel in pngs:
        ref_img, got_img = Image.open(tmp_path / "probs_jax" / rel), Image.open(tmp_path / "probs_torch" / rel)
        assert got_img.mode == "P" and got_img.size == (64, 64)
        assert got_img.getpalette() == ref_img.getpalette()
        d = _bin_distance(np.asarray(got_img), np.asarray(ref_img))
        print("{}: {} of {} pixels differ, max distance {}".format(rel, int((d != 0).sum()), d.size, d.max()))
        if min_within is None:
            assert int((d != 0).sum()) == 0
        else:
            assert (d <= 1).mean() >= min_within


@pytest.mark.parametrize(
    "common,overrides",
    [({"int8": False, "fused_head": False}, {}), ({"host_s2d": False}, {}), ({}, {"strip": 2}),
     ({}, {"profile": "trace"}),
     ({"model": "deeplabv3plus"}, {}), ({"int8_calibration": "pc"}, {})],
    ids=["fp32", "no-host-s2d", "strip", "profile", "deeplab", "per-channel"],
)
def test_predict_tool_unported_modes_raise(tmp_path, predict_fixture, common, overrides):
    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    save_config({"common": {"cuda": False, "int8": True, **common}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))
    with pytest.raises(NotImplementedError, match="ROADMAP|not ported"):
        predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs", checkpoint, **overrides))
