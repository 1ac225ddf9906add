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
- The unfused heads (`fused_head = false`: the final 1x1 conv, softmax and
  digitize) of the int8 step and of `predict` give the JAX package's bins.
- The int8 step on fine input (`host_s2d=False`: the fine stem; fine output
  through K6 at overlap 0) and `predict` with `--strip`, `host_s2d =
  false` and an odd overlap give the JAX package's bins; the port's strips
  equal its per-tile PNGs in float32; `--profile` writes a trace.
- The float step (fp32 and bf16; host_s2d, s2d, fine-grid and unfused
  forms) and the float `predict` hold the tolerances stated in their tests.
- `predict` dispatches ahead and fetches behind: batch k + 1 is issued
  before batch k is fetched, at most three batches are pending, and every
  PNG is written once.

The BN state has var + eps == 1 in float32, where rsqrt is exact in both
packages: XLA:CPU's rsqrt and torch's differ in the last bit elsewhere, and
int8 rounding amplifies a 1-ulp change of every folded weight.
"""

import argparse
import types

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
from robosat_tpu.parallel.steps import normalize as jax_normalize
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


@pytest.fixture(scope="module")
def fine_model(model):
    """Fine uint8 input and the JAX package's amaxes from a fine-stem
    calibration of it (blocked=False)."""
    params, state, _, _ = model
    raw = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    folded = jax.jit(junet.fold)(params, state)
    amaxes = np.asarray(
        jax.jit(lambda f, r: jq8.calibration_amaxes(f, jax_normalize(r), blocked=False, percentile=99.8))(folded, raw)
    )
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
    "common,tolerance",
    [({"int8": True, "pallas_tail": "sep"}, None), ({"int8": False, "bf16": True}, 0.99),
     ({"int8": True, "fused_head": False}, "bins"), ({"int8": False, "fused_head": False}, "bins"),
     ({"int8": False, "bf16": True, "fused_head": False}, 0.99)],
    ids=["sep", "bf16", "int8-unfused", "fp32-unfused", "bf16-unfused"],
)
def test_predict_tool_model_keys_match_jax(tmp_path, predict_fixture, common, tolerance):
    """`rs predict` through a `pallas_tail = "sep"` TOML (the doubly-blocked
    output, peeled once by the writer), an `int8 = false` TOML (the bf16
    float predict) and `fused_head = false` TOMLs (fine input and output)
    against the JAX tool: the "sep" PNGs equal, the int8 and float32
    unfused ones within one bin on at most 0.1% of the pixels (measured on
    the CPU: equal), the bf16 ones within one bin on >= 99% of pixels."""
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
        if tolerance is None:
            assert int((d != 0).sum()) == 0
        elif tolerance == "bins":
            _assert_close_bins(np.asarray(got_img), np.asarray(ref_img))
        else:
            assert (d <= 1).mean() >= tolerance


@pytest.mark.parametrize(
    "common,overrides,tolerance",
    [({"int8": True}, {"strip": 3}, None), ({"int8": False}, {"strip": 3}, None),
     ({"int8": False, "bf16": True}, {"strip": 3}, 0.99), ({"int8": True, "host_s2d": False}, {}, None),
     ({"int8": True}, {"tile_size": 62, "overlap": 1}, None), ({"int8": False}, {"tile_size": 62, "overlap": 1}, None)],
    ids=["int8-strip", "fp32-strip", "bf16-strip", "int8-fine", "int8-odd", "fp32-odd"],
)
def test_predict_tool_modes_match_jax(tmp_path, predict_fixture, common, overrides, tolerance):
    """`rs predict` with `--strip 3` (the fixture's two tiles as one strip
    of a column, fine input and output), with `host_s2d = false`, and with
    an odd overlap (`--tile_size 62 --overlap 1`: fine output from the
    fused head) against the JAX tool on the same checkpoint and
    `qat_amaxes`: int8 and fp32 PNGs equal, bf16 ones within one bin on
    >= 99% of pixels."""
    from robosat_tpu.tools import predict as jax_predict
    from robosat_tpu_torch.tools import predict

    root, _, checkpoint = predict_fixture
    size = overrides.get("tile_size", 64)
    save_config({"common": {"cuda": False, "batch_size": 2, "image_size": 64, "checkpoint": str(root), **common}},
                str(tmp_path / "model.toml"))
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(tmp_path / "dataset.toml"))
    out = predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs_torch", checkpoint, **overrides))
    assert out["tiles"] == 2
    jax_predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs_jax", checkpoint, **overrides))
    pngs = sorted(p.relative_to(tmp_path / "probs_jax") for p in (tmp_path / "probs_jax").rglob("*.png"))
    assert len(pngs) == 2
    for rel in pngs:
        ref_img, got_img = Image.open(tmp_path / "probs_jax" / rel), Image.open(tmp_path / "probs_torch" / rel)
        assert got_img.mode == "P" and got_img.size == ref_img.size == (size, size)
        assert got_img.getpalette() == ref_img.getpalette()
        d = _bin_distance(np.asarray(got_img), np.asarray(ref_img))
        print("{}: {} of {} pixels differ, max distance {}".format(rel, int((d != 0).sum()), d.size, d.max()))
        if tolerance is None:
            assert int((d != 0).sum()) == 0
        else:
            assert (d <= 1).mean() >= tolerance


@pytest.fixture(scope="module")
def column_tiles(tmp_path_factory):
    """Two columns of 64-px tiles with a gap in y (strips of 3 split into
    runs and chunks), as in tests/test_strip_predict.py."""
    root = tmp_path_factory.mktemp("port_strips")
    rng = np.random.default_rng(0)
    for x, y in [(100, y) for y in (50, 51, 52, 53, 55)] + [(101, 50), (101, 51)]:
        d = root / "18" / str(x)
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(d / "{}.png".format(y))
    return root


def test_predict_tool_strip_equals_per_tile(tmp_path, predict_fixture, column_tiles):
    """The port's `--strip 3` PNGs equal its per-tile ones in float32 (the
    strips carry the same context and the convolutions are translation
    invariant), over seven tiles in five strips."""
    from robosat_tpu_torch.tools import predict

    _, checkpoint, _ = predict_fixture
    save_config({"common": {"cuda": False, "int8": False}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))
    for strip in (1, 3):
        out = predict.main(_predict_args(tmp_path, column_tiles, tmp_path / "probs{}".format(strip), checkpoint,
                                         overlap=32, strip=strip, batch_size=4))
        assert out["tiles"] == 7
    singles = sorted(p.relative_to(tmp_path / "probs1") for p in (tmp_path / "probs1").rglob("*.png"))
    assert len(singles) == 7
    for rel in singles:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "probs3" / rel)),
                                      np.asarray(Image.open(tmp_path / "probs1" / rel)), err_msg=str(rel))


def test_predict_tool_profile_writes_trace(tmp_path, predict_fixture):
    """`--profile DIR` on the CPU: a TensorBoard trace in DIR whose events
    hold one `predict_batch` range per batch."""
    import json

    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    save_config({"common": {"cuda": False, "int8": True}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))
    trace_dir = tmp_path / "trace"
    out = predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs", checkpoint, batch_size=1,
                                     profile=str(trace_dir)))
    assert out["tiles"] == 2
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert sum(e.get("name") == "predict_batch" and e.get("cat") == "user_annotation" for e in events) == 2


@pytest.mark.parametrize(
    "common,overrides,error",
    [({"model": "segformer", "int8_calibration": "pc99.8"}, {}, ValueError),
     ({"int8_calibration": "pcx"}, {}, ValueError)],
    ids=["segformer", "pc-bad-spec"],
)
def test_predict_tool_unported_modes_raise(tmp_path, predict_fixture, common, overrides, error):
    """The per-channel calibrations with a model whose quantizer takes no
    per-channel amaxes (SegFormer) raise the JAX package's ValueError
    before anything is written; a "pc<percentile>" spec whose percentile is
    no number fails when the config is read, with the JAX tool's
    ValueError."""
    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    save_config({"common": {"cuda": False, "int8": True, **common}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))
    with pytest.raises(error, match="does not support per-channel|pcx|float"):
        predict.main(_predict_args(tmp_path, root / "tiles", tmp_path / "probs", checkpoint, **overrides))
    assert not (tmp_path / "probs").exists()


def test_dispatch_ahead_issues_before_fetching():
    """The tool's loop with a counting step: the first batch is done before
    the second is issued (the steady clock's start), batch k + 1 is issued
    before batch k is fetched, at most three batches are pending, and each
    batch reaches the writer once, with its own output."""
    from robosat_tpu_torch.tools import predict

    log = []

    class Handle:
        def __init__(self, k):
            self.k = k

        def fetch(self):
            log.append(("fetch", self.k))
            return self.k

    def issue(k):
        log.append(("issue", k))
        return Handle(k)

    written = []
    n = 6
    assert predict.dispatch_ahead(range(n), issue, lambda k, out: written.append((k, out))) is not None
    assert written == [(k, k) for k in range(n)]
    assert log[:3] == [("issue", 0), ("fetch", 0), ("issue", 1)]
    order = log[:1] + log[2:]  # without the first batch's set-up wait
    for k in range(n - 1):
        assert order.index(("issue", k + 1)) < order.index(("fetch", k))
    pending = 0
    for event, _ in order:
        pending += 1 if event == "issue" else -1
        assert 0 <= pending <= predict.IN_FLIGHT + 1 == 3
    assert predict.dispatch_ahead([], issue, None) is None


def test_predict_tool_counting_step_writes_each_png_once(tmp_path, predict_fixture, monkeypatch):
    """`predict.main` over six tiles, one per batch, with a counting step in
    place of the int8 step: every step's output is fetched through the
    tool's handle after the next batch was issued, and each tile's PNG is
    written once, with its own batch's values."""
    from robosat_tpu_torch.native import imagecodec
    from robosat_tpu_torch.tools import predict

    root, checkpoint, _ = predict_fixture
    rng = np.random.default_rng(13)
    tiles = [(69623 + i // 3, 104945 + i % 3) for i in range(6)]
    for x, y in tiles:
        (tmp_path / "tiles" / "18" / str(x)).mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
            tmp_path / "tiles" / "18" / str(x) / "{}.png".format(y))
    save_config({"common": {"cuda": False, "int8": True}}, str(tmp_path / "model.toml"))
    save_config({"common": {"classes": ["background", "parking"]}}, str(tmp_path / "dataset.toml"))

    log = []

    def counting_step(_, raw):
        k = sum(event == "issue" for event, _ in log)
        log.append(("issue", k))
        assert raw.shape == (1, 16, 16, 48)
        return torch.full((1, 32, 32, 4), 10 * k, dtype=torch.uint8)

    class Counted(predict.Dispatched):
        def fetch(self):
            out = super().fetch()
            log.append(("fetch", int(out.flat[0]) // 10))
            return out

    paths = []
    encode = imagecodec.encode_palette_png_d2s

    def counting_encode(path, *args):
        paths.append(path)
        return encode(path, *args)

    monkeypatch.setattr(predict, "make_int8_predict_step", lambda *a, **k: (counting_step, None))
    monkeypatch.setattr(predict, "Dispatched", Counted)
    monkeypatch.setattr(imagecodec, "encode_palette_png_d2s", counting_encode)
    out = predict.main(_predict_args(tmp_path, tmp_path / "tiles", tmp_path / "probs", checkpoint, batch_size=1))
    assert out["tiles"] == 6
    issued = [k for event, k in log if event == "issue"]
    assert issued == list(range(6))
    for k in range(5):
        last_fetch = max(i for i, e in enumerate(log) if e == ("fetch", k))
        assert log.index(("issue", k + 1)) < last_fetch
    assert sorted(paths) == sorted(set(paths)) and len(paths) == 6
    values = sorted(int(np.unique(np.asarray(Image.open(path)))[0]) for path in paths)
    assert values == [10 * k for k in range(6)]
    assert all(np.unique(np.asarray(Image.open(path))).size == 1 for path in paths)
