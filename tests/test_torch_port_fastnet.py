"""robosat_tpu_torch's fast family (models/fastnet.py) vs the JAX package, on the CPU.

The JAX package's weights (`fastnet.init(0)`) cross through the npz
bridge (`checkpoint.from_jax`); the inputs are seeded uint8 tiles at 64 px,
batch 2. The BN state has var + eps == 1 where the int8 walk is compared:
XLA:CPU's rsqrt and torch's differ in the last bit elsewhere, and int8
rounding amplifies a 1-ulp change of a folded weight.

- `subpixel_to_fine` and `interleave_subpixel_u8` exact on an arange;
- `apply` in eval and training mode: logits within 5e-4 of their largest
  value (measured 2e-6: the convolutions and batch norms sum in other
  orders), the new BN statistics within 1e-5 relative;
- `fold` within 1e-6 relative, `apply_folded` within 5e-4 of the largest
  logit;
- the plain int8 conv (`qconv.int8_conv` on CPU tensors) against the JAX
  package's `_int8_conv` at each case the walk has: stride-2 "SAME" on an
  even grid (padding (0, 1)) and on an odd one, dilation 2 with padding
  (2, 2), the stem's 48 input channels, bias or none, and the linear,
  relu and residual-relu epilogues: int32 accumulators exactly equal,
  bf16 outputs bit-equal;
- K5's plain version at the three up-sites (u3, u2, u1 at their widths)
  against the lhs-dilated `_int8_conv`: the four parity accumulators,
  interleaved, equal to its int32 accumulators, and the relu'd bf16
  outputs bit-equal;
- `calibration_amaxes_int8` at percentile 99.8 and at amax within 1e-5
  relative;
- `predict_quantized_int8` on the JAX package's scales, blocked (overlap
  8) and fine (overlap 0 and 8): uint8 within one bin on at most 0.1% of
  the pixels, the flips counted (measured: none); and the plain
  versions of the kernels equal to the wrappers' CPU path;
- `predict_quantized_folded` in float32: JAX's bins exactly; in bf16 at
  least as close to JAX's bf16 bins as those are to JAX's float32 ones
  (92.2% and 90.3% within one bin: at He init the logits reach ~40, and
  each package's bf16 forward parts from its own float32 one);
- the sub-pixel head on random features: within one bin on at most 0.1%
  of its outputs (float32 sums in other orders);
- `rs predict` with `model = 'fast'` on two 64-px tiles, overlap 16: int8
  (host-blocked input, 16-channel blocked output) on a QAT checkpoint's
  `qat_amaxes` and float32, within one bin on at most 0.1% of pixels of
  the JAX tool's PNGs; bf16 held as `predict_quantized_folded` is.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from robosat_tpu.checkpoint import save_checkpoint
from robosat_tpu.config import save_config
from robosat_tpu.models import fastnet as jfastnet
from robosat_tpu.models import int8 as jq8
from robosat_tpu.models.layers import CONV_DIMS
from robosat_tpu.models.layers import space_to_depth4 as jax_space_to_depth4
from robosat_tpu.ops import head as jhead
from robosat_tpu.ops.augment import normalize as jax_normalize
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models import fastnet, qconv, qdec
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models.registry import get_model
from robosat_tpu_torch.ops import head
from test_torch_port_bridge import _exact_var
from test_torch_port_predict import _assert_close_bins, _bin_distance


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(a):
    """A float32 array rounded to bfloat16, as (JAX array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.fixture(scope="module")
def net():
    """The JAX package's init (BN state as drawn) and a 64-px batch."""
    params, state = _np(jfastnet.init(0, num_classes=2))
    raw = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    return params, state, raw, np.asarray(jax_normalize(raw), np.float32)


def test_registry_returns_fastnet():
    assert get_model("fast") is fastnet
    with pytest.raises(ValueError, match="unknown model 'fastnet'; available: deeplabv3plus, fast, segformer, unet"):
        get_model("fastnet")


def test_subpixel_layout_exact():
    head16 = np.arange(2 * 3 * 5 * 32, dtype=np.float32).reshape(2, 3, 5, 32)
    want = np.asarray(jfastnet.subpixel_to_fine(head16, 2))
    got = fastnet.subpixel_to_fine(torch.from_numpy(head16), 2).numpy()
    assert got.shape == want.shape == (2, 12, 20, 2) and np.array_equal(got, want)
    blocked = (np.arange(2 * 3 * 5 * 16) % 251).astype(np.uint8).reshape(2, 3, 5, 16)
    want = np.asarray(jhead.interleave_subpixel_u8(blocked))
    assert np.array_equal(head.interleave_subpixel_u8(torch.from_numpy(blocked)).numpy(), want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_apply_matches_jax(net, train):
    params, state, _, x = net
    want, want_state = jax.jit(lambda p, s, xx: jfastnet.apply(p, s, xx, train))(params, state, x)
    tp, ts = from_jax(params, state)
    got, got_state = fastnet.apply(tp, ts, torch.from_numpy(x), train)
    want, got = np.asarray(want), got.detach().numpy()
    scale = np.abs(want).max()
    print("apply (train {}): logits |diff| max {} of their max".format(train, np.abs(got - want).max() / scale))
    assert got.shape == want.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * scale)
    assert sorted(got_state) == sorted(_np(want_state))
    for name, bn in _np(want_state).items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(got_state[name][k].detach().numpy(), bn[k], rtol=1e-5, atol=1e-6)


def test_fold_and_apply_folded_match_jax(net):
    params, state, _, x = net
    want = _np(jax.jit(jfastnet.fold)(params, state))
    tp, ts = from_jax(params, state)
    folded = fastnet.fold(tp, ts)
    assert sorted(folded) == sorted(want)
    for name in want:
        for k in want[name]:
            np.testing.assert_allclose(folded[name][k].numpy(), want[name][k], rtol=1e-6, atol=1e-7)
    want_logits = np.asarray(jax.jit(jfastnet.apply_folded)(want, x))
    got = fastnet.apply_folded(folded, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_logits, rtol=0, atol=5e-4 * np.abs(want_logits).max())


# (id, input (h, w, cin), cout, kernel side, stride, dilation, padding, bias, epilogue)
CONV_CASES = [
    ("s2-same-even", (8, 10, 32), 32, 3, 2, 1, "SAME", True, "relu"),
    ("s2-same-odd", (7, 9, 32), 48, 3, 2, 1, "SAME", True, "relu"),
    ("dilation2-residual", (6, 7, 32), 32, 3, 1, 2, ((2, 2), (2, 2)), True, "residual_relu"),
    ("residual", (9, 6, 48), 48, 3, 1, 1, "SAME", True, "residual_relu"),
    ("stem", (8, 8, 48), 32, 3, 1, 1, "SAME", True, "relu"),
    ("linear-no-bias", (5, 8, 32), 16, 3, 1, 1, "SAME", False, "linear"),
]


@pytest.mark.parametrize("shape,cout,k,stride,dilation,padding,bias,epilogue",
                         [c[1:] for c in CONV_CASES], ids=[c[0] for c in CONV_CASES])
def test_int8_conv_plain_matches_jax(shape, cout, k, stride, dilation, padding, bias, epilogue):
    rng = np.random.default_rng(sum(shape) + cout)
    node = {"w": (rng.normal(size=(k, k, shape[-1], cout)) * 0.1).astype(np.float32)}
    if bias:
        node["b"] = (rng.normal(size=cout) * 0.2).astype(np.float32)
    jnode = _np(jq8._qconv(node))
    jx, tx = _bf16(rng.normal(size=(2,) + shape).astype(np.float32))
    scale = 2.5 / 127  # some values clip at +-127
    xq = jq8._quantize_act(jx, scale)
    want_acc = lax.conv_general_dilated(xq, jnode["wq"], (stride, stride), padding, rhs_dilation=(dilation, dilation),
                                        dimension_numbers=CONV_DIMS, preferred_element_type=jnp.int32)
    y = jq8._int8_conv(jnode, jx, scale, stride=stride, padding=padding, dilation=dilation)
    want = y if epilogue == "linear" else jax.nn.relu(y + jx if epilogue == "residual_relu" else y)

    tnode, _ = from_jax(jnode, {})
    acc = q8._int8_acc(q8._quantize_act(tx, scale), tnode["wq"], stride=stride, padding=padding, dilation=dilation)
    assert np.array_equal(acc.numpy(), np.asarray(want_acc))
    got = qconv.int8_conv(tx, tnode, scale, stride=stride, dilation=dilation, padding=padding, epilogue=epilogue)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.array_equal(got.float().numpy().view(np.int32), np.asarray(want.astype(jnp.float32)).view(np.int32))
    _, (ho, wo) = qconv.conv_geometry(tx.shape, tnode, stride, dilation, padding)
    assert (ho, wo) == want.shape[1:3]


@pytest.mark.parametrize("grid,cin", [(2, 256), (4, 128), (8, 128)], ids=["u3", "u2", "u1"])
def test_parity_up_conv_plain_matches_lhs_dilated_conv(grid, cin):
    """K5's plain version is the JAX package's up-conv of the fast family."""
    rng = np.random.default_rng(grid)
    jnode = _np(jq8._qkernel(jq8._fused_k4(jnp.asarray(rng.normal(size=(3, 3, cin, 128)) * 0.05, jnp.float32))))
    jx, tx = _bf16(np.maximum(rng.normal(size=(2, grid, grid, cin)), 0).astype(np.float32))
    scale = 2.0 / 127
    want = jax.nn.relu(jq8._int8_conv(jnode, jx, scale, padding=((2, 2), (2, 2)), lhs_dilation=(2, 2)))
    want_acc = np.asarray(lax.conv_general_dilated(jq8._quantize_act(jx, scale), jnode["wq"], (1, 1),
                                                   ((2, 2), (2, 2)), lhs_dilation=(2, 2),
                                                   dimension_numbers=CONV_DIMS, preferred_element_type=jnp.int32))
    tnode, _ = from_jax(jnode, {})
    xq = q8._quantize_act(tx, scale)
    assert np.array_equal(q8._int8_acc(xq, tnode["wq"], padding=((2, 2), (2, 2)), lhs_dilation=(2, 2)).numpy(),
                          want_acc)
    # The four 2x2-tap parity convs K5 computes, interleaved: the same int32 sums.
    taps = qdec.parity_tap_weights(tnode["wq"])
    acc = np.zeros_like(want_acc)
    for di in (0, 1):
        for dj in (0, 1):
            w2 = taps[2 * di + dj].reshape(2, 2, cin, 128)
            acc[:, di::2, dj::2] = q8._int8_acc(xq, w2, padding=((1 - di, di), (1 - dj, dj))).numpy()
    assert np.array_equal(acc, want_acc)
    got = qdec.parity_up_conv(tx, tnode, scale)
    assert tuple(got.shape) == want.shape == (2, 2 * grid, 2 * grid, 128)
    assert np.array_equal(got.float().numpy().view(np.int32), np.asarray(want.astype(jnp.float32)).view(np.int32))


@pytest.mark.parametrize("percentile", [99.8, None], ids=["p99.8", "amax"])
def test_calibration_amaxes_match_jax(net, percentile):
    params, state, _, x = net
    folded = jax.jit(jfastnet.fold)(params, state)
    x48 = np.asarray(jax_space_to_depth4(x))
    want = np.asarray(jax.jit(lambda f, xx: jfastnet.calibration_amaxes_int8(f, xx, blocked=True,
                                                                             percentile=percentile))(folded, x48))
    tp, ts = from_jax(params, state)
    tfolded = fastnet.fold(tp, ts)
    got = fastnet.calibration_amaxes_int8(tfolded, torch.from_numpy(x48), blocked=True, percentile=percentile)
    fine = fastnet.calibration_amaxes_int8(tfolded, torch.from_numpy(x), percentile=percentile)
    assert got.shape == want.shape == (15,) and torch.equal(got, fine)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.fixture(scope="module")
def int8_net(net):
    """Exact-var weights, the JAX package's 99.8 calibration and qtree, and
    the port's qtree from its own fold (equal to JAX's, checked)."""
    params, _, raw, x = net
    state = _exact_var(net[1])
    folded = jax.jit(jfastnet.fold)(params, state)
    amaxes = np.asarray(jax.jit(lambda f, xx: jfastnet.calibration_amaxes_int8(f, xx, percentile=99.8))(folded, x))
    tp, ts = from_jax(params, state)
    qtree = fastnet.quantize_folded_int8(fastnet.fold(tp, ts))
    jqt = _np(jax.jit(jfastnet.quantize_folded_int8)(folded))
    for name in jqt:
        if "wq" in jqt[name]:
            assert np.array_equal(qtree[name]["wq"].numpy(), jqt[name]["wq"])
            assert np.array_equal(qtree[name]["ws"].numpy(), jqt[name]["ws"])
    return params, state, raw, x, amaxes, jqt, qtree


@pytest.mark.parametrize("blocked,overlap", [(True, 8), (False, 0), (False, 8)], ids=["blocked-8", "fine-0", "fine-8"])
def test_predict_quantized_int8_matches_jax(int8_net, blocked, overlap):
    params, state, raw, x, amaxes, jqt, qtree = int8_net
    scales = tuple(jq8.scales_from_amaxes(amaxes))
    xin = np.asarray(jax_space_to_depth4(x)) if blocked else x
    jx, tx = _bf16(xin)
    want = np.asarray(jax.jit(lambda t, xx: jfastnet.predict_quantized_int8(t, scales, xx, overlap=overlap,
                                                                            blocked=blocked))(jqt, jx))
    got = fastnet.predict_quantized_int8(qtree, scales, tx, overlap=overlap, blocked=blocked)
    assert tuple(got.shape) == want.shape == ((2, 12, 12, 16) if blocked else (2, 64 - 2 * overlap, 64 - 2 * overlap))
    _assert_close_bins(got.numpy(), want)
    assert torch.equal(fastnet.predict_quantized_int8(qtree, scales, tx, overlap=overlap, blocked=blocked, plain=True),
                       got)
    with pytest.raises((AssertionError, IndexError)):
        fastnet.predict_quantized_int8(qtree, scales[:-1], tx, overlap=overlap, blocked=blocked)
    with pytest.raises(AssertionError):
        fastnet.predict_quantized_int8(qtree, scales + (0.1,), tx, overlap=overlap, blocked=blocked)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_quantized_folded_matches_jax(int8_net, dtype):
    """float32: the JAX package's bins. bfloat16: each package's bf16
    forward parts from its own float32 one on ~10% of the pixels at this
    init (logits up to ~40, where one bf16 ulp is 0.25; measured: JAX's own
    bf16 and float32 bins within one bin on 90.3%), so the port's bf16 bins
    are held to agree with JAX's at least as well as JAX's agree with its
    float32 ones (measured 92.2%), not to ROADMAP's 99%."""
    params, state, _, x, _, _, _ = int8_net
    folded = jax.jit(jfastnet.fold)(params, state)
    run = jax.jit(lambda f, xx: jfastnet.predict_quantized_folded(f, xx, overlap=8))
    want32 = np.asarray(run(folded, x))
    tp, ts = from_jax(params, state)
    tfolded = fastnet.fold(tp, ts)
    if dtype == "float32":
        got = fastnet.predict_quantized_folded(tfolded, torch.from_numpy(x), overlap=8).numpy()
        assert got.shape == want32.shape == (2, 48, 48)
        assert np.array_equal(got, want32)
        return
    jx, tx = _bf16(x)
    want = np.asarray(run(folded, jx))
    got = fastnet.predict_quantized_folded(tfolded, tx, overlap=8).numpy()
    assert got.shape == want.shape == (2, 48, 48)
    port_jax, jax_own = (_bin_distance(got, want) <= 1).mean(), (_bin_distance(want, want32) <= 1).mean()
    print("bf16 predict: port vs JAX {:.4%} within one bin; JAX bf16 vs JAX float32 {:.4%}".format(port_jax, jax_own))
    assert port_jax >= jax_own


def test_subpixel_head_matches_jax():
    rng = np.random.default_rng(3)
    feats = np.maximum(rng.normal(size=(2, 16, 16, 128)), 0).astype(np.float32)
    w = (rng.normal(size=(1, 1, 128, 32)) * 0.2).astype(np.float32)
    b = (rng.normal(size=32) * 0.1).astype(np.float32)
    want = np.asarray(jhead.fused_prediction_head_subpixel(feats, w, b, overlap=8))
    got = head.fused_prediction_head_subpixel(*map(torch.from_numpy, (feats, w, b)), overlap=8).numpy()
    assert got.shape == want.shape == (2, 12, 12, 16)
    _assert_close_bins(got, want)


def _predict_args(root, probs, checkpoint, model_toml):
    return argparse.Namespace(batch_size=2, checkpoint=checkpoint, overlap=16, strip=1, tile_size=64, workers=2,
                              shard=None, tiles=str(root / "tiles"), probs=str(probs), model=str(model_toml),
                              dataset=str(root / "dataset.toml"), profile=None, png_optimize=False)


@pytest.fixture(scope="module")
def tool_fixture(tmp_path_factory, int8_net):
    """Two 64-px tiles, a QAT checkpoint of the exact-var weights (their
    99.8 amaxes as `qat_amaxes`) and the dataset config."""
    params, state, _, _, amaxes, _, _ = int8_net
    root = tmp_path_factory.mktemp("port_fast_predict")
    rng = np.random.default_rng(11)
    d = root / "tiles" / "18" / "69623"
    d.mkdir(parents=True)
    for y in (104945, 104946):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(d / "{}.png".format(y))
    checkpoint = str(root / "fast_qat.npz")
    save_checkpoint(checkpoint, {"params": params, "state": state},
                    meta={"epoch": 1, "qat_amaxes": [float(a) for a in amaxes]})
    save_config({"common": {"dataset": str(root), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(root / "dataset.toml"))
    return root, checkpoint


@pytest.mark.parametrize("mode", ["int8", "float32", "bfloat16"])
def test_predict_tool_fast_matches_jax(tmp_path, tool_fixture, mode):
    """int8 and float32 within one bin on at most 0.1% of pixels (measured:
    int8 equal, float32 one bin of 8,192: the head's float32 sums in
    another order); bf16 at least as close to the JAX tool's PNGs as the
    JAX tool's bf16 PNGs are to its float32 ones (measured 95.07% and
    94.90%; see test_predict_quantized_folded_matches_jax)."""
    from robosat_tpu.tools import predict as jax_predict
    from robosat_tpu_torch.tools import predict

    root, checkpoint = tool_fixture

    def run(tool, name, keys):
        model_toml = tmp_path / "model-{}.toml".format(name)
        save_config({"common": {"cuda": False, "batch_size": 2, "image_size": 64, "checkpoint": str(tmp_path),
                                "model": "fast", "int8_calibration": 99.8, **keys}}, str(model_toml))
        args = _predict_args(root, tmp_path / name, checkpoint, model_toml)
        tool.main(args)
        tiles = sorted(p.relative_to(tmp_path / name) for p in (tmp_path / name).rglob("*.png"))
        imgs = [Image.open(tmp_path / name / rel) for rel in tiles]
        assert len(imgs) == 2 and all(img.mode == "P" and img.size == (64, 64) for img in imgs)
        return args, tiles, np.stack([np.asarray(img) for img in imgs]), imgs[0].getpalette()

    keys = {"int8": {"int8": True, "bf16": True}, "float32": {"int8": False},
            "bfloat16": {"int8": False, "bf16": True}}[mode]
    args, tiles, got, palette = run(predict, "torch", keys)
    assert predict.host_s2d_input({"model": "fast", **keys}, args) == (mode == "int8")
    want_tiles, want, want_palette = run(jax_predict, "jax", keys)[1:]
    assert tiles == want_tiles and palette == want_palette
    if mode != "bfloat16":
        _assert_close_bins(got, want)
        return
    want32 = run(jax_predict, "jax32", {"int8": False})[2]
    port_jax, jax_own = (_bin_distance(got, want) <= 1).mean(), (_bin_distance(want, want32) <= 1).mean()
    print("bf16 PNGs: port vs JAX {:.4%} within one bin; JAX bf16 vs JAX float32 {:.4%}".format(port_jax, jax_own))
    assert port_jax >= jax_own
