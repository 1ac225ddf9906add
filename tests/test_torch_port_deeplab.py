"""robosat_tpu_torch's DeepLabv3+ (models/deeplab.py) vs the JAX package, on the CPU.

The JAX package's weights (`deeplab.init(0)`, full width: ResNet-50 at
output stride 16, ASPP 256, low-level 48) cross through the npz bridge
(`checkpoint.from_jax`); the inputs are seeded uint8 tiles at 64 px, batch
2 (enc4 and ASPP on a 4 x 4 grid, where the padding of the dilated convs is
wider than the grid). The BN state has var + eps == 1 where the int8 walk
is compared: XLA:CPU's rsqrt and torch's differ in the last bit elsewhere.

- `_resize_bilinear` against jax.image.resize at the walk's 4x up (4 -> 16,
  9 -> 36, 16 -> 64), edges included: bf16 bit-equal; float32 bit-equal
  at 9 -> 36 and 16 -> 64, where XLA:CPU fuses the multiply-adds of both
  contractions as torch's float32 product does; at 4 -> 16 XLA:CPU's
  column contraction rounds each product on its own, so the values there
  are held to the rounding of one product (half an ulp of the largest
  input), the count of differing values printed;
- `apply` in eval and training mode: logits within 5e-4 of their largest
  value, the new BN statistics within 5e-3; `fold` within 1e-6 relative,
  `apply_folded` within 5e-4 of the largest logit;
- `predict_quantized_folded` at overlap 8: uint8 within one bin on at most
  0.1% of the pixels (counted);
- `calibration_amaxes_int8`: 59 sites, fine and blocked, within 1e-5
  relative; `quantize_folded_int8`'s wq and ws exactly equal;
- `predict_quantized_int8` on the JAX package's scales, fine and blocked:
  uint8 within one bin on at most 0.1% of the pixels, the flips counted;
  the plain versions equal to the wrappers' CPU path;
- K3's plain version at dilation 2 (layer4's widths on a small grid), with
  and without the projection, against the block composed of the JAX
  package's `_int8_conv` as `walk_encoder` runs it: conv2's int32
  accumulators equal, the bf16 output bit-equal;
- `int8_conv_plain` at dilations 6, 12 and 18 with "SAME" padding on a
  40 x 40 grid (every tap reaches data for some outputs) and on a 4 x 4
  grid (padding wider than the grid) against `_int8_conv`: int32
  accumulators equal, bf16 bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from robosat_tpu.models import deeplab as jdeeplab
from robosat_tpu.models import int8 as jq8
from robosat_tpu.models.layers import CONV_DIMS
from robosat_tpu.models.layers import space_to_depth4 as jax_space_to_depth4
from robosat_tpu.ops.augment import normalize as jax_normalize
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models import deeplab, qconv, qenc
from robosat_tpu_torch.models import int8 as q8
from test_torch_port_bridge import _exact_var
from test_torch_port_predict import _assert_close_bins
from test_torch_port_train_forward import torch_threads  # noqa: F401


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(a):
    """A float32 array rounded to bfloat16, as (JAX array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


def _bits_equal(got, want):
    return np.array_equal(got.float().numpy().view(np.int32), np.asarray(want.astype(jnp.float32)).view(np.int32))


@pytest.fixture(scope="module")
def net():
    """The JAX package's init (BN state as drawn) and a 64-px batch."""
    params, state = _np(jdeeplab.init(0, num_classes=2))
    raw = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    return params, state, raw, np.asarray(jax_normalize(raw), np.float32)


@pytest.mark.parametrize("size", [4, 9, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_bilinear_matches_jax(size, dtype):
    rng = np.random.default_rng(size)
    x = (rng.normal(size=(2, size, size, 8)) * 3).astype(np.float32)
    if dtype == "bfloat16":
        jx, tx = _bf16(x)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    want = jax.jit(lambda t: jax.image.resize(t, (2, 4 * size, 4 * size, 8), method="bilinear"))(jx)
    got = deeplab._resize_bilinear(tx, 4 * size, 4 * size)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    if dtype == "bfloat16" or size != 4:
        assert _bits_equal(got, want)
        return
    g, w = got.numpy(), np.asarray(want)
    print("float32 resize 4 -> 16: {} of {} values differ".format(int((g != w).sum()), g.size))
    np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -24 * np.abs(x).max())


def test_resize_one_axis_and_edges():
    """Only the axes that change size are contracted; the edge outputs are
    the edge inputs (each column's weights normalized to one)."""
    x = torch.arange(2 * 4 * 3 * 2, dtype=torch.float32).reshape(2, 4, 3, 2)
    want = np.asarray(jax.image.resize(x.numpy(), (2, 16, 3, 2), method="bilinear"))
    got = deeplab._resize_bilinear(x, 16, 3)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got[:, 0], x[:, 0]) and torch.equal(got[:, -1], x[:, -1])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_apply_matches_jax(net, train):
    params, state, _, x = net
    want, want_state = jax.jit(lambda p, s, xx: jdeeplab.apply(p, s, xx, train))(params, state, x)
    tp, ts = from_jax(params, state)
    got, got_state = deeplab.apply(tp, ts, torch.from_numpy(x), train)
    want, got = np.asarray(want), got.detach().numpy()
    scale = np.abs(want).max()
    print("apply (train {}): logits |diff| max {} of their max".format(train, np.abs(got - want).max() / scale))
    assert got.shape == want.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * scale)
    want_leaves = jax.tree_util.tree_leaves_with_path(_np(want_state))
    got_leaves = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.detach().numpy(), got_state))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-3, err_msg=jax.tree_util.keystr(path))


def test_fold_and_apply_folded_match_jax(net):
    params, state, _, x = net
    want = _np(jax.jit(jdeeplab.fold)(params, state))
    tp, ts = from_jax(params, state)
    folded = deeplab.fold(tp, ts)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), folded))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (_, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    want_logits = np.asarray(jax.jit(jdeeplab.apply_folded)(want, x))
    got = deeplab.apply_folded(folded, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want_logits, rtol=0, atol=5e-4 * np.abs(want_logits).max())


def test_predict_quantized_folded_matches_jax(net):
    params, state, _, x = net
    folded = jax.jit(jdeeplab.fold)(params, state)
    want = np.asarray(jax.jit(lambda f, xx: jdeeplab.predict_quantized_folded(f, xx, overlap=8))(folded, x))
    tp, ts = from_jax(params, state)
    got = deeplab.predict_quantized_folded(deeplab.fold(tp, ts), torch.from_numpy(x), overlap=8).numpy()
    assert got.shape == want.shape == (2, 48, 48)
    _assert_close_bins(got, want)


@pytest.mark.parametrize("percentile", [99.8, None], ids=["p99.8", "amax"])
def test_calibration_amaxes_match_jax(net, percentile):
    params, state, _, x = net
    folded = jax.jit(jdeeplab.fold)(params, state)
    x48 = np.asarray(jax_space_to_depth4(x))
    want = np.asarray(jax.jit(lambda f, xx: jdeeplab.calibration_amaxes_int8(f, xx, blocked=True,
                                                                             percentile=percentile))(folded, x48))
    tp, ts = from_jax(params, state)
    tfolded = deeplab.fold(tp, ts)
    got = deeplab.calibration_amaxes_int8(tfolded, torch.from_numpy(x48), blocked=True, percentile=percentile)
    fine = deeplab.calibration_amaxes_int8(tfolded, torch.from_numpy(x), percentile=percentile)
    assert got.shape == fine.shape == want.shape == (59,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(fine.numpy(), want, rtol=1e-5)


@pytest.fixture(scope="module")
def int8_net(net):
    """Exact-var weights, the JAX package's 99.8 calibration and qtree, and
    the port's qtree from its own fold (equal to JAX's, checked)."""
    params, _, raw, x = net
    state = _exact_var(net[1])
    folded = jax.jit(jdeeplab.fold)(params, state)
    amaxes = np.asarray(jax.jit(lambda f, xx: jdeeplab.calibration_amaxes_int8(f, xx, percentile=99.8))(folded, x))
    tp, ts = from_jax(params, state)
    qtree = deeplab.quantize_folded_int8(deeplab.fold(tp, ts))
    jqt = _np(jax.jit(jdeeplab.quantize_folded_int8)(folded))
    want_leaves = jax.tree_util.tree_leaves_with_path(jqt)
    got_leaves = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), qtree))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        if jax.tree_util.keystr(path[-1:]) in ("['wq']", "['ws']"):
            assert np.array_equal(g, w), jax.tree_util.keystr(path)
    return amaxes, jqt, qtree, x


@pytest.mark.parametrize("blocked,overlap", [(True, 8), (False, 0)], ids=["blocked-8", "fine-0"])
def test_predict_quantized_int8_matches_jax(int8_net, blocked, overlap):
    amaxes, jqt, qtree, x = int8_net
    scales = tuple(jq8.scales_from_amaxes(amaxes))
    xin = np.asarray(jax_space_to_depth4(x)) if blocked else x
    jx, tx = _bf16(xin)
    want = np.asarray(jax.jit(lambda t, xx: jdeeplab.predict_quantized_int8(t, scales, xx, overlap=overlap,
                                                                            blocked=blocked))(jqt, jx))
    got = deeplab.predict_quantized_int8(qtree, scales, tx, overlap=overlap, blocked=blocked)
    assert tuple(got.shape) == want.shape == (2, 64 - 2 * overlap, 64 - 2 * overlap)
    _assert_close_bins(got.numpy(), want)
    assert torch.equal(deeplab.predict_quantized_int8(qtree, scales, tx, overlap=overlap, blocked=blocked,
                                                      plain=True), got)
    with pytest.raises((AssertionError, IndexError)):
        deeplab.predict_quantized_int8(qtree, scales[:-1], tx, overlap=overlap, blocked=blocked)


def _jax_block(x, qb, s1, s2, s3, sd, d):
    """The block as the JAX package's walk_encoder runs it on _int8_conv."""
    inner = jax.nn.relu(jq8._int8_conv(qb["conv1"], x, s1))
    inner = jax.nn.relu(jq8._int8_conv(qb["conv2"], inner, s2, dilation=d, padding=((d, d), (d, d))))
    inner = jq8._int8_conv(qb["conv3"], inner, s3)
    shortcut = jq8._int8_conv(qb["down_conv"], x, sd) if "down_conv" in qb else x
    return jax.nn.relu(inner + shortcut), inner


@pytest.mark.parametrize("down", [True, False], ids=["layer4.0-projection", "layer4.1-identity"])
def test_dilated_bottleneck_plain_matches_jax(down):
    """Layer4's widths (Cin 1024 or 2048, Cmid 512, Cout 2048) on a 5 x 6
    grid at dilation 2."""
    rng = np.random.default_rng(40 + down)
    cin, cmid, cout = (1024 if down else 2048), 512, 2048

    def node(k, ci, co):
        return {"w": (rng.normal(size=(k, k, ci, co)) * (2.0 / (k * k * ci)) ** 0.5).astype(np.float32),
                "b": (rng.normal(size=co) * 0.1).astype(np.float32)}

    qb = {"conv1": node(1, cin, cmid), "conv2": node(3, cmid, cmid), "conv3": node(1, cmid, cout)}
    if down:
        qb["down_conv"] = node(1, cin, cout)
    jqb = {k: _np(jq8._qconv(v)) for k, v in qb.items()}
    jx, tx = _bf16(np.maximum(rng.normal(size=(2, 5, 6, cin)), 0).astype(np.float32))
    s1, s2, s3, sd = 3.0 / 127, 2.0 / 127, 2.5 / 127, (3.0 / 127 if down else None)
    want, _ = _jax_block(jx, jqb, s1, s2, s3, sd, 2)
    h1 = jax.nn.relu(jq8._int8_conv(jqb["conv1"], jx, s1))
    want_acc = lax.conv_general_dilated(jq8._quantize_act(h1, s2), jqb["conv2"]["wq"], (1, 1), ((2, 2), (2, 2)),
                                        rhs_dilation=(2, 2), dimension_numbers=CONV_DIMS,
                                        preferred_element_type=jnp.int32)
    tqb = {k: from_jax(v, {})[0] for k, v in jqb.items()}
    th1 = torch.relu(q8._int8_conv(tqb["conv1"], tx, s1))
    acc = q8._int8_acc(q8._quantize_act(th1, s2), tqb["conv2"]["wq"], padding=((2, 2), (2, 2)), dilation=2)
    assert np.array_equal(acc.numpy(), np.asarray(want_acc))
    got = qenc.bottleneck_block(tx, tqb, s1, s2, s3, sd, dilation=2)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 5, 6, cout)
    assert _bits_equal(got, want)
    assert torch.equal(qenc.apply_stage_blocks(tx, [tqb], [s1, s2, s3] + ([sd] if down else []), dilation=2), got)


@pytest.mark.parametrize("call", [
    lambda x, qb: qenc.bottleneck_block(x, qb, 0.1, 0.1, 0.1, dilation=0),
    lambda x, qb: qenc.bottleneck_block_plain(x, qb, 0.1, 0.1, 0.1, stride=2, dilation=2),
    lambda x, qb: qenc.apply_stage_blocks(x, [qb], [0.1] * 3, first_stride=2, dilation=2),
], ids=["dilation-0", "stride2-dilated", "stage-stride2-dilated"])
def test_invalid_block_geometry_raises(call):
    qb = {k: {"wq": torch.zeros(kk, kk, 32, 32, dtype=torch.int8), "ws": torch.ones(32)}
          for k, kk in (("conv1", 1), ("conv2", 3), ("conv3", 1))}
    with pytest.raises(ValueError, match="dilation"):
        call(torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16), qb)


@pytest.mark.parametrize("rate", [6, 12, 18])
@pytest.mark.parametrize("grid", [40, 4])
def test_dilated_int8_conv_plain_matches_jax(rate, grid):
    """ASPP's dilated 3x3 convs with "SAME" padding (rate on each side):
    on 40 x 40 every tap row and column reaches data for some outputs, on
    4 x 4 the padding is wider than the grid."""
    rng = np.random.default_rng(rate + grid)
    cin, cout = 64, 32
    jnode = _np(jq8._qconv({"w": (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32),
                            "b": (rng.normal(size=cout) * 0.1).astype(np.float32)}))
    jx, tx = _bf16(np.maximum(rng.normal(size=(2, grid, grid, cin)), 0).astype(np.float32))
    scale = 2.5 / 127
    want = jax.nn.relu(jq8._int8_conv(jnode, jx, scale, dilation=rate))
    want_acc = lax.conv_general_dilated(jq8._quantize_act(jx, scale), jnode["wq"], (1, 1), "SAME",
                                        rhs_dilation=(rate, rate), dimension_numbers=CONV_DIMS,
                                        preferred_element_type=jnp.int32)
    tnode, _ = from_jax(jnode, {})
    acc = q8._int8_acc(q8._quantize_act(tx, scale), tnode["wq"], dilation=rate)
    assert np.array_equal(acc.numpy(), np.asarray(want_acc))
    assert qconv.route(3, 1, rate) == "conv_kernel"
    assert qconv.conv_geometry(tx.shape, tnode, 1, rate, "SAME") == ((rate, rate), (grid, grid))
    got = qconv.int8_conv(tx, tnode, scale, dilation=rate)
    assert tuple(got.shape) == want.shape and _bits_equal(got, want)
    assert torch.equal(qconv.int8_conv_plain(tx, tnode, scale, dilation=rate), got)


def test_decoder_sites_take_the_halo_route():
    """dec1 (Cin 304: four full 64-channel chunks and a 48-channel one) and
    dec2 take halo_conv_kernel, Cout 256 as two 128-wide items; the ASPP
    sites take conv_kernel; the site list is the walk's."""
    routes = {name: qconv.route(1 if name in ("aspp1", "aspp_proj") else 3, 1, d) for name, d in deeplab.DENSE_SITES}
    assert routes == {"aspp1": "conv_kernel", "aspp_d0": "conv_kernel", "aspp_d1": "conv_kernel",
                      "aspp_d2": "conv_kernel", "aspp_proj": "conv_kernel", "dec1": "halo", "dec2": "halo"}
    assert qconv.halo_bn(256) == 128
    wpt = qconv.packed_tap_slabs({"wq": torch.ones(3, 3, 304, 256, dtype=torch.int8)})
    assert tuple(wpt.shape) == (2 * 5 * 2 * 9, 128 * 32)
    # The last chunk holds channels 256-303: its upper 16 are zero padding.
    slabs = wpt.reshape(2, 5, 2, 9, 16, 2, 8, 16)  # (tile_n, chunk, half, tap, row // 8, k // 16, row % 8, k % 16)
    assert int(slabs[:, 4, 0].sum()) == 2 * 9 * 128 * 32 and int(slabs[:, 4, 1, :, :, 0].sum()) == 2 * 9 * 128 * 16
    assert int(slabs[:, 4, 1, :, :, 1].abs().sum()) == 0
