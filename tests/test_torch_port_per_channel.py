"""robosat_tpu_torch: the per-channel int8 calibrations ("pc", "pcamax", "pc<p>") vs the JAX package.

The same numpy inputs go through the JAX package and the port on the CPU.

- The quantizer: ScaleCursor's balanced scale vectors, the folded wq and
  ws equal the JAX package's bit for bit (as jit-compiled: XLA multiplies
  by the f32 reciprocal of 127, and its square root is correctly rounded,
  which the port's takes through float64), at every site of the U-Net, the
  fast family and DeepLab.
- The taps: `_Sites` on one tensor gives the JAX package's per-channel
  amax exactly and its percentiles to rel 1e-5; the float calibration
  walks agree to float32 summation order, |diff| <= 1e-5 of the site's
  largest channel (a near-dead channel's own relative error can be large).
- `_int8_conv` with a vector equals the JAX package's (int32
  accumulators, bf16 and f32 outputs); the kernels' plain versions (K3/K4,
  K5, K6, rs_int8_conv) take vectors and equal the JAX package's XLA
  composition of `_int8_conv`, bit for bit.
- The predict steps and the `predict` tool, with the JAX package's
  calibration taps handed to the port (monkeypatched): uint8 and PNGs
  equal to the JAX package's. A fresh calibration in float32 agrees only to
  summation order, which the int8 rounding of 15-59 sites amplifies (the
  JAX package's per-tensor amax mode shows the same; the port's tests of
  it hand over the amaxes too), so the steps are compared on one
  calibration and the calibrations separately.
- The gates: `pallas_tail`, `pallas_enc`, `calib_amaxes` and SegFormer
  raise the JAX package's ValueError with its message.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from robosat_tpu.checkpoint import save_checkpoint
from robosat_tpu.config import save_config
from robosat_tpu.models import deeplab as jdeeplab
from robosat_tpu.models import fastnet as jfastnet
from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import unet as junet
from robosat_tpu.models.layers import CONV_DIMS
from robosat_tpu.models.layers import space_to_depth4 as jax_space_to_depth4
from robosat_tpu.ops.head import fused_prediction_head_s2d_blocked
from robosat_tpu.parallel.steps import _normalize_s2d4 as jax_normalize_s2d4
from robosat_tpu.parallel.steps import make_int8_predict_step as jax_make_int8_predict_step
from robosat_tpu.parallel.steps import normalize as jax_normalize
from robosat_tpu_torch.checkpoint import from_jax, to_jax
from robosat_tpu_torch.models import deeplab, fastnet, qconv, qdec, qenc, qtail, segformer, unet
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.ops.augment import normalize
from robosat_tpu_torch.parallel.steps import _normalize_s2d4, make_int8_predict_step

MAX_FLIP_SHARE = 0.001


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _exact_var(tree):
    """A copy of a BN state tree with var + eps == 1 exactly in float32
    (the fold then agrees bit for bit: XLA:CPU's rsqrt and torch's differ
    in the last bit elsewhere)."""
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
    """Equal uint8, or one bin apart (modulo 256) on at most 0.1% of pixels."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = _bin_distance(got, ref)
    flips = int((d != 0).sum())
    print("uint8 bins differing: {} of {} (max distance {})".format(flips, d.size, d.max(initial=0)))
    assert d.max(initial=0) <= 1
    assert flips <= MAX_FLIP_SHARE * d.size


def _t(tree):
    """A numpy/JAX tree as torch tensors (the quantized nodes' layout)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _bf16(a):
    x = jnp.asarray(a, jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _check_taps(got, ref):
    """Per-channel taps of a float calibration walk: one vector per site of
    the JAX package's length, |diff| <= 1e-5 of the site's largest channel."""
    assert isinstance(got, list) and len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5 * float(r.max()))


def _jax_pc(quantize, tree, a):
    """The JAX package's quantizer `quantize(tree, cursor)` of one site on
    the amax vector `a`, jitted: (the quantized node, its scale vector)."""

    def run(t):
        cursor = jq8.ScaleCursor([a])
        return quantize(t, cursor), cursor.out_scales[0]

    node, scale = jax.jit(run)(tree)
    return _np(node), np.asarray(scale, np.float32)


# ---- the quantizer ----


def _cursor_case(case):
    """(kernel, amax vector) of a site: random, with an outlier activation
    channel (x1000) and a near-zero one, a rewritten 4x4 parity kernel,
    and a 1x1 kernel with a zero input channel."""
    rng = np.random.default_rng(3)
    if case == "k4":
        k = np.asarray(jq8._fused_k4(rng.normal(0, 0.1, (3, 3, 96, 32)).astype(np.float32)))
    elif case == "dense1x1":
        k = rng.normal(0, 0.2, (1, 1, 64, 128)).astype(np.float32)
        k[:, :, 5] = 0.0
    else:
        k = rng.normal(0, 0.05, (3, 3, 80, 48)).astype(np.float32)
    a = (np.abs(rng.normal(0, 2.0, k.shape[2])) + 0.01).astype(np.float32)
    if case == "outlier":
        a[7] *= 1000.0
        a[11] = 1e-9
    return k, a


@pytest.mark.parametrize("case", ["random", "outlier", "k4", "dense1x1"])
def test_scale_cursor_matches_jax(case):
    """ScaleCursor's vector, the folded wq and ws equal the JAX package's
    jitted ones bit for bit."""
    k, a = _cursor_case(case)

    def jax_site(kernel, amax):
        cursor = jq8.ScaleCursor([amax])
        node = jq8._qkernel_pc(kernel, cursor)
        return cursor.out_scales[0], node["wq"], node["ws"]

    js, jwq, jws = (np.asarray(v) for v in jax.jit(functools.partial(jax_site, amax=a))(k))
    cursor = q8.ScaleCursor([a])
    node = q8._qkernel_pc(torch.from_numpy(k), cursor)
    cursor.assert_done()
    assert np.array_equal(cursor.out_scales[0].numpy(), js)
    assert np.array_equal(node["ws"].numpy(), jws)
    assert node["wq"].dtype == torch.int8 and np.array_equal(node["wq"].numpy(), jwq)
    assert float((a / js).max()) == pytest.approx(127.0, rel=1e-6)


@pytest.fixture(scope="module")
def unet_net():
    params, state = junet.init(0, num_classes=2)
    state = _exact_var(state)
    raw = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    raw48 = np.asarray(jax_space_to_depth4(raw))
    folded = _np(jax.jit(junet.fold)(params, state))
    taps = [np.asarray(t) for t in jax.jit(lambda f, r: jq8.calibration_amaxes(
        f, jax_normalize_s2d4(r), blocked=True, percentile="pc99.8"))(folded, raw48)]
    return params, state, folded, raw, raw48, taps


def test_quantize_unet_folded_matches_jax(unet_net):
    """All 59 sites on the JAX package's calibration taps: the scale
    vectors and every leaf of the tree bit for bit (the decoder's vectors
    over the rewritten kernels' input channels)."""
    _, _, folded, _, _, taps = unet_net
    jqt, jscales = jax.jit(functools.partial(jq8.quantize_unet_folded, act_amaxes=taps))(folded)
    tf, _ = from_jax(folded, {})
    tqt, tscales = q8.quantize_unet_folded(tf, act_amaxes=taps)
    assert len(tscales) == len(jscales) == 59
    assert [s.shape[0] for s in tscales[-7:]] == [2048, 2304, 1280, 768, 320, 128, 128]
    for a, b in zip(jscales, tscales):
        assert np.array_equal(np.asarray(a), b.numpy())
    jl, tl = _leaves(_np(jqt)), _leaves(tqt)
    assert len(jl) == len(tl) == 174
    for a, b in zip(jl, tl):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    with pytest.raises(AssertionError, match="act-amax count mismatch"):
        q8.quantize_unet_folded(tf, act_amaxes=taps[:-1])


@pytest.mark.parametrize("family", ["fastnet", "deeplab"])
def test_family_quantize_folded_int8_matches_jax(family):
    """The fast family's 15 and DeepLab's 59 sites on random per-channel
    amaxes: scale vectors and tree bit for bit."""
    jm, tm = (jfastnet, fastnet) if family == "fastnet" else (jdeeplab, deeplab)
    params, state = jm.init(0, num_classes=2)
    folded = _np(jax.jit(jm.fold)(params, state))
    plain = jax.jit(jm.quantize_folded_int8)(folded)
    if family == "deeplab":  # the walk's order: the encoder's sites, then ASPP and the decoder
        cins = [n["wq"].shape[2] for si in range(4) for qb in plain["encoder"]["layer{}".format(si + 1)]
                for n in (qb[k] for k in ("conv1", "conv2", "conv3", "down_conv") if k in qb)]
        cins += [plain[name]["wq"].shape[2] for name, _ in deeplab.DENSE_SITES]
    else:
        cins = [plain[name]["wq"].shape[2] for name in jfastnet._ENC + jfastnet._DEC]
    rng = np.random.default_rng(5)
    amaxes = [(np.abs(rng.normal(0, 3.0, c)) + 1e-3).astype(np.float32) for c in cins]
    jqt, jscales = jax.jit(functools.partial(jm.quantize_folded_int8, act_amaxes=amaxes))(folded)
    tf = from_jax(folded, {})[0]
    tqt, tscales = tm.quantize_folded_int8(tf, act_amaxes=amaxes)
    assert len(tscales) == len(jscales) == (15 if family == "fastnet" else 59)
    for a, b in zip(jscales, tscales):
        assert np.array_equal(np.asarray(a), b.numpy())
    jl, tl = _leaves(_np(jqt)), _leaves(tqt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.array_equal(a, b.numpy())


# ---- the taps ----


@pytest.mark.parametrize("spec", ["pc", "pcamax", "pc99.8", "pc99.95"])
def test_sites_taps_match_jax(spec):
    """One site's per-channel tap of |x| over batch and space: the amax
    forms equal, the percentiles to rel 1e-5 (jnp.percentile's f32 index
    arithmetic; its weighted sum may fuse into an FMA under jit)."""
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1.0, (2, 12, 10, 24)).astype(np.float32)
    x[..., 3] *= 300.0
    x[0, 1, 2, 5] = 1e4

    def jax_tap(xx):
        sites = jq8._Sites(scales=None, percentile=spec)
        assert sites.next_scale(xx) == 1.0
        return sites.taps[0]

    ref = np.asarray(jax.jit(jax_tap)(x))
    sites = q8._Sites(scales=None, percentile=spec)
    assert sites.next_scale(torch.from_numpy(x)) == 1.0
    got = sites.taps[0].numpy()
    assert got.shape == ref.shape == (24,)
    if spec in ("pc", "pcamax"):
        assert np.array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_sites_consume_vectors():
    """Inference consumes a host vector as it is (the JAX package's
    `_Sites`), a scalar as a float."""
    v = np.asarray([0.5, 0.25], np.float32)
    sites = q8._Sites(scales=[v, np.float32(0.1)])
    assert sites.next_scale(None) is v
    assert isinstance(sites.next_scale(None), float)


@pytest.mark.parametrize("family,spec", [("unet", "pc99.8"), ("unet", "pcamax"), ("fastnet", "pc"),
                                         ("deeplab", "pc99.95")])
def test_calibration_taps_match_jax(unet_net, family, spec):
    """The float32 calibration walk at 64 px, one vector per site, against
    the JAX package's: |diff| <= 1e-5 of each site's largest channel."""
    if family == "unet":
        _, _, folded, _, raw48, taps = unet_net
        ref = taps if spec == "pc99.8" else jax.jit(lambda f, r: jq8.calibration_amaxes(
            f, jax_normalize_s2d4(r), blocked=True, percentile=spec))(folded, raw48)
        got = q8.calibration_amaxes(from_jax(folded, {})[0], _normalize_s2d4(torch.from_numpy(raw48)), blocked=True,
                                    percentile=spec)
        assert len(got) == 59
    else:
        jm, tm = (jfastnet, fastnet) if family == "fastnet" else (jdeeplab, deeplab)
        params, state = jm.init(0, num_classes=2)
        folded = _np(jax.jit(jm.fold)(params, state))
        raw = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        ref = jax.jit(lambda f, r: jm.calibration_amaxes_int8(f, jax_normalize(r), percentile=spec))(folded, raw)
        got = tm.calibration_amaxes_int8(from_jax(folded, {})[0], normalize(torch.from_numpy(raw)), percentile=spec)
    _check_taps(got, ref)


# ---- the datapath ----


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_conv_vector_matches_jax(compute_dtype):
    """`_int8_conv` with a per-channel vector on the JAX package's folded
    node: int32 accumulators equal, the outputs bit for bit (dequant by ws
    alone)."""
    rng = np.random.default_rng(12)
    w = rng.normal(0, 0.1, (3, 3, 32, 48)).astype(np.float32)
    a = (np.abs(rng.normal(0, 2.0, 32)) + 0.05).astype(np.float32)
    a[4] *= 100.0
    node, s = _jax_pc(jq8._qconv_pc, {"w": w, "b": np.full((48,), 0.1, np.float32)}, a)
    x = (rng.normal(0, 1.0, (2, 9, 9, 32)) * a / 3).astype(np.float32)
    jdt = jnp.float32 if compute_dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if compute_dtype == "float32" else torch.bfloat16
    ref = np.asarray(jq8._int8_conv(node, jnp.asarray(x), s, compute_dtype=jdt), np.float32)
    ref_acc = np.asarray(lax.conv_general_dilated(jq8._quantize_act(jnp.asarray(x), s), node["wq"], (1, 1), "SAME",
                                                  dimension_numbers=CONV_DIMS, preferred_element_type=jnp.int32))
    tnode = _t(node)
    got_acc = q8._int8_acc(q8._quantize_act(torch.from_numpy(x), s), tnode["wq"])
    assert np.array_equal(got_acc.numpy(), ref_acc)
    got = q8._int8_conv(tnode, torch.from_numpy(x), s, compute_dtype=tdt)
    assert got.dtype == tdt and np.array_equal(got.float().numpy(), ref)
    assert q8.scaled_ws(tnode, s) is tnode["ws"]


def test_per_channel_outlier_recovery():
    """The port's copy of tests/test_int8.py's case: an outlier activation
    channel that the net downweights blows the per-tensor scale; the
    balanced per-channel fold reconstructs the conv (mean error under a
    twentieth of the per-tensor one, worst case under 5% of the output)."""
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.2, (1, 1, 8, 16)).astype(np.float32)
    w[:, :, 3, :] *= 1e-3
    x = rng.normal(0, 1.0, (1, 4, 4, 8)).astype(np.float32)
    x[..., 3] *= 1000.0
    ref = np.einsum("nhwc,ijco->nhwo", x, w)

    amax = float(np.abs(x).max())
    y_pt = q8._int8_conv(q8._qconv({"w": torch.from_numpy(w)}), torch.from_numpy(x), amax / 127.0,
                         compute_dtype=torch.float32).numpy()
    cursor = q8.ScaleCursor([np.abs(x).reshape(-1, 8).max(axis=0).astype(np.float32)])
    node_pc = q8._qconv_pc({"w": torch.from_numpy(w)}, cursor)
    s_vec = q8.host_scales(cursor.out_scales)[0]
    y_pc = q8._int8_conv(node_pc, torch.from_numpy(x), s_vec, compute_dtype=torch.float32).numpy()
    err_pt, err_pc = np.abs(y_pt - ref).mean(), np.abs(y_pc - ref).mean()
    assert err_pc < err_pt / 20.0, (err_pc, err_pt)
    assert np.abs(y_pc - ref).max() / np.abs(ref).max() < 0.05


def test_per_channel_fold_exactness_and_counts():
    """The port's copy of tests/test_int8.py's case: the fast family's
    ragged calibration (one vector per site: the stem's 48 s2d channels,
    u3's 256), the normalization max(a / s) = 127, a wrong-length amax list
    rejected, and an exact-grid conv reconstructed bit for bit."""
    params, state = jfastnet.init(0, num_classes=2)
    tp, ts = from_jax(params, state)
    folded = fastnet.fold(tp, ts)
    raw = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    taps = fastnet.calibration_amaxes_int8(folded, normalize(torch.from_numpy(raw)), percentile="pc99.8")
    assert isinstance(taps, list) and len(taps) == len(fastnet._ENC) + len(fastnet._DEC)
    assert tuple(taps[0].shape) == (48,) and tuple(taps[len(fastnet._ENC)].shape) == (256,)
    _, scale_list = fastnet.quantize_folded_int8(folded, act_amaxes=taps)
    assert len(scale_list) == len(taps)
    for t, s in zip(taps, scale_list):
        assert s.shape == t.shape
        assert float((t / s).max()) == pytest.approx(127.0, rel=1e-5)
    with pytest.raises(AssertionError):
        fastnet.quantize_folded_int8(folded, act_amaxes=taps[:-1])

    rng = np.random.default_rng(5)
    a_vec = np.asarray([1.0, 4.0, 0.5, 2.0], np.float32) * 127.0
    w = rng.integers(-7, 8, (1, 1, 4, 8)).astype(np.float32) * 0.25
    cursor = q8.ScaleCursor([a_vec])
    node = q8._qconv_pc({"w": torch.from_numpy(w)}, cursor)
    s_vec = q8.host_scales(cursor.out_scales)[0]
    x = rng.integers(-127, 128, (1, 3, 3, 4)).astype(np.float32) * s_vec
    y = q8._int8_conv(node, torch.from_numpy(x), s_vec, compute_dtype=torch.float32).numpy()
    ref = np.einsum("nhwc,ijco->nhwo", np.round(x / s_vec), node["wq"].float().numpy()) * node["ws"].numpy()
    np.testing.assert_allclose(y, ref, rtol=1e-6)


# ---- the kernels' plain versions with vectors ----


def _pc_node(rng, kh, kw, cin, cout, bias=True, spread=100.0):
    """A per-channel quantized node (the JAX package's quantizer) and its
    scale vector; the activation ranges differ by up to `spread` x between
    channels."""
    a = (rng.uniform(1.0, spread, cin)).astype(np.float32)
    node = {"w": rng.normal(0, 0.1, (kh, kw, cin, cout)).astype(np.float32)}
    if bias:
        node["b"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
    q, s = _jax_pc(jq8._qconv_pc, node, a)
    return q, s, a


def _act(rng, shape, a):
    """bf16 activations whose channel c spans about a[c]."""
    return _bf16(rng.normal(0, 0.4, shape).astype(np.float32) * a)


@pytest.mark.parametrize("stride,down", [(1, True), (2, True), (1, False)], ids=["s1-proj", "s2-proj", "s1-identity"])
def test_bottleneck_block_plain_takes_vectors(stride, down):
    """K3/K4's plain version with per-channel vectors (conv1's and the
    projection's differ on the same x) equals the JAX package's XLA walk of
    the block on `_int8_conv`."""
    rng = np.random.default_rng(20 + stride)
    cin, cmid, cout = (32, 16, 64) if down else (64, 16, 64)
    qb, scales = {}, {}
    for key, (kh, ci, co) in {"conv1": (1, cin, cmid), "conv2": (3, cmid, cmid), "conv3": (1, cmid, cout)}.items():
        qb[key], scales[key], _ = _pc_node(rng, kh, kh, ci, co)
    if down:
        qb["down_conv"], scales["down_conv"], _ = _pc_node(rng, 1, 1, cin, cout)
    x, xt = _act(rng, (2, 8, 8, cin), rng.uniform(0.5, 5.0, cin).astype(np.float32))
    relu = jax.nn.relu
    inner = relu(jq8._int8_conv(qb["conv1"], x, scales["conv1"]))
    inner = relu(jq8._int8_conv(qb["conv2"], inner, scales["conv2"], stride=stride, padding=((1, 1), (1, 1))))
    inner = jq8._int8_conv(qb["conv3"], inner, scales["conv3"])
    short = jq8._int8_conv(qb["down_conv"], x, scales["down_conv"], stride=stride) if down else x
    ref = np.asarray(relu(inner.astype(jnp.float32) + short.astype(jnp.float32)).astype(jnp.bfloat16), np.float32)
    sd = scales.get("down_conv")
    if stride == 2:
        got = qenc.bottleneck_block_s2(xt, _t(qb), scales["conv1"], scales["conv2"], scales["conv3"], sd)
    else:
        got = qenc.bottleneck_block(xt, _t(qb), scales["conv1"], scales["conv2"], scales["conv3"], sd)
    assert tuple(got.shape) == ref.shape
    assert np.array_equal(got.float().numpy(), ref)


def test_parity_up_conv_plain_takes_vectors():
    """K5's plain version with a vector equals the JAX package's up-block
    (the lhs-dilated conv of the 4x4 kernel on `_int8_conv`); K8 refuses a
    vector on any device."""
    rng = np.random.default_rng(31)
    cin, cout = 96, 48
    a = rng.uniform(1.0, 100.0, cin).astype(np.float32)
    k4 = np.asarray(jq8._fused_k4(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32)))
    node, s = _jax_pc(jq8._qkernel_pc, k4, a)
    node["b"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
    x, xt = _act(rng, (2, 6, 6, cin), a / 3)
    ref = np.asarray(jax.nn.relu(jq8._int8_conv(node, x, s, padding=((2, 2), (2, 2)), lhs_dilation=(2, 2))),
                     np.float32)
    got = qdec.parity_up_conv(xt, _t(node), s)
    assert tuple(got.shape) == ref.shape == (2, 12, 12, cout)
    assert np.array_equal(got.float().numpy(), ref)
    with pytest.raises(ValueError, match="per-tensor"):
        qdec.parity_up_conv_separated(xt, _t(node), s)


def test_fused_tail_plain_takes_vectors():
    """K6's plain version with dec4's and dec5's vectors equals the JAX
    package's two `_int8_conv` sites and blocked head; K6's sparse-block
    form equals it too, and K9 refuses vectors."""
    rng = np.random.default_rng(41)
    a4, a5 = rng.uniform(1.0, 100.0, 128).astype(np.float32), rng.uniform(0.5, 50.0, 128).astype(np.float32)
    nodes, scales = [], []
    for a, kernel, cin in ((a4, jq8.s2d_up_conv3x3_kernel, 128), (a5, jq8.s2d_conv3x3_kernel, 32)):
        k = np.asarray(kernel(rng.normal(0, 0.1, (3, 3, cin, 32)).astype(np.float32)))
        node, scale = _jax_pc(jq8._qkernel_pc, k, a)
        nodes.append(node)
        scales.append(scale)
    w_final = rng.normal(0, 0.3, (1, 1, 32, 2)).astype(np.float32)
    b_final = np.asarray([0.1, -0.2], np.float32)
    x, xt = _act(rng, (2, 8, 8, 128), a4 / 3)
    y4 = jax.nn.relu(jq8._int8_conv(nodes[0], x, scales[0]))
    y5 = jax.nn.relu(jq8._int8_conv(nodes[1], y4, scales[1]))
    ref = np.asarray(fused_prediction_head_s2d_blocked(y5, w_final, b_final, overlap=0))
    t4, t5 = _t(nodes[0]), _t(nodes[1])
    got = qtail.fused_tail(xt, t4, scales[0], t5, scales[1], torch.from_numpy(w_final), torch.from_numpy(b_final))
    _assert_close_bins(got.numpy(), ref)
    feats = qtail.fused_tail_features(xt, t4, scales[0], t5, scales[1])
    assert np.array_equal(feats.float().numpy(), np.asarray(y5, np.float32))
    assert torch.equal(qtail.sparse_tail_features_plain(xt, t4, scales[0], t5, scales[1]), feats)
    with pytest.raises(ValueError, match="per-tensor"):
        qtail.fused_tail_features_sep(torch.zeros((1, 2, 2, 512), dtype=torch.bfloat16), t4, scales[0], t5, scales[1])
    with pytest.raises(ValueError, match="all per-tensor or all per-channel"):
        q8.check_one_kind((scales[0], 0.02))


@pytest.mark.parametrize("k,stride,dilation,epilogue", [(3, 1, 1, "residual_relu"), (3, 2, 1, "relu"),
                                                        (3, 1, 6, "relu"), (1, 1, 1, "linear")],
                         ids=["halo-residual", "s2", "aspp-d6", "1x1"])
def test_int8_conv_plain_takes_vectors(k, stride, dilation, epilogue):
    """rs_int8_conv's plain version with a vector equals the JAX package's
    `_int8_conv` and epilogue; `site_operands` keys its cache by the
    vector's bytes and `device_inv` pads the reciprocals to 128 channels."""
    rng = np.random.default_rng(50 + k + stride + dilation)
    cin = 48
    node, s, a = _pc_node(rng, k, k, cin, cin if epilogue == "residual_relu" else 32)
    x, xt = _act(rng, (2, 16, 16, cin), a / 3)
    padding = ((dilation, dilation),) * 2 if dilation > 1 else "SAME"
    y = jq8._int8_conv(node, x, s, stride=stride, dilation=dilation, padding=padding)
    if epilogue == "relu":
        y = jax.nn.relu(y)
    elif epilogue == "residual_relu":
        y = jax.nn.relu(y.astype(jnp.float32) + x.astype(jnp.float32)).astype(jnp.bfloat16)
    got = qconv.int8_conv(xt, _t(node), s, stride=stride, dilation=dilation, padding=padding, epilogue=epilogue)
    assert np.array_equal(got.float().numpy(), np.asarray(y, np.float32))

    tnode = _t(node)
    _, e, inv_v = qconv.site_operands(tnode, s, stride, dilation)
    assert e is tnode["ws"] and tuple(inv_v.shape) == (128,)
    assert np.array_equal(inv_v[:cin].numpy(), np.float32(1.0) / s) and not inv_v[cin:].any()
    s2 = s.copy()
    s2[0] *= 2
    assert not torch.equal(qconv.site_operands(tnode, s2, stride, dilation)[2], inv_v)
    assert qconv.site_operands(tnode, 0.02, stride, dilation)[2] == q8._act_inv(0.02)
    with pytest.raises(ValueError, match="per-channel scale of 48 channels"):
        q8.device_inv(tnode, s[:16], torch.device("cpu"), cin)


# ---- the steps, the gates and the tool ----


def _jax_taps(jm, calibrate):
    """A port calibration function that returns the JAX package's taps for
    the port's folded tree and input (converted to numpy)."""

    def calib(folded, x, blocked=False, percentile=None):
        out = jax.jit(lambda f, xx: calibrate(jm, f, xx, blocked, percentile))(to_jax(folded), x.numpy())
        return [torch.from_numpy(np.asarray(t)) for t in out]

    return calib


def _unet_calibrate(jm, f, x, blocked, percentile):
    return jq8.calibration_amaxes(f, x, blocked=blocked, percentile=percentile)


def _family_calibrate(jm, f, x, blocked, percentile):
    return jm.calibration_amaxes_int8(f, x, blocked=blocked, percentile=percentile)


@pytest.mark.parametrize("family,spec,host_s2d", [("unet", "pc", False), ("fastnet", "pcamax", True),
                                                  ("deeplab", "pc99.8", False)],
                         ids=["unet-pc-fine", "fast-pcamax-s2d", "deeplab-pc99.8-fine"])
def test_int8_predict_step_matches_jax(unet_net, monkeypatch, family, spec, host_s2d):
    """make_int8_predict_step with a per-channel spec against the JAX
    package's step on the same weights, 64 px, batch 2, the JAX package's
    calibration taps handed to the port's step: uint8 equal, or one bin
    apart on at most 0.1% of pixels. (The U-Net's "pc99.8" on host-blocked
    input runs in test_predict_tool_pc_matches_jax.)"""
    if family == "unet":
        params, state, _, raw, raw48, _ = unet_net
        jm, tm = junet, unet
        monkeypatch.setattr(q8, "calibration_amaxes", _jax_taps(jm, _unet_calibrate))
    else:
        jm, tm = (jfastnet, fastnet) if family == "fastnet" else (jdeeplab, deeplab)
        params, state = jm.init(0, num_classes=2)
        state = _exact_var(state)
        raw = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        raw48 = np.asarray(jax_space_to_depth4(raw))
        monkeypatch.setattr(tm, "calibration_amaxes_int8", _jax_taps(jm, _family_calibrate))
    batch = raw48 if host_s2d else raw
    jstep, jqt = jax_make_int8_predict_step(jm, params, state, batch, overlap=0, host_s2d=host_s2d,
                                            calib_percentile=spec)
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(tm, tp, ts, batch, overlap=0, host_s2d=host_s2d, calib_percentile=spec)
    _assert_close_bins(step(qtree, batch).numpy(), np.asarray(jstep(jqt, batch)))


def test_int8_predict_step_calibrates_itself(unet_net):
    """Without the JAX package's taps the port's step calibrates on its
    own: one vector per site consumed, the output of the right shape."""
    params, state, _, _, raw48, _ = unet_net
    tp, ts = from_jax(params, state)
    step, qtree = make_int8_predict_step(unet, tp, ts, raw48, overlap=8, host_s2d=True, calib_percentile="pc")
    assert qtree["dec5"]["wq"].dtype == torch.int8
    got = step(qtree, raw48)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 24, 24, 4)


_GATES = {
    "tail": dict(pallas_tail="tail"),
    "sep": dict(pallas_tail="sep"),
    "full": dict(pallas_tail="full"),
    "pallas_enc": dict(pallas_enc=True),
    "calib_amaxes": dict(calib_amaxes=np.ones(59, np.float32)),
}


@pytest.mark.parametrize("gate", sorted(_GATES))
def test_per_channel_gates_match_jax(unet_net, gate):
    """pc with pallas_tail ("tail", "sep", "full"), pallas_enc, or a QAT
    checkpoint's per-tensor amaxes: the JAX package's ValueError, word for
    word."""
    params, state, _, _, raw48, _ = unet_net
    kwargs = dict(overlap=0, host_s2d=True, calib_percentile="pc99.8", **_GATES[gate])
    with pytest.raises(ValueError) as ref:
        jax_make_int8_predict_step(junet, params, state, raw48, **kwargs)
    tp, ts = from_jax(params, state)
    with pytest.raises(ValueError) as got:
        make_int8_predict_step(unet, tp, ts, raw48, **kwargs)
    assert str(got.value) == str(ref.value)
    assert "per-channel" in str(got.value)


def test_segformer_refuses_per_channel():
    """SegFormer's quantizer takes no act_amaxes, as in the JAX package, so
    the step refuses "pc" with the JAX package's ValueError (its own module
    named); its calibration refuses a per-channel spec too."""
    from robosat_tpu.models import segformer as jsegformer

    params, state = jsegformer.init(0, num_classes=2)
    raw = np.zeros((1, 64, 64, 3), np.uint8)
    with pytest.raises(ValueError) as ref:
        jax_make_int8_predict_step(jsegformer, params, state, raw, calib_percentile="pc")
    tp, ts = from_jax(params, state)
    with pytest.raises(ValueError) as got:
        make_int8_predict_step(segformer, tp, ts, raw, calib_percentile="pc")
    assert str(got.value) == str(ref.value).replace("robosat_tpu.", "robosat_tpu_torch.")
    with pytest.raises(ValueError, match="does not support per-channel"):
        segformer.calibration_amaxes_int8((tp, ts), torch.zeros(1, 32, 32, 3), percentile="pc99.8")


def _predict_args(tmp_path, tiles, probs, checkpoint):
    return argparse.Namespace(
        batch_size=2, checkpoint=checkpoint, overlap=0, strip=1, tile_size=64, workers=2, shard=None,
        tiles=str(tiles), probs=str(probs), model=str(tmp_path / "model.toml"),
        dataset=str(tmp_path / "dataset.toml"), profile=None, png_optimize=False,
    )


@pytest.mark.parametrize("family", ["unet", "fast"])
def test_predict_tool_pc_matches_jax(tmp_path, monkeypatch, family):
    """`rs predict` with int8_calibration = "pc99.8" (the U-Net, the fast
    family) against the JAX tool on the same checkpoint and two 64-px
    tiles, the JAX package's calibration taps handed to the port: every
    PNG byte for byte."""
    from robosat_tpu.tools import predict as jax_predict
    from robosat_tpu_torch.tools import predict

    jm, tm = (junet, unet) if family == "unet" else (jfastnet, fastnet)
    if family == "unet":
        monkeypatch.setattr(q8, "calibration_amaxes", _jax_taps(jm, _unet_calibrate))
    else:
        monkeypatch.setattr(tm, "calibration_amaxes_int8", _jax_taps(jm, _family_calibrate))
    params, state = jm.init(0, num_classes=2)
    state = _exact_var(state)
    rng = np.random.default_rng(11)
    for y in (104945, 104946):
        d = tmp_path / "tiles" / "18" / "69623"
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(d / "{}.png".format(y))
    checkpoint = str(tmp_path / "model.npz")
    save_checkpoint(checkpoint, {"params": params, "state": state}, meta={"epoch": 1})
    common = {"cuda": False, "batch_size": 2, "image_size": 64, "checkpoint": str(tmp_path), "bf16": True,
              "int8": True, "int8_calibration": "pc99.8"}
    if family == "fast":
        common["model"] = "fast"
    save_config({"common": common}, str(tmp_path / "model.toml"))
    save_config({"common": {"dataset": str(tmp_path), "classes": ["background", "parking"],
                            "colors": ["denim", "orange"]}}, str(tmp_path / "dataset.toml"))
    assert predict.main(_predict_args(tmp_path, tmp_path / "tiles", tmp_path / "torch", checkpoint))["tiles"] == 2
    jax_predict.main(_predict_args(tmp_path, tmp_path / "tiles", tmp_path / "jax", checkpoint))
    pngs = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert len(pngs) == 2
    for rel in pngs:
        assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
