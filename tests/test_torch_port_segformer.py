"""robosat_tpu_torch's SegFormer (models/segformer.py) and its int8 dense route vs the JAX package, on the CPU.

The JAX package's weights (`segformer.init(0)`, full width: MiT-B0, widths
32/64/160/256, decoder 256) cross through the npz bridge
(`checkpoint.from_jax`); the inputs are seeded uint8 tiles at 64 px, batch
2 (stage 3 on a 2 x 2 grid). Where the int8 tree is compared the fuse's BN
state has var + eps == 1: XLA:CPU's rsqrt and torch's differ in the last
bit elsewhere.

- `apply` in eval and training mode: logits within 5e-4 of their largest
  value, the fuse's new BN statistics within 5e-3;
- `predict_quantized_folded` at overlap 8 in float32: uint8 within one bin
  on at most 0.1% of the pixels (counted);
- the bf16 predicts (float, and int8 on host-blocked and fine input) are
  counted, not held to that bound: the random-init network amplifies a
  bf16 rounding anywhere into tens of bins (the JAX package's own bf16
  predict differs from its float32 predict on ~8% of the pixels, by up to
  28 bins), and XLA:CPU keeps some bf16 intermediates in float32 across
  its fusions (a LayerNorm's mean over an unrounded residual sum), which
  eager torch rounds. Each is held to the JAX package's own spread: the
  port's bf16 uint8 no further from the JAX float reference than the JAX
  package's bf16 uint8 is, and no further from the JAX bf16 uint8 than
  that, both within 1.5x (README, "Known deviations of the port");
- the int8 walk with float32 compute around its sites (the JAX package's
  compute_dtype, the port's epilogues patched to keep float32): within one
  bin on at most 0.5% of the pixels (8 of 4608 measured, 0.17%: float32
  rounding of LayerNorm and softmax moves a few activations across an int8
  bin), which holds the walk's structure without bf16's noise;
- `_patch0_s2d4_kernel` exactly equal, and the blocked stage-0 embed equal
  to the fine one within float32 rounding;
- `calibration_amaxes_int8`: 54 sites, fine and blocked, within 1e-5
  relative; `quantize_folded_int8`'s wq and ws exactly equal; the site list;
- `int8_dense_plain` against `_int8_dense` at MiT-B0's dense widths, the SR
  route (space-to-depth r, then the dense) against `_int8_conv` at kernel =
  stride = 8, 4 and 2, and the fuse's 1x1 conv as a dense: int32
  accumulators equal, bf16 bit-equal (compiled, XLA:CPU computes
  acc * (ws * s) + b as one fused multiply-add, as `int8_mm.fma_f32` does
  exactly; op by op it rounds the product first, which the JAX package's
  jitted walks never do);
- `fma_f32` against exact rational arithmetic, ties included; the quantize
  route's layout; K2's dequant plan at every SegFormer site shape fits the
  shared memory a block may have.
"""

import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import segformer as jsegformer
from robosat_tpu.models.layers import CONV_DIMS
from robosat_tpu.models.layers import space_to_depth4 as jax_space_to_depth4
from robosat_tpu.ops.augment import normalize as jax_normalize
from robosat_tpu_torch.checkpoint import from_jax
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import qconv, segformer
from robosat_tpu_torch.ops import int8_mm
from test_torch_port_predict import _assert_close_bins, _bin_distance
from torch_port_refs import exact_var, family_calibration, jit_call

SPREAD = 1.5  # the port's bf16 deviation, against the JAX package's own bf16 spread
F32_INT8_FLIP_SHARE = 0.005


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(a):
    """A float32 array rounded to bfloat16, as (JAX array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _bits_equal(got, want):
    return np.array_equal(got.float().numpy().view(np.int32), np.asarray(want.astype(jnp.float32)).view(np.int32))


def _flips(a, b):
    return int((_bin_distance(np.asarray(a), np.asarray(b)) != 0).sum())


@pytest.fixture(scope="module")
def net():
    """The JAX package's init (BN state as drawn) and a 64-px batch."""
    params, state = _np(jsegformer.init(0, num_classes=2))
    raw = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    return params, state, raw, np.asarray(jax_normalize(raw), np.float32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_apply_matches_jax(net, train):
    params, state, _, x = net
    want, want_state = jit_call(jsegformer.apply, params, state, x, train=train)
    tp, ts = from_jax(params, state)
    got, got_state = segformer.apply(tp, ts, torch.from_numpy(x), train)
    want, got = np.asarray(want), got.detach().numpy()
    scale = np.abs(want).max()
    print("apply (train {}): logits |diff| max {} of their max".format(train, np.abs(got - want).max() / scale))
    assert got.shape == want.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4 * scale)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_state["fuse_bn"][k].detach().numpy(), np.asarray(want_state["fuse_bn"][k]),
                                   rtol=5e-3, atol=5e-3)


def test_fold_is_the_identity_pair(net):
    params, state, _, _ = net
    tp, ts = from_jax(params, state)
    folded = segformer.fold(tp, ts)
    assert folded[0] is tp and folded[1] is ts


def test_predict_quantized_folded_matches_jax(net):
    params, state, _, x = net
    want = np.asarray(jit_call(jsegformer.predict_quantized_folded, (params, state), x, overlap=8))
    tp, ts = from_jax(params, state)
    got = segformer.predict_quantized_folded(segformer.fold(tp, ts), torch.from_numpy(x), overlap=8).numpy()
    assert got.shape == want.shape == (2, 48, 48)
    _assert_close_bins(got, want)


def _held_to_jax_spread(label, got, want_bf16, want_f32):
    """The port's bf16 uint8 `got` against the JAX package's bf16 and
    float32 uint8 of the same function: counted, and held to SPREAD times
    the JAX package's own bf16-vs-float32 spread."""
    spread = _flips(want_bf16, want_f32)
    to_bf16, to_f32 = _flips(got, want_bf16), _flips(got, want_f32)
    print("{}: port bf16 vs JAX bf16 {} of {} pixels (max distance {}), vs JAX float {}; JAX bf16 vs JAX float "
          "{}".format(label, to_bf16, got.size, _bin_distance(got, want_bf16).max(), to_f32, spread))
    assert to_f32 <= SPREAD * spread and to_bf16 <= SPREAD * spread


def test_bf16_predict_quantized_folded_counted(net):
    params, state, _, x = net
    jx, tx = _bf16(x)
    want_bf16, want_f32 = (np.asarray(jit_call(jsegformer.predict_quantized_folded, (params, state), xx, overlap=8))
                           for xx in (jx, x))
    tp, ts = from_jax(params, state)
    got = segformer.predict_quantized_folded(segformer.fold(tp, ts), tx, overlap=8).numpy()
    _held_to_jax_spread("float predict", got, want_bf16, want_f32)


def test_patch0_s2d4_kernel_matches_jax(net):
    params, _, _, x = net
    w7 = params["stages"][0]["patch"]["w"]
    want = np.asarray(jsegformer._patch0_s2d4_kernel(w7))
    got = segformer._patch0_s2d4_kernel(torch.from_numpy(w7)).numpy()
    assert got.shape == want.shape == (2, 2, 48, 32) and np.array_equal(got, want)
    patch = from_jax(params["stages"][0]["patch"], {})[0]
    fine = segformer._patch0_apply(patch, torch.from_numpy(x), blocked=False)
    blocked = segformer._patch0_apply(patch, torch.from_numpy(np.asarray(jax_space_to_depth4(x))), blocked=True)
    np.testing.assert_allclose(blocked.numpy(), fine.numpy(), rtol=0, atol=1e-5 * float(fine.abs().max()))


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "fine"])
def test_calibration_amaxes_match_jax(net, blocked):
    params, state, _, x = net
    xin = np.asarray(jax_space_to_depth4(x)) if blocked else x
    want = np.asarray(family_calibration((params, state), xin, family=jsegformer, blocked=blocked, percentile=99.8))
    tp, ts = from_jax(params, state)
    got = segformer.calibration_amaxes_int8(segformer.fold(tp, ts), torch.from_numpy(xin), blocked=blocked,
                                            percentile=99.8)
    assert got.shape == want.shape == (54,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.fixture(scope="module")
def int8_net(net):
    """Exact-var weights, the JAX package's 99.8 calibration and qtree, and
    the port's qtree from its own fold (equal to JAX's, checked)."""
    params, _, _, x = net
    state = exact_var(net[1])
    amaxes = np.asarray(family_calibration((params, state), x, family=jsegformer, blocked=False, percentile=99.8))
    tp, ts = from_jax(params, state)
    qtree = segformer.quantize_folded_int8(segformer.fold(tp, ts))
    jqt = _np(jax.jit(jsegformer.quantize_folded_int8)((params, state)))
    want_leaves = jax.tree_util.tree_leaves_with_path(jqt)
    got_leaves = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(lambda t: t.numpy(), qtree))
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        if jax.tree_util.keystr(path[-1:]) in ("['wq']", "['ws']"):
            assert g.dtype == w.dtype and np.array_equal(g, w), jax.tree_util.keystr(path)
    return amaxes, jqt, qtree, x


def test_quantize_folded_int8_sites(int8_net):
    """54 sites in the walk's order: 51 on K2's dense route (40 block
    denses, 6 SR convs at their ratio, 4 projections, the fuse), 3 patch
    embeds on rs_int8_conv."""
    _, _, qtree, _ = int8_net
    sites = segformer.sites(qtree)
    assert len(sites) == 54
    assert [s[0] for s in sites[:14]] == ["stage0.0.q", "stage0.0.sr", "stage0.0.kv", "stage0.0.proj",
                                          "stage0.0.fc1", "stage0.0.fc2", "stage0.1.q", "stage0.1.sr",
                                          "stage0.1.kv", "stage0.1.proj", "stage0.1.fc1", "stage0.1.fc2",
                                          "stage1.patch", "stage1.0.q"]
    assert [s[0] for s in sites[-5:]] == ["proj0", "proj1", "proj2", "proj3", "fuse"]
    routes = [(route, stride) for _, _, route, stride in sites]
    assert routes.count(("conv", 2)) == 3 and sum(r == "dense" for r, _ in routes) == 51
    assert sorted(s for r, s in routes if r == "dense" and s > 1) == [2, 2, 4, 4, 8, 8]
    with pytest.raises(TypeError, match="act_amaxes"):
        segformer.quantize_folded_int8((None, None), act_amaxes=[np.ones(4)])
    with pytest.raises(ValueError, match="does not support per-channel"):
        segformer.calibration_amaxes_int8((None, None), torch.zeros(1, 32, 32, 3), percentile="pc99.8")


@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "fine"])
def test_predict_quantized_int8_counted(int8_net, blocked):
    amaxes, jqt, qtree, x = int8_net
    scales = tuple(jq8.scales_from_amaxes(amaxes))
    xin = np.asarray(jax_space_to_depth4(x)) if blocked else x
    jx, tx = _bf16(xin)

    def run(xx, dtype):
        return np.asarray(jit_call(jsegformer.predict_quantized_int8, jqt, scales=scales, x=xx, overlap=8,
                                   blocked=blocked, compute_dtype=dtype))

    want_bf16, want_f32 = run(jx, jnp.bfloat16), run(xin, jnp.float32)
    got = segformer.predict_quantized_int8(qtree, scales, tx, overlap=8, blocked=blocked)
    assert tuple(got.shape) == want_bf16.shape == (2, 48, 48) and got.dtype == torch.uint8
    _held_to_jax_spread("int8 predict ({})".format("blocked" if blocked else "fine"), got.numpy(), want_bf16,
                        want_f32)
    assert torch.equal(segformer.predict_quantized_int8(qtree, scales, tx, overlap=8, blocked=blocked, plain=True),
                       got)
    with pytest.raises((AssertionError, IndexError)):
        segformer.predict_quantized_int8(qtree, scales[:-1], tx, overlap=8, blocked=blocked)


def test_int8_walk_with_float32_compute_matches_jax(int8_net, monkeypatch):
    """The int8 walk without bf16's noise: the JAX package's walk at
    compute_dtype float32 on float32 input, the port's with its dense and
    conv epilogues patched to keep float32."""
    amaxes, jqt, qtree, x = int8_net
    scales = tuple(jq8.scales_from_amaxes(amaxes))
    want = np.asarray(jit_call(jsegformer.predict_quantized_int8, jqt, scales=scales, x=x, overlap=8,
                               compute_dtype=jnp.float32))
    monkeypatch.setattr(int8_mm, "dequantize", lambda acc, sc, b: int8_mm.fma_f32(acc.float(), sc, b))
    monkeypatch.setattr(qconv, "_int8_conv", functools.partial(q8._int8_conv, compute_dtype=torch.float32))
    got = segformer.predict_quantized_int8(qtree, scales, torch.from_numpy(x), overlap=8).numpy()
    d = _bin_distance(got, want)
    print("int8 walk, float32 compute: {} of {} bins differ (max distance {})".format(
        int((d != 0).sum()), d.size, d.max()))
    assert d.max() <= 1 and int((d != 0).sum()) <= F32_INT8_FLIP_SHARE * d.size


# MiT-B0's dense sites (K, N): q and proj d -> d, kv d -> 2d, fc1 d -> 4d,
# fc2 4d -> d per stage width d; the decoder's projections d -> 256.
DENSE_WIDTHS = sorted({(d, n) for d in (32, 64, 160, 256) for n in (d, 2 * d, 4 * d)}
                      | {(4 * d, d) for d in (32, 64, 160, 256)} | {(d, 256) for d in (32, 64, 160)})


@pytest.mark.parametrize("k,n", DENSE_WIDTHS, ids=["{}x{}".format(*w) for w in DENSE_WIDTHS])
def test_int8_dense_plain_matches_jax(k, n):
    rng = np.random.default_rng(k * 7 + n)
    node = {"w": (rng.normal(size=(k, n)) * (2.0 / (k + n)) ** 0.5).astype(np.float32),
            "b": (rng.normal(size=n) * 0.3).astype(np.float32)}
    jnode = _np(jsegformer._qdense(node))
    jx, tx = _bf16(rng.normal(size=(2, 9, 7, k)).astype(np.float32) * 1.5)
    scale = 3.0 / 127
    want = jit_call(jsegformer._int8_dense, jnode, jx, scale=scale)
    want_acc = lax.dot_general(jq8._quantize_act(jx, scale), jnode["wq"], (((3,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tnode, _ = from_jax(jnode, {})
    assert torch.equal(segformer._qdense(from_jax(node, {})[0])["wq"], tnode["wq"])
    xq = int8_mm.quantize_act(tx, scale)
    acc = int8_mm.int8_matmul_acc_plain(xq.reshape(-1, k), tnode["wq"])
    assert np.array_equal(acc.numpy(), np.asarray(want_acc).reshape(-1, n))
    got = int8_mm.int8_dense_plain(tx, tnode, scale)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 9, 7, n)
    assert _bits_equal(got, want)
    assert torch.equal(int8_mm.int8_dense(tx, tnode, scale), got)


@pytest.mark.parametrize("r,c", [(8, 32), (4, 64), (2, 160), (1, 1024)], ids=["sr8", "sr4", "sr2", "fuse-1x1"])
def test_sr_route_matches_int8_conv(r, c):
    """A kernel = stride = r conv (no padding: the sides divide) as the
    quantize kernel's r x r space-to-depth and a dense over it; r = 1 is the
    fuse's 1x1 conv (c -> 256)."""
    rng = np.random.default_rng(r + c)
    cout = 256 if r == 1 else c
    node = {"w": (rng.normal(size=(r, r, c, cout)) * (2.0 / (r * r * cout)) ** 0.5).astype(np.float32),
            "b": (rng.normal(size=cout) * 0.3).astype(np.float32)}
    jnode = _np(jq8._qconv(node))
    side = 2 * r if r > 1 else 5
    jx, tx = _bf16(rng.normal(size=(2, side, side + r * (r > 1), c)).astype(np.float32))
    scale = 3.5 / 127
    want = jit_call(jq8._int8_conv, jnode, jx, scale=scale, stride=r)
    want_acc = lax.conv_general_dilated(jq8._quantize_act(jx, scale), jnode["wq"], (r, r), "SAME",
                                        dimension_numbers=CONV_DIMS, preferred_element_type=jnp.int32)
    tnode, _ = from_jax(jnode, {})
    xq = int8_mm.quantize_act(tx, scale, r)
    assert tuple(xq.shape) == want.shape[:3] + (r * r * c,)
    acc = int8_mm.int8_matmul_acc_plain(xq.reshape(-1, r * r * c), tnode["wq"].reshape(-1, cout))
    assert np.array_equal(acc.numpy(), np.asarray(want_acc).reshape(-1, cout))
    got = int8_mm.int8_dense_plain(tx, tnode, scale, r)
    assert tuple(got.shape) == want.shape and _bits_equal(got, want)
    assert torch.equal(int8_mm.int8_dense(tx, tnode, scale, r), got)


def test_quantize_layout():
    """quantize_act's space-to-depth: channel (er r + ec) C + c of block
    (i, j) holds pixel (r i + er, r j + ec); r = 1 keeps the shape."""
    x = torch.arange(2 * 4 * 6 * 16, dtype=torch.float32).reshape(2, 4, 6, 16).to(torch.bfloat16) / 64
    q1 = int8_mm.quantize_act(x, 1.0 / 127 * 64)
    assert q1.shape == x.shape and torch.equal(q1, q8._quantize_act(x, 1.0 / 127 * 64))
    q2 = int8_mm.quantize_act(x, 1.0 / 127 * 64, 2)
    assert tuple(q2.shape) == (2, 2, 3, 64)
    for er in range(2):
        for ec in range(2):
            assert torch.equal(q2[..., (er * 2 + ec) * 16:(er * 2 + ec + 1) * 16], q1[:, er::2, ec::2])
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_mm.quantize_act(torch.zeros(2, 4, 4, 8, dtype=torch.bfloat16), 1.0)
    with pytest.raises(ValueError, match="sides that divide"):
        int8_mm.quantize_act(torch.zeros(1, 6, 4, 16, dtype=torch.bfloat16), 1.0, 4)


def test_int8_matmul_dequant_checks_operands():
    xq = torch.zeros(8, 32, dtype=torch.int8)
    wq = torch.zeros(32, 48, dtype=torch.int8)
    with pytest.raises(ValueError, match="do not chain"):
        int8_mm.int8_matmul_dequant(xq, wq.t(), torch.ones(48), torch.zeros(48))
    with pytest.raises(ValueError, match=r"\(N,\)"):
        int8_mm.int8_matmul_dequant(xq, wq, torch.ones(47), torch.zeros(48))
    out = int8_mm.int8_matmul_dequant(xq, wq, torch.ones(48), torch.full((48,), -0.5))
    assert out.dtype == torch.bfloat16 and bool((out == -0.5).all())


def _round_f32(value):
    """An exact rational rounded to float32, half to even."""
    f = np.float32(float(value))
    cands = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - value), int(np.array(v).view(np.int32)) & 1))


def test_fma_f32_is_exact():
    """fma_f32 against exact arithmetic, on random triples and on products
    that sit on a float32 tie with an addend below float64's ulp of them
    (where a float64 sum rounded twice gives the wrong neighbour)."""
    rng = np.random.default_rng(0)
    a = rng.integers(-2 ** 20, 2 ** 20, 400).astype(np.float32)
    b = (rng.normal(size=400) * 1e-3).astype(np.float32)
    c = rng.normal(size=400).astype(np.float32)
    a = np.concatenate([a, np.full(200, 3.0, np.float32)])
    b = np.concatenate([b, np.full(200, np.float32(1 + 2 ** -23))])
    c = np.concatenate([c, (rng.choice([-1.0, 1.0], 200) * 2.0 ** rng.integers(-80, -60, 200)).astype(np.float32)])
    got = int8_mm.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert not np.array_equal(naive[400:].view(np.int32), want[400:].view(np.int32))


# Every K2 dense site of the predict path at batch 8 and 576 px, (M, K, N).
SITE_SHAPES = sorted({(m, k, n) for d, m in ((32, 165888), (64, 41472), (160, 10368), (256, 2592))
                      for k, n in ((d, d), (d, 4 * d), (4 * d, d), (d, 256))}
                     | {(2592, d, 2 * d) for d in (32, 64, 160, 256)}
                     | {(2592, 2048, 32), (2592, 1024, 64), (2592, 640, 160), (165888, 1024, 256)})


def test_dequant_plan_fits_every_site():
    """K2's dequant epilogue at every site shape: a slab of weights, a ring
    of at least 3 stages, bf16 staging and the biases within the 227 KB a
    block may have; the requantizing plan is as before."""
    assert len(SITE_SHAPES) == 22
    for m, k, n in SITE_SHAPES:
        slab, stages, grid = int8_mm.plan("b", m, n, k, 132, "dequant")
        assert stages >= int8_mm.MIN_STAGES and grid % -(-n // slab) == 0
        assert int8_mm.smem_bytes("b", slab, k, stages, "dequant") <= int8_mm.SMEM_LIMIT
    # stage 0's SR (K = 2048, N = 32): 512 bytes of scales and biases, 64 rows
    # of 2064 weight bytes, 8 warps' 32 x 192-byte staging, 3 stages of 64 x 256
    assert int8_mm.smem_bytes("b", 64, 2048, 3, "dequant") == 640 + 64 * 2064 + 8 * 32 * 192 + 3 * 64 * 256
    assert int8_mm.smem_bytes("b", 128, 256, 8) == 125696


def test_every_c_entry_has_its_ctypes_signature():
    """Each `extern "C"` entry of csrc/*.cu has argtypes in
    kernels._SIGNATURES, one per parameter (without them ctypes passes a
    pointer as a 32-bit int), and no signature names a missing entry."""
    import glob
    import os
    import re

    from robosat_tpu_torch import kernels

    entries = {}
    for path in glob.glob(os.path.join(os.path.dirname(kernels.__file__), "csrc", "*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', open(path).read()):
            entries[name] = len(params.split(","))
    assert "rs_int8_mm_dequant" in entries and "rs_quantize_act" in entries
    assert entries == {name: len(argtypes) for name, argtypes in kernels._SIGNATURES.items()}
