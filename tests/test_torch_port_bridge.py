"""robosat_tpu_torch: weight bridge, BN fold, quantizer and calibration vs the JAX package.

The same numpy inputs go through the JAX function and its PyTorch port on
the CPU. The quantizer must agree bit for bit; the float calibration walk
agrees to float32 summation order (rtol 1e-5).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from robosat_tpu.checkpoint import save_checkpoint
from robosat_tpu.models import int8 as jq8
from robosat_tpu.models import unet as junet
from robosat_tpu.models.layers import space_to_depth4 as jax_space_to_depth4
from robosat_tpu.parallel.steps import _normalize_s2d4 as jax_normalize_s2d4
from robosat_tpu_torch.checkpoint import from_jax, load_model_checkpoint, to_jax
from robosat_tpu_torch.device import configure_device
from robosat_tpu_torch.models import int8 as q8
from robosat_tpu_torch.models import layers, unet
from robosat_tpu_torch.parallel.steps import _normalize_s2d4


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _exact_var(tree):
    """A copy of a BN state tree with var + eps == 1 exactly in float32."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, np.float32(1.0) - np.float32(1e-5)) if k == "var" else _exact_var(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_exact_var(v) for v in tree]
    return tree


@pytest.fixture(scope="module")
def jax_unet():
    params, state = junet.init(0, num_classes=2)
    return params, state, _np(jax.jit(junet.fold)(params, state))


def test_from_jax_to_jax_round_trip(jax_unet):
    params, state, _ = jax_unet
    tp, ts = from_jax(params, state)
    assert isinstance(tp["encoder"]["layer1"][0]["conv1"]["w"], torch.Tensor)
    back_p, back_s = to_jax(tp), to_jax(ts)
    for a, b in zip(_leaves(params) + _leaves(state), _leaves(back_p) + _leaves(back_s)):
        assert a.shape == b.shape and np.array_equal(np.asarray(a), b)


def test_load_model_checkpoint_npz(tmp_path, jax_unet):
    params, state, _ = jax_unet
    path = str(tmp_path / "model.npz")
    save_checkpoint(path, {"params": params, "state": state}, meta={"epoch": 3, "qat_amaxes": [1.0, 2.0]})
    tp, ts, meta = load_model_checkpoint(path)
    assert meta == {"epoch": 3, "qat_amaxes": [1.0, 2.0]}
    for a, b in zip(_leaves(params) + _leaves(state), _leaves(tp) + _leaves(ts)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_load_model_checkpoint_pth_matches_jax_loader(tmp_path):
    """A reference robosat .pth goes through the shared converter: the port
    loads exactly the arrays the JAX package's loader does."""
    from robosat_tpu.checkpoint import load_model_checkpoint as jax_load

    g = torch.Generator().manual_seed(0)
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = torch.randn(cout, cin, k, k, generator=g) * 0.05

    def bn(key, c):
        sd[key + ".weight"] = torch.ones(c)
        sd[key + ".bias"] = torch.zeros(c)
        sd[key + ".running_mean"] = torch.zeros(c)
        sd[key + ".running_var"] = torch.ones(c)

    conv("module.resnet.conv1", 64, 3, 7)
    bn("module.resnet.bn1", 64)
    cin = 64
    for si, (blocks, mid) in enumerate(((3, 64), (4, 128), (6, 256), (3, 512))):
        for bi in range(blocks):
            base = "module.resnet.layer{}.{}".format(si + 1, bi)
            conv(base + ".conv1", mid, cin, 1)
            bn(base + ".bn1", mid)
            conv(base + ".conv2", mid, mid, 3)
            bn(base + ".bn2", mid)
            conv(base + ".conv3", 4 * mid, mid, 1)
            bn(base + ".bn3", 4 * mid)
            if bi == 0:
                conv(base + ".downsample.0", 4 * mid, cin, 1)
                bn(base + ".downsample.1", 4 * mid)
            cin = 4 * mid
    for name, c_in, c_out in (("center", 2048, 256), ("dec0", 2304, 256), ("dec1", 1280, 256),
                              ("dec2", 768, 64), ("dec3", 320, 128), ("dec4", 128, 32)):
        conv("module.{}.block.block".format(name), c_out, c_in, 3)
    conv("module.dec5.block", 32, 32, 3)
    conv("module.final", 2, 32, 1)
    sd["module.final.bias"] = torch.zeros(2)
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": sd, "epoch": 7}, path)

    jp, js, jmeta = jax_load(path)
    tp, ts, meta = load_model_checkpoint(path)
    assert meta == jmeta == {"epoch": 7}
    for a, b in zip(_leaves(jp) + _leaves(js), _leaves(tp) + _leaves(ts)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_fold_matches_jax(jax_unet):
    """The BN fold agrees to 1 ulp (XLA:CPU's rsqrt and torch's differ in the
    last bit), and bit for bit where var + eps == 1 makes rsqrt exact."""
    params, state, folded = jax_unet
    tp, ts = from_jax(params, state)
    for a, b in zip(_leaves(folded), _leaves(unet.fold(tp, ts))):
        np.testing.assert_allclose(b.numpy(), a, rtol=2.5e-7, atol=0)

    exact_state = _exact_var(state)
    folded_exact = _np(jax.jit(junet.fold)(params, exact_state))
    tp, ts = from_jax(params, exact_state)
    for a, b in zip(_leaves(folded_exact), _leaves(unet.fold(tp, ts))):
        assert np.array_equal(a, b.numpy())


def test_quantizer_bit_equal(jax_unet):
    """wq bit for bit and ws equal on the same folded tree: pins that XLA
    computes `amax / 127.0` as a multiply by the f32 reciprocal and `w /
    scale` as a true division (models/int8.py:82)."""
    _, _, folded = jax_unet
    jqt = _np(jax.jit(jq8.quantize_unet_folded)(folded))
    tf, _ = from_jax(folded, {})
    tqt = q8.quantize_unet_folded(tf)
    jl, tl = _leaves(jqt), _leaves(tqt)
    assert len(jl) == len(tl) == 174
    for a, b in zip(jl, tl):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


def test_weight_rewrites_match_jax():
    from robosat_tpu.models import layers as jlayers

    rng = np.random.default_rng(3)
    w3 = rng.normal(0, 0.1, (3, 3, 16, 8)).astype(np.float32)
    w7 = rng.normal(0, 0.1, (7, 7, 3, 64)).astype(np.float32)
    t3, t7 = torch.from_numpy(w3), torch.from_numpy(w7)
    assert np.array_equal(np.asarray(jq8._fused_k4(w3)), q8._fused_k4(t3).numpy())
    assert np.array_equal(np.asarray(jlayers.s2d_up_conv3x3_kernel(w3)), layers.s2d_up_conv3x3_kernel(t3).numpy())
    assert np.array_equal(np.asarray(jlayers.s2d_conv3x3_kernel(w3)), layers.s2d_conv3x3_kernel(t3).numpy())
    assert np.array_equal(np.asarray(jlayers.stem_s2d4_kernel(w7)), layers.stem_s2d4_kernel(t7).numpy())
    x = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    assert np.array_equal(np.asarray(jlayers.space_to_depth2(x)), layers.space_to_depth2(torch.from_numpy(x)).numpy())
    x4 = rng.normal(0, 1, (2, 4, 4, 16)).astype(np.float32)
    assert np.array_equal(np.asarray(jlayers.depth_to_space2(x4)), layers.depth_to_space2(x4))
    np.testing.assert_allclose(
        layers.fused_upsample_conv3x3({"w": t3}, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.fused_upsample_conv3x3({"w": w3}, x)),
        rtol=1e-5, atol=1e-5,
    )
    xp = rng.normal(0, 1, (2, 6, 6, 4 * 8)).astype(np.float32)
    assert np.array_equal(
        np.asarray(jlayers.pool3s2_from_parity(xp, 8)), layers.pool3s2_from_parity(torch.from_numpy(xp), 8).numpy()
    )


def test_normalize_s2d4_bit_equal():
    raw = np.random.default_rng(1).integers(0, 256, (2, 8, 8, 48), dtype=np.uint8)
    ref = np.asarray(jax.jit(jax_normalize_s2d4)(raw))
    assert np.array_equal(ref, _normalize_s2d4(torch.from_numpy(raw)).numpy())


@pytest.mark.parametrize("percentile", [None, 99.8], ids=["amax", "p99.8"])
def test_calibration_amaxes_match_jax(jax_unet, percentile):
    """Per-site calibration of a full-width U-Net at 64 px: float32 convs sum
    in another order than XLA's, so agreement is to rtol 1e-5."""
    _, _, folded = jax_unet
    raw48 = jax_space_to_depth4(np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    ref = np.asarray(
        jax.jit(lambda f, r: jq8.calibration_amaxes(f, jax_normalize_s2d4(r), blocked=True, percentile=percentile))(
            folded, raw48
        )
    )
    tf, _ = from_jax(folded, {})
    got = q8.calibration_amaxes(tf, _normalize_s2d4(torch.from_numpy(raw48)), blocked=True,
                                percentile=percentile).numpy()
    assert got.shape == ref.shape == (59,)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(q8.scales_from_amaxes(got), jq8.scales_from_amaxes(ref), rtol=1e-5)


@pytest.mark.parametrize("percentile", [None, 99.8], ids=["amax", "p99.8"])
def test_calibration_amaxes_fine_match_jax(jax_unet, percentile):
    """`blocked=False`: the calibration walk from the fine stem (7x7/s2 conv
    and max pool) on fine input, against the JAX package's, rtol 1e-5."""
    from robosat_tpu.parallel.steps import normalize as jax_normalize
    from robosat_tpu_torch.parallel.steps import normalize

    _, _, folded = jax_unet
    raw = np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ref = np.asarray(
        jax.jit(lambda f, r: jq8.calibration_amaxes(f, jax_normalize(r), blocked=False, percentile=percentile))(
            folded, raw
        )
    )
    tf, _ = from_jax(folded, {})
    got = q8.calibration_amaxes(tf, normalize(torch.from_numpy(raw)), blocked=False, percentile=percentile).numpy()
    assert got.shape == ref.shape == (59,)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def _grid_fractions(clips, amaxes):
    """The index into the grid of each site's clip / amax."""
    return np.abs(clips[:, None] / amaxes[:, None] - q8._MSE_GRID[None, :]).argmin(axis=1)


@pytest.mark.parametrize("spec", ["mse", "mae"])
def test_grid_calibration_matches_jax(jax_unet, spec):
    """The "mse"/"mae" grids over the 59 sites of a full-width U-Net at 64
    px, host-blocked input: the port picks the JAX package's grid fraction
    at every site, and the clips agree to rtol 1e-5 (their amaxes differ by
    float32 summation order)."""
    _, _, folded = jax_unet
    raw48 = jax_space_to_depth4(np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    jfold = jax.jit(lambda f, r, p: jq8.calibration_amaxes(f, jax_normalize_s2d4(r), blocked=True, percentile=p),
                    static_argnums=2)
    ref, ref_amax = (np.asarray(jfold(folded, raw48, p)) for p in (spec, None))
    tf, _ = from_jax(folded, {})
    x = _normalize_s2d4(torch.from_numpy(raw48))
    got, got_amax = (q8.calibration_amaxes(tf, x, blocked=True, percentile=p).numpy() for p in (spec, None))
    assert got.shape == ref.shape == (59,)
    assert np.all(got <= got_amax) and np.all(got > 0)
    frac_got, frac_ref = _grid_fractions(got, got_amax), _grid_fractions(ref, ref_amax)
    print("{}: grid fractions {}".format(spec, frac_got.tolist()))
    np.testing.assert_array_equal(frac_got, frac_ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("spec,squared", [("mse", True), ("mae", False)])
def test_grid_calibration_oracle(spec, squared):
    """The grid's argmin against a numpy replica on a synthetic site with
    one huge outlier (tests/test_int8.py's oracle), rel 1e-5; the L1 grid
    clips the outlier to the bulk's edge, the L2 grid cannot."""
    a = np.abs(np.random.default_rng(4).standard_normal(4096).astype(np.float32))
    a[0] = 500.0

    best_clip, best_err = None, np.inf
    for frac in q8._MSE_GRID:
        clip = float(a.max()) * float(frac)
        step = max(clip, 1e-12) / 127.0
        resid = np.minimum(np.round(a / step), 127.0) * step - a
        err = float(np.mean(resid**2 if squared else np.abs(resid)))
        if err < best_err:
            best_clip, best_err = clip, err

    sites = q8._Sites(scales=None, percentile=spec)
    assert sites.next_scale(torch.from_numpy(a)) == 1.0
    got = float(sites.taps[0])
    assert got == pytest.approx(best_clip, rel=1e-5)
    assert (got < 0.05 * a.max()) == (not squared)
    assert np.array_equal(q8._MSE_GRID, jq8._MSE_GRID)


def test_configure_device():
    torch.backends.cudnn.allow_tf32 = True
    assert configure_device(False) == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.deterministic is True
    if torch.cuda.is_available():
        assert configure_device(True) == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            configure_device(True)


def test_port_imports_no_jax():
    """The port's entry point imports no JAX, not even transitively (this
    test process has JAX loaded already, so the check runs in a child)."""
    code = (
        "import sys; import robosat_tpu_torch.tools.predict, robosat_tpu_torch.tools.__main__, "
        "robosat_tpu_torch.kernels; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))); "
        "assert not bad, bad"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
