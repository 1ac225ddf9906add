"""robosat_tpu_torch K10: the plain head-stage rungs vs the Pallas rung kernels.

RUNG_SRC of benchmarks/bisect_mosaic_head.py is executed as it stands, once
per rung, with its `pl.pallas_call(` given `interpret=True` (an `ast`
rewrite), on its own inputs (standard-normal bf16 (1, 8, 288, 128), wm = 1,
bm = 0) and then, through the `fn` it builds, on random wm and bm. Each
plain rung is held against it:

- base, mul: bit-equal;
- reduce, reduce_mm: bit-equal margins (0 ulps): the plain versions sum in
  the orders fitted here to XLA:CPU's (sequential FMA for the reshape-sum,
  four accumulators for the one-hot matmul);
- sigmoid, sigmoid_mm: within 4 ulps (XLA:CPU's logistic against torch's
  sigmoid on the same margins; 2 measured);
- the uint8 rungs: +-1 bin on at most 0.1% of pixels, flips counted (the
  sigmoid's last ulps, and XLA:CPU's reciprocal in the digitize; README,
  "Known deviations of the port").

The TPU rungs pad their 4-wide outputs to 128, 8 or 4 lanes; the padding
must be zero, and the port returns only the meaningful lanes. Which order a
uint8 rung sums in is pinned on inputs where the two orders put a pixel in
adjacent bins.
"""

import ast
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robosat_tpu_torch.ops import head_rungs

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                       "bisect_mosaic_head.py")
SIGMOID_ULPS = 4
MAX_FLIP_SHARE = 0.001


@functools.lru_cache(maxsize=None)
def _rung_code():
    src = next(n.value.value for n in ast.parse(open(_SCRIPT).read()).body
               if isinstance(n, ast.Assign) and n.targets[0].id == "RUNG_SRC")
    tree = ast.parse(src)
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "pallas_call"]
    assert len(calls) == 1
    calls[0].keywords.append(ast.keyword(arg="interpret", value=ast.Constant(True)))
    return compile(ast.fix_missing_locations(tree), "RUNG_SRC", "exec")


@functools.lru_cache(maxsize=None)
def _rung_ns(rung):
    """The namespace RUNG_SRC leaves after running rung `rung`."""
    argv = sys.argv
    sys.argv = ["RUNG_SRC", rung]
    try:
        ns = {"__name__": "RUNG_SRC"}
        exec(_rung_code(), ns)
    finally:
        sys.argv = argv
    return ns


def _run_rung(rung, x, wm, bm):
    """The interpreted rung's output on numpy inputs (x holds bf16 values)."""
    ns = _rung_ns(rung)
    return np.asarray(jax.jit(ns["fn"])(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wm), jnp.asarray(bm), ns["sel"]))


@functools.lru_cache(maxsize=None)
def _jax_rung(rung):
    """(output on the script's inputs, the script's x/wm/bm, output on the
    random inputs, those inputs), all numpy."""
    ns = _rung_ns(rung)
    own = (np.array(ns["r"]), np.array(ns["x"].astype(jnp.float32)), np.array(ns["wm"]), np.array(ns["bm"]))
    rng = np.random.default_rng(7)
    x = np.array(jnp.asarray(rng.normal(0, 1.5, (1, 8, 288, 128)), jnp.bfloat16).astype(jnp.float32))
    wm = rng.normal(0, 0.3, (1, 128)).astype(np.float32)
    bm = rng.normal(0, 0.5, (1, 4)).astype(np.float32)
    return own, (_run_rung(rung, x, wm, bm), x, wm, bm)


def _meaningful(rung, ref):
    """The TPU rung's output without its lane padding, which must be zero."""
    ref = ref[0]
    if rung in ("base", "mul") or rung.startswith("merge"):
        return ref
    assert not ref[..., 4:].any(), "padding lanes are not zero"
    return ref[..., :4]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _bin_distance(a, b):
    d = (a.astype(np.int32) - b.astype(np.int32)) % 256
    return np.minimum(d, 256 - d)


@pytest.mark.parametrize("inputs", ["script", "random"])
@pytest.mark.parametrize("rung", head_rungs.RUNGS)
def test_head_rung_plain_matches_pallas(rung, inputs):
    own, rand = _jax_rung(rung)
    ref, x, wm, bm = own if inputs == "script" else rand
    ref = _meaningful(rung, ref)
    got = head_rungs.head_rung(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wm), torch.from_numpy(bm), rung)
    assert tuple(got.shape) == (1,) + ref.shape
    got = got[0].float().numpy() if got.dtype == torch.bfloat16 else got[0].numpy()
    ref = ref.astype(np.float32) if ref.dtype == jnp.bfloat16 else ref
    assert got.dtype == ref.dtype
    if rung in ("base", "mul", "reduce", "reduce_mm"):
        assert np.array_equal(got, ref), "{} of {} differ".format(int((got != ref).sum()), ref.size)
    elif rung.startswith("sigmoid"):
        assert int(_ulps(got, ref).max()) <= SIGMOID_ULPS
    else:
        d = _bin_distance(got, ref)
        flips = int((d != 0).sum())
        assert d.max() <= 1 and flips <= MAX_FLIP_SHARE * d.size, "{} of {} bins flipped".format(flips, d.size)


def test_matmul_order_is_not_the_reshape_sum_order():
    """The two TPU forms sum the same margins in other orders, and so do
    the two plain orders: the "_mm" rungs need their own path."""
    ref, x, wm, bm = _jax_rung("reduce")[1]
    ref_mm = _jax_rung("reduce_mm")[1][0]
    assert (ref[0, ..., :4] != ref_mm[0, ..., :4]).any()
    t = torch.from_numpy(x).to(torch.bfloat16)
    fma = head_rungs.margins_plain(t, torch.from_numpy(wm), torch.from_numpy(bm), mm=False)
    acc4 = head_rungs.margins_plain(t, torch.from_numpy(wm), torch.from_numpy(bm), mm=True)
    assert not torch.equal(fma, acc4)


@functools.lru_cache(maxsize=None)
def _order_deciding_inputs():
    """(x, wm, bm, pixel, fma bin, matmul bin): inputs on which the two
    summation orders put one pixel's group-0 probability in adjacent bins.
    Large positive products make the margin sums ~25-75, where they differ
    by up to 4 ulps; bm[0] then moves that pixel's margin onto the edge of
    bin 128 (sigmoid = 128/255), between the two sums."""
    rng = np.random.default_rng(11)
    x = np.array(jnp.asarray(rng.normal(2.0, 1.5, (1, 8, 288, 128)), jnp.bfloat16).astype(jnp.float32))
    wm = rng.uniform(0.5, 1.0, (1, 128)).astype(np.float32)
    xt, wt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wm)
    sums = [head_rungs.margins_plain(xt, wt, torch.zeros(1, 4), mm)[..., 0].flatten().double() for mm in (False, True)]
    pixel = int((sums[0] - sums[1]).abs().argmax())
    edge = np.log(128 / 127)  # the margin whose sigmoid is 128/255
    bm = np.array([[edge - (float(sums[0][pixel]) + float(sums[1][pixel])) / 2, 0, 0, 0]], np.float32)
    bins = [int(head_rungs.head_rung(xt, wt, torch.from_numpy(bm), rung).flatten()[4 * pixel])
            for rung in ("digitize", "digitize_mm")]
    return x, wm, bm, pixel, bins[0], bins[1]


@pytest.mark.parametrize("rung", [r for r in head_rungs.RUNGS if r.startswith(("digitize", "merge"))])
def test_rung_sums_in_the_tpu_rungs_order(rung):
    """The TPU script sums the margins as the one-hot matmul exactly for the
    rungs whose names end in "_mm" (digitize_mm_pad8 and _pad4 do not), and
    the plain rung follows it: on a pixel where the two orders land in
    adjacent bins, the plain rung's bin is the interpreted rung's."""
    x, wm, bm, pixel, fma_bin, mm_bin = _order_deciding_inputs()
    assert fma_bin != mm_bin
    ref = _meaningful(rung, _run_rung(rung, x, wm, bm)).reshape(-1)[4 * pixel]
    got = head_rungs.head_rung(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wm), torch.from_numpy(bm),
                               rung).flatten()[4 * pixel]
    assert int(ref) == (mm_bin if rung.endswith("_mm") else fma_bin)
    assert int(got) == int(ref)


def test_fma_rounds_once():
    """`_fma` is a correctly rounded f32 fused multiply-add where float64
    rounds twice: 65 * 16519105 = 2**30 + 1, so a * b = 2**-24 + 2**-54 and
    1 + a * b lies just above the f32 midpoint 1 + 2**-24. float64 rounds it
    onto the midpoint, which then rounds to even (1.0); once is 1 + 2**-23."""
    a = torch.tensor([65 * 2.0**-30, -65 * 2.0**-30])
    b = torch.tensor([16519105 * 2.0**-24] * 2)
    c = torch.tensor([1.0, -1.0])
    assert (a.double() * b.double() + c.double()).float().abs().tolist() == [1.0, 1.0]
    assert head_rungs._fma(a, b, c).tolist() == [1.0 + 2.0**-23, -(1.0 + 2.0**-23)]


def test_head_rung_rejects_bad_operands():
    x = torch.zeros(1, 2, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown rung"):
        head_rungs.head_rung(x, torch.ones(1, 128), torch.zeros(1, 4), "merge_pad8")
    with pytest.raises(ValueError, match=r"\(N, H, W, 128\)"):
        head_rungs.head_rung(x[..., :64], torch.ones(1, 128), torch.zeros(1, 4), "reduce")
    assert head_rungs.head_rung(x, torch.ones(1, 128), torch.zeros(1, 4), "merge").shape == (1, 2, 8)
