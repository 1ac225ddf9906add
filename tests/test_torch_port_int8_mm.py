"""robosat_tpu_torch K2: the plain int8 matmul + requantize vs the Pallas kernels.

`make_mm_a` and `make_mm_b` are taken out of benchmarks/bench_pallas_mm.py
by `ast` (they are nested in its `main`) and run with a `pl` whose
`pallas_call` adds `interpret=True`, so the JAX side is the TPU kernels'
own code, interpreted on the CPU. The plain K2 must equal them bit for bit
in both orientations and at the probes' output widths (cout 64, 128, 256),
including accumulators above 2**24, where f32(acc) rounds. The kernel's
shared-memory plan (`int8_mm.plan`) is checked here too: it is plain
arithmetic that csrc/int8_mm.cu repeats.
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from robosat_tpu_torch.ops import int8_mm

_SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks", "bench_pallas_mm.py")
P, P_BLK, COUT = 1024, 512, 64  # COUT: the width of the cases that do not vary it


@functools.lru_cache(maxsize=None)
def _makers():
    """{"a": make_mm_a, "b": make_mm_b} from the script, bound to JAX and an
    interpreting `pl`."""
    main = next(n for n in ast.parse(open(_SCRIPT).read()).body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in ("make_mm_a", "make_mm_b")]
    assert len(defs) == 2
    interpreting = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        GridSpec=pl.GridSpec, BlockSpec=pl.BlockSpec, CostEstimate=pl.CostEstimate,
    )
    ns = {"jax": jax, "jnp": jnp, "pl": interpreting, "pltpu": pltpu}
    exec(compile(ast.Module(body=defs, type_ignores=[]), _SCRIPT, "exec"), ns)
    return {"a": ns["make_mm_a"], "b": ns["make_mm_b"]}


def _operands(orientation, cin, scales, seed, saturate=False, cout=COUT):
    """(lhs, rhs, scale) numpy operands of an orientation: w (cout, cin) and
    x (cin, P) for "a", x (P, cin) and w (cin, cout) for "b"."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (cout, cin), dtype=np.int8)
    x = rng.integers(-127, 128, (cin, P), dtype=np.int8)
    if saturate:
        # |acc| = (cin - 1) * 127**2 + 127 * 126 (odd, 2**24.3 at cin = 1280)
        # at (0, 0) and (1, 0).
        w[0], w[1], x[:, 0] = 127, -127, 127
        x[0, 0] = 126
    if scales == "const":
        s = np.full(cout, 1e-3, np.float32)
    elif saturate:
        s = rng.uniform(2e-6, 6e-6, cout).astype(np.float32)  # keeps |acc| ~ 2**24 inside +-127
    else:
        s = np.exp(rng.uniform(np.log(1e-5), np.log(1e-3), cout)).astype(np.float32)
    if orientation == "a":
        return w, x, s.reshape(cout, 1)
    return np.ascontiguousarray(x.T), np.ascontiguousarray(w.T), s.reshape(1, cout)


def _check(orientation, lhs, rhs, s):
    cin = lhs.shape[1]
    cout = s.size
    mm = _makers()[orientation](cout, cin, P, P_BLK)
    ref = np.asarray(mm(jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(s)))
    got = int8_mm.int8_matmul_requant(torch.from_numpy(lhs), torch.from_numpy(rhs), torch.from_numpy(s), orientation)
    assert got.dtype == torch.int8 and tuple(got.shape) == ref.shape
    diff = int((got.numpy() != ref).sum())
    assert diff == 0, "{} of {} outputs differ".format(diff, ref.size)
    return int8_mm.int8_matmul_acc_plain(torch.from_numpy(lhs), torch.from_numpy(rhs))


@pytest.mark.parametrize("cout", [64, 128, 256])
@pytest.mark.parametrize("scales", ["random", "const"])
@pytest.mark.parametrize("cin", [64, 576, 1280])
@pytest.mark.parametrize("orientation", ["a", "b"])
def test_int8_matmul_requant_plain_matches_pallas(orientation, cin, scales, cout):
    lhs, rhs, s = _operands(orientation, cin, scales, seed=cin + (orientation == "b") + cout, cout=cout)
    acc = _check(orientation, lhs, rhs, s)
    # The epilogue saw both signs and both sides of the clip.
    out = int8_mm.requantize(acc, torch.from_numpy(s))
    assert (out == 127).any() or scales == "random"
    assert (out > -127).logical_and(out < 127).any()


@pytest.mark.parametrize("orientation", ["a", "b"])
def test_int8_matmul_requant_above_2_24_matches_pallas(orientation):
    """Rows of w and a column of x at +-127: |acc| = 1279 * 127**2 + 127 * 126
    > 2**24 and odd, so f32(acc) rounds; the scales keep the result unclipped."""
    lhs, rhs, s = _operands(orientation, 1280, "random", seed=11, saturate=True)
    acc = _check(orientation, lhs, rhs, s)
    big = acc.abs() > 2**24
    assert int(big.sum()) == 2
    assert not torch.equal(acc[big].float().double(), acc[big].double())  # f32(acc) rounded
    out = int8_mm.requantize(acc, torch.from_numpy(s))[big]
    assert int(out.abs().max()) < 127


def test_int8_matmul_requant_rejects_bad_operands():
    w = torch.zeros(64, 32, dtype=torch.int8)
    x = torch.zeros(32, 48, dtype=torch.int8)
    with pytest.raises(ValueError, match="orientation"):
        int8_mm.int8_matmul_requant(w, x, torch.ones(64, 1), "c")
    with pytest.raises(ValueError, match="scale of shape"):
        int8_mm.int8_matmul_requant(w, x, torch.ones(1, 48), "a")
    with pytest.raises(ValueError, match="chain"):
        int8_mm.int8_matmul_requant(w, w, torch.ones(64, 1), "a")
    # Orientation "b" on the same operands: a scale per output column.
    out = int8_mm.int8_matmul_requant(w, x, torch.ones(1, 48), "b")
    assert out.shape == (64, 48) and int(out.abs().max()) == 0


@pytest.mark.parametrize("orientation", ["a", "b"])
def test_int8_matmul_plan_fits_the_probes(orientation):
    """Every probe contraction: the smallest slab that holds all its output
    channels, a ring of at least MIN_STAGES inside the 227 KB, one block per
    SM (at most one walker per P tile); dec3par's 1280 x 128 weights fit."""
    for name, (cout, cin, p) in int8_mm.PROBE_SHAPES.items():
        m, n = (cout, p) if orientation == "a" else (p, cout)
        slab, stages, grid = int8_mm.plan(orientation, m, n, cin, 132)
        assert slab == min(s for s in int8_mm.SLABS if s >= cout), name
        assert stages >= int8_mm.MIN_STAGES, name
        assert stages * int8_mm.K_CHUNK * int8_mm.tile_p(slab) <= int8_mm.RING_BYTES, name
        assert int8_mm.smem_bytes(orientation, slab, cin, stages) <= int8_mm.SMEM_LIMIT, name
        assert grid == 132, name
    slab, stages, _ = int8_mm.plan(orientation, *((128, 41472) if orientation == "a" else (41472, 128)), 1280, 132)
    assert slab == 128 and stages >= int8_mm.MIN_STAGES
    assert 1280 * 128 < int8_mm.smem_bytes(orientation, 128, 1280, stages) <= int8_mm.SMEM_LIMIT
    assert int8_mm.smem_bytes(orientation, 128, 1280, stages + 1) > int8_mm.SMEM_LIMIT


@pytest.mark.parametrize("orientation", ["a", "b"])
def test_int8_matmul_plan_grids(orientation):
    """The grid is slabs x walkers: ragged widths take the next slab or, when
    its weights do not fit, more slabs of a smaller one; fewer P tiles than
    SMs give one walker per tile."""
    def plan(cout, k, p, sms=132):
        return int8_mm.plan(orientation, *((cout, p) if orientation == "a" else (p, cout)), k, sms)

    deep = {slab: int8_mm.RING_BYTES // (64 * int8_mm.tile_p(slab)) for slab in int8_mm.SLABS}  # 4, 8, 16 stages
    assert plan(48, 80, 1040) == (64, deep[64], -(-1040 // int8_mm.tile_p(64)))  # one slab, a walker per P tile
    assert plan(130, 64, 165888) == (256, deep[256], 132)
    assert plan(130, 1280, 64)[0::2] == (128, 2)  # 256 x 1296 bytes do not fit: two slabs of 128
    assert plan(1040, 64, 165888) == (256, deep[256], 5 * 26)  # five slabs, 26 walkers each
    assert plan(64, 64, 16) == (64, deep[64], 1)
    assert plan(256, 64, 165888, sms=114) == (256, deep[256], 114)
    # Deeper K leaves less room for the ring, down to MIN_STAGES at the
    # largest K that fits at all (a 64-K step of weights is smaller than a stage).
    stages, k = [], 64
    while True:
        try:
            stages.append(plan(64, k, 165888)[1])
        except ValueError:
            break
        k += 64
    assert stages == sorted(stages, reverse=True) and stages[0] == deep[64] and stages[-1] == int8_mm.MIN_STAGES
    assert 2048 < k < 4096


def test_int8_matmul_plan_raises_past_the_shared_memory():
    """K whose 64-channel weight slab and minimal ring overflow the 227 KB:
    a ValueError naming the limit, in both orientations. The plain version
    on CPU tensors has no such limit."""
    for orientation in ("a", "b"):
        with pytest.raises(ValueError, match="232448"):
            int8_mm.plan(orientation, 64, 64, 4096, 132)
    lhs = torch.zeros(64, 4096, dtype=torch.int8)
    out = int8_mm.int8_matmul_requant(lhs, torch.zeros(4096, 32, dtype=torch.int8), torch.ones(64, 1), "a")
    assert out.shape == (64, 32)
