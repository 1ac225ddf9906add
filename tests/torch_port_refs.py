"""What the port's CPU parity tests share: a small torch thread pool and the JAX references, each compiled once.

- Importing this module sets torch's intra-op pool to TORCH_THREADS threads
  for the process. Tier-1 runs six xdist workers on the machine's cores;
  with a full OpenMP pool in each, every small parallel region of the
  port's CPU path waits on threads that another worker has descheduled,
  and the port's own time under load grows ~10x (one thread a worker:
  the port's files take 12% less summed time than at two). A worker
  collects every test module, so the cap holds for the whole worker.
- The JAX references that several cases or files compute are module-level
  jitted functions here, keyed by their static arguments: one compile per
  process for each, and the same program (the same name and HLO) in every
  file, so the persistent compilation cache serves a second process from
  the first one's compile. Their bodies are the JAX package's calls as the
  tests made them before, so their numbers are unchanged.
- `run_capped` runs a JAX reference in a child process whose XLA:CPU code
  is capped at REFERENCE_ISA, with a persistent compilation cache of its
  own and a time limit.
"""

import functools
import os
import pickle
import subprocess
import sys
import tempfile

import jax
import numpy as np
import torch

from robosat_tpu.models import int8 as jq8
from robosat_tpu.parallel.steps import _normalize_s2d4 as jax_normalize_s2d4
from robosat_tpu.parallel.steps import normalize as jax_normalize

TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)

HERE = os.path.dirname(os.path.abspath(__file__))

# XLA:CPU's instruction-set cap for the JAX reference train steps
# (tests/test_torch_port_train.py's docstring): the same code on every
# x86-64 host the suite runs on.
REFERENCE_ISA = "AVX2"


@functools.partial(jax.jit, static_argnames=("fn", "static"))
def _call(args, arrays, fn, static):
    return fn(*args, **arrays, **dict(static))


def jit_call(fn, *args, **kwargs):
    """fn(*args, **kwargs) compiled by jax.jit: `fn` (a module-level JAX
    function) and every keyword argument that is not an array are static,
    so each distinct (fn, static keywords, argument shapes) compiles once
    per process, where a test body's `jax.jit(lambda ...)` compiles anew
    on every call."""
    arrays = {k: v for k, v in kwargs.items() if isinstance(v, (np.ndarray, jax.Array))}
    static = tuple(sorted((k, v) for k, v in kwargs.items() if k not in arrays))
    return _call(args, arrays, fn=fn, static=static)


# ---- the U-Net's and the families' calibrations ----


@functools.partial(jax.jit, static_argnames=("blocked", "percentile"))
def unet_calibration(folded, raw, blocked, percentile):
    """jq8.calibration_amaxes on raw uint8 input, normalized as the step
    normalizes it (4x4-blocked input when `blocked`)."""
    x = jax_normalize_s2d4(raw) if blocked else jax_normalize(raw)
    return jq8.calibration_amaxes(folded, x, blocked=blocked, percentile=percentile)


@functools.partial(jax.jit, static_argnames=("blocked", "percentile"))
def unet_calibration_normalized(folded, x, blocked, percentile):
    """jq8.calibration_amaxes on normalized input."""
    return jq8.calibration_amaxes(folded, x, blocked=blocked, percentile=percentile)


@functools.partial(jax.jit, static_argnames=("family", "blocked", "percentile"))
def family_calibration(folded, x, family, blocked, percentile):
    """`family.calibration_amaxes_int8` (a JAX package model module) on
    normalized input."""
    return family.calibration_amaxes_int8(folded, x, blocked=blocked, percentile=percentile)


@functools.partial(jax.jit, static_argnames=("family", "percentile"))
def family_calibration_raw(folded, raw, family, percentile):
    """`family.calibration_amaxes_int8` on raw uint8 fine input."""
    return family.calibration_amaxes_int8(folded, jax_normalize(raw), percentile=percentile)


@functools.lru_cache(maxsize=None)
def unet_int8_model():
    """The full-width U-Net of the int8 step tests (seed 0, BN var + eps ==
    1), its 4x4-blocked batch and the JAX package's 99.8 calibration of
    it: (params, state, raw48, amaxes), computed once per process."""
    from robosat_tpu.models import unet as junet
    from robosat_tpu.models.layers import space_to_depth4

    params, state = junet.init(0, num_classes=2)
    state = exact_var(state)
    raw48 = space_to_depth4(np.random.default_rng(7).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    folded = jax.jit(junet.fold)(params, state)
    amaxes = np.asarray(unet_calibration(folded, raw48, blocked=True, percentile=99.8))
    return params, state, raw48, amaxes


def exact_var(tree):
    """A copy of a BN state tree with var + eps == 1 exactly in float32
    (rsqrt is then exact in both packages: XLA:CPU's and torch's differ in
    the last bit elsewhere)."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, np.float32(1.0) - np.float32(1e-5)) if k == "var" else exact_var(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [exact_var(v) for v in tree]
    return tree


# ---- JAX references in a child process ----


def capped_cache_dir():
    """The capped children's persistent compilation cache: the suite's
    directory (tests/conftest.py, named by the host's instruction-set
    flags) with REFERENCE_ISA appended, so that it matches the ignored
    `.jax_cache_cpu_*` pattern and never mixes capped and uncapped code.
    None when the suite has no cache."""
    parent = jax.config.jax_compilation_cache_dir
    return "{}_{}".format(parent.rstrip(os.sep), REFERENCE_ISA.lower()) if parent else None


def run_capped(func, *args, timeout):
    """func(*args) in a child process whose XLA:CPU code is capped at
    REFERENCE_ISA (it starts its own XLA backend): `func` is a module-level
    function of a test module, its arguments and result pickled. The child
    fails after `timeout` seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "args.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(args, f)
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="{} --xla_cpu_max_isa={}".format(os.environ.get("XLA_FLAGS", ""), REFERENCE_ISA))
        code = "import sys; sys.path[:0] = {!r}; import torch_port_refs as r; r._child({!r}, {!r}, {!r}, {!r}, {!r}, {!r})"
        cache = (capped_cache_dir(), jax.config.jax_persistent_cache_min_compile_time_secs)
        subprocess.run([sys.executable, "-c", code.format([HERE, os.path.dirname(HERE)], func.__module__,
                                                          func.__name__, inp, out, *cache)],
                       env=env, check=True, timeout=timeout)
        with open(out, "rb") as f:
            return pickle.load(f)


def _child(module, name, inp, out, cache_dir, min_compile_secs):
    import importlib

    jax.config.update("jax_platforms", "cpu")
    if cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    with open(inp, "rb") as f:
        args = pickle.load(f)
    result = getattr(importlib.import_module(module), name)(*args)
    with open(out, "wb") as f:
        pickle.dump(result, f)
