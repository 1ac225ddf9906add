"""Build and load the port's CUDA kernels (csrc/*.cu) through ctypes.

The sources compile at first use with nvcc for sm_90a, one nvcc process
per `.cu` file, all started together, then link into one shared library
with a plain C interface, cached under `_build/` by the hash of the sources
(a changed source rebuilds). An exclusive file lock serialises the build
across processes. Nothing here runs at import time: this module
imports on machines without nvcc or a GPU, where only the plain PyTorch
versions of the kernels are used.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

import torch

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, (w, e, b) x 4 [conv1, conv2, conv3, down], inv x 4, inv vector x 4, h1, h2, sc, out, n, h, w, cin, cmid,
    # cout, stride, dilation, stream
    "rs_bottleneck_block": [_P] * 13 + [_F] * 4 + [_P] * 8 + [_I] * 8 + [_P],
    # x, w, e, b, inv, inv vector, out, n, h, w, cin, cout, stream
    "rs_parity_up_conv": [_P, _P, _P, _P, _F, _P, _P] + [_I] * 5 + [_P],
    # x, w, e, b, inv, out, n, h, w, cin, cout, stream
    "rs_parity_up_conv_separated": [_P, _P, _P, _P, _F, _P] + [_I] * 5 + [_P],
    # x, w, e, b, inv, inv vector, out, n, h, w, cin, cout, k, stride, dil, pad_top, pad_left, ho, wo, epilogue,
    # stream
    "rs_int8_conv": [_P, _P, _P, _P, _F, _P, _P] + [_I] * 13 + [_P],
    # x, (blocks, table, n_blocks, e) x 2 [dec4, dec5], wmb, inv4, inv5, inv vectors 4 and 5, y4, out, n, h, w, o,
    # stream
    "rs_fused_tail": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _F, _F, _P, _P, _P, _P] + [_I] * 4 + [_P],
    # x, (blocks, table, n_blocks, e) x 2 [dec4, dec5], inv4, inv5, inv vectors 4 and 5, y4, y5, n, h, w, stream
    "rs_fused_tail_features": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _F, _F, _P, _P, _P, _P] + [_I] * 3 + [_P],
    # x, (blocks, table, n_blocks, e) x 2 [dec4, dec5], inv4, inv5, y4, y5, hc, wc, stream
    "rs_fused_tail_features_sep": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _F, _F, _P, _P] + [_I] * 3 + [_P],
    # features, wmb, out, n, h, w, groups, o, bf16, stream
    "rs_margin_head": [_P] * 3 + [_I] * 6 + [_P],
    # a, b, scale, out, m, n, k, orientation, slab, stages, grid, stream
    "rs_int8_mm": [_P] * 4 + [_I] * 7 + [_P],
    # x, w, sc, bias, out, m, n, k, slab, stages, grid, stream
    "rs_int8_mm_dequant": [_P] * 5 + [_I] * 6 + [_P],
    # x, out, inv, n, h, w, c, r, stream
    "rs_quantize_act": [_P, _P, _F] + [_I] * 5 + [_P],
    # x, wm, bm, out, n, h, w, stage, mm, stream
    "rs_head_rung": [_P] * 4 + [_I] * 5 + [_P],
}

_lib = None
build_seconds = None


def _sources():
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh")))


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels build only where the toolkit is installed")
    return found


def library_path():
    digest = hashlib.sha256()
    for path in _sources():
        digest.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, "librs_kernels_{}.so".format(digest.hexdigest()[:16]))


def build():
    """Compile the kernels if the cached library is missing; returns its path."""
    global build_seconds
    lib_path = library_path()
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(lib_path):
                start = time.perf_counter()
                tmp = lib_path + ".tmp{}".format(os.getpid())
                nvcc = _nvcc()
                objs = []
                procs = []
                for src in (p for p in _sources() if p.endswith(".cu")):
                    obj = "{}.{}.o".format(tmp, os.path.basename(src)[:-3])
                    objs.append(obj)
                    cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                    procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
                failed = []
                for src, proc in procs:
                    output = proc.communicate()[0]
                    if proc.returncode != 0:
                        failed.append("{} ({}):\n{}".format(os.path.basename(src), proc.returncode, output))
                if not failed:
                    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
                    if proc.returncode != 0:
                        failed.append("link ({}):\n{}{}".format(proc.returncode, proc.stdout, proc.stderr))
                for obj in objs:
                    if os.path.exists(obj):
                        os.remove(obj)
                if failed:
                    raise RuntimeError("nvcc failed: " + "\n".join(failed))
                os.replace(tmp, lib_path)
                build_seconds = time.perf_counter() - start
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib_path


def library():
    """The loaded kernel library, building it on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name, *args):
    """Call kernel entry `name` on the current CUDA stream; raise on a
    refused launch (the entry returns cudaGetLastError())."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError("{} launch failed with CUDA error {}".format(name, rc))


def ptr(t):
    """Device pointer of a tensor (None for a missing optional operand)."""
    return None if t is None else t.data_ptr()


def check_cuda(t, name, dtype, shape=None):
    """Validate a kernel operand: CUDA, dtype, contiguous, 16-byte aligned,
    and (where given) its shape; raises ValueError otherwise."""
    if not t.is_cuda:
        raise ValueError("{} must be a CUDA tensor (got {})".format(name, t.device))
    if t.dtype != dtype:
        raise ValueError("{} must be {} (got {})".format(name, dtype, t.dtype))
    if not t.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))
    if t.data_ptr() % 16:
        raise ValueError("{} must be 16-byte aligned".format(name))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("{} must have shape {} (got {})".format(name, tuple(shape), tuple(t.shape)))
    return t
