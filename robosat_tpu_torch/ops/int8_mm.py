"""int8 matmul with a fused requantize or dequant epilogue: CUDA kernel K2,
the activation quantize that feeds its dense sites, and their plain versions.

Counterpart of the Pallas kernels benchmarks/bench_pallas_mm.py:make_mm_a
and make_mm_b, the probe of the U-Net's 1x1 and per-tap int8 contractions
(their `SHAPES`: cout 64-256, cin 64-1280, P = 8 x 144 x 144 or a quarter
of it). Both compute

    acc = lhs @ rhs                               (int8 x int8 -> int32)
    out = clip(round(f32(acc) * scale), -127, 127).astype(int8)

with round half to even, in one of two orientations:

- "a" (channels-major): lhs = w (cout, cin), rhs = x (cin, P), scale
  (cout, 1), out (cout, P);
- "b" (NHWC-flat): lhs = x (P, cin), rhs = w (cin, cout), scale (1, cout),
  out (P, cout).

`int8_matmul_requant` launches csrc/int8_mm.cu on CUDA tensors (the
orientation and the weight slab are template parameters there, the ring's
depth and the grid come from `plan`) and runs the plain version on CPU
tensors. The plain version takes the accumulators from a float64
matmul over the int8 values, exact while |acc| < 2**53 (here < 2**25),
then the epilogue in torch; above 2**24 the f32 conversion rounds, as the
reference's does. The probe's timing harness (the dependent-chain marginal
timing and the XLA conv baseline) is not ported: chip_smoke.py times the
kernel beside `torch._int_mm`.

SegFormer's int8 dense sites (robosat_tpu/models/segformer.py `_int8_dense`,
an XLA dot in the JAX package, and its spatial-reduction and fuse convs,
which are denses over a space-to-depth or over pixels) run `int8_dense`:

    xq = clip(round(x * f32(1 / s)), -127, 127)            (quantize_act; r x r space-to-depth for r > 1)
    out = bf16(fma(f32(xq @ wq), ws * s, b))                (int8_matmul_dequant: K2, orientation b)

with one fused multiply-add in f32, as XLA:CPU compiles the JAX package's
acc * (ws * s) + b for its dot and its conv alike (`fma_f32` computes it
exactly on any device). On CUDA
tensors `quantize_act` launches csrc/int8_mm.cu's rs_quantize_act and
`int8_matmul_dequant` its rs_int8_mm_dequant (K2 with a bf16 epilogue);
on CPU tensors each runs its plain version. `dense_operands` caches a
site's 2-D weight, ws * s and bias on its tree node.
"""

import functools

import numpy as np
import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.int8 import _act_inv, _quantize_act, scaled_ws
from robosat_tpu_torch.models.layers import space_to_depth

ORIENTATIONS = {"a": 0, "b": 1}

P_FULL = 165888  # 8 x 144 x 144: layer1's pixels at batch 8 of 576-px buffered tiles
# The probe's contractions, name -> (cout, cin, P) (bench_pallas_mm.py:SHAPES).
PROBE_SHAPES = {
    "c1b0": (64, 64, P_FULL),
    "c1b12": (64, 256, P_FULL),
    "c2tap1": (64, 64, P_FULL),  # conv2 as 9 of these
    "c2tap9": (64, 576, P_FULL),  # conv2 with all taps K-stacked
    "c3": (256, 64, P_FULL),
    "c3down": (256, 128, P_FULL),
    "dec3par": (128, 1280, P_FULL // 4),
    "dense256": (256, 256, P_FULL),
}


# csrc/int8_mm.cu's shared-memory plan: a block keeps SLAB output channels
# of weights (rows of K rounded up to 64, + 16 bytes), their f32 scales (and
# biases, with the dequant epilogue), its consumer warps' staged output tiles
# and a ring of stages of 64 K bytes x the P tile, after three mbarriers per
# stage; each piece starts on 128 bytes.
SMEM_LIMIT = 232448  # dynamic shared memory one block may have on the H100 (227 KB)
SLABS = (64, 128, 256)
MIN_STAGES = 3
RING_BYTES = 65536  # the ring's depth: as many stages as fit in this many bytes
K_CHUNK = 64


def tile_p(slab):
    """Columns of P (the streamed dimension) per tile for a weight slab."""
    return {64: 256, 128: 128, 256: 64}[slab]


def staged_bytes(slab, epilogue="requant"):
    """Shared memory of the consumer warps' staged output tiles: 8 warps of
    32 x 64, at slabs of 256 16 warps of 32 x 32; int8 rows padded by 32
    bytes to 96 (32 x 32: unpadded), bf16 rows (dequant) of 128 bytes padded
    to 192 (32 x 32: 64, unpadded)."""
    if epilogue == "dequant":
        return 16 * 32 * 64 if slab == 256 else 8 * 32 * 192
    return 16 * 32 * 32 if slab == 256 else 8 * 32 * (64 + 32)


def smem_bytes(orientation, slab, k, stages, epilogue="requant"):
    """Dynamic shared memory of one block of csrc/int8_mm.cu (its `plan`)."""
    def align(x):
        return (x + 127) // 128 * 128

    row_w = -(-k // K_CHUNK) * K_CHUNK + 16
    w = align(align(24 * stages) + 4 * slab * (2 if epilogue == "dequant" else 1))
    return align(align(w + slab * row_w) + staged_bytes(slab, epilogue)) + stages * K_CHUNK * tile_p(slab)


@functools.lru_cache(maxsize=None)
def plan(orientation, m, n, k, sms, epilogue="requant"):
    """(slab, stages, grid) of a launch: the smallest slab that holds every
    output channel (at most 256), or the largest smaller one whose weights fit
    beside a ring of MIN_STAGES; the deepest ring up to RING_BYTES that fits;
    about one block per SM in all (`sms`), as slabs x walkers with at most one
    walker per P tile. Raises ValueError when not even a 64-channel slab fits."""
    cout, p = (m, n) if orientation == "a" else (n, m)
    first = next((i for i, s in enumerate(SLABS) if s >= cout), len(SLABS) - 1)
    for slab in reversed(SLABS[:first + 1]):
        deepest = max(MIN_STAGES, RING_BYTES // (K_CHUNK * tile_p(slab)))
        stages = next((st for st in range(deepest, MIN_STAGES - 1, -1)
                       if smem_bytes(orientation, slab, k, st, epilogue) <= SMEM_LIMIT), None)
        if stages is not None:
            slabs = -(-cout // slab)
            walkers = max(1, min(-(-p // tile_p(slab)), sms // slabs))
            return slab, stages, slabs * walkers
    raise ValueError("the int8 matmul keeps a slab of at least {} output channels of weights in shared memory: "
                     "K = {} needs {} bytes with a ring of {} stages, over the {} a block may have".format(
                         SLABS[0], k, smem_bytes(orientation, SLABS[0], k, MIN_STAGES, epilogue), MIN_STAGES,
                         SMEM_LIMIT))


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_matmul_acc_plain(lhs, rhs):
    """The int32 accumulators lhs @ rhs of int8 (M, K) and (K, N) operands
    (any device)."""
    return (lhs.double() @ rhs.double()).to(torch.int32)


def requantize(acc, scale):
    """int32 accumulators -> int8: f32(acc) * scale, round half to even, clip."""
    return torch.clamp(torch.round(acc.float() * scale), -127, 127).to(torch.int8)


def int8_matmul_requant_plain(lhs, rhs, scale):
    """requantize(lhs @ rhs, scale) with the scale broadcast over the output
    (any device, either orientation)."""
    return requantize(int8_matmul_acc_plain(lhs, rhs), scale)


def int8_matmul_requant(lhs, rhs, scale, orientation):
    """int8 lhs (M, K) @ rhs (K, N), requantized by `scale` ((M, 1) f32 for
    orientation "a", (1, N) for "b") -> int8 (M, N)."""
    if orientation not in ORIENTATIONS:
        raise ValueError("orientation must be 'a' or 'b' (got {!r})".format(orientation))
    if lhs.dim() != 2 or rhs.dim() != 2 or lhs.shape[1] != rhs.shape[0]:
        raise ValueError("lhs (M, K) and rhs (K, N) do not chain: {} @ {}".format(tuple(lhs.shape), tuple(rhs.shape)))
    scale_shape = (lhs.shape[0], 1) if orientation == "a" else (1, rhs.shape[1])
    if tuple(scale.shape) != scale_shape:
        raise ValueError("orientation {!r} takes a scale of shape {} (got {})".format(
            orientation, scale_shape, tuple(scale.shape)))
    if lhs.device.type == "cpu":
        return int8_matmul_requant_plain(lhs, rhs, scale)
    kernels.check_cuda(lhs, "lhs", torch.int8)
    kernels.check_cuda(rhs, "rhs", torch.int8)
    kernels.check_cuda(scale, "scale", torch.float32)
    (m, k), n = lhs.shape, rhs.shape[1]
    if k % 16 or n % 16:
        raise ValueError("the int8 matmul needs K and N that are multiples of 16 (got K {}, N {})".format(k, n))
    slab, stages, grid = plan(orientation, m, n, k, _sm_count(lhs.device.index))
    out = torch.empty((m, n), dtype=torch.int8, device=lhs.device)
    if m == 0 or n == 0:
        return out
    p = kernels.ptr
    kernels.launch("rs_int8_mm", p(lhs), p(rhs), p(scale), p(out), m, n, k, ORIENTATIONS[orientation], slab, stages,
                   grid)
    int8_matmul_requant.launches += 1
    return out


int8_matmul_requant.launches = 0


def quantize_act_plain(x, scale, r=1):
    """The int8 activations of x at the static `scale` (any device), for
    r > 1 in their r x r space-to-depth."""
    xq = _quantize_act(x, scale)
    return space_to_depth(xq, r) if r > 1 else xq


def _check_quantize(x, r):
    if x.shape[-1] % 16:
        raise ValueError("the quantize kernel needs a channel count that is a multiple of 16 (got {})".format(
            x.shape[-1]))
    if r > 1 and (x.dim() != 4 or x.shape[1] % r or x.shape[2] % r):
        raise ValueError("a space-to-depth by {} needs (N, H, W, C) with sides that divide (got {})".format(
            r, tuple(x.shape)))


def quantize_act(x, scale, r=1):
    """bf16 activations (..., C) -> int8 of the same shape, quantized with
    the host-f32 reciprocal of `scale`; with r > 1, x (N, H, W, C) -> (N,
    H/r, W/r, r r C), the r x r space-to-depth of the quantized values."""
    _check_quantize(x, r)
    if x.device.type == "cpu":
        return quantize_act_plain(x, scale, r)
    kernels.check_cuda(x, "x", torch.bfloat16)
    if r > 1:
        n, h, w, c = x.shape
        out_shape = (n, h // r, w // r, r * r * c)
    else:
        n, h, w, c = 1, 1, x.numel() // x.shape[-1], x.shape[-1]
        out_shape = tuple(x.shape)
    out = torch.empty(out_shape, dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    kernels.launch("rs_quantize_act", kernels.ptr(x), kernels.ptr(out), _act_inv(scale), n, h, w, c, r)
    quantize_act.launches += 1
    return out


quantize_act.launches = 0


def fma_f32(a, b, c):
    """a * b + c of float32 tensors rounded once to float32, as a fused
    multiply-add does: the product exact in float64, the sum rounded to odd
    in float64 (TwoSum's error moves an even result one ulp toward the exact
    sum), whose 53 bits round to float32 as the exact sum would."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def dequantize(acc, sc, b):
    """int32 accumulators (M, N) -> bf16: fma(f32(acc), sc, b) rounded
    once to f32, then to bf16."""
    return fma_f32(acc.float(), sc, b).to(torch.bfloat16)


def int8_matmul_dequant_plain(xq, wq, sc, b):
    """dequantize(xq @ wq, sc, b) of int8 (M, K) and (K, N) (any device)."""
    return dequantize(int8_matmul_acc_plain(xq, wq), sc, b)


def int8_matmul_dequant(xq, wq, sc, b):
    """int8 xq (M, K) @ wq (K, N) -> bf16 (M, N) = bf16(f32(acc) * sc + b)
    with sc and b f32 (N,): K2 in orientation b with its dequant epilogue on
    CUDA tensors, the plain version on CPU tensors."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError("xq (M, K) and wq (K, N) do not chain: {} @ {}".format(tuple(xq.shape), tuple(wq.shape)))
    (m, k), n = xq.shape, wq.shape[1]
    if tuple(sc.shape) != (n,) or b is None or tuple(b.shape) != (n,):
        raise ValueError("sc and b must be (N,) = ({},) vectors".format(n))
    if xq.device.type == "cpu":
        return int8_matmul_dequant_plain(xq, wq, sc, b)
    kernels.check_cuda(xq, "xq", torch.int8)
    kernels.check_cuda(wq, "wq", torch.int8)
    kernels.check_cuda(sc, "sc", torch.float32)
    kernels.check_cuda(b, "b", torch.float32)
    if k % 16 or n % 16:
        raise ValueError("the int8 matmul needs K and N that are multiples of 16 (got K {}, N {})".format(k, n))
    slab, stages, grid = plan("b", m, n, k, _sm_count(xq.device.index), "dequant")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=xq.device)
    if m == 0:
        return out
    p = kernels.ptr
    kernels.launch("rs_int8_mm_dequant", p(xq), p(wq), p(sc), p(b), p(out), m, n, k, slab, stages, grid)
    int8_matmul_dequant.launches += 1
    return out


int8_matmul_dequant.launches = 0


def _weight_2d(node):
    """A dense (K, N) or kernel = stride conv (r, r, C, N) int8 weight as
    the (K, N) operand of K2: the conv's rows in space-to-depth order."""
    wq = node["wq"]
    return wq.reshape(-1, wq.shape[-1])


def dense_operands(node, scale):
    """(2-D int8 weight, ws * s, bias) of a dense site, cached on its node
    for the last scale given: the tree is quantized once and every batch
    reuses them."""
    key = float(np.float32(scale))
    cached = node.get("dense")
    if cached is None or cached[0] != key:
        cached = node["dense"] = (key, _weight_2d(node).contiguous(), scaled_ws(node, scale).contiguous(),
                                  node["b"].float().contiguous())
    return cached[1:]


def int8_dense_plain(x, node, scale, r=1):
    """The dense site as separate plain ops (any device): quantize (with an
    r x r space-to-depth for an SR conv), the exact int32 product, the
    dequant epilogue -> bf16 (..., N), for r > 1 (N, H/r, W/r, N)."""
    xq = quantize_act_plain(x, scale, r)
    wq = _weight_2d(node)
    y = int8_matmul_dequant_plain(xq.reshape(-1, xq.shape[-1]), wq, scaled_ws(node, scale), node["b"].float())
    return y.reshape(tuple(xq.shape[:-1]) + (wq.shape[1],))


def int8_dense(x, node, scale, r=1):
    """An int8 dense site on bf16 x (..., K) with the quantized tree entry
    `node` ({"wq": (K, N) int8, or (r, r, C, N) for a kernel = stride = r
    conv, "ws": (N,) f32, "b": (N,) f32}) at the site's static activation scale ->
    bf16 (..., N): the quantize kernel, then K2's dequant epilogue, on CUDA
    tensors; `int8_dense_plain` on CPU tensors."""
    _check_quantize(x, r)
    if x.device.type == "cpu":
        return int8_dense_plain(x, node, scale, r)
    wq, sc, b = dense_operands(node, scale)
    xq = quantize_act(x, scale, r)
    if xq.shape[-1] != wq.shape[0]:
        raise ValueError("the site's weight takes {} input channels (got {})".format(wq.shape[0], xq.shape[-1]))
    y = int8_matmul_dequant(xq.reshape(-1, xq.shape[-1]), wq, sc, b)
    return y.reshape(tuple(xq.shape[:-1]) + (wq.shape[1],))
