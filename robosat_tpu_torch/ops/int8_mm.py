"""int8 matmul with a fused requantize epilogue: CUDA kernel K2 and its plain version.

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
"""

import functools

import torch

from robosat_tpu_torch import kernels

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
# of weights (rows of K rounded up to 64, + 16 bytes), their f32 scales, its
# consumer warps' staged output tiles and a ring of stages of 64 K bytes x the P
# tile, after three mbarriers per stage; each piece starts on 128 bytes.
SMEM_LIMIT = 232448  # dynamic shared memory one block may have on the H100 (227 KB)
SLABS = (64, 128, 256)
MIN_STAGES = 3
RING_BYTES = 65536  # the ring's depth: as many stages as fit in this many bytes
K_CHUNK = 64


def tile_p(slab):
    """Columns of P (the streamed dimension) per tile for a weight slab."""
    return {64: 256, 128: 128, 256: 64}[slab]


def staged_bytes(slab):
    """Shared memory of the consumer warps' staged output tiles: 8 warps of
    32 x 64, rows padded by 32 bytes; at slabs of 256, 16 warps of 32 x 32."""
    return 16 * 32 * 32 if slab == 256 else 8 * 32 * (64 + 32)


def smem_bytes(orientation, slab, k, stages):
    """Dynamic shared memory of one block of csrc/int8_mm.cu (its `plan`)."""
    def align(x):
        return (x + 127) // 128 * 128

    row_w = -(-k // K_CHUNK) * K_CHUNK + 16
    w = align(align(24 * stages) + 4 * slab)
    return align(align(w + slab * row_w) + staged_bytes(slab)) + stages * K_CHUNK * tile_p(slab)


@functools.lru_cache(maxsize=None)
def plan(orientation, m, n, k, sms):
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
                       if smem_bytes(orientation, slab, k, st) <= SMEM_LIMIT), None)
        if stages is not None:
            slabs = -(-cout // slab)
            walkers = max(1, min(-(-p // tile_p(slab)), sms // slabs))
            return slab, stages, slabs * walkers
    raise ValueError("the int8 matmul keeps a slab of at least {} output channels of weights in shared memory: "
                     "K = {} needs {} bytes with a ring of {} stages, over the {} a block may have".format(
                         SLABS[0], k, smem_bytes(orientation, SLABS[0], k, MIN_STAGES), MIN_STAGES, SMEM_LIMIT))


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
