"""The head-stage rungs on dec5 activations: CUDA kernel K10 and its plain versions.

Counterpart of the Pallas rung kernels of benchmarks/bisect_mosaic_head.py
(RUNG_SRC): prefixes of K6's head stage on bf16 activations
(N, H, W, 128), with per-channel margin weights wm (1, 128) and per-parity
biases bm (1, 4), f32:

    base      x                                       bf16 (N, H, W, 128)
    mul       bf16(f32(x) * wm)                       bf16 (N, H, W, 128)
    reduce    margins: group g's 32 products + bm[g]  f32  (N, H, W, 4)
    sigmoid   sigmoid(margins)                        f32  (N, H, W, 4)
    digitize  the exact 256-bin digitize              uint8 (N, H, W, 4)
    merge     the digitize bytes as (N, H, 4W)        uint8

The four rungs whose names end in "_mm" (reduce_mm, sigmoid_mm,
digitize_mm, merge_mm) compute the same function with the margins summed
as XLA:CPU sums the TPU kernel's one-hot matmul. digitize_mm_pad8 and
digitize_mm_pad4 do not end in "_mm", so the TPU kernel sums them as the
reshape-sum: they are digitize with the Mosaic lane padding of their
outputs changed. Every rung here returns only the meaningful lanes: the
128-, 8- and 4-lane padding of the TPU rungs was a Mosaic workaround.

The margins sum in the order XLA:CPU compiles each TPU form to (fitted in
tests/test_torch_port_head_rungs.py), so the plain versions and the kernel
give the same margins bit for bit:

- reshape-sum: the multiply fused into the reduction, sequentially in
  channel order, one fused multiply-add per channel from 0 (`_fma`);
- one-hot matmul: each product rounded to f32, then four accumulators,
  channel c into c % 4, combined as (a0 + a1) + (a2 + a3).

The plain sigmoid is torch's and the plain digitize the port's IEEE one
(ops/head.py); the kernel's sigmoid is head.cuh's 1 / (1 + expf(-m)). They
may differ in the last ulps, which can move a probability across a 1/255
bin edge: a counted +-1 flip.

`head_rung(x, wm, bm, rung)` launches csrc/head_rungs.cu on a CUDA tensor
and runs `head_rung_plain` on a CPU tensor.
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.ops.head import _digitize_exact, _to_u8

RUNGS = ("base", "mul", "reduce", "sigmoid", "digitize", "merge",
         "reduce_mm", "sigmoid_mm", "digitize_mm", "merge_mm", "digitize_mm_pad8", "digitize_mm_pad4")
CHANNELS = 128

# A rung's name without "_mm..." -> the kernel's stage (csrc/head_rungs.cu).
_STAGES = {"base": 0, "mul": 1, "reduce": 2, "sigmoid": 3, "digitize": 4, "merge": 4}


def _rung(rung):
    """(stage, mm, merge) of a rung name."""
    if rung not in RUNGS:
        raise ValueError("unknown rung {!r} (one of {})".format(rung, ", ".join(RUNGS)))
    base = rung.split("_")[0]
    return _STAGES[base], rung.endswith("_mm"), base == "merge"


def _fma(a, b, c):
    """f32(a * b + c) rounded once, for f32 tensors whose product is exact in
    float64 (a holds bf16 values): the float64 sum rounded to odd, so the
    rounding to f32 cannot round twice."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)  # the float64 sum's rounding error (TwoSum)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).float()


def margins_plain(x, wm, bm, mm=False):
    """The f32 margins (N, H, W, 4) of bf16 activations (N, H, W, 128), in
    the reshape-sum's order or (mm) the one-hot matmul's."""
    f = x.float().reshape(*x.shape[:3], 4, 32)
    w = wm.reshape(4, 32).float()
    if mm:
        p = f * w
        acc = [torch.zeros(f.shape[:-1], dtype=torch.float32, device=x.device) for _ in range(4)]
        for c in range(32):
            acc[c % 4] = acc[c % 4] + p[..., c]
        m = (acc[0] + acc[1]) + (acc[2] + acc[3])
    else:
        m = torch.zeros(f.shape[:-1], dtype=torch.float32, device=x.device)
        for c in range(32):
            m = _fma(f[..., c], w[:, c], m)
    return m + bm.reshape(4).float()


def head_rung_plain(x, wm, bm, rung):
    """Rung `rung` of bf16 activations (N, H, W, 128) (any device)."""
    stage, mm, merge = _rung(rung)
    if stage == 0:
        return x.clone()
    if stage == 1:
        return (x.float() * wm.reshape(CHANNELS).float()).to(torch.bfloat16)
    m = margins_plain(x, wm, bm, mm)
    if stage == 2:
        return m
    p = torch.sigmoid(m)
    if stage == 3:
        return p
    q = _to_u8(_digitize_exact(p))
    return q.reshape(q.shape[0], q.shape[1], -1) if merge else q


def head_rung(x, wm, bm, rung):
    """Rung `rung` of bf16 activations (N, H, W, 128), wm (1, 128) and bm
    (1, 4) f32; output shapes in the module docstring."""
    stage, mm, merge = _rung(rung)
    if x.dim() != 4 or x.shape[-1] != CHANNELS:
        raise ValueError("x must be (N, H, W, {}) (got {})".format(CHANNELS, tuple(x.shape)))
    if wm.numel() != CHANNELS or bm.numel() != 4:
        raise ValueError("wm must hold {} and bm 4 values".format(CHANNELS))
    if x.device.type == "cpu":
        return head_rung_plain(x, wm, bm, rung)
    kernels.check_cuda(x, "x", torch.bfloat16)
    wm = kernels.check_cuda(wm.reshape(CHANNELS).contiguous(), "wm", torch.float32)
    bm = kernels.check_cuda(bm.reshape(4).contiguous(), "bm", torch.float32)
    n, h, w, _ = x.shape
    if stage <= 1:
        out = torch.empty_like(x)
    else:
        out = torch.empty((n, h, w, 4), dtype=torch.uint8 if stage == 4 else torch.float32, device=x.device)
    p = kernels.ptr
    kernels.launch("rs_head_rung", p(x), p(wm), p(bm), p(out), n, h, w, stage, int(mm))
    head_rung.launches += 1
    return out.view(n, h, 4 * w) if merge else out


head_rung.launches = 0
