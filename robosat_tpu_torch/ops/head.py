"""Prediction heads: margin, sigmoid, exact 256-bin digitize, crop; CUDA kernel K1.

Counterpart of robosat_tpu/ops/head.py. For a binary model the softmax
foreground probability is sigmoid(l1 - l0), so the final 1x1 conv collapses
to a margin dot with w[:, 1] - w[:, 0]. The heads differ only in layout:

- `fused_prediction_head`: fine-grid features (N, H, W, 32) -> fine uint8
  (N, H - 2o, W - 2o);
- `fused_prediction_head_s2d_blocked`: parity-blocked (N, H, W, 4 * 32) ->
  blocked uint8 (N, H - o, W - o, 4), cropped by o/2 on the blocked grid;
- `fused_prediction_head_s2d`: the same margin, then the depth-to-space and
  the fine crop -> (N, 2H - 2o, 2W - 2o);
- `fused_prediction_head_s2d_blocked_sep`: doubly-blocked (N, H, W, 16 * 32)
  -> (N, H - o/2, W - o/2, 16), channel p288 * 4 + p576, cropped by o/4;
- `fused_prediction_head_subpixel` (the fast family's head, no kernel):
  coarse features (N, h, w, 128) and 16 margin vectors -> (N, h - o/2,
  w - o/2, 16) in the "sep" channel layout; `interleave_subpixel_u8` gives
  its fine grid.

These are plain PyTorch (any device); their margins sum in the order XLA
compiles the JAX package's heads to (`_margin`), so their bins equal the
JAX package's. `margin_head(features, w, b, overlap, groups)` is kernel K1
(csrc/head.cu) behind all four: G groups of 32 channels per pixel, G = 1,
4 or 16 for the three layouts, through the operator
`torch.ops.robosat.margin_head` (`torch.library.custom_op`), which a
torch.export program keeps as one node: a loaded `.pt2` needs this module
imported first. On a CUDA tensor the operator launches the kernel, which
sums in the same order; on a CPU tensor it runs the plain head of its
layout. The kernel's expf and torch's sigmoid may differ in the last
ulp, which can move a probability across a 1/255 bin edge: a counted +-1
flip. `pallas_prediction_head` is the G = 1 call with the JAX signature.
"""

import torch

from robosat_tpu_torch import kernels
from robosat_tpu_torch.models.layers import _resize_bilinear, depth_to_space2

# Features' grid per group count: the crop divisor of the fine overlap.
_CROP_DIVISOR = {1: 1, 4: 2, 16: 4}


def _digitize_exact(p):
    """np.digitize(p, linspace(0, 1, 256)) for float32 p in [0, 1] as int32:
    k = rint(p * 255), then three exact comparisons against the anchors
    (k + off) / 255 with IEEE division. The caller's uint8 cast wraps the
    p == 1.0 index 256 to 0 (the reference's quirk)."""
    k = torch.round(p * 255.0)
    # Divide by a tensor, not a Python scalar: CUDA turns division by a host
    # scalar into multiplication by its reciprocal, which is not IEEE `/`.
    denom = torch.tensor(255.0, dtype=torch.float32, device=p.device)
    q = k.to(torch.int32) - 1
    for off in (-1.0, 0.0, 1.0):
        q = q + ((k + off) / denom <= p).to(torch.int32)
    return q


def _to_u8(q):
    """int32 -> uint8 with the modular wrap of the JAX package's cast."""
    return (q & 0xFF).to(torch.uint8)


def _margin_weights(w, b, cin):
    """(wm, bm): the f32 margin weights w[:, 1] - w[:, 0] and bias b1 - b0."""
    w2 = w.reshape(cin, -1)
    assert w2.shape[1] == 2, "fused head requires a binary model"
    b2 = b.reshape(2)
    return (w2[:, 1] - w2[:, 0]).float(), (b2[1] - b2[0]).float()


def _crop(x, o):
    return x[:, o:-o, o:-o] if o else x


def _margin(features, w, b, groups, o):
    """The f32 margins (N, H - 2o, W - 2o, groups) of `groups` blocks of C
    channels, after a crop of `o` on the features' grid, summed in the order
    XLA:CPU compiles the JAX package's heads to:

    - one group (jnp.sum of the products): sequentially in channel order,
      each product and sum rounded on its own;
    - blocked (the block-diagonal einsum): four accumulators, channel c
      into c % 4 by fused multiply-add, then (a0 + a1) + (a2 + a3). The FMA
      is taken in float64, where the f32 product is exact; the sum's double
      rounding could differ from one FMA's with probability ~2**-29.
    """
    cin = features.shape[-1] // groups
    wm, bm = _margin_weights(w, b, cin)
    f = _crop(features, o).float()
    f = f.reshape(*f.shape[:3], groups, cin)
    if groups == 1:
        m = f[..., 0] * wm[0]
        for c in range(1, cin):
            m = m + f[..., c] * wm[c]
    else:
        w64 = wm.double().tolist()
        acc = [torch.zeros(f.shape[:-1], dtype=torch.float32, device=f.device) for _ in range(4)]
        for c in range(cin):
            acc[c % 4] = (acc[c % 4].double() + f[..., c].double() * w64[c]).float()
        m = (acc[0] + acc[1]) + (acc[2] + acc[3])
    return m + bm


def _blocked_head(features, w, b, groups, o):
    """Margin over `groups` blocks of C channels, after a crop of `o` on the
    features' grid -> (N, H - 2o, W - 2o, groups) uint8."""
    return _to_u8(_digitize_exact(torch.sigmoid(_margin(features, w, b, groups, o))))


def fused_prediction_head(features, w, b, overlap=0):
    """Decoder features (N, H, W, C) -> quantized fg uint8 (N, H - 2o, W - 2o)."""
    return _blocked_head(features, w, b, 1, overlap)[..., 0]


def fused_prediction_head_s2d_blocked(features, w, b, overlap=0):
    """Parity-blocked decoder features (N, H, W, 4C) -> blocked quantized
    foreground (N, H - overlap, W - overlap, 4) uint8, cropped by overlap/2
    on the blocked grid before the margin."""
    assert overlap % 2 == 0, "blocked head crops on the coarse grid"
    return _blocked_head(features, w, b, 4, overlap // 2)


def fine_from_blocked(q, overlap=0):
    """Blocked uint8 (N, H, W, 4) -> fine (N, 2H - 2 overlap, 2W - 2 overlap):
    the depth-to-space, then the fine crop (any overlap)."""
    return _crop(depth_to_space2(q)[..., 0], overlap)


def fused_prediction_head_s2d(features, w, b, overlap=0):
    """Parity-blocked features (N, H, W, 4C) -> fine uint8 (N, 2H - 2o, 2W - 2o)."""
    return fine_from_blocked(_blocked_head(features, w, b, 4, 0), overlap)


def fused_prediction_head_s2d_blocked_sep(features, w, b, overlap=0):
    """Doubly-blocked features (N, H, W, 16C), channel p288 * 4C + p576 * C
    + c -> (N, H - overlap/2, W - overlap/2, 16) uint8, channel
    p288 * 4 + p576, cropped by overlap/4 before the margin."""
    assert overlap % 4 == 0, "doubly-blocked head crops on the coarse-coarse grid"
    return _blocked_head(features, w, b, 16, overlap // 4)


def fused_prediction_head_subpixel(features, w, b, overlap=0, block=4):
    """The fast family's learned sub-pixel head on coarse features
    (N, h, w, C) -> (N, h - 2o, w - 2o, block^2) uint8 with o = overlap /
    block, channel = sub-pixel position: per position the margin of the
    head's two classes (w's channel position * 2 + class) as one float32
    (C, block^2) matrix product (TF32 off: device.configure_device), the
    sigmoid and the exact digitize. The JAX package computes it in XLA too;
    K1 does not serve it (one margin weight vector per group there, 16 over
    the same channels here)."""
    n, h, w_, cin = features.shape
    p2 = block * block
    assert overlap % block == 0, "sub-pixel head crops on the coarse grid"
    w2 = w.reshape(cin, p2, 2)
    b2 = b.reshape(p2, 2)
    wm = (w2[:, :, 1] - w2[:, :, 0]).float()
    bm = (b2[:, 1] - b2[:, 0]).float()
    margin = torch.matmul(_crop(features, overlap // block).float(), wm) + bm
    return _to_u8(_digitize_exact(torch.sigmoid(margin)))


def interleave_subpixel_u8(blocked, block=4):
    """(N, h, w, block^2) uint8 -> fine (N, block h, block w): two nested
    2x2 parity levels (channel (2a + b) * 4 + 2u + v is fine pixel
    (4i + 2a + u, 4j + 2b + v)), what the PNG writer's two depth-to-space
    passes do on the host."""
    n, h, w, p2 = blocked.shape
    assert p2 == block * block == 16
    x = blocked.reshape(n, h, w, 2, 2, 2, 2).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(n, block * h, block * w)


_PLAIN = {1: fused_prediction_head, 4: fused_prediction_head_s2d_blocked, 16: fused_prediction_head_s2d_blocked_sep}


def resized_margin_head(final, feats, h, w, overlap=0):
    """DeepLab's and SegFormer's margin-then-resize head: the float32
    margin w1 - w0 of the features at their grid (summed in channel order,
    as XLA:CPU reduces the JAX package's jnp.sum), bilinear to (h, w), then
    the sigmoid, the 256-bin digitize and the crop -> uint8 (N, h - 2o,
    w - 2o). Equal to the softmax of the resized 2-class logits up to float
    rounding, since the resize is linear. No kernel: torch ops."""
    margin = _margin(feats, final["w"], final["b"], 1, 0)
    margin = _resize_bilinear(margin, h, w)[..., 0]
    return _crop(_to_u8(_digitize_exact(torch.sigmoid(margin))), overlap)


def margin_head_plain(features, w, b, overlap=0, groups=1):
    """The plain head of `groups`' layout (any device)."""
    return _PLAIN[groups](features, w, b, overlap=overlap)


def _out_shape(features, overlap, groups):
    """The margin head's output shape, checking the crop against the grid."""
    if overlap % _CROP_DIVISOR[groups]:
        raise ValueError("overlap {} does not crop whole pixels of the G = {} grid".format(overlap, groups))
    n, h, w_, _ = features.shape
    o = overlap // _CROP_DIVISOR[groups]
    if 2 * o >= min(h, w_):
        raise ValueError("overlap must be smaller than the grid")
    return (n, h - 2 * o, w_ - 2 * o) + ((groups,) if groups > 1 else ())


@torch.library.custom_op("robosat::margin_head", mutates_args=(), device_types="cpu")
def _margin_head_op(features: torch.Tensor, w: torch.Tensor, b: torch.Tensor, overlap: int,
                    groups: int) -> torch.Tensor:
    """K1 as an operator, so that a traced program (torch.export) keeps it
    as one node, `robosat.margin_head`. On the CPU it is the plain head of
    the layout; on the card the kernel launch below."""
    return margin_head_plain(features, w, b, overlap, groups).contiguous()


@_margin_head_op.register_kernel("cuda")
def _margin_head_cuda(features, w, b, overlap, groups):
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("features must be float32 or bfloat16 (got {})".format(features.dtype))
    kernels.check_cuda(features, "features", features.dtype)
    n, h, w_, c = features.shape
    if c != 32 * groups:
        raise ValueError("features must have 32 * groups = {} channels (got {})".format(32 * groups, c))
    shape = _out_shape(features, overlap, groups)
    wm, bm = _margin_weights(w, b, 32)
    wmb = kernels.check_cuda(torch.cat([wm, bm.reshape(1)]).contiguous(), "final", torch.float32, (33,))
    out = torch.empty(shape, dtype=torch.uint8, device=features.device)
    p = kernels.ptr
    kernels.launch("rs_margin_head", p(features), p(wmb), p(out), n, h, w_, groups,
                   overlap // _CROP_DIVISOR[groups], int(features.dtype == torch.bfloat16))
    margin_head.launches += 1
    return out


@_margin_head_op.register_fake
def _margin_head_fake(features, w, b, overlap, groups):
    return features.new_empty(_out_shape(features, overlap, groups), dtype=torch.uint8)


def margin_head(features, w, b, overlap=0, groups=1):
    """Margin head over `groups` blocks of 32 channels per pixel: features
    (N, H, W, 32 G) f32 or bf16 -> uint8 (N, H - 2c, W - 2c, G), squeezed
    to (N, H - 2c, W - 2c) for G = 1, with the crop c = overlap / (1, 2, 4)
    for G = (1, 4, 16) on the features' grid. Calls the operator
    `torch.ops.robosat.margin_head`: K1 on the card, the plain head on the
    CPU."""
    if groups not in _CROP_DIVISOR:
        raise ValueError("groups must be 1, 4 or 16 (got {})".format(groups))
    return torch.ops.robosat.margin_head(features, w, b, overlap, groups)


margin_head.launches = 0


def pallas_prediction_head(features, w, b, overlap=0):
    """K1 on fine-grid features (N, H, W, 32) -> (N, H - 2o, W - 2o) uint8."""
    return margin_head(features, w, b, overlap=overlap, groups=1)
