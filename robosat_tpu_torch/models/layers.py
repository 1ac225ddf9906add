"""Layer helpers and weight rewrites of the U-Net (NHWC, HWIO), and the
bilinear resize of DeepLab and SegFormer.

Counterpart of robosat_tpu/models/layers.py, limited to what the U-Net's
training forward, the int8 predict walk and its float calibration need,
plus jax.image.resize's bilinear mode (`_resize_bilinear`), which the JAX
package's deeplab.py and segformer.py call. Activations stay NHWC and conv
kernels HWIO at every public function; the convs and the batch norm run
through torch's NCHW operators on permuted views (channels-last in
memory).

Two contexts switch layers onto a mesh of ranks (parallel/mesh.py's
`Mesh`, or any object with its `size`, `sum` and `halo`) for a forward:

- `sync_batch_norm(mesh)`: `bn_apply` in training mode takes its
  statistics over the global batch (the JAX package's pjit semantics), by
  an all-reduce that the backward pass all-reduces too;
- `height_sharded(mesh)`: `conv_nhwc`, `max_pool` and `upsample_conv_k4`
  take their halo rows from the neighbouring ranks (`Mesh.halo`), the
  exchange GSPMD inserts for the JAX package's height-sharded predict step.
"""

import contextlib
import contextvars

import numpy as np
import torch
import torch.nn.functional as F

_SYNC_BN = contextvars.ContextVar("sync_bn_mesh", default=None)
_HEIGHT_SHARDS = contextvars.ContextVar("height_shards_mesh", default=None)


@contextlib.contextmanager
def _using(var, mesh):
    token = var.set(mesh)
    try:
        yield
    finally:
        var.reset(token)


def sync_batch_norm(mesh):
    """Context: training-mode batch norm over the global batch of `mesh`
    (None: the local batch)."""
    return _using(_SYNC_BN, mesh)


def height_sharded(mesh):
    """Context: convolutions, max pools and transposed convolutions on a
    raster split by height over `mesh`'s ranks exchange halo rows."""
    return _using(_HEIGHT_SHARDS, mesh)


def _same_pads(size, k, stride, dilation):
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x, w, stride=1, padding="SAME", dilation=1, groups=1):
    """XLA-style conv: x (N, H, W, Cin), w (KH, KW, Cin / groups, Cout);
    `padding` is "SAME" or ((top, bottom), (left, right)); `groups` is
    feature_group_count (Cin for a depthwise conv). Runs in x's dtype.

    Under `height_sharded`, x is this rank's rows of a raster split by
    height: SAME pads come from the raster's height, and the rows the
    kernel reads across the split are the neighbours' (zeros past the
    raster's edges), so each rank computes its rows of the whole conv."""
    kh, kw = w.shape[0], w.shape[1]
    shards = _HEIGHT_SHARDS.get()
    if padding == "SAME":
        rows = x.shape[1] * (shards.size if shards is not None else 1)
        padding = (_same_pads(rows, kh, stride, dilation), _same_pads(x.shape[2], kw, stride, dilation))
    (pt, pb), (pl, pr) = padding
    if shards is not None:
        x, h_out = _halo_rows(shards, x, kh, stride, dilation, pt, pb, 0.0)
        pt = pb = 0
    xc = x.permute(0, 3, 1, 2)
    wc = w.to(x.dtype).permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        y = F.conv2d(xc, wc, stride=stride, padding=(pt, pl), dilation=dilation, groups=groups)
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), wc, stride=stride, dilation=dilation, groups=groups)
    if shards is not None:
        y = y[:, :, :h_out]
    return y.permute(0, 2, 3, 1).contiguous()


def _halo_rows(shards, x, k, stride, dilation, pt, pb, fill):
    """A window op's input rows on one rank of a height split: x extended
    by the rows its output rows read above and below (`Mesh.halo`, `fill`
    past the raster's edges), and that output's row count. Output row o of
    the whole raster reads rows o * stride - pt + i * dilation, i < k; a
    rank's share of the output is an equal split, so its rows start at its
    first input row over the stride."""
    h = x.shape[1]
    rows = h * shards.size
    out_rows = (rows + pt + pb - (k - 1) * dilation - 1) // stride + 1
    if out_rows * stride != rows or out_rows % shards.size:
        raise ValueError("a height split needs each rank's rows to map to whole output rows "
                         "({} rows, kernel {}, stride {}, pads {}/{})".format(rows, k, stride, pt, pb))
    h_out = out_rows // shards.size
    bottom = max((h_out - 1) * stride - pt + (k - 1) * dilation + 1 - h, 0)
    return shards.halo(x, pt, bottom, fill), h_out


def bn_apply(params, state, x, train, momentum=0.1, eps=1e-5):
    """Batch normalization of NHWC `x` over (N, H, W); returns (y in x's
    dtype, new state).

    In training mode the statistics are the batch's, in float32, with the
    biased variance both in the normalization and in the running update
    (the JAX package's `bn_apply`). F.batch_norm computes them once and
    updates copies of the running statistics; its running variance takes
    the unbiased variance, so the batch's share of that update is scaled
    back by (n - 1) / n. Under `sync_batch_norm` the statistics are
    the global batch's (`_bn_global`). In eval mode the running statistics
    normalize and the state passes through.
    """
    xc = x.permute(0, 3, 1, 2)
    if not train:
        y = F.batch_norm(xc, state["mean"], state["var"], params["scale"], params["bias"], training=False, eps=eps)
        return y.permute(0, 2, 3, 1), state
    shards = _SYNC_BN.get()
    if shards is not None:
        return _bn_global(shards, params, state, x, momentum, eps)
    n = x.numel() // x.shape[-1]
    mean, var = state["mean"].clone(), state["var"].clone()
    y = F.batch_norm(xc, mean, var, params["scale"], params["bias"], training=True, momentum=momentum, eps=eps)
    kept = (1 - momentum) * state["var"]
    return y.permute(0, 2, 3, 1), {"mean": mean, "var": kept + (var - kept) * ((n - 1) / n)}


def _bn_global(shards, params, state, x, momentum, eps):
    """Training-mode batch norm over the global batch of the ranks of
    `shards` (every rank holds as many rows): the per-channel mean, then
    the biased variance about it, each a float32 sum over (N, H, W)
    all-reduced with its gradient, so the backward pass reduces too. The
    normalization and the running update are the JAX package's:
    (x - mean) * (rsqrt(var + eps) * scale) + bias, in float32."""
    xf = x.float()
    n = xf.numel() // xf.shape[-1] * shards.size
    mean = shards.sum(xf.sum(dim=(0, 1, 2))) / n
    centered = xf - mean
    var = shards.sum((centered * centered).sum(dim=(0, 1, 2))) / n
    y = centered * (torch.rsqrt(var + eps) * params["scale"]) + params["bias"]
    new_state = {"mean": (1 - momentum) * state["mean"] + momentum * mean.detach(),
                 "var": (1 - momentum) * state["var"] + momentum * var.detach()}
    return y.to(x.dtype), new_state


def fold_conv_bn(conv_params, bn_params, bn_state, eps=1e-5):
    """Fold an inference-mode batch norm into the preceding conv:
    W' = W * scale / sqrt(var + eps), b' = bias - mean * scale / sqrt(..)."""
    inv = bn_params["scale"] * torch.rsqrt(bn_state["var"].float() + eps)
    w = conv_params["w"] * inv
    b = bn_params["bias"] - bn_state["mean"] * inv
    return {"w": w.float(), "b": b.float()}


def conv_bias_apply(params, x, stride=1, padding="SAME", dilation=1):
    return conv_nhwc(x, params["w"], stride=stride, padding=padding, dilation=dilation) + params["b"].to(x.dtype)


def _resize_weights(size_in, size_out, dtype, device):
    """jax.image.resize's bilinear weight matrix (size_in, size_out) of one
    axis (jax/_src/image/scale.py compute_weight_mat, antialiased, no
    translation), built in float32 as it is: half-pixel sample positions,
    the triangle kernel (scaled by the inverse scale when downsampling),
    each column normalized by its sum, zeros where the sample falls outside
    the input; then cast to `dtype`."""
    inv_scale = float(np.float32(1.0 / (size_out / size_in)))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(size_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(size_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = torch.clamp_min(1.0 - dist, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device=device, dtype=dtype)


def _resize_bilinear(x, h, w):
    """NHWC x resized to (h, w) as jax.image.resize(method="bilinear")
    computes it: one weight matrix per resized axis (`_resize_weights`, in
    x's dtype), contracted rows first, then columns, each contraction a
    float32 product of x's values rounded to x's dtype (the einsum of the
    JAX package: in bf16 the rows' result is rounded to bf16 before the
    columns' contraction). An axis that keeps its size is left alone."""
    n, hi, wi, c = x.shape
    out = x
    if hi != h:
        wm = _resize_weights(hi, h, x.dtype, x.device).float()
        out = torch.einsum("nhwc,hH->nHwc", out.float(), wm).to(x.dtype)
    if wi != w:
        wm = _resize_weights(wi, w, x.dtype, x.device).float()
        out = torch.einsum("nhwc,wW->nhWc", out.float(), wm).to(x.dtype)
    return out


def max_pool(x, window, stride, padding):
    """Max pooling of NHWC `x`; `padding` is applied symmetrically (-inf).
    Under `height_sharded` the rows across the split are the
    neighbours' (-inf past the raster's edges)."""
    shards = _HEIGHT_SHARDS.get()
    if shards is None:
        y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
        return y.permute(0, 2, 3, 1).contiguous()
    x, h_out = _halo_rows(shards, x, window, stride, 1, padding, padding, float("-inf"))
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, (0, padding))
    return y[:, :, :h_out].permute(0, 2, 3, 1).contiguous()


_K4_SETS = ((0,), (0, 1), (1, 2), (2,))


def fused_k4(w3):
    """The 4x4 parity-combined kernel of nearest-2x upsample + 3x3 conv:
    rows and columns [W0, W0+W1, W1+W2, W2] (summed in the JAX package's
    order, so the float32 sums are bit-equal)."""
    return torch.stack(
        [torch.stack([sum(w3[r, c] for r in rows for c in cols) for cols in _K4_SETS]) for rows in _K4_SETS]
    )


def fused_upsample_conv3x3(params, x):
    """Nearest-2x upsample + 3x3 SAME conv as one transposed conv with the
    4x4 parity-combined kernel."""
    return upsample_conv_k4(fused_k4(params["w"]), x)


def upsample_conv_k4(k4, x):
    """The JAX package's lhs-dilated conv (dilation 2, padding 2) of x with
    the 4x4 kernel `k4` (HWIO, cast to x's dtype), as the transposed conv
    of its flipped kernel.

    Under `height_sharded`: output row o reads input rows (o + 1 - t) / 2
    for the taps t, so a rank's 2h output rows read one row on either side
    of its h. With those rows (zeros past the raster's edges) the
    transposed conv gives 2h + 6 rows, the rank's rows 3 below the top:
    padding 3 crops them, where padding 1 crops the whole raster's."""
    wt = k4.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)  # (Cin, Cout, 4, 4)
    shards = _HEIGHT_SHARDS.get()
    pad_h = 1
    if shards is not None:
        x, pad_h = shards.halo(x, 1, 1, 0.0), 3
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=2, padding=(pad_h, 1))
    return y.permute(0, 2, 3, 1).contiguous()


# Row/col tap maps of upsample + conv3x3 on the space-to-depth grid: for
# output parity d and coarse offset a, the fine conv taps landing there.
_UPS_TAPS = {
    0: {-1: (0,), 0: (1, 2), 1: ()},
    1: {-1: (), 0: (0, 1), 1: (2,)},
}


def s2d_up_conv3x3_kernel(w3):
    """(3, 3, Cin, Cout) -> (3, 3, Cin, 4 Cout): nearest-2x upsample + 3x3
    SAME conv emitting parity-blocked space-to-depth output."""
    kh, kw, cin, cout = w3.shape
    assert kh == 3 and kw == 3
    blocks = []
    for di in (0, 1):
        for dj in (0, 1):
            rows = []
            for a in (-1, 0, 1):
                cols = []
                for b in (-1, 0, 1):
                    taps = [w3[t, s] for t in _UPS_TAPS[di][a] for s in _UPS_TAPS[dj][b]]
                    cols.append(sum(taps) if taps else torch.zeros((cin, cout), dtype=w3.dtype, device=w3.device))
                rows.append(torch.stack(cols))
            blocks.append(torch.stack(rows))
    return torch.cat(blocks, dim=-1)


def s2d_conv3x3_kernel(w3):
    """(3, 3, Cin, Cout) -> (3, 3, 4 Cin, 4 Cout): a fine-grid 3x3 SAME conv
    on the space-to-depth grid, parity-blocked on both sides."""
    kh, kw, cin, cout = w3.shape
    assert kh == 3 and kw == 3
    k = torch.zeros((3, 3, 4 * cin, 4 * cout), dtype=w3.dtype, device=w3.device)
    for di in (0, 1):
        for dj in (0, 1):
            for t in range(3):
                for s in range(3):
                    a, ei = (di + t - 1) // 2, (di + t - 1) % 2
                    b, ej = (dj + s - 1) // 2, (dj + s - 1) % 2
                    k[a + 1, b + 1, (2 * ei + ej) * cin : (2 * ei + ej + 1) * cin,
                      (2 * di + dj) * cout : (2 * di + dj + 1) * cout] = w3[t, s]
    return k


def space_to_depth4(x):
    """(N, 4H, 4W, C) -> (N, H, W, 16C), slot (er, ec) channel-minor:
    channel (er * 4 + ec) * C + c. Works on numpy arrays and tensors."""
    n, h4, w4, c = x.shape
    x = x.reshape(n, h4 // 4, 4, w4 // 4, 4, c)
    if isinstance(x, np.ndarray):
        return np.ascontiguousarray(x.transpose(0, 1, 3, 2, 4, 5)).reshape(n, h4 // 4, w4 // 4, 16 * c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h4 // 4, w4 // 4, 16 * c)


def stem_s2d4_kernel(w7):
    """7x7/stride-2 stem kernel (7, 7, Cin, Cout) -> its 4x4 space-to-depth
    form (3, 3, 16 Cin, 4 Cout): a 3x3 SAME conv on the blocked grid that
    emits the four stride-2 output parities p = 2 fi + fj."""
    kh, kw, cin, cout = w7.shape
    assert kh == 7 and kw == 7, "rewrite is specific to the 7x7 stem"
    w7p = F.pad(w7, (0, 0, 0, 0, 0, 1, 0, 1))  # taps padded to 8x8: index 7 reads zeros
    blocks = []
    for fi in (0, 1):
        for fj in (0, 1):
            t_map = np.full((3, 3, 16), 7)
            s_map = np.full((3, 3, 16), 7)
            for ai, a in enumerate((-1, 0, 1)):
                for bi, b in enumerate((-1, 0, 1)):
                    for er in range(4):
                        for ec in range(4):
                            t = 4 * a + er + 3 - 2 * fi
                            s = 4 * b + ec + 3 - 2 * fj
                            if 0 <= t <= 6 and 0 <= s <= 6:
                                t_map[ai, bi, er * 4 + ec] = t
                                s_map[ai, bi, er * 4 + ec] = s
            blocks.append(w7p[torch.from_numpy(t_map), torch.from_numpy(s_map)].reshape(3, 3, 16 * cin, cout))
    return torch.cat(blocks, dim=-1)


def pool3s2_from_parity(x, cout):
    """3x3/stride-2/pad-1 max pool of a fine grid held as 2x2 parity blocks
    (N, H, W, 4 cout) -> pooled (N, H, W, cout)."""
    p = [x[..., k * cout : (k + 1) * cout] for k in range(4)]

    def up(t):
        return F.pad(t, (0, 0, 0, 0, 1, 0), value=float("-inf"))[:, :-1]

    def left(t):
        return F.pad(t, (0, 0, 1, 0), value=float("-inf"))[:, :, :-1]

    out = None
    for fi, row_shift in ((1, True), (0, False), (1, False)):
        for fj, col_shift in ((1, True), (0, False), (1, False)):
            t = p[fi * 2 + fj]
            if row_shift:
                t = up(t)
            if col_shift:
                t = left(t)
            out = t if out is None else torch.maximum(out, t)
    return out.contiguous()


def space_to_depth(x, r):
    """(N, H, W, C) -> (N, H/r, W/r, r r C), slot (er, ec) channel-minor:
    channel (er r + ec) C + c holds pixel (r i + er, r j + ec) (the layout
    of space_to_depth2 and space_to_depth4 at any r; SegFormer's
    spatial-reduction convs as denses)."""
    n, h, w, c = x.shape
    return x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r, r * r * c)


def space_to_depth2(x):
    """(N, 2H, 2W, C) -> (N, H, W, 4C), parity-blocked (p = 2 di + dj)."""
    n, h2, w2, c = x.shape
    return x.reshape(n, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h2 // 2, w2 // 2, 4 * c)


def depth_to_space2(x):
    """(N, H, W, 4C) -> (N, 2H, 2W, C), inverse of space_to_depth2. Works on
    numpy arrays and tensors."""
    n, h, w, c4 = x.shape
    x = x.reshape(n, h, w, 2, 2, c4 // 4)
    x = x.transpose(0, 1, 3, 2, 4, 5) if isinstance(x, np.ndarray) else x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c4 // 4)
