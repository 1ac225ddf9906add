"""The training step of the train cells, in plain PyTorch, for the reference.

One step on a uint8 batch and its masks: the flips and quarter turns drawn
from a torch.Generator (a horizontal flip with probability 0.5, then three
independent quarter turns with probability 0.5 each, robosat's training
transforms), the ImageNet normalization, the family's forward with batch
norm over the batch, the Lovasz hinge of each sample's C*H*W flattening
(Berman et al., arXiv:1705.08790; robosat/losses.py's LovaszLoss2d), its
mean over the samples, the backward, and Adam (Kingma and Ba, optax's
form: bias-corrected moments, eps outside the square root).

`Float32` computes in float32 with TF32 off, the reference. `Fp8` is the
control, the precision below the configured bf16: what the bf16 step
holds in bf16 (each conv's input, kernel and output, each batch norm's
output) rounded to float8 e4m3, and the gradients that reach them to e5m2,
each at a per-tensor scale to the format's range.
"""

import torch
import torch.nn.functional as F

from portbench.reference.layers import IMAGENET_MEAN, IMAGENET_STD, conv_nhwc, fused_k4, upsample_conv_k4


def flatten(tree, prefix=""):
    """[(path, leaf)] of a tree of dicts and lists, in sorted-key order (a
    tuple is a leaf)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten(tree[k], "{}{}{}".format(prefix, "/" if prefix else "",
                                                                                        k))]
    if isinstance(tree, list):
        return [item for i, v in enumerate(tree) for item in flatten(v, "{}/{}".format(prefix, i))]
    return [(prefix, tree)]


def batch_norm_train(x, params, eps=1e-5):
    """Batch norm of NHWC x over (N, H, W) with the batch's biased variance."""
    y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, params["scale"], params["bias"], training=True, eps=eps)
    return y.permute(0, 2, 3, 1)


class Float32:
    """Float32 convolutions and batch norm over the batch."""

    def conv(self, x, w, stride, padding, dilation):
        return conv_nhwc(x, w.float(), stride=stride, padding=padding, dilation=dilation)

    def up_conv(self, x, w3):
        """Nearest-2x upsample then a 3x3 SAME conv of kernel w3."""
        return upsample_conv_k4(fused_k4(w3.float()), x)

    def bn(self, x, params, state):
        return batch_norm_train(x, params)


def _round(t, dtype):
    """t rounded to float8 `dtype` at a per-tensor scale (its amax to the
    format's largest finite value), back in float32."""
    top = torch.finfo(dtype).max
    scale = torch.clamp_min(t.abs().amax(), 1e-30) / top
    return (t / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """Forward: the input rounded to e4m3. Backward: the incoming gradient
    rounded to e5m2, as float8 training keeps its gradients."""

    @staticmethod
    def forward(ctx, t):
        return _round(t.detach(), torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2)


class Fp8(Float32):
    """Float8 where the configured step keeps bf16: every conv's input,
    kernel and output and every batch norm's output in e4m3, the gradients
    that reach them in e5m2."""

    def conv(self, x, w, stride, padding, dilation):
        y = conv_nhwc(_Fp8.apply(x), _Fp8.apply(w.float()), stride=stride, padding=padding, dilation=dilation)
        return _Fp8.apply(y)

    def up_conv(self, x, w3):
        return _Fp8.apply(upsample_conv_k4(_Fp8.apply(fused_k4(w3.float())), _Fp8.apply(x)))

    def bn(self, x, params, state):
        return _Fp8.apply(batch_norm_train(x, params))


class Recorder(Float32):
    """Float32 forward that normalizes by the batch and records each batch
    norm's batch mean and biased variance into its state node: the running
    statistics under which the eval-mode forward equals this one."""

    def bn(self, x, params, state):
        state["mean"] = x.mean(dim=(0, 1, 2))
        state["var"] = ((x - state["mean"]) ** 2).mean(dim=(0, 1, 2))
        return batch_norm_train(x, params)


def augment(generator, images, masks):
    """Per sample a horizontal flip, then Binomial(3, 0.5) quarter turns
    counter-clockwise, of NHWC images and NHW masks alike."""
    n = images.shape[0]
    flips = torch.rand((n,), generator=generator, device=images.device) < 0.5
    rots = (torch.rand((n, 3), generator=generator, device=images.device) < 0.5).sum(dim=1) % 4
    out_i, out_m = [], []
    for i in range(n):
        img, msk = images[i], masks[i]
        if bool(flips[i]):
            img, msk = img.flip(1), msk.flip(1)
        k = int(rots[i])
        out_i.append(torch.rot90(img, k, dims=(0, 1)))
        out_m.append(torch.rot90(msk, k, dims=(0, 1)))
    return torch.stack(out_i), torch.stack(out_m)


def normalize(images):
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return (images.float() / 255.0 - mean) / std


def lovasz(logits, masks):
    """Mean over samples of the Lovasz hinge of the NCHW flattening of the
    logits against the one-hot masks."""
    n, _, _, c = logits.shape
    flat = logits.permute(0, 3, 1, 2).reshape(n, -1)
    labels = F.one_hot(masks.long(), c).to(logits.dtype).permute(0, 3, 1, 2).reshape(n, -1)
    losses = []
    for i in range(n):
        signs = 2.0 * labels[i] - 1.0
        errors = 1.0 - flat[i] * signs
        errors_sorted, perm = torch.sort(errors, descending=True)
        gt = labels[i][perm]
        total = gt.sum()
        inter = total - gt.cumsum(0)
        union = total + (1.0 - gt).cumsum(0)
        jaccard = 1.0 - inter / union
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
        losses.append(torch.dot(torch.relu(errors_sorted), jaccard))
    return torch.stack(losses).mean()


class Adam:
    def __init__(self, leaves, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.leaves, self.lr, self.b1, self.b2, self.eps = leaves, lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self):
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for p, mu, nu in zip(self.leaves, self.mu, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + self.eps))
            p.grad = None


def run(family, params, state, batches, generator, lr, ops):
    """Train `params` (float32, changed in place) for one step per
    (images, masks) of `batches`; returns (the first step's gradient of
    each leaf, each leaf's change over all steps), keyed by their paths."""
    named = flatten(params)
    start = [p.detach().clone() for _, p in named]
    leaves = [p.requires_grad_(True) for _, p in named]
    opt = Adam(leaves, lr)
    grads = None
    for images, masks in batches:
        images, masks = augment(generator, images, masks)
        lovasz(family.forward(ops, params, state, normalize(images)).float(), masks).backward()
        if grads is None:
            grads = {path: p.grad.detach().clone() for (path, _), p in zip(named, leaves)}
        opt.step()
    return grads, {path: p.detach() - p0 for (path, p), p0 in zip(named, start)}
