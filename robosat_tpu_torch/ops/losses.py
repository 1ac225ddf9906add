"""Segmentation losses on NHWC logits and NHW integer targets.

Counterpart of robosat_tpu/ops/losses.py, with the reference's quirks
(robosat/losses.py:8-119):

- NLL reductions are weighted means: sum(w[t] * -logp) / sum(w[t]) (torch
  NLLLoss semantics);
- the mIoU loss returns max(soft-mIoU loss, NLL) (robosat/losses.py:83);
- Lovasz flattens each sample over C*H*W together, in the reference's NCHW
  order, before sorting (robosat/losses.py:96-119).

Lovasz is a torch.autograd.Function, the counterpart of the JAX package's
custom VJP: its gradient coefficients depend only on the label ranking, so
the forward sorts once and saves the gradient, already unpermuted, for the
backward.
"""

import torch
import torch.nn.functional as F


def _gathered_nll(values, targets, weight):
    """Weighted-mean NLL over gathered per-pixel values (already log-space)."""
    targets = targets.long()
    gathered = torch.take_along_dim(values, targets[..., None], dim=-1)[..., 0]
    if weight is None:
        return -torch.mean(gathered)
    w = torch.as_tensor(weight, dtype=values.dtype, device=values.device)[targets]
    return -torch.sum(w * gathered) / torch.sum(w)


def cross_entropy_loss(logits, targets, weight=None):
    """CrossEntropyLoss2d: NLL of log-softmax with per-class weights."""
    return _gathered_nll(F.log_softmax(logits, dim=-1), targets, weight)


def focal_loss(logits, targets, weight=None, gamma=2.0):
    """FocalLoss2d: (1 - softmax)^gamma penalty on log-softmax, then NLL."""
    logp = F.log_softmax(logits, dim=-1)
    penalty = (1.0 - F.softmax(logits, dim=-1)) ** gamma
    return _gathered_nll(penalty * logp, targets, weight)


def miou_loss(logits, targets, weight=None):
    """mIoULoss2d: 1 - mean soft-IoU over (class, sample), floored by NLL."""
    n, h, w, c = logits.shape
    softs = F.softmax(logits, dim=-1)
    masks = F.one_hot(targets.long(), c).to(softs.dtype)

    inters = torch.sum((softs * masks).reshape(n, -1, c), dim=1)  # (N, C)
    unions = torch.sum((softs + masks - softs * masks).reshape(n, -1, c), dim=1)

    miou = 1.0 - torch.mean(inters / unions)
    return torch.maximum(miou, cross_entropy_loss(logits, targets, weight))


class LovaszFlat(torch.autograd.Function):
    """Per-sample Lovasz hinge of flattened (N, P) masks and inputs; returns
    the (N,) losses.

    Forward: errors = 1 - (2 mask - 1) * input; one batched stable sort of
    -errors along dim 1 (the order of the JAX package's stable `lax.sort`);
    the Jaccard coefficients from one cumsum of the sorted labels; the loss
    relu(sorted errors) . coefficients. The gradient, where(errors > 0,
    coefficient, 0) * -(2 mask - 1), is scattered back to the inputs' order
    in the forward and saved; the backward scales it. The masks get no
    gradient (they come from integer targets).
    """

    @staticmethod
    def forward(ctx, mask, inp):
        signs = mask * 2.0 - 1.0
        errors = 1.0 - signs * inp
        neg_sorted, perm = torch.sort(-errors, dim=1, stable=True)
        errors_sorted = -neg_sorted
        labels_sorted = torch.gather(mask, 1, perm)

        total = labels_sorted.sum(dim=1, keepdim=True)
        csum = torch.cumsum(labels_sorted, dim=1)
        inter = total - csum
        # cumsum(1 - l) == (k + 1) - cumsum(l): one cumsum instead of two.
        ranks = torch.arange(1, errors.shape[1] + 1, dtype=errors.dtype, device=errors.device)
        iou = 1.0 - inter / (total + ranks - csum)
        grad = torch.cat([iou[:, :1], iou[:, 1:] - iou[:, :-1]], dim=1)
        loss = (torch.relu(errors_sorted) * grad).sum(dim=1)

        # errors_sorted[rank(i)] is the same float as errors[i], so the relu'
        # test runs in the inputs' order after the scatter (at 0: 0).
        g_orig = torch.empty_like(grad).scatter_(1, perm, grad)
        ctx.save_for_backward(torch.where(errors > 0, g_orig, torch.zeros_like(g_orig)) * -signs)
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        (d_inp,) = ctx.saved_tensors
        return None, grad_loss[:, None] * d_inp


def lovasz_loss(logits, targets):
    """LovaszLoss2d: the Lovasz hinge on each sample's C*H*W flattening, in
    the reference's NCHW `.view(N, -1)` order (robosat/losses.py:103), so
    ties break over the same layout; the mean over the samples."""
    n, h, w, c = logits.shape
    masks = F.one_hot(targets.long(), c).to(logits.dtype)  # NHWC
    flat_inputs = logits.permute(0, 3, 1, 2).reshape(n, -1)
    flat_masks = masks.permute(0, 3, 1, 2).reshape(n, -1)
    return torch.mean(LovaszFlat.apply(flat_masks, flat_inputs))


LOSSES = {
    "CrossEntropy": lambda logits, targets, weight: cross_entropy_loss(logits, targets, weight),
    "Focal": lambda logits, targets, weight: focal_loss(logits, targets, weight),
    "mIoU": lambda logits, targets, weight: miou_loss(logits, targets, weight),
    "Lovasz": lambda logits, targets, weight: lovasz_loss(logits, targets),
}


def get_loss(name):
    """Loss fn by config name (robosat/tools/train.py:97-106)."""
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError("Unknown [opt][loss] value: {}".format(name)) from None
