"""Segmentation metrics: confusion counts on the device, a host-side tracker.

Counterpart of robosat_tpu/ops/metrics.py: the counts use the conventional
tn/fn/fp/tp definitions and give the reference's reported mIoU, foreground
IoU and MCC (robosat/metrics.py:27-84; the formulas are symmetric under
fn <-> fp). `confusion_counts` runs inside the train and eval steps, so
only four integers per step cross to the host.
"""

import math

import numpy as np
import torch


def _argmax_first(outputs):
    """argmax over the last axis, ties to the first index (as jnp.argmax)."""
    top = outputs.amax(dim=-1, keepdim=True)
    index = torch.arange(outputs.shape[-1], device=outputs.device)
    return torch.where(outputs == top, index, outputs.shape[-1]).amin(dim=-1)


def confusion_counts(outputs, masks):
    """Binary confusion counts from NHWC outputs (logits or probabilities)
    and NHW masks: an int32 tensor [tn, fn, fp, tp] over the whole batch."""
    pred = _argmax_first(outputs)
    actual = masks.to(pred.dtype)
    tn = torch.sum((pred == 0) & (actual == 0))
    fn = torch.sum((pred == 0) & (actual == 1))
    fp = torch.sum((pred == 1) & (actual == 0))
    tp = torch.sum((pred == 1) & (actual == 1))
    return torch.stack([tn, fn, fp, tp]).to(torch.int32)


class Metrics:
    """Running binary-segmentation metrics tracker (reference API parity)."""

    def __init__(self, labels=None):
        self.labels = labels
        self.tn = 0
        self.fn = 0
        self.fp = 0
        self.tp = 0

    def add(self, actual, predicted):
        """Add one observation: NHW (or HW) mask + NHWC (or HWC) outputs."""
        outputs = torch.as_tensor(predicted)
        masks = torch.as_tensor(actual, device=outputs.device)
        if outputs.dim() == 3:
            outputs = outputs[None]
            masks = masks[None]
        self.add_counts(confusion_counts(outputs, masks).cpu().numpy())

    def add_counts(self, counts):
        """Accumulate a [tn, fn, fp, tp] counts vector (from a step)."""
        tn, fn, fp, tp = (int(v) for v in counts)
        self.tn += tn
        self.fn += fn
        self.fp += fp
        self.tp += tp

    def get_miou(self):
        """Mean IoU over background and foreground (nanmean, reference parity)."""
        with np.errstate(invalid="ignore", divide="ignore"):
            bg = _safe_div(self.tn, self.tn + self.fn + self.fp)
            fg = _safe_div(self.tp, self.tp + self.fn + self.fp)
        return float(np.nanmean([bg, fg]))

    def get_fg_iou(self):
        return _safe_div(self.tp, self.tp + self.fn + self.fp)

    def get_mcc(self):
        denom = math.sqrt(
            (self.tp + self.fp) * (self.tp + self.fn) * (self.tn + self.fp) * (self.tn + self.fn)
        )
        if denom == 0:
            return float("nan")
        return (self.tp * self.tn - self.fp * self.fn) / denom


def _safe_div(a, b):
    return float("nan") if b == 0 else a / b
