"""Metrics: top-k accuracy and streaming mean IoU (port of
myrtle_vision_tpu/utils/metrics.py, whose module imports jax).

- ``accuracy``: precision@k (reference utils/utils.py:243-259);
- ``MIoU``: streaming per-class intersection / union counts (reference
  utils/miou.py:5-63), counted with ``torch.bincount`` on the device the
  predictions live on and accumulated in float64 on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def accuracy(output, target, topk=(1,)):
    """precision@k percentages, as in the reference
    (utils/utils.py:243-259): ``output`` (batch, classes) scores,
    ``target`` (batch,) labels; one 0-d fp32 tensor per k."""
    if target.numel() == 0:
        return [torch.zeros((), device=output.device)]
    maxk = max(topk)
    batch_size = target.shape[0]
    _, pred = torch.topk(output, maxk, dim=-1)  # (batch, maxk)
    correct = pred == target[:, None]
    return [correct[:, :k].sum().float() * (100.0 / batch_size)
            for k in topk]


def _intersect_and_union_counts(pred, label, num_classes: int):
    """Per-class (intersection, pred, label) pixel counts of one image or
    batch, int64 on the inputs' device; a value outside [0, num_classes)
    (the -1 of an unlabelled DLRSD pixel) falls in no bin."""
    pred = torch.as_tensor(pred).reshape(-1).long()
    label = torch.as_tensor(label).reshape(-1).long().to(pred.device)

    def counts(x):
        x = x[(x >= 0) & (x < num_classes)]
        return torch.bincount(x, minlength=num_classes)

    inter = torch.where(pred == label, pred, torch.full_like(pred, -1))
    return counts(inter), counts(pred), counts(label)


class MIoU:
    """Streaming mean-IoU accumulator (reference utils/miou.py:44-63).
    ``add_img`` / ``add_batch`` take predictions and labels of the same
    shape, numpy arrays or tensors on any device."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.total_area_intersect = np.zeros(num_classes, np.float64)
        self.total_area_union = np.zeros(num_classes, np.float64)

    def add_img(self, prediction, ground_truth):
        inter, pred, label = (
            c.cpu().numpy().astype(np.float64)
            for c in _intersect_and_union_counts(prediction, ground_truth,
                                                 self.num_classes))
        self.total_area_intersect += inter
        self.total_area_union += pred + label - inter

    # batches count as images do (the counts add up)
    add_batch = add_img

    def get_per_class_iou(self):
        """Intersection over union per class; NaN for a class absent from
        every prediction and label so far."""
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.total_area_intersect / self.total_area_union

    def get_miou(self):
        """``np.mean`` of the per-class IoU: NaN while any class is
        absent from both, as in the JAX package."""
        return float(np.mean(self.get_per_class_iou()))
