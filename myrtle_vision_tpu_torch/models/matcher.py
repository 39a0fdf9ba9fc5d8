"""Hungarian matching between detection predictions and padded targets
(port of myrtle_vision_tpu/models/matcher.py ``hungarian_match``).

DETR-style bipartite matching (reference: src/myrtle_vision/models/
matcher.py): cost = cost_bbox * L1 + cost_class * (-prob[target]) +
cost_giou * (-GIoU).  The cost matrix is computed in torch on the model's
device without gradient; the assignment itself is data-dependent host
work, one small LSAP per image on the CPU (``_match_host``), as the
reference runs scipy's ``linear_sum_assignment`` there: the repository's
native solver (native/lsap.py), else scipy.

Targets are padded to a static ``max_boxes`` with a validity mask, as
the JAX package pads them; the result is, per target slot ``m``, the
matched query index ``src[b, m]`` (0 where ``tgt_valid[b, m]`` is false).
The JAX package's on-device solver (ops/lsap_device.py) and its matcher
switches exist for its TPU runtime and are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from myrtle_vision_tpu_torch.native import lsap as native_lsap
from myrtle_vision_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    generalized_box_iou,
)

_BIG = 1e8


def _solve_lsap(cost: np.ndarray) -> tuple:
    """Solve one LSAP (rows=queries, cols=targets, rows >= cols).
    Returns (row_idx, col_idx) arrays of length cols."""
    if native_lsap.available():
        return native_lsap.solve(cost)
    from scipy.optimize import linear_sum_assignment

    return linear_sum_assignment(cost)


def _match_host(cost: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Per-image LSAP on the first n_valid[b] columns; returns (B, M) int64
    of query indices per target slot (0 for invalid slots)."""
    cost = np.asarray(cost, np.float64)
    B, _, M = cost.shape
    src = np.zeros((B, M), np.int64)
    for b in range(B):
        m = int(n_valid[b])
        if m == 0:
            continue
        rows, cols = _solve_lsap(cost[b, :, :m])
        src[b, cols] = rows
    return src


@torch.no_grad()
def hungarian_match(pred_logits, pred_boxes, tgt_labels, tgt_boxes,
                    tgt_valid, cost_class: float = 1.0,
                    cost_bbox: float = 1.0, cost_giou: float = 1.0):
    """Batched matching.

    Args:
      pred_logits: (B, Q, C+1) raw logits.
      pred_boxes: (B, Q, 4) cxcywh in [0,1].
      tgt_labels: (B, M) int class ids (padded).
      tgt_boxes: (B, M, 4) cxcywh normalized (padded).
      tgt_valid: (B, M) bool.

    Returns:
      src_idx: (B, M) int64 on the predictions' device — the matched query
      per valid target slot.
    """
    prob = torch.softmax(pred_logits.float(), dim=-1)
    labels = tgt_labels.long()[:, None, :].expand(-1, prob.shape[1], -1)
    c_class = -torch.gather(prob, -1, labels)
    pred_boxes = pred_boxes.float()
    tgt_boxes = tgt_boxes.float()
    c_bbox = (pred_boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(
        -1)
    c_giou = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                  box_cxcywh_to_xyxy(tgt_boxes))
    cost = cost_bbox * c_bbox + cost_class * c_class + cost_giou * c_giou
    cost = torch.where(tgt_valid[:, None, :], cost,
                       torch.full_like(cost, _BIG))
    # NaN/inf guard (degenerate boxes) so LSAP stays solvable
    cost = torch.nan_to_num(cost, nan=_BIG, posinf=_BIG, neginf=-_BIG)
    n_valid = tgt_valid.sum(-1)
    src = _match_host(cost.cpu().numpy(), n_valid.cpu().numpy())
    return torch.from_numpy(src).to(pred_logits.device)
