"""Detection loss (DETR-derived set criterion) and COCO post-processing
(port of myrtle_vision_tpu/models/detector.py).

- Targets are padded to a static ``max_boxes`` per image with a validity
  mask, as the JAX package pads them; matched pairs come from the
  Hungarian matcher as a query index per target slot (models/matcher.py).
- ``num_boxes``: the number of valid targets in the batch; with a data
  ``group`` (multi-GPU training) summed over it and divided by its size,
  the JAX package's ``axis_name`` branch; then clamped to 1 (reference
  detector.py:133-138).
- Losses (reference detector.py:41-98): weighted CE with ``eos_coef``
  down-weighting the no-object class, class and cardinality errors
  (logging only, no gradient), L1 + GIoU box losses normalized by
  ``num_boxes``.
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.models.matcher import hungarian_match
from myrtle_vision_tpu_torch.ops.boxes import (
    box_cxcywh_to_xyxy,
    generalized_box_iou,
)


def criterion(outputs, targets, num_classes: int, weight_dict=None,
              eos_coef: float = 0.1, cost_class: float = 1.0,
              cost_bbox: float = 5.0, cost_giou: float = 2.0, src_idx=None,
              group=None):
    """Compute the DETR loss dict.

    Args:
      outputs: {"pred_logits": (B,Q,C+1), "pred_boxes": (B,Q,4) cxcywh}.
      targets: {"labels": (B,M) int, "boxes": (B,M,4) normalized cxcywh,
                "valid": (B,M) bool}.
      num_classes: real classes (no-object = index num_classes).
      weight_dict: loss-name -> weight for the "loss" total
        (reference detection/train.py:199-215 builds it from train_config).
      src_idx: (B, M) matched queries; matched here when None.
      group: the data group of a multi-GPU run, over which ``num_boxes``
        averages, or None.

    Returns a dict of 0-dim fp32 tensors: loss_ce / class_error /
    cardinality_error / loss_bbox / loss_giou and the weighted total
    "loss".
    """
    pred_logits = outputs["pred_logits"].float()
    pred_boxes = outputs["pred_boxes"].float()
    labels = targets["labels"].long()
    boxes = targets["boxes"].float()
    valid = targets["valid"].bool()
    B, Q, _ = pred_logits.shape

    if src_idx is None:
        src_idx = hungarian_match(pred_logits, pred_boxes, labels, boxes,
                                  valid, cost_class=cost_class,
                                  cost_bbox=cost_bbox, cost_giou=cost_giou)
    src_idx = src_idx.long()
    num_boxes = valid.float().sum()
    if group is not None:
        import torch.distributed as dist

        num_boxes = num_boxes.clone()
        dist.all_reduce(num_boxes, group=group)
        num_boxes = num_boxes / dist.get_world_size(group)
    num_boxes = num_boxes.clamp(min=1.0)

    # ---- loss_labels (detector.py:41-60) ----
    # matched target classes scattered into a (B, Q) map of no-object;
    # invalid slots go to an extra column that is dropped
    scatter_q = torch.where(valid, src_idx, torch.full_like(src_idx, Q))
    target_classes = torch.full((B, Q + 1), num_classes, dtype=torch.long,
                                device=labels.device)
    target_classes.scatter_(1, scatter_q, labels)
    target_classes = target_classes[:, :Q]
    empty_weight = torch.ones(num_classes + 1, device=pred_logits.device)
    empty_weight[num_classes] = eos_coef
    logp = torch.log_softmax(pred_logits, dim=-1)
    nll = -torch.gather(logp, -1, target_classes[..., None])[..., 0]
    w = empty_weight[target_classes]
    loss_ce = (w * nll).sum() / w.sum().clamp(min=1e-9)

    with torch.no_grad():
        # class_error: top-1 error over matched predictions
        # (detector.py:57-59)
        matched_logits = torch.gather(
            pred_logits, 1,
            src_idx[..., None].expand(-1, -1, pred_logits.shape[-1]))
        correct = ((matched_logits.argmax(-1) == labels) & valid).float().sum()
        class_error = 100.0 - 100.0 * correct / num_boxes
        # cardinality (logging only, detector.py:62-74)
        card_pred = (pred_logits.argmax(-1) != num_classes).float().sum(-1)
        cardinality_error = (card_pred - valid.float().sum(-1)).abs().mean()

    # ---- loss_boxes (detector.py:76-98) ----
    src_boxes = torch.gather(pred_boxes, 1, src_idx[..., None].expand(-1, -1, 4))
    l1 = (src_boxes - boxes).abs().sum(-1)
    zero = torch.zeros_like(l1)
    loss_bbox = torch.where(valid, l1, zero).sum() / num_boxes
    giou_pair = generalized_box_iou(
        box_cxcywh_to_xyxy(src_boxes)[..., None, :],
        box_cxcywh_to_xyxy(boxes)[..., None, :],
    )[..., 0, 0]
    loss_giou = torch.where(valid, 1.0 - giou_pair, zero).sum() / num_boxes

    losses = {
        "loss_ce": loss_ce,
        "class_error": class_error,
        "cardinality_error": cardinality_error,
        "loss_bbox": loss_bbox,
        "loss_giou": loss_giou,
    }
    if weight_dict is not None:
        losses["loss"] = sum(losses[k] * w for k, w in weight_dict.items()
                             if w != 0)
    return losses


def post_process(outputs, target_sizes):
    """Model outputs -> COCO-format detections (reference
    detector.py:148-176).

    Args:
      outputs: {"pred_logits", "pred_boxes"}.
      target_sizes: (B, 2) [height, width] of the ORIGINAL images.

    Returns a dict of (B, Q) scores and labels (the best class but the
    no-object one, first on a tie) and (B, Q, 4) absolute-xyxy boxes."""
    logits = outputs["pred_logits"].float()
    out_bbox = outputs["pred_boxes"].float()
    prob = torch.softmax(logits, dim=-1)[..., :-1]
    scores = prob.amax(-1)
    labels = prob.argmax(-1)
    boxes = box_cxcywh_to_xyxy(out_bbox)
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([w, h, w, h], dim=1).float()
    return {"scores": scores, "labels": labels,
            "boxes": boxes * scale[:, None, :]}


def build_weight_dict(train_config):
    """Loss weights from the train_config schema
    (reference detection/train.py:199-215)."""
    return {
        "loss_ce": train_config["loss_ce"],
        "class_error": train_config.get("class_error", 0.0),
        "loss_bbox": train_config["loss_bbox"],
        "loss_giou": train_config["loss_giou"],
        "cardinality_error": train_config.get("cardinality_error", 0.0),
    }
