"""YOLOS detection outputs to COCO detections (port of ``post_process``
of myrtle_vision_tpu/models/detector.py).  The Hungarian matcher and the
set criterion of detection training are not ported yet (ROADMAP A7).
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops.boxes import box_cxcywh_to_xyxy


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
