"""Detection task: the DETR loss for the trainer core, the eval forward
and COCO evaluation (port of ``make_loss_fn``, ``make_detect_fn`` and
``evaluate_coco`` of myrtle_vision_tpu/training/detection.py).  The JAX package's split matching (``make_match_fn``,
``use_split_matching``) works around its TPU runtime and is not ported:
here the matcher runs inside the loss, on the training forward's
outputs, as in the JAX package's default.  FP32 and the stateless float
formats (FP16_16, FP16_32, TF32) share both functions: those formats keep
no state, so there is no ``quant`` collection to thread through, as in
the JAX ``make_loss_fn`` for them.  A PyTorchINT8 model before convert
trains as the JAX ``qat_int8`` branch does, in one pass: the calibrating
forward, differentiated, its observers (the model's buffers, which the
checkpoints carry) folding in each micro-batch as it runs; its eval
forward is the simulation's, the observers frozen."""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.eval.coco_eval import CocoEvaluator
from myrtle_vision_tpu_torch.models.detector import criterion, post_process


def make_loss_fn(model, num_classes, weight_dict, eos_coef, group=None):
    """micro-batch {"image", "labels", "boxes", "valid"} on the model's
    device -> (weighted loss, {"metrics": the other losses}), for
    training/trainer.py ``make_train_step``; ``group``, the data group of
    a multi-GPU run, averages ``num_boxes`` over the ranks (the JAX
    ``axis_name``)."""
    qat_int8 = model.int8 and not model.converted

    def loss_fn(batch, dropout_rng=None):
        outputs = model(batch["image"], calibrating=qat_int8,
                        dropout_rng=dropout_rng)
        targets = {k: batch[k] for k in ("labels", "boxes", "valid")}
        losses = criterion(outputs, targets, num_classes=num_classes,
                           weight_dict=weight_dict, eos_coef=eos_coef,
                           group=group)
        loss = losses.pop("loss")
        return loss, {"metrics": losses}

    return loss_fn


def make_detect_fn(model):
    """images (B, H, W, C) on the model's device -> {"pred_logits",
    "pred_boxes"}, under ``torch.no_grad()`` with the model in eval
    mode."""

    def detect(images):
        model.eval()
        with torch.no_grad():
            return model(images)

    return detect


def evaluate_coco(detect_fn, loader, coco_index, epoch=0, predictions=None):
    """COCO mAP over a loader of collated detection batches (reference
    detection/train.py:40-71): post-processed detections of every image
    into the evaluator, then its 12-number summary, printed.  Returns the
    evaluator (stats[0] = AP@[.5:.95]).  ``predictions``, a dict, also
    collects {image id: {"scores", "labels", "boxes"}} as numpy arrays."""
    evaluator = CocoEvaluator(coco_index)
    for batch in loader.epoch(epoch):
        outputs = detect_fn(batch["image"])
        results = post_process(outputs, batch["orig_size"])
        scores, labels, boxes = (results[k].cpu().numpy()
                                 for k in ("scores", "labels", "boxes"))
        batch_preds = {
            int(img_id): {"scores": scores[i], "labels": labels[i],
                          "boxes": boxes[i]}
            for i, img_id in enumerate(batch["image_id"].tolist())
        }
        evaluator.update(batch_preds)
        if predictions is not None:
            predictions.update(batch_preds)
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    evaluator.summarize()
    return evaluator
