"""Classification task: the loss function for the trainer core and the
eval forward (myrtle_vision_tpu/training/classification.py
``make_loss_fn``, FP32 without a distiller, and ``make_predict_fn``, for
the FP32 and the converted PyTorchINT8 model alike)."""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.training.optim import cross_entropy_loss


def make_loss_fn(model):
    """batch -> (loss, {"metrics": {"acc"}}): mean cross entropy of the
    model's logits and the batch accuracy, differentiable in the model's
    parameters."""

    def loss_fn(batch):
        logits = model(batch["image"])
        labels = batch["label"].long()
        loss = cross_entropy_loss(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"metrics": {"acc": acc}}

    return loss_fn


def make_predict_fn(model):
    """images (B, H, W, C) on the model's device -> fp32 logits, under
    ``torch.inference_mode()`` with the model in eval mode.  A converted
    PyTorchINT8 model runs its int8 products; its observers are frozen,
    so the forward changes no state."""

    def predict(images):
        model.eval()
        with torch.inference_mode():
            return model(images).float()

    return predict
