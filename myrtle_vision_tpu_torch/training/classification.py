"""Classification task: the loss function for the trainer core and the
eval forward (myrtle_vision_tpu/training/classification.py
``make_loss_fn`` without a distiller, and ``make_predict_fn``)."""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.training.optim import cross_entropy_loss


def make_loss_fn(model):
    """batch -> (loss, {"metrics": {"acc"}}): mean cross entropy of the
    model's logits and the batch accuracy, differentiable in the model's
    parameters.

    A PyTorchINT8 model before convert trains in two passes, the JAX
    two-pass INT8 QAT step: pass 1, without gradient, is the calibrating
    forward, which folds the batch into every observer; pass 2, the
    differentiated one, runs the same forward with those observers frozen,
    each block half one op with their site table (``int8_fused``).  The
    observers after the step are pass 1's: as the JAX step keeps pass 1's
    ``quant``, pass 2 folds nothing.  Beyond the fused Block's length
    pass 2's blocks run the JAX Block's discrete composition, calibrating
    with the observers frozen, differentiated (models/vit.py
    ``Block.forward_int8``), as the JAX pass 2 does there."""
    two_pass = model.int8 and not model.converted

    def loss_fn(batch):
        if two_pass:
            with torch.no_grad():
                model(batch["image"], calibrating=True)
            logits = model(batch["image"], int8_fused=True)
        else:
            logits = model(batch["image"])
        labels = batch["label"].long()
        loss = cross_entropy_loss(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"metrics": {"acc": acc}}

    return loss_fn


def make_predict_fn(model):
    """images (B, H, W, C) on the model's device -> fp32 logits, under
    ``torch.inference_mode()`` with the model in eval mode.  A converted
    PyTorchINT8 model runs its int8 products, one before convert the
    simulation's eval forward; their observers are frozen, so the forward
    changes no state."""

    def predict(images):
        model.eval()
        with torch.inference_mode():
            return model(images).float()

    return predict
