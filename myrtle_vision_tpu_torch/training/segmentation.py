"""Segmentation task: the pixel-wise cross-entropy loss for the trainer
core (port of myrtle_vision_tpu/training/segmentation.py).

The logits are NHWC (B, H, W, C), as the JAX package returns them; the
reference's are NCHW (reference segmentation/train.py:188,260-261).
"""
from __future__ import annotations

import torch


def pixel_cross_entropy(logits_nhwc, labels_hw):
    """Mean softmax cross entropy over all pixels, fp32, as the JAX
    package computes it with ``jnp.take_along_axis``: a label in
    [-C, 0) wraps to class ``C + label`` (the -1 of an unlabelled DLRSD
    pixel takes the last class's log-probability, and its gradient), and
    a label past either end gives NaN, whose pixel passes no gradient."""
    logp = torch.log_softmax(logits_nhwc.float(), dim=-1)
    c = logp.shape[-1]
    labels = labels_hw.long()
    idx = torch.where(labels < 0, labels + c, labels)
    inside = (idx >= 0) & (idx < c)
    picked = logp.gather(-1, idx.clamp(0, c - 1)[..., None])[..., 0]
    nll = torch.where(inside, -picked, torch.full_like(picked, float("nan")))
    return nll.mean()


def make_loss_fn(model):
    """micro-batch {"image", "label"} on the model's device -> (loss,
    {"metrics": {"acc"}}), for training/trainer.py ``make_train_step``.
    One pass in every format, as the JAX ``make_loss_fn``: a PyTorchINT8
    model before convert runs its calibrating forward, differentiated,
    the observers (buffers the checkpoints carry) folding in each
    micro-batch as it runs.  ``acc`` is the share of pixels whose argmax
    is the label (a -1 pixel never is)."""
    qat_int8 = model.int8 and not model.converted

    def loss_fn(batch, dropout_rng=None):
        logits = model(batch["image"], calibrating=qat_int8,
                       dropout_rng=dropout_rng)
        labels = batch["label"].long()
        loss = pixel_cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"metrics": {"acc": acc}}

    return loss_fn
