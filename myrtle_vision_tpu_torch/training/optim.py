"""Optimizer and LR schedule of the reference's timm recipe, in PyTorch
(port of myrtle_vision_tpu/training/optim.py, whose module imports
optax).

- optimizer "adamw": AdamW with opt_eps / opt_betas (null -> (0.9,
  0.999)) and weight_decay, weight decay only on params with more than one
  dimension (timm ``add_weight_decay``); "sgd" / "momentum" /
  "nesterov" (decay then momentum SGD) and "adam" as in the JAX package.
  ``clip_grad`` is applied by the train step (training/trainer.py) to the
  summed gradients, as the JAX package chains ``clip_by_global_norm``
  before the update.
- scheduler "cosine": timm CosineLRScheduler stepped per epoch, as a pure
  function of (config, epoch); the trainer sets it on every param group
  before each step.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def lr_at_epoch(train_config, epoch: int) -> float:
    """timm CosineLRScheduler.get_epoch_values equivalent."""
    lr = float(train_config["lr"])
    min_lr = float(train_config["min_lr"])
    warmup_lr = float(train_config["warmup_lr"])
    warmup_t = int(train_config["warmup_epochs"])
    t_initial = int(train_config["epochs"])

    if warmup_t > 0 and epoch < warmup_t:
        value = warmup_lr + epoch * (lr - warmup_lr) / warmup_t
    elif epoch < t_initial:
        t = epoch - warmup_t
        total = max(t_initial - warmup_t, 1)
        value = min_lr + 0.5 * (lr - min_lr) * (
            1 + math.cos(math.pi * t / total)
        )
    else:
        # past the single cosine cycle (cooldown epochs): floor
        value = min_lr

    value = _add_noise(train_config, value, epoch)
    return float(value)


def _add_noise(train_config, value, epoch):
    """timm Scheduler._add_noise: optional multiplicative LR noise applied
    from lr_noise * epochs onwards (normal, clipped to +-lr_noise_pct)."""
    lr_noise = train_config.get("lr_noise")
    if lr_noise is None:
        return value
    t_initial = int(train_config["epochs"])
    if isinstance(lr_noise, (list, tuple)):
        noise_range = [n * t_initial for n in lr_noise]
        active = noise_range[0] <= epoch < noise_range[1]
    else:
        active = epoch >= lr_noise * t_initial
    if not active:
        return value
    noise_pct = float(train_config.get("lr_noise_pct") or 0.67)
    noise_std = float(train_config.get("lr_noise_std") or 1.0)
    seed = int(train_config.get("seed", 42))
    rng = np.random.RandomState(seed + epoch)
    while True:
        noise = rng.normal(0, noise_std)
        if abs(noise) < noise_pct:
            break
    return value + value * noise


def param_groups(model, weight_decay: float):
    """timm add_weight_decay: decay only multi-dim params (weights and the
    pos/cls/det token embeddings); skip biases and norm scales."""
    params = [p for p in model.parameters() if p.requires_grad]
    return [
        {"params": [p for p in params if p.ndim > 1],
         "weight_decay": weight_decay},
        {"params": [p for p in params if p.ndim <= 1], "weight_decay": 0.0},
    ]


def create_optimizer(train_config, model) -> torch.optim.Optimizer:
    """The torch optimizer of the reference train_config schema over
    ``model``'s parameters, at the config's peak LR (the trainer sets each
    step's LR with :func:`set_learning_rate`)."""
    opt_name = train_config["optimizer"].lower()
    eps = float(train_config["opt_eps"])
    betas = tuple(train_config.get("opt_betas") or (0.9, 0.999))
    weight_decay = float(train_config["weight_decay"])
    momentum = float(train_config.get("momentum", 0.9))
    lr = float(train_config["lr"])

    if opt_name == "adamw":
        return torch.optim.AdamW(param_groups(model, weight_decay), lr=lr,
                                 betas=betas, eps=eps)
    if opt_name in ("sgd", "momentum", "nesterov"):
        return torch.optim.SGD(param_groups(model, weight_decay), lr=lr,
                               momentum=momentum,
                               nesterov=opt_name == "nesterov")
    if opt_name == "adam":
        return torch.optim.Adam(model.parameters(), lr=lr, betas=betas,
                                eps=eps)
    raise NotImplementedError(f"optimizer {opt_name}")


def set_learning_rate(optimizer, lr) -> None:
    """Set ``lr`` on every param group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the gradients, in place: scaled by
    max_norm / norm when their global norm exceeds max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor)


def cross_entropy_loss(logits, labels):
    """Mean softmax cross entropy with integer labels."""
    return F.cross_entropy(logits.float(), labels.long())
