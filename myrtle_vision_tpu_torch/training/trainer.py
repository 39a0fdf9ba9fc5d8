"""Training core: the train step over gradient-accumulation micro-batches
(port of myrtle_vision_tpu/training/trainer.py ``make_train_step`` for one
device; the multi-device and tensor-parallel branches wait for ROADMAP
A9).

One step runs ``n_accum`` micro-batches, calls backward on each loss
without dividing it, so that the gradients SUM over the micro-batches as
in the reference and the JAX package, averages the metrics over the
micro-batches, sets the epoch's LR, clips when configured and steps the
optimizer.  The parameters and optimizer state update in place.

A model with active dropout trains with the state's dropout generator
(:func:`dropout_generator`, seeded from the config's seed as the JAX
trainer seeds its "dropout" rng stream), which each micro-batch's loss
takes as its second argument and which advances across steps, where the
JAX step folds the iteration and the micro-batch index into its key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from myrtle_vision_tpu_torch.training.optim import (
    clip_by_global_norm,
    set_learning_rate,
)


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    iteration: int = 0  # optimizer steps taken
    # the dropout sites' generator (None: the model has no active dropout)
    dropout: Optional[torch.Generator] = None


def dropout_generator(model, seed):
    """A ``torch.Generator`` on ``model``'s device seeded with ``seed``
    when the model (a ViT, or a wrapper with a ``student``) has a
    positive ``dropout`` or ``emb_dropout``; else None."""
    vit = getattr(model, "student", model)
    if not (vit.dropout or vit.emb_dropout):
        return None
    device = next(model.parameters()).device
    return torch.Generator(device=device).manual_seed(int(seed))


def make_train_step(loss_fn, n_accum: int, clip_grad=None):
    """(state, batch, lr) -> metrics, with batch leaves [n_accum,
    micro_batch, ...] on the model's device and ``loss_fn(micro_batch) ->
    (loss, {"metrics": dict})``, or ``loss_fn(micro_batch,
    state.dropout)`` when the state carries a dropout generator.  Metrics
    come back as 0-dim tensors on the device (reading one waits for the
    step)."""

    def step(state: TrainState, batch, lr):
        model, optimizer = state.model, state.optimizer
        model.train()
        set_learning_rate(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        sums = {}
        for i in range(n_accum):
            mb = {k: v[i] for k, v in batch.items()}
            loss, aux = (loss_fn(mb) if state.dropout is None
                         else loss_fn(mb, state.dropout))
            loss.backward()
            for name, value in {**aux["metrics"], "loss": loss}.items():
                value = value.detach().float()
                sums[name] = sums[name] + value if name in sums else value
        params = [p for g in optimizer.param_groups for p in g["params"]]
        for p in params:
            # a parameter the loss does not reach (the detection tokens of
            # a classifier) has a zero gradient, as under jax.grad, so
            # that weight decay still applies to it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if clip_grad is not None:
            clip_by_global_norm(params, float(clip_grad))
        optimizer.step()
        state.iteration += 1
        return {name: value / n_accum for name, value in sums.items()}

    return step
