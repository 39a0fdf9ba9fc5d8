"""Training core: the train step over gradient-accumulation micro-batches
(port of myrtle_vision_tpu/training/trainer.py ``make_train_step``), on
one device or as one rank of a multi-GPU run (parallel/mesh.py).

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

Several ranks (``mesh`` with a data or a model group), as the JAX step
under ``shard_map``:

  - data parallelism: the loss functions call the model through
    ``DistributedDataParallel`` over the data group
    (:func:`data_parallel`), every micro-batch but the last under
    ``no_sync()``, so that each rank's gradients sum over its
    micro-batches and then average over the data group, where the JAX
    step takes ``pmean`` of its summed gradients; buffers are not
    broadcast (DDP's ``broadcast_buffers`` off), since the PyTorchINT8
    observers reduce with MIN / MAX over the data group after the
    backward, as the JAX ``pmin`` / ``pmax``, and rank 0's must not
    overwrite the others';
  - tensor parallelism (parallel/tp.py): the Blocks' parameter gradients,
    each rank's part of them in any of the Block's forms, are summed over
    the model group in one all-reduce after the backward; the INT8
    observers of activations split over the group fold its MIN / MAX as
    they observe (quantize.py ``ActQuant``), so the model ranks' observers
    are alike before the data group's MIN / MAX;
  - the metrics average over the data group;
  - each data rank draws its dropout masks from its own generator
    (:func:`dropout_generator` with the data index), the model ranks of a
    row from the same one.

With one rank nothing of this runs: no group, no wrapper.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

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


def dropout_generator(model, seed, data_index: int = 0):
    """A ``torch.Generator`` on ``model``'s device seeded with ``seed``
    (data rank ``data_index`` > 0: with the seed and its index, so that
    each data rank draws its own masks) when the model (a ViT, or a
    wrapper with a ``student``) has a positive ``dropout`` or
    ``emb_dropout``; else None."""
    vit = getattr(model, "student", model)
    if not (vit.dropout or vit.emb_dropout):
        return None
    device = next(model.parameters()).device
    seed = int(seed) if data_index == 0 else hash((int(seed), data_index))
    return torch.Generator(device=device).manual_seed(seed & 0x7FFFFFFF)


class DataParallel(torch.nn.parallel.DistributedDataParallel):
    """``DistributedDataParallel`` whose attributes fall back to the
    wrapped module's, so that the loss functions read ``model.int8`` and
    the like through it."""

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self.module, name)


def data_parallel(model, mesh):
    """``model`` wrapped in :class:`DataParallel` over ``mesh``'s data
    group, or ``model`` itself where the mesh has none (one data rank).
    Buffers are not broadcast.  DDP leaves out the parameters that a
    ViT's decoder never reads (a classifier's or segmenter's detection
    tokens and their positions), so that every parameter it holds gets a
    gradient in each backward and it need not search the graph for
    unused ones; the step still gives those a zero gradient, and weight
    decay moves them alike on every rank, as in the JAX step."""
    from myrtle_vision_tpu_torch.models.vit import ViT

    if mesh is None or mesh.data_group is None:
        return model
    unused = [(prefix, name) for prefix, m in model.named_modules()
              if isinstance(m, ViT) and m.decoder_name != "detection"
              for name in ("pos_embedding_det", "det_tokens")]
    # DDP looks these up both as named_parameters() names them and as
    # f"{module name}.{parameter name}", which starts with a dot on the
    # root module
    DataParallel._set_params_and_buffers_to_ignore_for_model(
        model, [f"{p}.{n}" for p, n in unused]
        + [f"{p}.{n}".lstrip(".") for p, n in unused])
    device = next(model.parameters()).device
    return DataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        process_group=mesh.data_group, broadcast_buffers=False)


def reduce_observers(model, group) -> None:
    """Each PyTorchINT8 observer's running min and max, MIN and MAX over
    ``group`` (the JAX step's ``pmin`` / ``pmax`` of its ``quant``)."""
    from myrtle_vision_tpu_torch.quantize import ActQuant

    observers = [m for m in model.modules() if isinstance(m, ActQuant)]
    if not observers:
        return
    for name, op in (("min", dist.ReduceOp.MIN), ("max", dist.ReduceOp.MAX)):
        values = torch.stack([getattr(o, name) for o in observers])
        dist.all_reduce(values, op=op, group=group)
        for o, v in zip(observers, values):
            getattr(o, name).copy_(v)


def make_train_step(loss_fn, n_accum: int, clip_grad=None, mesh=None,
                    module=None):
    """(state, batch, lr) -> metrics, with batch leaves [n_accum,
    micro_batch, ...] on the model's device and ``loss_fn(micro_batch) ->
    (loss, {"metrics": dict})``, or ``loss_fn(micro_batch,
    state.dropout)`` when the state carries a dropout generator.  Metrics
    come back as 0-dim tensors on the device (reading one waits for the
    step).

    ``mesh`` (parallel/mesh.py) and ``module``, the model as the loss
    function calls it (:func:`data_parallel` of the state's model), make
    the step one rank's of a multi-GPU step (the module docstring)."""
    ddp = isinstance(module, torch.nn.parallel.DistributedDataParallel)
    data_group = None if mesh is None else mesh.data_group
    model_group = None if mesh is None else mesh.model_group

    def step(state: TrainState, batch, lr):
        model, optimizer = state.model, state.optimizer
        model.train()
        set_learning_rate(optimizer, lr)
        optimizer.zero_grad(set_to_none=True)
        sums = {}
        for i in range(n_accum):
            mb = {k: v[i] for k, v in batch.items()}
            # DDP reduces the summed gradients in the last backward
            sync = (module.no_sync() if ddp and i < n_accum - 1
                    else contextlib.nullcontext())
            with sync:
                loss, aux = (loss_fn(mb) if state.dropout is None
                             else loss_fn(mb, state.dropout))
                loss.backward()
            for name, value in {**aux["metrics"], "loss": loss}.items():
                value = value.detach().float()
                sums[name] = sums[name] + value if name in sums else value
        if model_group is not None:
            from myrtle_vision_tpu_torch.parallel.tp import (
                reduce_sharded_gradients,
            )

            reduce_sharded_gradients(model, model_group)
        if data_group is not None:
            reduce_observers(model, data_group)
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
        metrics = {name: value / n_accum for name, value in sums.items()}
        if data_group is not None:
            names = sorted(metrics)
            values = torch.stack([metrics[k] for k in names])
            dist.all_reduce(values, group=data_group)
            values = values / dist.get_world_size(data_group)
            metrics = dict(zip(names, values))
        return metrics

    return step
