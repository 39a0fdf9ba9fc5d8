"""Training checkpoints with the reference's logical schema (port of
myrtle_vision_tpu/utils/checkpoint.py).

A checkpoint is ``torch.save`` of {"model": the reference-named state
dict, "optimizer": the optimizer's state dict, "quant": {},
"lr_scheduler": {...}, "iteration": n}, the envelope the upstream
reference writes (utils/models.py:113-126), and "q_format", the name of
the model's format, written atomically.  Under a distiller the model is
the DistillWrapper (models/distill.py), its student's names under
``student.``, which utils/convert.py ``load_reference_checkpoint`` reads
back for a plain ViT.  The
port's eval CLI reads it as it is (utils/convert.py
``load_reference_checkpoint``).  The LR schedule is a pure function of
(config, epoch), so "lr_scheduler" holds metadata only.
"""
from __future__ import annotations

import os

import torch

from myrtle_vision_tpu_torch.utils.convert import require_torch_file


def _write(filepath, model, optimizer, iteration, extra):
    payload = {
        "model": {name: t.detach().cpu()
                  for name, t in model.state_dict().items()},
        "optimizer": optimizer,
        "quant": {},
        "lr_scheduler": extra or {},
        "iteration": int(iteration),
        "q_format": model.q_format.name,
    }
    tmp = f"{filepath}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, filepath)


def save_checkpoint(state, filepath, extra=None, include_optimizer=True):
    """Write a TrainState to ``filepath`` (a temporary file, then
    ``os.replace``)."""
    _write(filepath, state.model,
           state.optimizer.state_dict() if include_optimizer else None,
           state.iteration, extra)


def save_model(model, filepath, iteration=0):
    """Write a model without optimizer state (a converted deployment
    checkpoint, its int8 or fp16 storage as it is); utils/convert.py
    ``load_reference_checkpoint`` reads it back."""
    _write(filepath, model, None, iteration, None)


def load_checkpoint(state, filepath, restore_optimizer=True):
    """Restore a checkpoint into ``state`` in place (the model strictly);
    returns (state, iteration)."""
    require_torch_file(filepath)
    payload = torch.load(filepath, map_location="cpu", weights_only=True)
    if not isinstance(payload.get("model"), dict):
        raise ValueError(
            f"{filepath} is not a training checkpoint (no 'model' state "
            "dict)")
    state.model.load_state_dict(payload["model"], strict=True)
    if restore_optimizer and payload.get("optimizer") is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
    state.iteration = int(payload["iteration"])
    return state, state.iteration


def prepare_model_and_load_ckpt(train_config, state, restore_optimizer=True):
    """Resume from train_config["checkpoint_path"] if set, else iteration
    0 (reference utils/models.py:63-81)."""
    path = train_config.get("checkpoint_path", "")
    if path:
        return load_checkpoint(state, path,
                               restore_optimizer=restore_optimizer)
    return state, 0
