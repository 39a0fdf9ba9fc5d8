"""Weights carried across: JAX param trees, reference-format ``.pth``
files and pretrained timm backbones -> state dicts in the reference
naming that the port's modules load.

The name mappings are the JAX package's own
(myrtle_vision_tpu/utils/export.py ``export_torch_state_dict``,
myrtle_vision_tpu/utils/pretrained.py), reused by import; those modules
import numpy only at their top.
"""
from __future__ import annotations

import zipfile

import numpy as np
import torch

from myrtle_vision_tpu.utils import export
from myrtle_vision_tpu.utils.export import export_torch_state_dict
from myrtle_vision_tpu.utils.pretrained import (
    load_state_dict_from_source,
    rename_timm_state_dict,
)


def state_dict_from_jax(params_numpy, decoder: str = "classification"):
    """JAX ViT param tree (numpy arrays) -> {reference name: fp32 tensor}
    with torch (out, in) Linear weights."""
    return {
        name: torch.from_numpy(arr)
        for name, arr in export_torch_state_dict(params_numpy,
                                                 decoder).items()
    }


def require_torch_file(path):
    """Raise unless ``path`` is a file that ``torch.save`` wrote; a flax
    msgpack training checkpoint is refused with the way to convert it."""
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a torch checkpoint (a flax msgpack training "
            "checkpoint?); convert it with classification/"
            "export_checkpoint.py -c <config.json> --output <model.pth> and "
            "point train_config.checkpoint_path at the .pth"
        )


def load_reference_checkpoint(path):
    """Read the ``.pth`` that classification/export_checkpoint.py writes:
    a plain state dict or the reference's ``{"model": state_dict,
    "iteration": n, ...}`` envelope, which the port's trainer writes
    (utils/checkpoint.py).  A flax msgpack training checkpoint is
    refused: export it first."""
    require_torch_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {name: t.float() for name, t in obj.items()}


def load_pretrained_backbone(model, source: str):
    """Load a timm ViT backbone into ``model`` (the JAX package's
    ``load_pretrained_backbone``): ``source`` is a timm model name, which
    needs timm and raises RuntimeError without it, or a ``.pth`` of a
    timm-style state dict.  The classifier head is not loaded; an
    unexpected key or a shape mismatch raises."""
    update = rename_timm_state_dict(load_state_dict_from_source(source))
    sd = {}
    for path, name, is_kernel in export._rules(update, "classification"):
        try:
            arr = export._get(update, path)
        except KeyError:  # a parameter the backbone does not carry
            continue
        arr = np.asarray(arr, np.float32)
        sd[name] = torch.from_numpy(np.ascontiguousarray(
            arr.T if is_kernel else arr))
    own = model.state_dict()
    for name, t in sd.items():
        if own[name].shape != t.shape:
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(own[name].shape)} vs {tuple(t.shape)}")
    model.load_state_dict(sd, strict=False)
