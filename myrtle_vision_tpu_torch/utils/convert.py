"""Weights and observer state carried across: JAX param trees (with their
``quant`` collection), reference-format ``.pth`` files and pretrained
timm backbones -> state dicts in the reference naming that the port's
modules load.

The parameter names are the reference's, by the rules of
myrtle_vision_tpu/utils/export.py, which the port keeps a copy of
(utils/export.py).  The PyTorchINT8 observers (models/vit.py) take the
names below; each site holds two fp32 scalars, ``<site>.min`` and
``<site>.max``, the running minimum and maximum of the JAX ``quant``
collection's ``min`` and ``max``:

=========================================  ================================
JAX ``quant`` path                         port site
=========================================  ================================
quant_img, quant_cls_token,                the same name on the model
quant_pos_embedding, cls_token_cat,
pos_embedding_cat, pos_embedding_add
(detection also quant_det_tokens;
a DeiT student also quant_distill_token,
distill_token_cat)
patch_to_embedding/act_out                 patch_to_embedding.act_out
decoder/norm/act_out                       decoder.norm.act_out
decoder/linear/act_out                     decoder.linear.act_out
(classification and segmentation)
(detection: decoder/class_embed/act_out,   decoder.class_embed.act_out,
decoder/bbox_embed/act_out)                decoder.bbox_embed.act_out
transformer/layers_i/attn_norm/act_out     transformer.layers.i.0.fn.norm.act_out
  .../attn/to_qkv/act_out                  transformer.layers.i.0.fn.fn.to_qkv.act_out
  .../attn/quant_out                       transformer.layers.i.0.fn.fn.quant_out
  .../attn/to_out/act_out                  transformer.layers.i.0.fn.fn.to_out.0.act_out
  .../attn_res/res_add                     transformer.layers.i.0.res_add
  .../ffn_norm/act_out                     transformer.layers.i.1.fn.norm.act_out
  .../ffn/fc1/act_out                      transformer.layers.i.1.fn.fn.net.0.act_out
  .../ffn/gelu/act_out                     transformer.layers.i.1.fn.fn.net.1.act_out
  .../ffn/fc2/act_out                      transformer.layers.i.1.fn.fn.net.3.act_out
  .../ffn_res/res_add                      transformer.layers.i.1.res_add
=========================================  ================================

A converted JAX tree (``convert_params``) keeps its storage: an int8
``kernel`` with its fp32 ``kernel_scale`` becomes an int8
``<linear>.weight`` in the torch (out, in) layout with an fp32 0-d
``<linear>.weight_scale``; the fp16 ``kernel`` and LayerNorm ``scale`` of
FP16_16 / FP16_32 become fp16 ``<module>.weight`` (TF32 keeps fp32).
"""
from __future__ import annotations

import zipfile

import numpy as np
import torch

from myrtle_vision_tpu_torch.models.vit import DISTILL_SITES
from myrtle_vision_tpu_torch.utils import export
from myrtle_vision_tpu_torch.utils.pretrained import (
    load_state_dict_from_source,
    rename_timm_state_dict,
)

_QUANT_TOP = ["quant_img", "quant_cls_token", "quant_pos_embedding",
              "cls_token_cat", "pos_embedding_cat", "pos_embedding_add"]
_QUANT_EMBED = [(("patch_to_embedding", "act_out"),
                 "patch_to_embedding.act_out")]
_QUANT_HEAD = {"classification": ("norm", "linear"),
               "segmentation": ("norm", "linear"),
               "detection": ("class_embed", "bbox_embed")}
_QUANT_LAYER = [
    (("attn_norm", "act_out"), "0.fn.norm.act_out"),
    (("attn", "to_qkv", "act_out"), "0.fn.fn.to_qkv.act_out"),
    (("attn", "quant_out"), "0.fn.fn.quant_out"),
    (("attn", "to_out", "act_out"), "0.fn.fn.to_out.0.act_out"),
    (("attn_res", "res_add"), "0.res_add"),
    (("ffn_norm", "act_out"), "1.fn.norm.act_out"),
    (("ffn", "fc1", "act_out"), "1.fn.fn.net.0.act_out"),
    (("ffn", "gelu", "act_out"), "1.fn.fn.net.1.act_out"),
    (("ffn", "fc2", "act_out"), "1.fn.fn.net.3.act_out"),
    (("ffn_res", "res_add"), "1.res_add"),
]


def quant_site_names(depth: int, decoder: str = "classification"):
    """[(JAX quant path, port site name)] of a ViT with ``decoder``
    ("classification", "segmentation" or "detection")."""
    top = _QUANT_TOP + (["quant_det_tokens"] if decoder == "detection"
                        else [])
    names = [((n,), n) for n in top] + list(_QUANT_EMBED)
    names += [(("decoder", m, "act_out"), f"decoder.{m}.act_out")
              for m in _QUANT_HEAD[decoder]]
    for i in range(depth):
        for path, name in _QUANT_LAYER:
            names.append((("transformer", f"layers_{i}") + path,
                          f"transformer.layers.{i}.{name}"))
    return names


def state_dict_from_jax(params_numpy, decoder: str = "classification",
                        quant=None):
    """JAX ViT param tree (numpy arrays) of a ``decoder``
    ("classification", "segmentation" or "detection"), before or after
    ``convert_params``, and optionally its ``quant`` collection -> {port
    name: tensor}: fp32
    parameters with torch (out, in) Linear weights; int8 weights with
    their ``weight_scale``; fp16 weights as fp16; ``<site>.min`` and
    ``<site>.max`` of every observer.

    A JAX ``DistillWrapper`` tree ({student, distillation_token,
    distill_mlp_norm, distill_mlp_linear}) gives the port wrapper's state
    dict (models/distill.py): the student's names under ``student.``, the
    token, the head's LayerNorm and Linear; with its ``quant`` collection
    (a PyTorchINT8 student's, under "student"), the student's observers,
    its token's two included.  The teacher is a torchvision state dict in
    both packages and is read as it is."""
    if "student" in params_numpy:
        squant = None if quant is None else quant["student"]
        sd = {f"student.{name}": t for name, t in state_dict_from_jax(
            params_numpy["student"], decoder, squant).items()}
        for name in DISTILL_SITES if squant is not None else ():
            for key in ("min", "max"):
                sd[f"student.{name}.{key}"] = torch.tensor(
                    np.float32(squant[name][key]))
        norm = params_numpy["distill_mlp_norm"]
        linear = params_numpy["distill_mlp_linear"]
        for name, arr in (
                ("distillation_token", params_numpy["distillation_token"]),
                ("distill_mlp_norm.weight", norm["scale"]),
                ("distill_mlp_norm.bias", norm["bias"]),
                ("distill_mlp_linear.weight", np.asarray(linear["kernel"]).T),
                ("distill_mlp_linear.bias", linear["bias"])):
            sd[name] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))
        return sd
    sd = {}
    for path, name, is_kernel in export._rules(params_numpy, decoder):
        arr = np.asarray(export._get(params_numpy, path))
        if is_kernel:
            arr = arr.T
        if arr.dtype == np.int8:
            scale = export._get(params_numpy, path[:-1] + ("kernel_scale",))
            sd[name[:-len("weight")] + "weight_scale"] = torch.tensor(
                np.float32(scale))
        elif arr.dtype != np.float16:
            arr = arr.astype(np.float32)
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    if quant is not None:
        depth = len([k for k in params_numpy["transformer"]
                     if k.startswith("layers_")])
        for path, name in quant_site_names(depth, decoder):
            site = export._get(quant, path)
            for key in ("min", "max"):
                sd[f"{name}.{key}"] = torch.tensor(np.float32(site[key]))
    return sd


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


def student_state_dict(sd):
    """The student's state dict of a distillation wrapper's (its entries
    under ``student.``) as a plain ViT reads it: a PyTorchINT8 student's
    observers of its distillation token left out, as the JAX
    ``load_checkpoint`` reads the student's ``quant`` into a plain ViT's
    sites; or ``sd`` as it is when it holds no wrapper."""
    if not any(name.startswith("student.") for name in sd):
        return sd
    return {name[len("student."):]: t for name, t in sd.items()
            if name.startswith("student.")
            and name.split(".")[1] not in DISTILL_SITES}


def load_reference_checkpoint(path):
    """Read the ``.pth`` that classification/export_checkpoint.py writes:
    a plain state dict or the reference's ``{"model": state_dict,
    "iteration": n, ...}`` envelope, which the port's trainer and its
    converted checkpoints write (utils/checkpoint.py).  The converted
    storage comes back as it is (int8, fp16), other tensors fp32.  A
    distillation training checkpoint gives its student's state dict, as
    the JAX package's ``load_checkpoint`` reads a DistillWrapper tree into
    a plain ViT (the reference's distill runs save the student alone).  A
    flax msgpack training checkpoint is refused: export it first."""
    require_torch_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {name: t if t.dtype in (torch.int8, torch.float16) else t.float()
            for name, t in student_state_dict(obj).items()}


def checkpoint_q_format(path):
    """The ``q_format`` name that a port checkpoint's envelope carries
    (utils/checkpoint.py), or None for a file without one (a reference
    ``.pth``)."""
    require_torch_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    fmt = obj.get("q_format")
    return fmt if isinstance(fmt, str) else None


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
