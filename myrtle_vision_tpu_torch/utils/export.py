"""The reference's state-dict naming and its torch checkpoint, the FPGA
deployment hand-off format (reference: classification/README.md:31-33,
utils/models.py:113-126).  The naming rules of
myrtle_vision_tpu/utils/export.py, copied (the port imports nothing of
the JAX package): ``transformer.layers.N.0.fn.fn.to_qkv.weight`` etc.,
flax (in, out) kernels transposed to torch (out, in) weights.  A JAX ViT
param tree (numpy arrays) maps onto these names (``_rules``,
``export_torch_state_dict``); the port's modules already carry them, so
its state dicts export by name (``export_state_dict``,
``save_torch_checkpoint``) and import back (``import_torch_state_dict``).
"""
from __future__ import annotations

import numpy as np
import torch

# (JAX param path, reference name template, is_linear_kernel)
_BACKBONE = [
    (("pos_embedding",), "pos_embedding", False),
    (("pos_embedding_det",), "pos_embedding_det", False),
    (("cls_token",), "cls_token", False),
    (("det_tokens",), "det_tokens", False),
    (("patch_to_embedding", "kernel"), "patch_to_embedding.weight", True),
    (("patch_to_embedding", "bias"), "patch_to_embedding.bias", False),
]

_LAYER = [
    (("attn_norm", "scale"), "transformer.layers.{i}.0.fn.norm.weight",
     False),
    (("attn_norm", "bias"), "transformer.layers.{i}.0.fn.norm.bias", False),
    (("attn", "to_qkv", "kernel"),
     "transformer.layers.{i}.0.fn.fn.to_qkv.weight", True),
    (("attn", "to_qkv", "bias"),
     "transformer.layers.{i}.0.fn.fn.to_qkv.bias", False),
    (("attn", "to_out", "kernel"),
     "transformer.layers.{i}.0.fn.fn.to_out.0.weight", True),
    (("attn", "to_out", "bias"),
     "transformer.layers.{i}.0.fn.fn.to_out.0.bias", False),
    (("ffn_norm", "scale"), "transformer.layers.{i}.1.fn.norm.weight",
     False),
    (("ffn_norm", "bias"), "transformer.layers.{i}.1.fn.norm.bias", False),
    (("ffn", "fc1", "kernel"),
     "transformer.layers.{i}.1.fn.fn.net.0.weight", True),
    (("ffn", "fc1", "bias"),
     "transformer.layers.{i}.1.fn.fn.net.0.bias", False),
    (("ffn", "fc2", "kernel"),
     "transformer.layers.{i}.1.fn.fn.net.3.weight", True),
    (("ffn", "fc2", "bias"),
     "transformer.layers.{i}.1.fn.fn.net.3.bias", False),
]

_DECODER = {
    "classification": [
        (("decoder", "norm", "scale"), "decoder.norm.weight", False),
        (("decoder", "norm", "bias"), "decoder.norm.bias", False),
        (("decoder", "linear", "kernel"), "decoder.linear.weight", True),
        (("decoder", "linear", "bias"), "decoder.linear.bias", False),
    ],
    "segmentation": [
        (("decoder", "norm", "scale"), "decoder.norm.weight", False),
        (("decoder", "norm", "bias"), "decoder.norm.bias", False),
        (("decoder", "linear", "kernel"), "decoder.linear.weight", True),
        (("decoder", "linear", "bias"), "decoder.linear.bias", False),
    ],
    "detection": [
        (("decoder", "class_embed", "kernel"),
         "decoder.class_embed.weight", True),
        (("decoder", "class_embed", "bias"),
         "decoder.class_embed.bias", False),
        (("decoder", "bbox_embed", "kernel"),
         "decoder.bbox_embed.weight", True),
        (("decoder", "bbox_embed", "bias"),
         "decoder.bbox_embed.bias", False),
    ],
}


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return node


def _rules(params, decoder: str):
    depth = len(
        [k for k in params["transformer"] if k.startswith("layers_")]
    )
    return _rules_at(depth, decoder)


def _rules_at(depth: int, decoder: str):
    """(JAX param path, reference name, is_linear_kernel) of every
    parameter of a ``depth``-layer ViT with ``decoder``."""
    rules = list(_BACKBONE)
    for i in range(depth):
        for path, name, is_kernel in _LAYER:
            rules.append(
                (("transformer", f"layers_{i}") + path, name.format(i=i),
                 is_kernel)
            )
    rules += _DECODER[decoder]
    return rules


def _qat_name(name: str) -> str:
    """Reference module name -> its QAT-prepared name: the reference's
    prepare_qat for the stateless float formats wraps every Linear and
    LayerNorm in Sequential(activation_pre_process, module), so each
    module parameter gains one ``.1`` path component
    (``patch_to_embedding.weight`` -> ``patch_to_embedding.1.weight``);
    token parameters are unaffected."""
    for suffix in (".weight", ".bias"):
        if name.endswith(suffix):
            return name[: -len(suffix)] + ".1" + suffix
    return name


def export_torch_state_dict(params, decoder: str,
                            qat_wrapped: bool = False) -> dict:
    """Param tree -> {reference torch name: numpy array} in fp32;
    ``qat_wrapped`` emits the QAT-prepared names (see _qat_name)."""
    sd = {}
    for path, name, is_kernel in _rules(params, decoder):
        arr = np.array(_get(params, path), np.float32, copy=True)
        if is_kernel:
            arr = np.ascontiguousarray(arr.T)  # flax (in,out)->torch (out,in)
        sd[_qat_name(name) if qat_wrapped else name] = arr
    return sd


def depth_of(state_dict) -> int:
    """The layer count of a reference-named state dict (plain or
    QAT-prepared names)."""
    return len({name.split(".")[2] for name in state_dict
                if name.startswith("transformer.layers.")})


def export_state_dict(state_dict, decoder: str,
                      qat_wrapped: bool = False) -> dict:
    """A port model's state dict -> {reference torch name: fp32 CPU
    tensor} of every parameter the reference names, as
    ``export_torch_state_dict`` writes them from the JAX tree of the same
    weights (bit for bit: a torch (out, in) weight is the flax kernel
    transposed); observers and other buffers are left out, as the JAX
    export leaves its ``quant`` collection out.  ``qat_wrapped`` emits
    the QAT-prepared names (see _qat_name)."""
    sd = {}
    for _, name, _ in _rules_at(depth_of(state_dict), decoder):
        t = state_dict[name].detach().to("cpu", torch.float32)
        sd[_qat_name(name) if qat_wrapped else name] = t.contiguous().clone()
    return sd


def save_torch_checkpoint(state_dict, decoder: str, filepath: str,
                          qat_wrapped: bool = False):
    """torch.save the exported state dict (the reference / FPGA hand-off
    format) of a port model's ``state_dict``."""
    torch.save(export_state_dict(state_dict, decoder, qat_wrapped), filepath)


def import_torch_state_dict(own, state_dict, decoder: str) -> dict:
    """A reference-format torch state dict merged into ``own``, a port
    model's state dict (the inverse of export): every parameter the
    reference names, found under its plain or its QAT-prepared name (see
    _qat_name), replaces ``own``'s as fp32; keys it does not name are
    ignored (the reference model carries extra quantizer buffers in some
    formats), and what it lacks (the observers) keeps ``own``'s value.  A
    shape mismatch raises, and so do fewer than half of the expected
    parameters (an unrecognised layout would otherwise load a model near
    its initialisation)."""
    merged = dict(own)
    rules = _rules_at(depth_of(own), decoder)
    found = 0
    for _, name, _ in rules:
        key = name if name in state_dict else _qat_name(name)
        if key not in state_dict:
            continue
        found += 1
        value = torch.as_tensor(state_dict[key])
        if tuple(value.shape) != tuple(own[name].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, the model "
                             f"has {tuple(own[name].shape)}")
        merged[name] = value.to(torch.float32)
    if found * 2 < len(rules):
        raise ValueError(
            f"only {found}/{len(rules)} expected parameters found in the "
            "torch state dict: unrecognized checkpoint layout")
    return merged
