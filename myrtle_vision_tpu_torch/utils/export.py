"""The reference's state-dict naming: a JAX ViT param tree (numpy
arrays) -> {reference torch name: array}.  The naming rules of
myrtle_vision_tpu/utils/export.py, copied (the port imports nothing of
the JAX package): ``transformer.layers.N.0.fn.fn.to_qkv.weight`` etc.,
flax (in, out) kernels transposed to torch (out, in) weights.
"""
from __future__ import annotations

import numpy as np

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
