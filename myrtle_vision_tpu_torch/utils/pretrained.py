"""timm ViT state dicts -> JAX-layout param update trees: the mapping of
myrtle_vision_tpu/utils/pretrained.py (reference
src/myrtle_vision/utils/models.py:154-223), copied (the port imports
nothing of the JAX package).  utils/convert.py turns the tree into the
port's state dict with the export naming rules.

The classifier head is dropped, and the conv patch embedding becomes the
Linear patch embedding with the (O, I, H, W) -> ((H, W, I), O)
permutation.  Sources: a timm model name (needs ``timm`` and its
download) or a ``.pth`` of a timm-style state dict.
"""
from __future__ import annotations

import re

import numpy as np

# timm name -> (JAX param path, transform)
_RULES = [
    (r"^pos_embed$", ("pos_embedding",), "none"),
    (r"^cls_token$", ("cls_token",), "none"),
    (r"^patch_embed\.proj\.weight$", ("patch_to_embedding", "kernel"),
     "patch_conv"),
    (r"^patch_embed\.proj\.bias$", ("patch_to_embedding", "bias"), "none"),
    (r"^blocks\.([0-9]+)\.norm1\.weight$",
     ("transformer", "layers_{0}", "attn_norm", "scale"), "none"),
    (r"^blocks\.([0-9]+)\.norm1\.bias$",
     ("transformer", "layers_{0}", "attn_norm", "bias"), "none"),
    (r"^blocks\.([0-9]+)\.attn\.qkv\.weight$",
     ("transformer", "layers_{0}", "attn", "to_qkv", "kernel"), "linear_w"),
    (r"^blocks\.([0-9]+)\.attn\.qkv\.bias$",
     ("transformer", "layers_{0}", "attn", "to_qkv", "bias"), "none"),
    (r"^blocks\.([0-9]+)\.attn\.proj\.weight$",
     ("transformer", "layers_{0}", "attn", "to_out", "kernel"), "linear_w"),
    (r"^blocks\.([0-9]+)\.attn\.proj\.bias$",
     ("transformer", "layers_{0}", "attn", "to_out", "bias"), "none"),
    (r"^blocks\.([0-9]+)\.norm2\.weight$",
     ("transformer", "layers_{0}", "ffn_norm", "scale"), "none"),
    (r"^blocks\.([0-9]+)\.norm2\.bias$",
     ("transformer", "layers_{0}", "ffn_norm", "bias"), "none"),
    (r"^blocks\.([0-9]+)\.mlp\.fc1\.weight$",
     ("transformer", "layers_{0}", "ffn", "fc1", "kernel"), "linear_w"),
    (r"^blocks\.([0-9]+)\.mlp\.fc1\.bias$",
     ("transformer", "layers_{0}", "ffn", "fc1", "bias"), "none"),
    (r"^blocks\.([0-9]+)\.mlp\.fc2\.weight$",
     ("transformer", "layers_{0}", "ffn", "fc2", "kernel"), "linear_w"),
    (r"^blocks\.([0-9]+)\.mlp\.fc2\.bias$",
     ("transformer", "layers_{0}", "ffn", "fc2", "bias"), "none"),
]

# classifier head weights are intentionally not loaded
# (reference utils/models.py:190-198)
_IGNORE = [r"^norm\.weight$", r"^norm\.bias$", r"^head\.weight$",
           r"^head\.bias$"]


def rename_timm_state_dict(state_dict: dict) -> dict:
    """A timm-style flat state dict (numpy arrays) -> a nested update tree
    in the JAX layout.  Unmatched keys raise, as the reference asserts no
    unexpected keys on load (classification/train.py:141-148)."""
    out: dict = {}
    unmatched = []
    for key, value in state_dict.items():
        if any(re.match(p, key) for p in _IGNORE):
            continue
        arr = np.asarray(value)
        for pattern, path_tpl, transform in _RULES:
            m = re.match(pattern, key)
            if m is None:
                continue
            path = tuple(p.format(*m.groups()) for p in path_tpl)
            if transform == "linear_w":
                arr = arr.T  # torch (out,in) -> flax (in,out)
            elif transform == "patch_conv":
                # conv (O,I,H,W) -> linear kernel ((H,W,I), O)
                o, i, h, w = arr.shape
                arr = arr.transpose(0, 2, 3, 1).reshape(o, h * w * i).T
            _set(out, path, arr)
            break
        else:
            unmatched.append(key)
    if unmatched:
        raise ValueError(f"unexpected keys in pretrained state: {unmatched}")
    return out


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def load_state_dict_from_source(source: str) -> dict:
    """A timm-style state dict (numpy arrays) from a torch checkpoint path
    or, with timm installed, a timm model name."""
    if source.endswith((".pth", ".pt", ".bin", ".ckpt")):
        import torch

        sd = torch.load(source, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        if isinstance(sd, dict) and "model" in sd and isinstance(
            sd["model"], dict
        ):
            sd = sd["model"]
        return {k: v.numpy() for k, v in sd.items()}
    try:
        import timm  # optional, the reference's online path
    except ImportError as e:
        raise RuntimeError(
            f"pretrained_backbone={source!r} looks like a timm model name "
            "but timm is not installed; provide a .pth checkpoint path "
            "instead"
        ) from e
    model = timm.create_model(source, pretrained=True)
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}
