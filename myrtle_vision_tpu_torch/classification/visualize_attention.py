"""Attention-map visualization CLI (PyTorch port of
classification/visualize_attention.py).

    python -m myrtle_vision_tpu_torch.classification.visualize_attention \
        -c <config.json> --image img.jpg --output_dir attn/ [--layer -1] \
        [--device cuda|cpu]

Runs the checkpoint of ``train_config.checkpoint_path`` (a reference
``.pth`` or a port checkpoint, as the eval CLI reads it) on one image
through the validation transform with attention capture
(models/vit.py ``capture_attention``: every Block discrete, the ``xla``
core, each layer's softmax probabilities in depth order) and writes, for
the chosen layer, one grayscale PNG per head of the CLS token's attention
over the patch grid (min-max scaled, upsampled bilinearly to the input
size), plus the head-mean map: ``layer{L}_head{h}.png`` and
``layer{L}_mean.png``, the JAX CLI's files.  ``--layer`` indexes the
layers in depth order.  ``--device`` defaults to ``cuda``; without a CUDA
device that raises, it never carries on on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from PIL import Image

from myrtle_vision_tpu_torch.classification.test import resolve_device
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.transforms.classification import (
    transform_from_config,
)
from myrtle_vision_tpu_torch.utils.config import parse_config
from myrtle_vision_tpu_torch.utils.convert import load_reference_checkpoint


def attention_maps(config, image_path, device):
    """(the model, each layer's (heads, N, N) fp32 probabilities of the
    image as numpy arrays, in depth order)."""
    train_config = config["train_config"]
    data_config = parse_config(config["data_config_path"])
    if not train_config["checkpoint_path"]:
        raise ValueError("Must provide a checkpoint path in the config file")
    vit = ViT(**vit_kwargs_from_config(config, data_config), device=device)
    vit.load_state_dict(
        load_reference_checkpoint(train_config["checkpoint_path"]),
        strict=True)
    vit.eval()
    transform = transform_from_config(data_config["transform_ops_val"])
    img = transform(Image.open(image_path).convert("RGB"),
                    np.random.default_rng(0))
    batch = torch.as_tensor(np.asarray(img), device=device)[None]
    with torch.inference_mode():
        _, probs = vit(batch, capture_attention=True)
    return vit, [p[0].float().cpu().numpy() for p in probs]


def visualize(config, image_path, output_dir, layer=-1, device="cpu"):
    vit, maps = attention_maps(config, image_path, torch.device(device))
    probs = maps[layer]  # (heads, n, n)

    grid = vit.image_size // vit.patch_size
    n_prefix = 1  # CLS token leads the sequence
    cls_attn = probs[:, 0, n_prefix:n_prefix + grid * grid]
    os.makedirs(output_dir, exist_ok=True)

    def save(name, attn_1d):
        a = attn_1d.reshape(grid, grid)
        a = (a - a.min()) / max(a.max() - a.min(), 1e-12)
        im = Image.fromarray((a * 255).astype(np.uint8), "L")
        im = im.resize((vit.image_size, vit.image_size), Image.BILINEAR)
        im.save(os.path.join(output_dir, name))

    for h in range(cls_attn.shape[0]):
        save(f"layer{layer}_head{h}.png", cls_attn[h])
    save(f"layer{layer}_mean.png", cls_attn.mean(0))
    print(
        f"wrote {cls_attn.shape[0] + 1} attention maps "
        f"(layer {layer}, {cls_attn.shape[0]} heads + mean) to {output_dir}"
    )
    return cls_attn


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-c", "--config", type=str, help="JSON file for configuration"
    )
    parser.add_argument("--image", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument(
        "--layer", type=int, default=-1,
        help="transformer layer to visualize (default: last)",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        config = json.loads(f.read())
    return visualize(config, args.image, args.output_dir, args.layer,
                     resolve_device(args.device))


if __name__ == "__main__":
    main()
