"""Import a reference-format torch checkpoint into a port checkpoint
(PyTorch port of classification/import_checkpoint.py).

    python -m myrtle_vision_tpu_torch.classification.import_checkpoint \\
        -c <config.json> --torch_ckpt reference.pth --output imported \\
        [--device cuda|cpu]

The inverse of export_checkpoint.py: reads a ``.pth`` in the reference's
module naming, a plain state dict (the FPGA hand-off format) or the
{"model", "iteration"} training-checkpoint envelope (reference
utils/models.py:113-141), plain or QAT-prepared (``.1``) names, into the
config's model (utils/export.py ``import_torch_state_dict``: keys it does
not name are ignored, the INT8 observers keep their fresh state), and
writes a port checkpoint without optimizer state (utils/checkpoint.py
``save_model``, the model's ``q_format`` and the iteration carried) that
the port's eval CLIs read through ``train_config.checkpoint_path`` and its
train CLIs resume from.  ``--device`` defaults to ``cuda``; without a
CUDA device that raises.
"""
from __future__ import annotations

import argparse
import json

import torch

from myrtle_vision_tpu_torch.classification.test import resolve_device
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.utils.checkpoint import save_model
from myrtle_vision_tpu_torch.utils.config import parse_config
from myrtle_vision_tpu_torch.utils.convert import require_torch_file
from myrtle_vision_tpu_torch.utils.export import import_torch_state_dict


def import_checkpoint(config, torch_ckpt, output, device="cpu"):
    """Write ``output``; returns the model with the imported weights."""
    data_config = parse_config(config["data_config_path"])
    model = ViT(**vit_kwargs_from_config(config, data_config), device=device)
    require_torch_file(torch_ckpt)
    payload = torch.load(torch_ckpt, map_location="cpu", weights_only=True)
    iteration = 0
    if isinstance(payload, dict) and isinstance(payload.get("model"), dict):
        iteration = int(payload.get("iteration", 0))
        payload = payload["model"]
    model.load_state_dict(import_torch_state_dict(
        model.state_dict(), payload, model.decoder_name), strict=True)
    save_model(model, output, iteration)
    print(f"imported {torch_ckpt} (iteration {iteration}) -> {output} "
          f"(decoder={model.decoder_name})")
    return model


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-c", "--config", type=str, help="JSON file for configuration"
    )
    parser.add_argument("--torch_ckpt", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        config = json.loads(f.read())
    return import_checkpoint(config, args.torch_ckpt, args.output,
                             resolve_device(args.device))


if __name__ == "__main__":
    main()
