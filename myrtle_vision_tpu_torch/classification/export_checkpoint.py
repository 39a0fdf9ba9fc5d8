"""Export a trained checkpoint to the reference torch state-dict format
(PyTorch port of classification/export_checkpoint.py).

    python -m myrtle_vision_tpu_torch.classification.export_checkpoint \\
        -c <config.json> --output model.pth [--wrap_train_ckpt] \\
        [--device cuda|cpu]

The reference's torch checkpoints are its FPGA deployment hand-off format
(reference: classification/README.md:31-33).  This CLI reads the port
checkpoint (or reference ``.pth``) named in ``train_config.checkpoint_path``
into the config's model, strictly, and writes its parameters under the
reference's module names (utils/export.py), fp32, as the JAX CLI writes
them from the same weights: any of the three decoders, with the task's
config.  In a stateless float format (FP16_16, FP16_32, TF32) the names
carry the reference's QAT-prepared ``.1`` component, so that the file
loads into a reference model built with that format.  The INT8
observers are not exported, as the JAX CLI leaves its ``quant``
collection out.  ``--wrap_train_ckpt`` writes the reference's
{"model", "iteration"} training-checkpoint envelope, which the
reference's train and eval CLIs read through their ``checkpoint_path``.
A distillation config (``distiller_config``) exports the student's
state dict alone, as the JAX CLI does (the reference's distill runs save
the student): utils/convert.py ``load_reference_checkpoint`` reads the
student of the trainer's DistillWrapper checkpoint, in any format (a
PyTorchINT8 student's observers left out with the rest, its token's two
included).  ``--device`` defaults to ``cuda``; without a CUDA device that
raises.
"""
from __future__ import annotations

import argparse
import json

import torch

from myrtle_vision_tpu_torch.classification.test import resolve_device
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.utils.config import parse_config
from myrtle_vision_tpu_torch.utils.convert import (
    checkpoint_q_format,
    load_reference_checkpoint,
)
from myrtle_vision_tpu_torch.utils.export import (
    export_state_dict,
    save_torch_checkpoint,
)


def export(config, output, wrap_train_ckpt=False, device="cpu"):
    """Write ``output``."""
    train_config = config["train_config"]
    path = train_config["checkpoint_path"]
    if not path:
        raise ValueError("Must provide a checkpoint path in the config file")
    data_config = parse_config(config["data_config_path"])
    model = ViT(**vit_kwargs_from_config(config, data_config), device=device)
    fmt = checkpoint_q_format(path)
    if fmt is not None and fmt != model.q_format.name:
        raise ValueError(f"{path} holds a q_format {fmt} model; the config "
                         f"asks for {model.q_format.name}")
    model.load_state_dict(load_reference_checkpoint(path), strict=True)
    if wrap_train_ckpt:
        iteration = torch.load(path, map_location="cpu",
                               weights_only=True).get("iteration", 0)
        sd = export_state_dict(model.state_dict(), model.decoder_name,
                               qat_wrapped=model.float_format)
        torch.save({"model": sd, "iteration": int(iteration)}, output)
    else:
        save_torch_checkpoint(model.state_dict(), model.decoder_name, output,
                              qat_wrapped=model.float_format)
    print(f"exported {path} -> {output} (reference torch format, "
          f"decoder={model.decoder_name})")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-c", "--config", type=str, help="JSON file for configuration"
    )
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument(
        "--wrap_train_ckpt",
        action="store_true",
        help="Wrap in the reference's {model, iteration} training-checkpoint"
        " envelope so the reference train/test CLIs load it directly",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        config = json.loads(f.read())
    return export(config, args.output, args.wrap_train_ckpt,
                  resolve_device(args.device))


if __name__ == "__main__":
    main()
