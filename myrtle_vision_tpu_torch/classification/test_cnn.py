"""CNN-baseline evaluation CLI, the distillation teacher's check (PyTorch
port of classification/test_cnn.py).

    python -m myrtle_vision_tpu_torch.classification.test_cnn \\
        --model resnet50 --cnn_weights weights.pth [--use_val_set] \\
        [--data_config data_configs/data_config.json] [--device cuda|cpu]

Evaluates a finetuned torchvision-layout CNN checkpoint (``finetune_cnn``
writes one) on the RESISC45 test split, or the validation split with
``--use_val_set``, batch 32, batch norm in eval mode, and prints the eval
CLI's per-class classification report (reference:
classification/test_cnn.py).  Any of ``ALL_CNN_ARCHS``: resnet18,
resnet50, squeezenet1_0 / 1_1, mobilenet_v2, mnasnet1_0,
shufflenet_v2_x1_0 (models/resnet.py, models/cnn.py).  ``--device``
defaults to ``cuda``; without a CUDA device that raises, it never
carries on on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from myrtle_vision_tpu_torch.classification.test import (
    classification_report,
    resolve_device,
)
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.resisc45 import Resisc45
from myrtle_vision_tpu_torch.models.cnn import (
    ALL_CNN_ARCHS,
    apply_any_torch_sd,
)
from myrtle_vision_tpu_torch.models.resnet import read_state_dict
from myrtle_vision_tpu_torch.utils.config import get_label_list, parse_config

SUPPORTED = ALL_CNN_ARCHS


def test_cnn(model_name, cnn_weights, use_val_set=False,
             data_config_path="data_configs/data_config.json",
             device="cpu"):
    """Evaluate, print the report; returns (ground truth, predictions,
    fp32 logits) as numpy, numpy and a CPU tensor."""
    if model_name not in SUPPORTED:
        raise SystemExit(
            f"unsupported model {model_name!r}; supported: {SUPPORTED}"
        )
    data_config = parse_config(data_config_path)
    dataset_path = data_config["dataset_path"]
    label_map_path = data_config["label_map"]
    evalset = Resisc45(
        mode="eval",
        dataset_path=dataset_path,
        imagepaths=(data_config["valid_files"] if use_val_set
                    else data_config["test_files"]),
        label_map_path=label_map_path,
        transform_config=data_config["transform_ops_val"],
    )
    eval_loader = DataLoader(evalset, batch_size=32, device=device,
                             drop_last=False)
    params = {k: v.to(device) for k, v in read_state_dict(cnn_weights).items()}

    gts, logits = [], []
    with torch.inference_mode():
        for batch in eval_loader.epoch(0):
            logits.append(apply_any_torch_sd(params, batch["image"],
                                             model_name).cpu())
            gts.append(batch["label"].cpu())
    gts, logits = torch.cat(gts).numpy(), torch.cat(logits)
    preds = logits.argmax(-1).numpy()
    print(classification_report(gts, preds, data_config["number_of_classes"],
                                get_label_list(dataset_path, label_map_path)))
    return gts, preds, logits


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="resnet50",
                        help=f"CNN architecture, one of {SUPPORTED}")
    parser.add_argument(
        "--cnn_weights", type=str, required=True,
        help="Path to the pretrained weights of the CNN model (.pth file)")
    parser.add_argument("--use_val_set", action="store_true",
                        help="Evaluate on the validation split instead of "
                        "test")
    parser.add_argument("--data_config", type=str,
                        default="data_configs/data_config.json")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return test_cnn(args.model, args.cnn_weights, args.use_val_set,
                    args.data_config, resolve_device(args.device))


if __name__ == "__main__":
    main()
