"""RESISC45 classification evaluation CLI (PyTorch port of
classification/test.py).

    python -m myrtle_vision_tpu_torch.classification.test -c <config.json> \
        [--device cuda|cpu]

Evaluates the reference-format ``.pth`` named in
``train_config.checkpoint_path`` (written by
classification/export_checkpoint.py) on the test split and prints the
per-class precision/recall/F1 report.  The configs are the JAX CLI's,
and relative paths resolve against the working directory as there.
``--device`` defaults to ``cuda``; without a CUDA device that raises, it
never carries on on the CPU.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.resisc45 import Resisc45
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.training.classification import make_predict_fn
from myrtle_vision_tpu_torch.utils.config import get_label_list, parse_config
from myrtle_vision_tpu_torch.utils.convert import load_reference_checkpoint


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: expected cuda or cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device "
            "cpu to evaluate on the CPU)"
        )
    return device


def evaluate_dataset(predict_fn, loader):
    """(ground truth, prediction, fp32 logits) over a dataset, padding
    rows dropped."""
    gts, logits = [], []
    for batch in loader.epoch(0):
        n = int(batch.pop("_n_valid", len(batch["label"])))
        logits.append(predict_fn(batch["image"])[:n].cpu())
        gts.append(batch["label"][:n].cpu())
    logits = torch.cat(logits)
    return torch.cat(gts).numpy(), logits.argmax(-1).numpy(), logits


def classification_report(gts, preds, num_classes, target_names):
    """Per-class P/R/F1 report (classification/test.py): sklearn's when it
    is installed, else the same numbers from numpy."""
    try:
        from sklearn.metrics import classification_report as skl_report

        return skl_report(
            gts, preds, labels=np.arange(num_classes),
            target_names=target_names, zero_division=0,
        )
    except ImportError:
        lines = [f"{'':>25} {'precision':>9} {'recall':>9} {'f1':>9} "
                 f"{'support':>9}"]
        for c, name in enumerate(target_names):
            tp = np.sum((preds == c) & (gts == c))
            fp = np.sum((preds == c) & (gts != c))
            fn = np.sum((preds != c) & (gts == c))
            p = tp / max(tp + fp, 1)
            r = tp / max(tp + fn, 1)
            f1 = 2 * p * r / max(p + r, 1e-12)
            lines.append(
                f"{name:>25} {p:9.2f} {r:9.2f} {f1:9.2f} "
                f"{int(np.sum(gts == c)):9d}"
            )
        acc = float(np.mean(gts == preds))
        lines.append(f"\n{'accuracy':>25} {acc:29.2f}")
        return "\n".join(lines)


def build_eval(config, device):
    """(model, test-split loader, data config) as the CLI evaluates them:
    dropout zeroed, the checkpoint loaded strictly."""
    train_config = config["train_config"]
    data_config = parse_config(config["data_config_path"])
    dataset_path = data_config["dataset_path"]
    label_map_path = data_config["label_map"]

    testset = Resisc45(
        mode="eval",
        dataset_path=dataset_path,
        imagepaths=data_config["test_files"],
        label_map_path=label_map_path,
        transform_config=data_config["transform_ops_val"],
    )
    loader = DataLoader(
        testset,
        batch_size=train_config["local_batch_size"],
        device=device,
        drop_last=train_config["drop_last_batch"],
        pad_last=True,
    )

    # dropout removed for eval (reference test.py:47-49)
    config["vit_config"]["dropout"] = 0.0
    config["vit_config"]["emb_dropout"] = 0.0
    model = ViT(**vit_kwargs_from_config(config, data_config), device=device)

    if not train_config["checkpoint_path"]:
        raise ValueError("Must provide a checkpoint path in the config file")
    model.load_state_dict(
        load_reference_checkpoint(train_config["checkpoint_path"]),
        strict=True,
    )
    return model, loader, data_config


def run_eval(config, device):
    """Evaluate, print the report, return (gts, preds, logits)."""
    model, loader, data_config = build_eval(config, device)
    gts, preds, logits = evaluate_dataset(make_predict_fn(model), loader)
    print(
        classification_report(
            gts,
            preds,
            data_config["number_of_classes"],
            get_label_list(data_config["dataset_path"],
                           data_config["label_map"]),
        )
    )
    return gts, preds, logits


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-c", "--config", type=str, help="JSON file for configuration"
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        config = json.loads(f.read())
    return run_eval(config, resolve_device(args.device))


if __name__ == "__main__":
    main()
