"""DIOR detection evaluation CLI: COCO mAP (PyTorch port of
detection/test.py).

    python -m myrtle_vision_tpu_torch.detection.test -c <config.json> \
        [--device cuda|cpu]

Evaluates the checkpoint named in ``train_config.checkpoint_path`` (a
reference-format ``.pth``, as classification/export_checkpoint.py and
myrtle_vision_tpu/utils/export.py write it, or a port checkpoint) on the
test split through ``post_process`` and the COCO evaluator, and prints
the 12-number summary.  The model is the config's ``q_format``: FP32, a
stateless float format (FP16_16, FP16_32, TF32) or PyTorchINT8 (the
simulation before convert, its observers from the checkpoint and frozen:
full fp32 products, the exact erf); a port checkpoint carries the format
it was trained in, and one of another format is refused.  The configs are the JAX CLI's, and relative paths
resolve against the working directory as there.  ``--device`` defaults
to ``cuda``; without a CUDA device that raises, it never carries on on
the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

from myrtle_vision_tpu_torch.classification.test import resolve_device
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.coco import CocoDetection
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.training.detection import (
    evaluate_coco,
    make_detect_fn,
)
from myrtle_vision_tpu_torch.transforms import detection as T
from myrtle_vision_tpu_torch.utils.config import parse_config
from myrtle_vision_tpu_torch.utils.convert import (
    checkpoint_q_format,
    load_reference_checkpoint,
)


def build_eval(config, device):
    """(model, test-split loader, test set) as the CLI evaluates them:
    dropout zeroed, the checkpoint loaded strictly, batches of
    ``local_batch_size`` images, the last one ragged."""
    train_config = config["train_config"]
    vit_config = config["vit_config"]
    data_config = parse_config(config["data_config_path"])
    num_det_tokens = vit_config.get("num_det_tokens", 100)
    dataset_path = data_config["dataset_path"]

    testset = CocoDetection(
        os.path.join(dataset_path, data_config["test_images"]),
        os.path.join(dataset_path, "annotations",
                     data_config["test_annotations"]),
        T.from_config(data_config["transform_ops_val"]),
        subset=data_config.get("test_subset"),
    )
    loader = DataLoader(
        testset,
        batch_size=train_config["local_batch_size"],
        device=device,
        drop_last=False,
        collate_fn=lambda items: T.collate_detection(
            items, max_boxes=num_det_tokens),
    )

    config["vit_config"]["dropout"] = 0.0
    config["vit_config"]["emb_dropout"] = 0.0
    model = ViT(**vit_kwargs_from_config(config, data_config), device=device)
    path = train_config["checkpoint_path"]
    if not path:
        raise ValueError("Must provide a checkpoint path in the config file")
    fmt = checkpoint_q_format(path)
    if fmt is not None and fmt != model.q_format.name:
        raise ValueError(f"{path} holds a q_format {fmt} model; the config "
                         f"asks for {model.q_format.name}")
    model.load_state_dict(load_reference_checkpoint(path), strict=True)
    return model, loader, testset


def run_eval(config, device):
    """Evaluate and print the summary; returns (evaluator, {image id:
    {"scores", "labels", "boxes"}})."""
    model, loader, testset = build_eval(config, device)
    predictions = {}
    evaluator = evaluate_coco(make_detect_fn(model), loader, testset.coco,
                              predictions=predictions)
    return evaluator, predictions


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
