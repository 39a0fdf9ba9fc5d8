"""DLRSD segmentation evaluation CLI: mIoU and per-class IoU (PyTorch
port of segmentation/test.py).

    python -m myrtle_vision_tpu_torch.segmentation.test -c <config.json> \\
        [--visualize_dir DIR] [--visualize_n N] [--device cuda|cpu]

Evaluates the checkpoint named in ``train_config.checkpoint_path`` (a port
checkpoint, as the segmentation train CLI and the import CLI write it,
or a reference-format ``.pth``) on the test split and prints the mIoU and
each class's IoU under the label map's names (reference
segmentation/test.py:79-88).  The model is the config's ``q_format``:
FP32, a stateless float format (FP16_16, FP16_32, TF32) or PyTorchINT8
(the simulation before convert, its observers from the checkpoint and
frozen); a port checkpoint carries the format it was trained in, and one
of another format is refused.  The last batch is padded to the local
batch and only its real images are counted.  ``--visualize_dir`` writes
the first ``--visualize_n`` predictions and labels as RGB PNGs
(``pred_i.png``, ``label_i.png``) in the DLRSD palette (utils/colors.py).
The configs are the JAX CLI's, and relative paths resolve against the
working directory as there.  ``--device`` defaults to ``cuda``; without a
CUDA device that raises, it never carries on on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

from PIL import Image

from myrtle_vision_tpu_torch.classification.test import resolve_device
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.dlrsd import Dlrsd
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.training.classification import make_predict_fn
from myrtle_vision_tpu_torch.utils.colors import colorize_mask
from myrtle_vision_tpu_torch.utils.config import get_label_list, parse_config
from myrtle_vision_tpu_torch.utils.convert import (
    checkpoint_q_format,
    load_reference_checkpoint,
)
from myrtle_vision_tpu_torch.utils.metrics import MIoU


def build_eval(config, device):
    """(model, test-split loader, data config) as the CLI evaluates them:
    dropout zeroed, the checkpoint loaded strictly, batches of
    ``local_batch_size`` images, the last one padded."""
    train_config = config["train_config"]
    data_config = parse_config(config["data_config_path"])
    testset = Dlrsd(
        mode="test",
        dataset_path=data_config["dataset_path"],
        imagepaths=data_config["test_files"],
        label_map_path=data_config["label_map"],
        transform_config=data_config["transform_ops_val"],
    )
    loader = DataLoader(
        testset,
        batch_size=train_config["local_batch_size"],
        device=device,
        drop_last=train_config["drop_last_batch"],
        pad_last=True,
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
    return model, loader, data_config


def evaluate(predict_fn, loader, n_classes, visualize_dir=None,
             visualize_n=8):
    """The streaming MIoU over a loader's real images (padding dropped);
    the first ``visualize_n`` predictions and labels written as PNGs into
    ``visualize_dir`` when it is given."""
    miou = MIoU(num_classes=n_classes)
    n_written = 0
    for batch in loader.epoch(0):
        n = int(batch.pop("_n_valid", len(batch["label"])))
        preds = predict_fn(batch["image"]).argmax(-1)[:n]
        labels = batch["label"][:n]
        miou.add_batch(preds, labels)
        if visualize_dir is not None and n_written < visualize_n:
            os.makedirs(visualize_dir, exist_ok=True)
            for pred, label in zip(preds.cpu().numpy(),
                                   labels.cpu().numpy()):
                if n_written >= visualize_n:
                    break
                Image.fromarray(colorize_mask(pred)).save(
                    os.path.join(visualize_dir, f"pred_{n_written}.png"))
                Image.fromarray(colorize_mask(label)).save(
                    os.path.join(visualize_dir, f"label_{n_written}.png"))
                n_written += 1
    return miou


def test_seg(config, device, visualize_dir=None, visualize_n=8):
    """Evaluate and print the mIoU and the per-class IoU; returns the
    MIoU accumulator."""
    model, loader, data_config = build_eval(config, device)
    miou = evaluate(make_predict_fn(model), loader,
                    data_config["number_of_classes"], visualize_dir,
                    visualize_n)
    label_list = get_label_list(data_config["dataset_path"],
                                data_config["label_map"])
    print(f"mIoU: {miou.get_miou():.4f}")
    for name, iou in zip(label_list, miou.get_per_class_iou()):
        print(f"  {name:>15}: {iou:.4f}")
    return miou


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-c", "--config", type=str, help="JSON file for configuration"
    )
    parser.add_argument(
        "--visualize_dir", type=str, default=None,
        help="write colorized prediction/label PNGs here",
    )
    parser.add_argument("--visualize_n", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        config = json.loads(f.read())
    return test_seg(config, resolve_device(args.device), args.visualize_dir,
                    args.visualize_n)


if __name__ == "__main__":
    main()
