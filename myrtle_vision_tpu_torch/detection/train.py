"""DIOR object detection trainer: YOLOS-style ViT + DETR loss (PyTorch
port of detection/train.py) on one device.

    python -m myrtle_vision_tpu_torch.detection.train \\
        -c <config.json> [--device cuda|cpu]

The configs are the JAX CLI's, and relative paths resolve against the
working directory as there.  The loop is the JAX CLI's: the LR of each
epoch from the cosine/warmup schedule, one ``Iteration i`` line per
optimizer step (loss, ce, bbox, giou), per-epoch COCO validation on the
val split with its summary and an ``Epoch`` line, ``vit_best`` (with
{"ap": AP} beside it) whenever the epoch's AP is at least the best so far,
and ``vit_{iteration:06}`` at the end.  One optimizer step is
``global_batch_size`` images, collated together (padded to one canvas),
split into ``global_batch_size / local_batch_size`` micro-batches whose
gradients sum; the Hungarian matcher runs inside each micro-batch's loss.
Checkpoints are ``torch.save`` files (utils/checkpoint.py) that the
port's detection eval CLI reads as they are; ``checkpoint_path``
resumes from one.  ``--device`` defaults to ``cuda``; without a CUDA
device that raises, it never carries on on the CPU.  Multi-device
training and TensorBoard scalars are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from datetime import datetime

import torch

from myrtle_vision_tpu_torch.classification.test import resolve_device
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.coco import CocoDetection
from myrtle_vision_tpu_torch.models.detector import build_weight_dict
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.training.detection import (
    evaluate_coco,
    make_detect_fn,
    make_loss_fn,
)
from myrtle_vision_tpu_torch.training.optim import create_optimizer, lr_at_epoch
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)
from myrtle_vision_tpu_torch.transforms import detection as T
from myrtle_vision_tpu_torch.utils.checkpoint import (
    prepare_model_and_load_ckpt,
    save_checkpoint,
)
from myrtle_vision_tpu_torch.utils.config import (
    get_batch_sizes,
    parse_config,
    seed_everything,
)
from myrtle_vision_tpu_torch.utils.convert import load_pretrained_backbone

# the fields of a collated batch that the loss reads
STEP_KEYS = ("image", "labels", "boxes", "valid")


def build_train(config, device):
    """(model, train loader, validation loader, validation set, (micro-batch
    size, micro-batches per step)) as the CLI trains them: the seed set
    first (it also fixes the order the train split is read in), the train
    loader shuffled and yielding one optimizer step's images per batch on
    one canvas, the model initialised from the seed and, when the config
    names one, the pretrained backbone loaded."""
    train_config = config["train_config"]
    vit_config = config["vit_config"]
    data_config = parse_config(config["data_config_path"])
    if vit_config["q_format"] != "FP32":
        raise NotImplementedError(
            f"detection training in q_format {vit_config['q_format']} is not "
            "ported yet; see ROADMAP.md A5a (float formats) and A5b (INT8)")
    seed = train_config["seed"]
    seed_everything(seed)
    num_det_tokens = vit_config.get("num_det_tokens", 100)

    batch_size, n_batch_accum = get_batch_sizes(
        train_config["local_batch_size"], 1,
        train_config["global_batch_size"], verbose=True,
    )
    dataset_path = data_config["dataset_path"]

    def split(images, annotations, transforms, subset):
        return CocoDetection(
            os.path.join(dataset_path, data_config[images]),
            os.path.join(dataset_path, "annotations",
                         data_config[annotations]),
            T.from_config(data_config[transforms]),
            subset=data_config.get(subset),
        )

    def collate(items):
        return T.collate_detection(items, max_boxes=num_det_tokens)

    trainset = split("train_images", "train_annotations",
                     "transform_ops_train", "train_subset")
    valset = split("valid_images", "valid_annotations", "transform_ops_val",
                   "valid_subset")
    train_loader = DataLoader(trainset, batch_size=batch_size * n_batch_accum,
                              device=device, shuffle=True, seed=seed,
                              drop_last=train_config["drop_last_batch"],
                              collate_fn=collate)
    val_loader = DataLoader(valset, batch_size=batch_size, device=device,
                            drop_last=False, collate_fn=collate)

    model = ViT(**vit_kwargs_from_config(config, data_config), device=device,
                generator=torch.Generator().manual_seed(seed))
    pretrained = train_config.get("pretrained_backbone")
    if pretrained is not None:
        try:
            load_pretrained_backbone(model, pretrained)
            print(f"loaded pretrained backbone: {pretrained}")
        except RuntimeError as e:
            print(f"WARNING: pretrained backbone unavailable ({e}); "
                  "training from scratch")
    return (model, train_loader, val_loader, valset,
            (batch_size, n_batch_accum))


def micro_batches(batch, n_accum, micro):
    """A step's collated batch -> its fields the loss reads, each
    [n_accum, micro, ...]."""
    return {k: batch[k].view(n_accum, micro, *batch[k].shape[1:])
            for k in STEP_KEYS}


def train(config, device):
    train_config = config["train_config"]
    epochs = train_config["epochs"]
    output_directory = train_config["output_directory"]
    n_classes = parse_config(config["data_config_path"])["number_of_classes"]

    model, train_loader, val_loader, valset, (batch_size, n_batch_accum) = \
        build_train(config, device)
    os.makedirs(output_directory, exist_ok=True)
    print("output directory:", output_directory)
    print(f"device: {device}, local_batch={batch_size}, "
          f"n_accum={n_batch_accum}")

    state, iteration = prepare_model_and_load_ckpt(
        train_config, TrainState(model, create_optimizer(train_config, model)))
    train_step = make_train_step(
        make_loss_fn(model, n_classes, build_weight_dict(train_config),
                     train_config["eos_coef"]),
        n_batch_accum, clip_grad=train_config.get("clip_grad"))
    detect_fn = make_detect_fn(model)

    best_ap = -1.0
    # epoch offset on resume (the JAX CLI's formula, one device)
    epoch_offset = max(0, int(batch_size * iteration
                              / max(len(train_loader.dataset), 1)))
    for epoch in range(epoch_offset, epochs):
        lr = lr_at_epoch(train_config, epoch)
        epoch_loss = 0.0
        steps = max(len(train_loader), 1)
        t_epoch = time.time()
        for batch in train_loader.epoch(epoch):
            metrics = train_step(
                state, micro_batches(batch, n_batch_accum, batch_size), lr)
            iteration = state.iteration
            loss = float(metrics["loss"])
            epoch_loss += loss / steps
            print(f"Iteration {iteration}:\tloss={loss:.4f}\t"
                  f"ce={float(metrics['loss_ce']):.4f}\t"
                  f"bbox={float(metrics['loss_bbox']):.4f}\t"
                  f"giou={float(metrics['loss_giou']):.4f}")

        evaluator = evaluate_coco(detect_fn, val_loader, valset.coco, epoch)
        ap = float(evaluator.stats[0])
        print(f"Epoch : {epoch + 1} - loss : {epoch_loss:.4f} - "
              f"val AP: {ap:.4f} - time: {time.time() - t_epoch:.1f}s\n")
        if ap >= best_ap:
            best_ap = ap
            save_checkpoint(state, f"{output_directory}/vit_best",
                            extra={"ap": ap})

    save_checkpoint(state, f"{output_directory}/vit_{iteration:06}")
    return state


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
    device = resolve_device(args.device)
    config["train_config"]["output_directory"] += datetime.now().strftime(
        "_%m_%d_%Y_%H_%M_%S"
    )
    return train(config, device)


if __name__ == "__main__":
    main()
