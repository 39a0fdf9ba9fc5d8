"""DLRSD semantic segmentation trainer (PyTorch port of
segmentation/train.py) on one device.

    python -m myrtle_vision_tpu_torch.segmentation.train \\
        -c <config.json> [--device cuda|cpu]

The configs are the JAX CLI's, and relative paths resolve against the
working directory as there.  The loop is the port's classification
trainer's, which is the JAX CLI's: the LR of each epoch from the
cosine/warmup schedule, a checkpoint every ``iters_per_checkpoint``
optimizer steps and validation every ``iters_per_val`` (both before the
step, from iteration 0), one ``Iteration i`` line per step (the mean
pixel cross entropy and pixel accuracy) and an ``Epoch`` summary per
epoch, and a final checkpoint.  Validation gives the loss, the pixel
accuracy and the streaming mIoU of the val split and prints ``miou is
...`` (reference segmentation/train.py:35-75).  One optimizer step sums
the gradients of ``global_batch_size / local_batch_size`` micro-batches.
Checkpoints are ``torch.save`` files (utils/checkpoint.py) that the
port's segmentation eval CLI reads as they are; ``checkpoint_path``
resumes from one.  ``vit_config.q_format`` FP32 trains with bf16
compute; FP16_16, FP16_32 and TF32 train the float simulation (QAT: the
format's snaps, straight-through, fp32 compute); PyTorchINT8 the INT8
simulation in the JAX package's one-pass QAT step
(training/segmentation.py), its checkpoints carrying the observers.  A
``pretrained_backbone`` is loaded where it is available (a timm-style
``.pth``, or a timm model name with timm installed); otherwise the CLI
warns and trains from scratch.  ``--device`` defaults to ``cuda``;
without a CUDA device that raises, it never carries on on the CPU.
Multi-device training and TensorBoard scalars are not ported yet
(ROADMAP A9, A10).
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
from myrtle_vision_tpu_torch.datasets.dlrsd import Dlrsd
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.training.classification import make_predict_fn
from myrtle_vision_tpu_torch.training.optim import (
    create_optimizer,
    lr_at_epoch,
)
from myrtle_vision_tpu_torch.training.segmentation import (
    make_loss_fn,
    pixel_cross_entropy,
)
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)
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
from myrtle_vision_tpu_torch.utils.metrics import MIoU


def validation(predict_fn, val_loader, n_classes):
    """(loss, pixel accuracy, mIoU) over the validation split, each batch's
    loss and accuracy averaged over the batches, the mIoU streamed over
    every pixel (reference segmentation/train.py:35-75); prints the
    ``miou is`` line."""
    total_loss, total_acc, n = 0.0, 0.0, 0
    miou = MIoU(num_classes=n_classes)
    for batch in val_loader.epoch(0):
        logits = predict_fn(batch["image"])
        labels = batch["label"].long()
        total_loss += float(pixel_cross_entropy(logits, labels))
        preds = logits.argmax(-1)
        total_acc += float((preds == labels).float().mean())
        miou.add_batch(preds, labels)
        n += 1
    miou_value = miou.get_miou() if n else 0.0
    print(f"miou is {miou_value}")
    return total_loss / max(n, 1), total_acc / max(n, 1), miou_value


def build_train(config, device):
    """(model, train loader, validation loader, (micro-batch size,
    micro-batches per step)) as the CLI trains them: the seed set first
    (it also fixes the order the train split is read in), the train
    loader shuffled and yielding one optimizer step's images per batch,
    the model initialised from the seed and, when the config names one
    that is available, the pretrained backbone loaded."""
    train_config = config["train_config"]
    data_config = parse_config(config["data_config_path"])
    seed = train_config["seed"]
    seed_everything(seed)

    batch_size, n_batch_accum = get_batch_sizes(
        train_config["local_batch_size"], 1,
        train_config["global_batch_size"], verbose=True,
    )

    def split(mode, files, transforms):
        return Dlrsd(
            mode=mode,
            dataset_path=data_config["dataset_path"],
            imagepaths=data_config[files],
            label_map_path=data_config["label_map"],
            transform_config=data_config[transforms],
        )

    trainset = split("train", "train_files", "transform_ops_train")
    valset = split("eval", "valid_files", "transform_ops_val")
    train_loader = DataLoader(trainset, batch_size=batch_size * n_batch_accum,
                              device=device, shuffle=True, seed=seed,
                              drop_last=train_config["drop_last_batch"])
    # the local batch, as the reference's validation loader
    val_loader = DataLoader(valset, batch_size=batch_size, device=device,
                            drop_last=train_config["drop_last_batch"])

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
    return model, train_loader, val_loader, (batch_size, n_batch_accum)


def train(config, device):
    train_config = config["train_config"]
    epochs = train_config["epochs"]
    output_directory = train_config["output_directory"]
    iters_per_checkpoint = train_config["iters_per_checkpoint"]
    iters_per_val = train_config["iters_per_val"]
    n_classes = parse_config(config["data_config_path"])["number_of_classes"]

    model, train_loader, val_loader, (batch_size, n_batch_accum) = \
        build_train(config, device)
    os.makedirs(output_directory, exist_ok=True)
    print("output directory:", output_directory)
    print(f"device: {device}, local_batch={batch_size}, "
          f"n_accum={n_batch_accum}")

    state, iteration = prepare_model_and_load_ckpt(
        train_config, TrainState(model, create_optimizer(train_config, model)))
    train_step = make_train_step(make_loss_fn(model), n_batch_accum,
                                 clip_grad=train_config.get("clip_grad"))
    predict_fn = make_predict_fn(model)

    def micro_batches(batch):
        return {k: v.view(n_batch_accum, batch_size, *v.shape[1:])
                for k, v in batch.items()}

    # epoch offset on resume (the JAX CLI's formula, one device)
    epoch_offset = max(0, int(batch_size * iteration
                              / len(train_loader.dataset)))
    last_val_loss, last_val_acc = 0.0, 0.0
    steps_per_epoch = len(train_loader)

    for epoch in range(epoch_offset, epochs):
        lr = lr_at_epoch(train_config, epoch)
        epoch_loss, epoch_acc = 0.0, 0.0
        t_epoch = time.time()
        for batch in train_loader.epoch(epoch):
            if iteration % iters_per_checkpoint == 0:
                save_checkpoint(state,
                                f"{output_directory}/vit_{iteration:06}")
            if iteration % iters_per_val == 0:
                last_val_loss, last_val_acc, _ = validation(
                    predict_fn, val_loader, n_classes)
            metrics = train_step(state, micro_batches(batch), lr)
            iteration = state.iteration
            loss = float(metrics["loss"])
            acc = float(metrics["acc"])
            epoch_loss += loss / steps_per_epoch
            epoch_acc += acc / steps_per_epoch
            print(f"Iteration {iteration}:\tloss={loss:.4f}\t"
                  f"acc={acc:.4f}")

        print(
            f"Epoch : {epoch + 1} - loss : {epoch_loss:.4f} - "
            f"acc: {epoch_acc:.4f} - "
            f"val_loss : {last_val_loss:.4f} - "
            f"val_acc: {last_val_acc:.4f} - "
            f"time: {time.time() - t_epoch:.1f}s\n"
        )

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
