"""DLRSD semantic segmentation trainer (PyTorch port of
segmentation/train.py), on one device or over several GPUs.

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
Several GPUs as in classification/train.py (parallel/launch.py); rank 0
alone validates and writes the checkpoints and the scalars.  As the JAX
CLI,
each validation's accuracy, loss and mIoU go to ``runs/`` (TensorBoard
where the package is installed, else ``runs/scalars.jsonl``;
utils/logging.py), and with ``MVT_PROFILE_DIR`` set steps 3-5 are traced
(utils/profiling.py).  A positive ``dropout`` or ``emb_dropout`` trains
with the dropout sites active (training/trainer.py).
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
from myrtle_vision_tpu_torch.parallel import launch
from myrtle_vision_tpu_torch.parallel.mesh import Mesh, train_loader_kwargs
from myrtle_vision_tpu_torch.parallel.tp import setup_tensor_parallel
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
    data_parallel,
    dropout_generator,
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
from myrtle_vision_tpu_torch.utils.logging import ScalarLogger
from myrtle_vision_tpu_torch.utils.metrics import MIoU
from myrtle_vision_tpu_torch.utils.profiling import StepProfiler


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


def build_train(config, device, mesh=None):
    """(model, train loader, validation loader, (micro-batch size,
    micro-batches per step)) as the CLI trains them: the seed set first
    (it also fixes the order the train split is read in), the train
    loader shuffled and yielding one optimizer step's images per batch
    (this data rank's share on a ``mesh`` of several), the model
    initialised from the seed and, when the config names one that is
    available, the pretrained backbone loaded."""
    mesh = mesh or Mesh()
    train_config = config["train_config"]
    data_config = parse_config(config["data_config_path"])
    seed = train_config["seed"]
    seed_everything(seed)

    batch_size, n_batch_accum = get_batch_sizes(
        train_config["local_batch_size"], mesh.n_data,
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
    train_loader = DataLoader(trainset, device=device, shuffle=True,
                              seed=seed, **train_loader_kwargs(
                                  train_config, mesh, batch_size,
                                  n_batch_accum))
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


def train(config, device, mesh=None):
    """Train on ``device`` as one rank of ``mesh`` (parallel/mesh.py; one
    rank alone when None); the final TrainState."""
    mesh = mesh or Mesh()
    main = mesh.rank == 0
    train_config = config["train_config"]
    epochs = train_config["epochs"]
    output_directory = train_config["output_directory"]
    iters_per_checkpoint = train_config["iters_per_checkpoint"]
    iters_per_val = train_config["iters_per_val"]
    n_classes = parse_config(config["data_config_path"])["number_of_classes"]

    model, train_loader, val_loader, (batch_size, n_batch_accum) = \
        build_train(config, device, mesh)
    writer = ScalarLogger("runs/", enabled=main)
    if main:
        os.makedirs(output_directory, exist_ok=True)
    print("output directory:", output_directory)
    print(f"device: {device}, local_batch={batch_size}, "
          f"n_accum={n_batch_accum}")
    if mesh.distributed:
        print(f"ranks: {mesh.world} (data={mesh.n_data}, "
              f"model={mesh.tensor_parallel}), rank {mesh.rank}")

    state, iteration = prepare_model_and_load_ckpt(
        train_config, TrainState(model, create_optimizer(train_config, model),
                                 dropout=dropout_generator(
                                     model, train_config["seed"],
                                     mesh.data_index)))
    setup_tensor_parallel(model, mesh)
    module = data_parallel(model, mesh)
    train_step = make_train_step(make_loss_fn(module), n_batch_accum,
                                 clip_grad=train_config.get("clip_grad"),
                                 mesh=mesh, module=module)
    predict_fn = make_predict_fn(model)

    def micro_batches(batch):
        return {k: v.view(n_batch_accum, batch_size, *v.shape[1:])
                for k, v in batch.items()}

    # epoch offset on resume (the JAX CLI's formula)
    epoch_offset = max(0, int(batch_size * mesh.n_data * iteration
                              / len(train_loader.dataset)))
    last_val_loss, last_val_acc = 0.0, 0.0
    steps_per_epoch = len(train_loader)
    profiler = StepProfiler()
    if not main:
        profiler.trace_dir = None

    for epoch in range(epoch_offset, epochs):
        lr = lr_at_epoch(train_config, epoch)
        epoch_loss, epoch_acc = 0.0, 0.0
        t_epoch = time.time()
        for batch in train_loader.epoch(epoch):
            if iteration % iters_per_checkpoint == 0 and main:
                save_checkpoint(state,
                                f"{output_directory}/vit_{iteration:06}")
            if iteration % iters_per_val == 0 and main:
                last_val_loss, last_val_acc, miou_value = validation(
                    predict_fn, val_loader, n_classes)
                writer.add_scalar("accuracy", last_val_acc, iteration)
                writer.add_scalar("loss", last_val_loss, iteration)
                writer.add_scalar("miou", miou_value, iteration)
            metrics = train_step(state, micro_batches(batch), lr)
            iteration = state.iteration
            profiler.step(iteration)
            loss = float(metrics["loss"])
            acc = float(metrics["acc"])
            epoch_loss += loss / steps_per_epoch
            epoch_acc += acc / steps_per_epoch
            if main:
                print(f"Iteration {iteration}:\tloss={loss:.4f}\t"
                      f"acc={acc:.4f}")

        if not main:
            continue
        print(
            f"Epoch : {epoch + 1} - loss : {epoch_loss:.4f} - "
            f"acc: {epoch_acc:.4f} - "
            f"val_loss : {last_val_loss:.4f} - "
            f"val_acc: {last_val_acc:.4f} - "
            f"time: {time.time() - t_epoch:.1f}s\n"
        )

    profiler.close()
    if main:
        save_checkpoint(state, f"{output_directory}/vit_{iteration:06}")
    writer.flush()
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
    return launch.run(train, config, device)


if __name__ == "__main__":
    main()
