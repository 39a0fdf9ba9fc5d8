"""Finetune a CNN teacher on RESISC45 (PyTorch port of
classification/finetune_cnn.py, the script form of the reference's
Finetune_CNN_Resisc45.ipynb).

    python -m myrtle_vision_tpu_torch.classification.finetune_cnn \\
        --model resnet50 --epochs 5 --lr 1e-3 \\
        --output resnet50_resisc45_pyt_finetuned_weights.pth \\
        [--data_config data_configs/data_config.json] [--batch_size 32] \\
        [--init_weights imagenet.pth] [--device cuda|cpu]

The reference finetunes torchvision CNNs into the frozen distillation
teacher (reference: classification/Finetune_CNN_Resisc45.ipynb,
utils/models.py:14-22).  This CLI trains a torchvision-layout state dict
directly (models/resnet.py, models/cnn.py: any of the seven
architectures of ``ALL_CNN_ARCHS``), so the ``.pth`` it writes loads
wherever a torchvision checkpoint does:

  - initial weights: a torchvision ``.pth`` when ``--init_weights`` names
    one (its classifier head redrawn for the dataset's classes), else
    He-init (models/cnn.py ``random_any_state_dict``); nothing is
    downloaded;
  - the step, as the JAX CLI's: batch norm in train mode, normalizing
    with the batch's statistics, and each running mean and variance
    replaced by its momentum-0.1 update (unbiased batch variance) after
    the step; the optimizer takes every tensor but the running
    statistics (convolutions, the classifier, batch norm's weight and
    bias): the global gradient norm over those tensors clipped to 5.0,
    then SGD with momentum 0.9 (``optax.masked(chain(
    clip_by_global_norm(5.0), sgd(lr, momentum=0.9)))``);
  - one ``Epoch`` line per epoch (mean loss, validation accuracy);
  - the output carries one ``num_batches_tracked`` (0) per batch norm, as
    a strict torchvision load expects, and serves ``test_cnn`` and
    ``distiller_config.teacher_weights_path``.

The convolutions run in fp32 (TF32 off), forward and backward.
``--device`` defaults to ``cuda``; without a CUDA device that raises, it
never carries on on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from myrtle_vision_tpu_torch.classification.test import resolve_device
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.resisc45 import Resisc45
from myrtle_vision_tpu_torch.models.cnn import (
    apply_any_torch_sd,
    head_keys,
    random_any_state_dict,
)
from myrtle_vision_tpu_torch.models.resnet import fp32_convolutions
from myrtle_vision_tpu_torch.training.optim import (
    clip_by_global_norm,
    cross_entropy_loss,
)
from myrtle_vision_tpu_torch.utils.config import parse_config, seed_everything

CLIP_NORM = 5.0
MOMENTUM = 0.9


def load_initial_sd(model_name, num_classes, init_weights):
    """{name: numpy array}: the ``init_weights`` state dict with its
    classifier head redrawn for ``num_classes`` (N(0, 1 / in_features),
    bias 0, from ``RandomState(0)``), or He-init weights."""
    if init_weights:
        sd = torch.load(init_weights, map_location="cpu", weights_only=True)
        sd = {k: v.numpy() for k, v in sd.items()}
        rng = np.random.RandomState(0)
        wk, bk, conv_head = head_keys(model_name)
        in_features = sd[wk].shape[1]
        shape = ((num_classes, in_features, 1, 1) if conv_head
                 else (num_classes, in_features))
        sd[wk] = (rng.randn(*shape) * in_features ** -0.5).astype(np.float32)
        sd[bk] = np.zeros(num_classes, np.float32)
        return sd
    return random_any_state_dict(model_name, num_classes)


def is_trainable(key):
    """Every tensor but batch norm's running statistics."""
    return not key.endswith(("running_mean", "running_var",
                             "num_batches_tracked"))


def make_step(model_name, params, lr):
    """(images, labels) -> loss, updating ``params`` ({name: tensor} on
    the images' device) in place: a train-mode forward, the cross
    entropy's gradient for the trainable tensors, their global norm
    clipped to 5.0, an SGD step with momentum 0.9, then the running
    statistics' update."""
    trainable = [p.requires_grad_(True) for k, p in params.items()
                 if is_trainable(k)]
    optimizer = torch.optim.SGD(trainable, lr=lr, momentum=MOMENTUM)

    def step(images, labels):
        optimizer.zero_grad(set_to_none=True)
        with fp32_convolutions():
            logits, new_stats = apply_any_torch_sd(params, images,
                                                   model_name, train=True)
            loss = cross_entropy_loss(logits, labels)
            loss.backward()
        clip_by_global_norm(trainable, CLIP_NORM)
        optimizer.step()
        with torch.no_grad():
            for name, value in new_stats.items():
                params[name].copy_(value)
        return loss.detach()

    return step


def finetune(model_name, data_config_path, epochs, batch_size, lr,
             init_weights, output, device="cpu"):
    """Train, print one line per epoch, write ``output``; returns the
    written state dict and [(mean loss, validation accuracy)] per
    epoch."""
    device = torch.device(device)
    data_config = parse_config(data_config_path)
    seed_everything(0)
    num_classes = data_config["number_of_classes"]
    sd = load_initial_sd(model_name, num_classes, init_weights)
    params = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                 device=device)
              for k, v in sd.items() if not k.endswith("num_batches_tracked")}

    trainset = Resisc45(
        mode="train",
        dataset_path=data_config["dataset_path"],
        imagepaths=data_config["train_files"],
        label_map_path=data_config["label_map"],
        transform_config=data_config["transform_ops_train"],
    )
    valset = Resisc45(
        mode="eval",
        dataset_path=data_config["dataset_path"],
        imagepaths=data_config["valid_files"],
        label_map_path=data_config["label_map"],
        transform_config=data_config["transform_ops_val"],
    )
    train_loader = DataLoader(trainset, batch_size=batch_size, device=device,
                              shuffle=True, seed=0)
    val_loader = DataLoader(valset, batch_size=batch_size, device=device,
                            drop_last=False)
    step = make_step(model_name, params, lr)

    history = []
    for epoch in range(epochs):
        epoch_loss, steps = 0.0, 0
        for batch in train_loader.epoch(epoch):
            loss = step(batch["image"], batch["label"].long())
            epoch_loss += float(loss)
            steps += 1
        correct, total = 0, 0
        with torch.inference_mode():
            for batch in val_loader.epoch(0):
                logits = apply_any_torch_sd(params, batch["image"],
                                            model_name)
                correct += int((logits.argmax(-1)
                                == batch["label"].long()).sum())
                total += len(batch["label"])
        history.append((epoch_loss / max(steps, 1), correct / max(total, 1)))
        print(f"Epoch {epoch + 1}: loss={history[-1][0]:.4f} "
              f"val_acc={history[-1][1]:.4f}")

    out_sd = {k: v.detach().cpu().clone() for k, v in params.items()}
    # torch BatchNorm state dicts carry num_batches_tracked; a strict
    # load (reference utils/models.py:17 get_teacher) rejects their
    # absence, so one goes with each batch norm's running statistics
    for k in list(out_sd):
        if k.endswith("running_mean"):
            out_sd[k[: -len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0, dtype=torch.int64))
    torch.save(out_sd, output)
    print(f"saved finetuned weights to {output}")
    return out_sd, history


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="resnet50")
    parser.add_argument("--data_config", type=str,
                        default="data_configs/data_config.json")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument(
        "--init_weights", type=str, default=None,
        help="Optional ImageNet-pretrained torchvision .pth to start from",
    )
    parser.add_argument("--output", type=str,
                        default="resnet50_resisc45_pyt_finetuned_weights.pth")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    return finetune(args.model, args.data_config, args.epochs,
                    args.batch_size, args.lr, args.init_weights, args.output,
                    resolve_device(args.device))


if __name__ == "__main__":
    main()
