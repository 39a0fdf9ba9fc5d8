"""RESISC45 classification trainer (PyTorch port of
classification/train.py), on one device or over several GPUs.

    python -m myrtle_vision_tpu_torch.classification.train \\
        -c <config.json> [--device cuda|cpu]

The configs are the JAX CLI's, and relative paths resolve against the
working directory as there.  The loop is the JAX CLI's: the LR of each
epoch from the cosine/warmup schedule, a checkpoint every
``iters_per_checkpoint`` optimizer steps and validation every
``iters_per_val`` (both before the step, from iteration 0), one
``Iteration i`` line per step and an ``Epoch`` summary per epoch, and a
final checkpoint.  One optimizer step sums the gradients of
``global_batch_size / local_batch_size`` micro-batches.  Checkpoints are
``torch.save`` files (utils/checkpoint.py) that the port's eval CLI
reads as they are; ``checkpoint_path`` resumes from one.
``vit_config.q_format`` FP16_16, FP16_32 or TF32 trains the float
format's simulation (QAT: fp32 compute, the format's snaps at the JAX
sites, straight-through gradients, AdamW as for FP32); its checkpoints
hold fp32 parameters, which the eval CLI and the PTQ CLI
(``test_quantize``) read as they read the JAX CLI's.  ``q_format``
PyTorchINT8 trains the INT8 simulation in the JAX package's two-pass QAT
step (training/classification.py: a calibrating pass folds each batch
into the observers, a second pass with the observers frozen is
differentiated through the INT8 block-half ops); validation runs the
simulation's eval forward, and the checkpoints carry the observers, so
that the eval CLI evaluates them and the PTQ CLI calibrates on, converts
and runs the converted INT8 model.  A ``distiller_config`` (the DeiT
configs) trains the student ViT inside models/distill.py's
``DistillWrapper`` (the distillation token and head) against the frozen
CNN teacher of ``teacher_weights_path`` (a ResNet-50 ``.pth`` that
``finetune_cnn`` writes), run without gradient once per micro-batch, in
any ``q_format``: a float-format student trains its QAT simulation, a
PyTorchINT8 one in the JAX package's one-pass step (its calibrating
forward, differentiated, the observers updated as it runs); the
pretrained backbone, if any, goes into the student; validation gives the
distillation loss and the plain student's accuracy; the checkpoints hold
the wrapper's state dict (a PyTorchINT8 student's observers with it),
whose student the eval, PTQ and export CLIs read.  ``--device`` defaults
to ``cuda``; without a CUDA device that raises, it never carries on on
the CPU.

Several GPUs (parallel/launch.py): with ``train_config.distributed``
(default true) and more than one visible CUDA device, one process per
device, or one rank a process launched by the caller
(MVT_COORDINATOR, MVT_NUM_PROCESSES, MVT_PROCESS_ID; ``--device cpu``
then trains over gloo).  ``dist_config`` names the backend, the URL and
``tensor_parallel``; ranks lie (data, model), data-major.  The step's
batch splits over the data ranks (``get_batch_sizes`` over n_data, each
rank loading its block of the same permutation), gradients average over
them (training/trainer.py); ``tensor_parallel`` > 1 runs the fused blocks
head-sharded (parallel/tp.py) where ``fused_gate`` holds and raises
elsewhere (ROADMAP A9b).  Rank 0 alone creates the output directory,
writes checkpoints, validates and prints the iteration lines.  With one
rank nothing of this runs.  With ``MVT_PROFILE_DIR`` set, steps 3-5 are
traced into that directory (utils/profiling.py).  A positive ``dropout``
or ``emb_dropout`` trains with the dropout sites active, their masks from
a generator seeded from ``train_config.seed`` (training/trainer.py).
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
from myrtle_vision_tpu_torch.datasets.resisc45 import Resisc45
from myrtle_vision_tpu_torch.models.distill import DistillWrapper
from myrtle_vision_tpu_torch.models.resnet import make_teacher_fn
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.parallel import launch
from myrtle_vision_tpu_torch.parallel.mesh import Mesh, train_loader_kwargs
from myrtle_vision_tpu_torch.parallel.tp import setup_tensor_parallel
from myrtle_vision_tpu_torch.training.classification import (
    make_loss_fn,
    make_predict_fn,
)
from myrtle_vision_tpu_torch.training.optim import (
    create_optimizer,
    cross_entropy_loss,
    lr_at_epoch,
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
from myrtle_vision_tpu_torch.utils.profiling import StepProfiler


def validation(predict_fn, val_loader, distill_eval=None):
    """Mean validation loss and accuracy over the batches (reference
    train.py:29-52); under a distiller the loss is
    ``distill_eval(images, labels)``'s (reference train.py:41-44)."""
    total_loss, total_acc, n = 0.0, 0.0, 0
    for batch in val_loader.epoch(0):
        logits = predict_fn(batch["image"])
        labels = batch["label"].long()
        loss = (cross_entropy_loss(logits, labels) if distill_eval is None
                else distill_eval(batch["image"], labels))
        total_loss += float(loss)
        total_acc += float((logits.argmax(-1) == labels).float().mean())
        n += 1
    return total_loss / max(n, 1), total_acc / max(n, 1)


def build_models(config, data_config, device, generator):
    """(ViT, DistillWrapper around it or None) from the config (JAX
    build_models, reference utils/models.py:25-60), the parameters drawn
    from ``generator``; the teacher comes from :func:`build_teacher`."""
    vit = ViT(**vit_kwargs_from_config(config, data_config), device=device,
              generator=generator)
    if "distiller_config" not in config:
        return vit, None
    dc = config["distiller_config"]
    return vit, DistillWrapper(vit, temperature=dc["temperature"],
                               alpha=dc["alpha"], generator=generator)


def build_teacher(config, device):
    """The frozen ResNet-50 teacher of ``distiller_config``'s
    ``teacher_weights_path`` on ``device`` (models/resnet.py
    ``make_teacher_fn``)."""
    return make_teacher_fn(config["distiller_config"]["teacher_weights_path"],
                           device=device)


def build_train(config, device, mesh=None):
    """(model, train loader, validation loader, (micro-batch size,
    micro-batches per step)) as the CLI trains them: the seed set first
    (it also fixes the order the train split is read in), the train
    loader shuffled and yielding one optimizer step's images per batch
    (this data rank's share of them on a ``mesh`` of several), the model
    initialised from the seed and, when the config names one, the
    pretrained backbone loaded.  The model is the module the step
    trains: the ViT, or under a distiller the DistillWrapper whose
    ``student`` is the ViT."""
    mesh = mesh or Mesh()
    train_config = config["train_config"]
    data_config = parse_config(config["data_config_path"])
    seed = train_config["seed"]
    seed_everything(seed)

    batch_size, n_batch_accum = get_batch_sizes(
        train_config["local_batch_size"], mesh.n_data,
        train_config["global_batch_size"], verbose=True,
    )
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
    train_loader = DataLoader(trainset, device=device, shuffle=True,
                              seed=seed, **train_loader_kwargs(
                                  train_config, mesh, batch_size,
                                  n_batch_accum))
    val_loader = DataLoader(valset, batch_size=batch_size, device=device,
                            seed=seed,
                            drop_last=train_config["drop_last_batch"])

    vit, distiller = build_models(config, data_config, device,
                                  torch.Generator().manual_seed(seed))
    # Pretrained timm backbone import into the student (reference
    # train.py:137-148)
    pretrained = train_config.get("pretrained_backbone")
    if pretrained is not None:
        try:
            load_pretrained_backbone(vit, pretrained)
            print(f"loaded pretrained backbone: {pretrained}")
        except RuntimeError as e:
            print(f"WARNING: pretrained backbone unavailable ({e}); "
                  "training from scratch")
    model = vit if distiller is None else distiller
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

    model, train_loader, val_loader, (batch_size, n_batch_accum) = \
        build_train(config, device, mesh)
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
    distiller = model if isinstance(model, DistillWrapper) else None
    setup_tensor_parallel(getattr(model, "student", model), mesh,
                          extra_ok=distiller is None)
    module = data_parallel(model, mesh)
    distill_eval = None
    if distiller is not None:
        vit, teacher_fn = distiller.student, build_teacher(config, device)

        def distill_eval(images, labels):
            """The validation loss through the distiller (reference
            train.py:41-44)."""
            distiller.eval()
            with torch.inference_mode():
                return distiller(images, labels, teacher_fn(images))[0]
    else:
        vit, teacher_fn = model, None
    loss_fn = (make_loss_fn(module) if distiller is None
               else make_loss_fn(vit, module, teacher_fn))
    train_step = make_train_step(loss_fn, n_batch_accum,
                                 clip_grad=train_config.get("clip_grad"),
                                 mesh=mesh, module=module)
    predict_fn = make_predict_fn(vit)

    def micro_batches(batch):
        return {k: v.view(n_batch_accum, batch_size, *v.shape[1:])
                for k, v in batch.items()}

    # epoch offset on resume (reference formula, train.py:181-183)
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
            # checkpoints and validation: rank 0's work (reference
            # train.py:203-237)
            if iteration % iters_per_checkpoint == 0 and main:
                save_checkpoint(state,
                                f"{output_directory}/vit_{iteration:06}")
            if iteration % iters_per_val == 0 and main:
                last_val_loss, last_val_acc = validation(
                    predict_fn, val_loader, distill_eval)
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
    # final checkpoint
    if main:
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
    return launch.run(train, config, device)


if __name__ == "__main__":
    main()
