"""Post-training quantized evaluation CLI (PyTorch port of
classification/test_quantize.py).

    python -m myrtle_vision_tpu_torch.classification.test_quantize \
        -c <config.json> [--calib_steps N] [--quantized_ckpt] \
        [--save_converted <path>] [--device cuda|cpu]

The flow of the JAX CLI (classification/test_quantize.py:77-162) for
``vit_config.q_format`` PyTorchINT8, FP16_16, FP16_32 or TF32:
  1. the fp32 reference-format ``.pth`` of ``train_config.checkpoint_path``
     into a model of the format (an INT8 model's observers fresh);
  2. ``--calib_steps`` batches of the validation split through the
     calibrating forward, which folds them into every INT8 observer's
     running min/max; a float format has no observers, so its
     simulation forward runs and updates nothing, as in the JAX CLI;
  3. convert: the Linear weights become int8 with a per-tensor fp32
     scale (PyTorchINT8), or the Linear and LayerNorm weights take the
     format's fake-quant, stored as fp16 (FP16_16, FP16_32) or fp32
     (TF32);
  4. the model sizes before and after;
  5. with ``--save_converted``, the converted checkpoint (its int8 or
     fp16 storage as it is);
  6. the test split through the converted model (INT8: the int8 products
     and the INT8 block-half ops, ops/fused_int8_block.py; a float
     format: its sites through K11 and the block-half ops with its
     ``qspec``) and the classification report.
``--quantized_ckpt`` is parsed and, as in the JAX CLI, not read.  FP32
has nothing to quantize (classification/test.py evaluates it).
``--device`` defaults to ``cuda``; without a CUDA device that raises, it
never carries on on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from myrtle_vision_tpu_torch.classification.test import (
    classification_report,
    evaluate_dataset,
    resolve_device,
)
from myrtle_vision_tpu_torch.data.loader import DataLoader
from myrtle_vision_tpu_torch.datasets.resisc45 import Resisc45
from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
from myrtle_vision_tpu_torch.quantize import (
    convert_params,
    is_observer,
    model_size_mb,
)
from myrtle_vision_tpu_torch.training.classification import make_predict_fn
from myrtle_vision_tpu_torch.utils.checkpoint import save_model
from myrtle_vision_tpu_torch.utils.config import get_label_list, parse_config
from myrtle_vision_tpu_torch.utils.convert import load_reference_checkpoint


def build_quantize(config, device):
    """(model, validation loader, test loader, data config, model kwargs)
    as the CLI sets them up: dropout zeroed, the model of the config's
    format (an INT8 model with fresh observers) and the fp32 checkpoint
    loaded strictly; the validation loader unpadded, the test loader
    padding its last batch."""
    train_config = config["train_config"]
    decoder = config["vit_config"]["decoder"]
    if decoder != "classification":
        raise NotImplementedError(
            f"post-training quantization of a {decoder} model: this CLI "
            "quantizes classifiers, as the JAX classification/"
            "test_quantize.py does; a float-format detector trains and "
            "evaluates through detection/train.py and detection/test.py "
            "(ROADMAP A5a)")
    if config["vit_config"]["q_format"] == "FP32":
        raise ValueError("q_format FP32: nothing to quantize; "
                         "classification/test.py evaluates it")
    data_config = parse_config(config["data_config_path"])
    loader_kwargs = dict(batch_size=train_config["local_batch_size"],
                         device=device,
                         drop_last=train_config["drop_last_batch"])
    sets = [
        Resisc45(mode="eval", dataset_path=data_config["dataset_path"],
                 imagepaths=data_config[split],
                 label_map_path=data_config["label_map"],
                 transform_config=data_config["transform_ops_val"])
        for split in ("valid_files", "test_files")
    ]
    val_loader = DataLoader(sets[0], **loader_kwargs)
    test_loader = DataLoader(sets[1], pad_last=True, **loader_kwargs)

    config["vit_config"]["dropout"] = 0.0
    config["vit_config"]["emb_dropout"] = 0.0
    kwargs = vit_kwargs_from_config(config, data_config)
    model = ViT(**kwargs, device=device)
    if not train_config["checkpoint_path"]:
        raise ValueError("Must provide a checkpoint path in the config file")
    model.load_ptq_state_dict(
        load_reference_checkpoint(train_config["checkpoint_path"]))
    return model, val_loader, test_loader, data_config, kwargs


@torch.no_grad()
def calibrate(model, loader, calib_steps):
    """Feed ``calib_steps`` batches through the calibrating forward
    (reference test_quantize.py:26-34); a float format's forward updates
    nothing."""
    print(f"\nRunning {calib_steps} calibration steps")
    model.eval()
    for i, batch in enumerate(loader.epoch(0)):
        if i >= calib_steps:
            break
        model(batch["image"], calibrating=True)


def convert_model(model, kwargs, device):
    """The converted model: convert_params of the calibrated state dict,
    loaded strictly into a ``converted=True`` model."""
    converted = ViT(**dict(kwargs, converted=True), device=device)
    converted.load_state_dict(
        convert_params(model.state_dict(), model.q_format), strict=True)
    return converted


def weights_mb(model):
    """Size of the model's weights, observers left out, in MB (the JAX
    CLI's ``model_size_mb`` of the param tree)."""
    return model_size_mb({name: t for name, t in model.state_dict().items()
                          if not is_observer(name)})


def run_quantize(config, device, calib_steps, quantized_ckpt=False,
                 save_converted=None):
    """The CLI's flow; returns (gts, preds, logits) of the test split."""
    del quantized_ckpt  # parsed, never read, as in the JAX CLI
    model, val_loader, test_loader, data_config, kwargs = build_quantize(
        config, device)
    print(f"Pre-quantization model size: {weights_mb(model)} MB")
    calibrate(model, val_loader, calib_steps)
    converted = convert_model(model, kwargs, device)
    del model
    print(f"\nPost-quantization model size: {weights_mb(converted)} MB")
    if save_converted:
        save_model(converted, save_converted)
        print(f"Converted checkpoint: {save_converted} "
              f"({os.path.getsize(save_converted) / 1e6} MB)")
    gts, preds, logits = evaluate_dataset(make_predict_fn(converted),
                                          test_loader)
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
    parser.add_argument(
        "--calib_steps",
        type=int,
        default=10,
        help="Number of steps to calibrate the model on",
    )
    parser.add_argument(
        "--quantized_ckpt",
        action="store_true",
        help="If set, the checkpoint was trained with the config's q_format "
        "active (QAT); otherwise an fp32 checkpoint is post-training "
        "quantized (parsed and not read, as in the JAX CLI)",
    )
    parser.add_argument(
        "--save_converted",
        type=str,
        default=None,
        help="Write the converted checkpoint (its int8 or fp16 storage) "
        "here",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    with open(args.config) as f:
        config = json.loads(f.read())
    return run_quantize(config, resolve_device(args.device),
                        args.calib_steps, args.quantized_ckpt,
                        args.save_converted)


if __name__ == "__main__":
    main()
