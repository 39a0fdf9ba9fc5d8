#!/usr/bin/env python3
"""The port's ViT-S/16 throughputs (PERF.md section 2) for two checkouts
on one card, alternating them, so that a change is held against its
parent under the same conditions.

    python3 tools/perf/torch_ab.py <parent_root> <change_root> [--rounds 2]

Each round runs parent, change, change, parent, every measurement in a
fresh process that puts its checkout's root first on ``sys.path`` and so
builds and runs that checkout's kernels.  A measurement times, with CUDA
events at batch 256 and weights drawn from seed 0: the bf16 (FP32 format)
forward, the converted INT8 forward (calibrated on 2 batches of seeded
random images), the converted FP16_32 forward, one train step (forward,
backward, AdamW) of the ``vit_small.json`` optimizer in FP32 and one in
FP16_32 (QAT), all kernel path; and the YOLOS-S detection forward at
800 px (2601 tokens) at batch 8.  Prints one line per
measurement and, last, each metric's per-checkout times, medians and the
change's median against the parent's.  Needs a CUDA device.
"""
import json
import os
import statistics
import subprocess
import sys

BATCH = 256


def cuda_ms(torch, fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(root):
    """The four times (ms) of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch

    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.quantize import QFormat, convert_params
    from myrtle_vision_tpu_torch.training.classification import make_loss_fn
    from myrtle_vision_tpu_torch.training.optim import create_optimizer
    from myrtle_vision_tpu_torch.training.trainer import (
        TrainState,
        make_train_step,
    )

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: no CUDA device")
    device = torch.device("cuda", 0)
    widths = ("classification", 224, 16, 45, 384, 12, 6, 1536)
    gen = torch.Generator(device).manual_seed(0)
    imgs = torch.randn(BATCH, 224, 224, 3, device=device, generator=gen)
    out = {}

    model = ViT(*widths, device=device)
    model.eval()
    with torch.inference_mode():
        out["bf16 forward"] = cuda_ms(torch, lambda: model(imgs), 20)

    calib = ViT(*widths, q_format="PyTorchINT8", device=device)
    calib.load_state_dict(model.state_dict(), strict=False)
    calib.eval()
    with torch.inference_mode():
        for _ in range(2):
            calib(torch.randn(32, 224, 224, 3, device=device, generator=gen),
                  calibrating=True)
    conv = ViT(*widths, q_format="PyTorchINT8", converted=True, device=device)
    conv.load_state_dict(convert_params(calib.state_dict(),
                                        QFormat.PyTorchINT8), strict=True)
    conv.eval()
    with torch.inference_mode():
        out["converted INT8 forward"] = cuda_ms(torch, lambda: conv(imgs), 10)
    del calib, conv

    conv = ViT(*widths, q_format="FP16_32", converted=True, device=device)
    conv.load_state_dict(convert_params(model.state_dict(), QFormat.FP16_32),
                         strict=True)
    conv.eval()
    with torch.inference_mode():
        out["converted FP16_32 forward"] = cuda_ms(torch, lambda: conv(imgs),
                                                   5)
    del conv

    with open(os.path.join(root, "classification", "train_configs",
                           "vit_small.json")) as f:
        tc = json.load(f)["train_config"]
    state = TrainState(model, create_optimizer(tc, model))
    batch = {"image": imgs[None],
             "label": torch.randint(0, 45, (1, BATCH), device=device,
                                    generator=gen)}
    step = make_train_step(make_loss_fn(model), 1)
    out["train step"] = cuda_ms(torch, lambda: step(state, batch, tc["lr"]),
                                10)
    del state, step, model

    model = ViT(*widths, q_format="FP16_32", device=device)
    state = TrainState(model, create_optimizer(tc, model))
    step = make_train_step(make_loss_fn(model), 1)
    out["FP16_32 QAT step"] = cuda_ms(
        torch, lambda: step(state, batch, tc["lr"]), 5, warmup=2)
    del state, step, model, imgs, batch

    model = ViT("detection", 224, 16, 20, 384, 12, 6, 1536, device=device)
    model.eval()
    det = torch.randn(8, 800, 800, 3, device=device, generator=gen)
    with torch.inference_mode():
        out["YOLOS-S forward 800 px B=8"] = cuda_ms(torch,
                                                    lambda: model(det), 10)
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))))
        return
    args = sys.argv[1:]
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    if len(args) != 2:
        raise SystemExit(__doc__)
    trees = {"parent": os.path.abspath(args[0]),
             "change": os.path.abspath(args[1])}
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    times = {name: {} for name in trees}
    for _ in range(rounds):
        for name in ("parent", "change", "change", "parent"):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 trees[name]], capture_output=True, text=True)
            if run.returncode:
                raise SystemExit(f"torch_ab: {name} failed:\n{run.stderr}")
            got = json.loads(run.stdout.strip().splitlines()[-1])
            print(f"torch_ab: {name} {got} [{power}]")
            for metric, ms in got.items():
                if metric != "device":
                    times[name].setdefault(metric, []).append(ms)
    for metric in times["parent"]:
        p, c = times["parent"][metric], times["change"][metric]
        mp, mc = statistics.median(p), statistics.median(c)
        print(f"torch_ab: {metric}: parent {p} ms (median {mp:.3f}), "
              f"change {c} ms (median {mc:.3f}), change / parent "
              f"{mc / mp:.4f} [{power}]")


if __name__ == "__main__":
    main()
