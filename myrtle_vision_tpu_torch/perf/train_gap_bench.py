"""The FP32 ViT-S/16 train step on the card, part by part.

The counterpart of tools/perf/train_gap_bench.py on the port's FP32 path
(bf16 compute through the kernel chains).  Times, each a component of
one train step at ``--batch`` 224 px images:

  infer        the model's forward (eval, no autograd)
  grad         forward and backward, no optimizer
  train        the train step of ``make_train_step``: grad and AdamW
               (the optimizer of classification/train_configs/
               vit_small.json, training/optim.py)
  opt          the AdamW update alone, on fixed gradients
  attn_f       one fused attention block forward (K1's chain)
  attn_fb      its forward and backward (K1 and K2)
  mlp_f        one fused MLP block forward (K3)
  mlp_fb       its forward and backward (K3 and K4)
  embed_train  a depth-0 model's train step (patch embedding, position,
               class token, head and loss, AdamW)

then the derived gaps: train - grad (the optimizer inside the step),
grad - depth x (attn_fb + mlp_fb) (embedding, head, loss and the glue
between the blocks) and infer - depth x (attn_f + mlp_f).  Weights and
inputs come from ``--seed``.

    python -m myrtle_vision_tpu_torch.perf.train_gap_bench \\
        [--device cuda|cpu] [--batch 512] [--depth 12] [--iters 10] \\
        [--only NAME] [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block
from myrtle_vision_tpu_torch.perf._timing import time_ms, where
from myrtle_vision_tpu_torch.training.classification import make_loss_fn
from myrtle_vision_tpu_torch.training.optim import create_optimizer
from myrtle_vision_tpu_torch.training.trainer import (
    TrainState,
    make_train_step,
)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "classification", "train_configs",
    "vit_small.json")
COMPONENTS = ("infer", "grad", "train", "opt", "attn_f", "attn_fb", "mlp_f",
              "mlp_fb", "embed_train")
C, HEADS, HIDDEN, N = 384, 6, 1536, 197


def train_config():
    with open(CONFIG) as f:
        return json.load(f)["train_config"]


def build(depth, device, seed):
    """A ViT-S/16 classifier of ``depth`` blocks (45 classes) with seeded
    weights, and its train state under the config's AdamW."""
    model = ViT("classification", 224, 16, 45, C, depth, HEADS, HIDDEN,
                device=device, generator=torch.Generator().manual_seed(seed))
    return TrainState(model, create_optimizer(train_config(), model))


def grad_step(model, loss_fn, micro_batch):
    """Forward and backward of one micro-batch into the parameters'
    ``.grad``, as the train step computes them, without the optimizer."""
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(micro_batch)
    loss.backward()
    return loss


def block_inputs(batch, device, seed):
    """bf16 rows (B, 197, 384) std 1 and one block's weights as the TPU
    tool draws them: (in, out) bf16 std 0.05, zero fp32 biases, LayerNorm
    ones and zeros."""
    g = torch.Generator(device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(*shape, device=device, generator=g) * std).to(bf)

    x = randn(batch, N, C)
    sl, bl = torch.ones(C, dtype=bf, device=device), \
        torch.zeros(C, dtype=bf, device=device)
    attn = [sl, bl, randn(C, 3 * C, std=0.05),
            torch.zeros(3 * C, device=device), randn(C, C, std=0.05),
            torch.zeros(C, device=device)]
    mlp = [sl, bl, randn(C, HIDDEN, std=0.05),
           torch.zeros(HIDDEN, device=device), randn(HIDDEN, C, std=0.05),
           torch.zeros(C, device=device)]
    return x, attn, mlp


def block_fns(x, attn, mlp):
    """{attn_f, attn_fb, mlp_f, mlp_fb}: each block half forward, and
    forward and backward of the sum of its output to x."""
    scale = (C // HEADS) ** -0.5

    def attn_op(t):
        return fused_attention_block(t, *attn, HEADS, scale)

    def mlp_op(t):
        return fused_mlp_block(t, *mlp)

    def fb(op):
        def run():
            t = x.detach().requires_grad_()
            op(t).float().sum().backward()
            return t.grad
        return run

    def f(op):
        def run():
            with torch.no_grad():
                return op(x)
        return run

    return {"attn_f": f(attn_op), "attn_fb": fb(attn_op),
            "mlp_f": f(mlp_op), "mlp_fb": fb(mlp_op)}


def main(argv=None):
    from myrtle_vision_tpu_torch.classification.test import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--only", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b = args.batch
    tc = train_config()
    print(f"train_gap_bench: ViT-S/16 FP32 (bf16 compute), depth "
          f"{args.depth}, batch {b} [{where(device)}]")
    results = {}

    def record(name, fn, iters=args.iters):
        if args.only and args.only not in name:
            return
        results[name] = time_ms(fn, device, iters, warmup=2)
        print(f"{name:12s} {results[name]:9.3f} ms/iter", flush=True)

    g = torch.Generator(device).manual_seed(args.seed + 1)
    images = torch.randn(b, 224, 224, 3, device=device, generator=g)
    batch = {"image": images[None],
             "label": torch.zeros((1, b), dtype=torch.int64, device=device)}
    state = build(args.depth, device, args.seed)
    model = state.model
    loss_fn = make_loss_fn(model)

    def infer():
        model.eval()
        with torch.inference_mode():
            return model(images)

    record("infer", infer)
    record("grad", lambda: grad_step(model, loss_fn,
                                     {k: v[0] for k, v in batch.items()}))
    step = make_train_step(loss_fn, 1)
    record("train", lambda: step(state, batch, tc["lr"]))
    for p in model.parameters():
        p.grad = torch.full_like(p, 1e-6)
    record("opt", state.optimizer.step)
    del state, model, loss_fn, step

    for name, fn in block_fns(*block_inputs(b, device, args.seed + 2)).items():
        record(name, fn)

    state0 = build(0, device, args.seed)
    step0 = make_train_step(make_loss_fn(state0.model), 1)
    record("embed_train", lambda: step0(state0, batch, tc["lr"]))
    del state0, step0

    if all(k in results for k in ("train", "grad", "opt", "attn_fb",
                                  "mlp_fb", "infer")):
        blocks_fb = args.depth * (results["attn_fb"] + results["mlp_fb"])
        blocks_f = args.depth * (results.get("attn_f", 0.0)
                                 + results.get("mlp_f", 0.0))
        derived = {"opt (train-grad)": results["train"] - results["grad"],
                   "blocks fwd+bwd": blocks_fb,
                   "grad - blocks": results["grad"] - blocks_fb,
                   "blocks fwd": blocks_f,
                   "infer - blocks": results["infer"] - blocks_f}
        results.update(derived)
        print(f"\n--- attribution (ms @ b{b}) [{where(device)}] ---")
        print(f"train total          {results['train']:9.3f}")
        print(f"  grad               {results['grad']:9.3f}")
        print(f"  opt (train-grad)   {derived['opt (train-grad)']:9.3f}"
              f"   (opt alone: {results['opt']:.3f})")
        print(f"  {args.depth}x fused blocks   {blocks_fb:9.3f}")
        print(f"  grad - blocks      {derived['grad - blocks']:9.3f}"
              "   <- embed/head/loss/residual glue")
        if "embed_train" in results:
            print(f"  depth0 train       {results['embed_train']:9.3f}")
        print(f"infer total          {results['infer']:9.3f}")
        print(f"  {args.depth}x fused blocks f {blocks_f:9.3f}")
        print(f"  infer - blocks     {derived['infer - blocks']:9.3f}")
    return results


if __name__ == "__main__":
    main()
