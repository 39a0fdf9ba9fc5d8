"""The converted-INT8 ViT-S/16 forward on the card, part by part.

The counterpart of tools/perf/int8_component_bench.py on the port.  The
converted model comes from the port's own calibrate and convert: a
PyTorchINT8 ViT-S/16 with seeded weights, one calibrating forward over 64
seeded images, ``convert_params``.  Times, at ``--batch`` 224 px images:

  full       the converted model's forward
  attn_i8    the converted model's first attention half (K9's chain,
             ops/fused_int8_block.py) with its int8 weights and calibrated
             sites, on the tokens that enter it
  mlp_i8     its first MLP half (K10's chain), on that half's input
  core_fp32  the fp32 attention core alone (``attention_core_f32``: 3-pass
             scores and P V, an exact softmax divide, the int8 context) on
             seeded fp32 (B, 197, 1152) rows std 1
  bf16_attn  the bf16 fused attention block at the same shapes (K1's
             chain), seeded bf16 weights std 0.05: what the block costs
             when nothing is quantized
  bf16_mlp   the bf16 fused MLP block (K3's chain)

and the derived ``edges = full - depth x (attn_i8 + mlp_i8)``: the patch
embedding, position add, class token, decoder LayerNorm and head, with
their requant sites outside the fused blocks.  The TPU tool timed its
int8 blocks on synthetic weights and sites (scale 0.05 at every site,
which saturates the qkv rows); so timed by chip_smoke.py's probes phase,
the attention half took 4.103 ms at batch 256 against 2.806 for K9 in the
model (NVIDIA H100 80GB HBM3, 700.00 W), and the edges came out negative,
so the blocks here are the model's own.

    python -m myrtle_vision_tpu_torch.perf.int8_component_bench \\
        [--device cuda|cpu] [--batch 512] [--depth 12] [--iters 10] \\
        [--only NAME] [--seed 0]
"""
from __future__ import annotations

import argparse

import torch

from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block
from myrtle_vision_tpu_torch.perf._timing import time_ms, where
from myrtle_vision_tpu_torch.quantize import QFormat, convert_params

COMPONENTS = ("full", "attn_i8", "mlp_i8", "core_fp32", "bf16_attn",
              "bf16_mlp")
C, HEADS, HIDDEN, N = 384, 6, 1536, 197
CALIB_IMAGES = 64


def converted_model(depth, images, device, seed):
    """A converted PyTorchINT8 ViT-S/16 of ``depth`` blocks: seeded
    weights, one calibrating forward over ``images``, convert."""
    kw = dict(decoder="classification", image_size=224, patch_size=16,
              num_classes=45, dim=C, depth=depth, heads=HEADS, mlp_dim=HIDDEN,
              q_format="PyTorchINT8", device=device)
    calib = ViT(**kw, generator=torch.Generator().manual_seed(seed))
    calib.eval()
    with torch.inference_mode():
        calib(images, calibrating=True)
    conv = ViT(**kw, converted=True)
    conv.load_state_dict(convert_params(calib.state_dict(),
                                        QFormat.PyTorchINT8), strict=True)
    conv.eval()
    return conv


def block_fns(model, images, seed):
    """{attn_i8, mlp_i8, core_fp32, bf16_attn, bf16_mlp} thunks at the
    model's shapes.  attn_i8 and mlp_i8 are the converted model's first
    block, its int8 weights and calibrated sites, on the tokens that enter
    it; the rest take seeded operands, as the TPU tool draws them."""
    device = images.device
    g = torch.Generator(device).manual_seed(seed)
    bf = torch.bfloat16
    block, sites = model.transformer.layers[0], model.block_sites[0]
    with torch.inference_mode():
        x0 = model.embed_converted(images, K.for_device(images))
        x1 = block.converted_attention(x0, sites)

    def weight(rows, cols):
        """An (in, out) bf16 weight std 0.05, the transposed view of a
        torch (out, in) tensor."""
        return (torch.randn(cols, rows, device=device, generator=g)
                * 0.05).to(bf).t()

    x = torch.randn(images.shape[0], N, C, device=device, generator=g)
    sl = torch.ones(C, dtype=bf, device=device)
    zeros = {n: torch.zeros(n, device=device) for n in (C, 3 * C, HIDDEN)}
    qkv = torch.randn(images.shape[0], N, 3 * C, device=device, generator=g)
    wq, wo, w1, w2 = (weight(C, 3 * C), weight(C, C), weight(C, HIDDEN),
                      weight(HIDDEN, C))
    scale = (C // HEADS) ** -0.5
    xb = x.to(bf)
    kern = K.for_device(x)
    return {
        "attn_i8": lambda: block.converted_attention(x0, sites),
        "mlp_i8": lambda: block.converted_mlp(x1, sites),
        "core_fp32": lambda: kern.attention_core_f32(qkv, HEADS, scale,
                                                     sites[0][2]),
        "bf16_attn": lambda: fused_attention_block(
            xb, sl, zeros[C], wq, zeros[3 * C], wo, zeros[C], HEADS, scale),
        "bf16_mlp": lambda: fused_mlp_block(xb, sl, zeros[C], w1,
                                            zeros[HIDDEN], w2, zeros[C]),
    }


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
    print(f"int8_component_bench: converted PyTorchINT8 ViT-S/16, depth "
          f"{args.depth}, batch {b} [{where(device)}]")
    results = {}

    def record(name, fn):
        if args.only and args.only not in name:
            return
        with torch.inference_mode():
            results[name] = time_ms(fn, device, args.iters, warmup=2)
        print(f"{name:10s} {results[name]:9.3f} ms/iter", flush=True)

    g = torch.Generator(device).manual_seed(args.seed + 1)
    images = torch.randn(b, 224, 224, 3, device=device, generator=g)
    model = converted_model(args.depth, images[:CALIB_IMAGES], device,
                            args.seed)
    record("full", lambda: model(images))
    for name, fn in block_fns(model, images, args.seed + 2).items():
        record(name, fn)
    del model

    if all(k in results for k in ("full", "attn_i8", "mlp_i8")):
        blocks = args.depth * (results["attn_i8"] + results["mlp_i8"])
        results["edges"] = results["full"] - blocks
        print(f"\n--- attribution (ms @ b{b}) [{where(device)}] ---")
        print(f"full converted       {results['full']:9.3f}")
        print(f"  {args.depth}x int8 blocks    {blocks:9.3f}")
        print(f"  edges (full-blk)   {results['edges']:9.3f}"
              "   <- patch-embed/pos/cls/head + their requants")
        if "core_fp32" in results:
            print(f"  {args.depth}x fp32 core      "
                  f"{args.depth * results['core_fp32']:9.3f}"
                  "   <- the core alone, its rows in device memory")
        if "bf16_attn" in results and "bf16_mlp" in results:
            floor = args.depth * (results["bf16_attn"] + results["bf16_mlp"])
            print(f"  {args.depth}x bf16 blocks    {floor:9.3f}"
                  "   <- nothing-quantized floor")
    return results


if __name__ == "__main__":
    main()
