"""K13: the MLP-block forward with GELU variants, timed on the card.

The counterpart of the TPU probe tools/perf/mlp_microbench.py (``_call``
:113 -> ``pallas_call`` :119, body ``_kernel`` :82 with ``_erf_variant``
:54).  Each variant is x + fc2(GELU(fc1(LN x))) over bf16 (B, N, C) rows,
a chain of the port's kernels, the GELU in the fc1 GEMM's epilogue
(csrc/gemm_bf16_epilogue.cu) in the variant's mode:

  prod    the production ``fused_mlp_block`` (K3's chain on the wgmma
          GEMM csrc/gemm_bf16_wgmma.cu; it rounds the fc1 and fc2 biases
          to bf16, as the JAX op does); the variants below run the WMMA
          GEMM that it replaced
  base    the production GELU: the A&S 7.1.26 erf with an exact divide
  nogelu  h passed through: bounds all of the GELU's cost (a diagnostic)
  noexp   the erf without its exp term: the exp's cost (wrong on purpose,
          a diagnostic)
  nodiv   t = 1 / (1 + 0.3275911 |x|) from the approximate reciprocal
          (``rcp.approx.ftz.f32``) and one Newton step, ~2^-24 relative:
          what the exact divide costs on Hopper
  pipe    base's function scheduled otherwise: the two halves of the
          batch on two CUDA streams, so that one half's fc1 epilogue runs
          beside the other half's GEMMs (the counterpart of the TPU
          kernel's image loop with fc1 of image j+1 issued before the GELU
          of image j); it returns the two halves

It checks base, nodiv and pipe against prod, then prints each variant's
ms per call and its share of the H100's 989 TFLOP/s bf16 peak.
``--group`` and ``MVT_MLP_FWD_ROWS`` of the TPU tool are gone: they set
the images per program of the TPU grid.

    python -m myrtle_vision_tpu_torch.perf.mlp_microbench \\
        [--device cuda|cpu] [--batch 512] [--seq 197] [--dim 384] \\
        [--iters 20] [--variants prod,base,...] [--seed 0]
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    fused_mlp_block_plain,
)
from myrtle_vision_tpu_torch.perf._timing import (
    bound,
    cost,
    device_rates,
    nbytes,
    time_ms,
    where,
)

VARIANTS = ("prod", "base", "nogelu", "noexp", "nodiv", "pipe")
# the variants the TPU tool holds against prod (the others change the
# function on purpose)
CHECKED = ("base", "nodiv", "pipe")


def make_inputs(batch, seq, dim, seed, device):
    """The TPU tool's inputs, drawn from ``seed``: x bf16 (B, N, C) std 1,
    the LayerNorm's ones and zeros (bf16), w1 (C, 4C) and w2 (4C, C) bf16
    std 0.05, b1 and b2 fp32 std 0.01."""
    g = torch.Generator(device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=g)

    c = dim
    return {
        "x": randn(batch, seq, c).to(bf),
        "ln_s": torch.ones(c, dtype=bf, device=device),
        "ln_b": torch.zeros(c, dtype=bf, device=device),
        "w1": (randn(c, 4 * c) * 0.05).to(bf), "b1": randn(4 * c) * 0.01,
        "w2": (randn(4 * c, c) * 0.05).to(bf), "b2": randn(c) * 0.01,
    }


def probe_block(kern, x, ln_s, ln_b, w1, b1, w2, b2, gelu):
    """LN -> fc1 with the GELU of mode ``gelu`` -> fc2 + residual on
    ``kern`` (``K.CUDA`` or ``K.PLAIN``); fp32 biases as they are."""
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    xn = kern.layernorm_rows(x2, ln_s, ln_b)
    g = kern.gemm_probe(xn, w1, b1.float().contiguous(), "bias_gelu",
                        gelu=gelu)
    out = kern.gemm_probe(g, w2, b2.float().contiguous(), "bias_residual",
                          residual=x2)
    return out.view(x.shape)


def variants(inputs, plain=False):
    """{variant: thunk} over ``inputs`` (:func:`make_inputs`); the kernel
    chains, or with ``plain`` their plain versions.  ``pipe`` gives the
    two halves of the batch."""
    kern = K.PLAIN if plain else K.for_device(inputs["x"])
    args = [inputs[k] for k in ("x", "ln_s", "ln_b", "w1", "b1", "w2", "b2")]
    x = inputs["x"]
    halves = x.chunk(2)
    streams = None
    if x.is_cuda:
        streams = [torch.cuda.Stream(x.device) for _ in halves]

    def pipe():
        if streams is None:
            return tuple(probe_block(kern, h, *args[1:], "base")
                         for h in halves)
        main = torch.cuda.current_stream(x.device)
        outs = []
        for half, stream in zip(halves, streams):
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                outs.append(probe_block(kern, half, *args[1:], "base"))
        for out, stream in zip(outs, streams):
            main.wait_stream(stream)
            out.record_stream(main)  # made on its stream, used on main
        return tuple(outs)

    op = fused_mlp_block_plain if plain else fused_mlp_block
    out = {"prod": lambda: op(*args), "pipe": pipe}
    for name in ("base", "nogelu", "noexp", "nodiv"):
        out[name] = (lambda name=name: probe_block(kern, *args, name))
    return out


def joined(out):
    """A variant's output as one tensor (``pipe`` gives two halves)."""
    return torch.cat(out) if isinstance(out, tuple) else out


def variant_cost(inputs):
    """The bound of one call (bytes: x in, the block out, the weights and
    biases; operations: the two products at the bf16 peak) and its
    yardstick, the eager block: F.layer_norm, cuBLAS bf16, F.gelu."""
    x = inputs["x"]
    b, n, c = x.shape
    w = [inputs[k] for k in ("w1", "b1", "w2", "b2")]

    def eager():
        xn = F.layer_norm(x.float(), (c,), inputs["ln_s"].float(),
                          inputs["ln_b"].float(), K.EPS).to(x.dtype)
        g = F.gelu(torch.matmul(xn, w[0]) + w[1].to(x.dtype))
        return x + (torch.matmul(g, w[2]) + w[3].to(x.dtype))

    return cost(2 * nbytes(x) + nbytes(*w), 4 * b * n * c * 4 * c, "bf16",
                eager)


def main(argv=None):
    from myrtle_vision_tpu_torch.classification.test import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = args.variants.split(",")
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"mlp_microbench: unknown variants {unknown}")
    inputs = make_inputs(args.batch, args.seq, args.dim, args.seed, device)
    fns = variants(inputs)
    b, n, c = inputs["x"].shape
    print(f"mlp_microbench: B={b} N={n} C={c} M={4 * c} bf16 "
          f"[{where(device)}]")

    ref = fns["prod"]().float()
    results = {name: {} for name in names}
    for name in names:
        if name in CHECKED:
            err = (joined(fns[name]()).float() - ref).abs().max().item()
            results[name]["max_diff"] = err
            print(f"{name:8s} max|diff| vs prod = {err:.5f}")
    del ref

    c_ = variant_cost(inputs)
    b_ms, by = bound(c_)
    for name in names:
        ms = time_ms(fns[name], device, args.iters)
        results[name].update(ms=ms, bound_ms=b_ms, bound_by=by)
        print(f"{name:8s} {ms:8.3f} ms/iter   "
              + device_rates(device, c_["ops"], ms, b)
              + f"   bound {b_ms:.4f} ms ({by})")
    return results


if __name__ == "__main__":
    main()
