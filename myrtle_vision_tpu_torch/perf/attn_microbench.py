"""K12: the attention-block forward variants, timed on the card.

The counterpart of the TPU probe tools/perf/attn_microbench.py (its Pallas
variants, ``_call`` :266 -> ``pallas_call`` :275).  Each variant is x +
proj(core(qkv(LN x))) over bf16 (B, N, C) rows, a chain of the port's own
kernels with the attention core (csrc/attention_core.cu) in the mode that
computes what the TPU variant's body computes, so the probe splits the
time of the port's kernel, not of a copy:

  base      the production ``fused_attention_block`` (K1's chain, on the
            wgmma kernels csrc/gemm_bf16_wgmma.cu and
            csrc/attention_core_wgmma.cu; the variants below run the
            WMMA designs those replaced, so they compare within one)
  pvrow     rowmajor's function with the QKV weight head-major (3, H, C,
            D), read in panels by the GEMM (``_kernel_pvrow``)
  rowmajor  s = (q k^T) scale in fp32, p = bf16(e / rowsum), p v
  defer     s = bf16(q scale) k^T, bf16(e) v / rowsum with a true divide
            (the production core multiplies by the reciprocal)
  pipe      defer, with each warp's next S product issued before its
            softmax (``_kernel_pipe``'s overlap of products and softmax)
  dotonly   only the products: bf16(x W), bf16(bf16(q k^T) v), bf16(o Wp),
            no LayerNorm, bias, scale, softmax or residual
  none      defer with e = s 0.01 (no max, no exp), a diagnostic
  nomax     defer with e = exp(s) (no max-subtract), a diagnostic
  sumdot    defer with the rowsum from the P V product (a column of ones)
  xlaattn   the whole block in eager PyTorch (F.layer_norm, cuBLAS bf16,
            scaled_dot_product_attention): a yardstick, as XLA is in the
            TPU tool; the port never calls it
  xlamlp    the MLP block in eager PyTorch (F.gelu): a yardstick
  mlp       the production ``fused_mlp_block`` (K3's chain, on the wgmma GEMM)

It checks each variant against ``base`` (``mlp`` for ``xlamlp``) and
prints the largest difference, then each variant's ms per call and its
share of the H100's 989 TFLOP/s bf16 peak (of the block's matrix-product
FLOPs).  ``--group`` and ``MVT_MLP_FWD_ROWS`` of the TPU tool are gone:
they set the images per program of the TPU grid, and a CUDA kernel's grid
follows from the shapes.

    python -m myrtle_vision_tpu_torch.perf.attn_microbench \\
        [--device cuda|cpu] [--batch 512] [--seq 197] [--dim 384] \\
        [--heads 6] [--iters 20] [--variants base,pvrow,...] [--seed 0]
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
    fused_attention_block_plain,
)
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

# every variant, in the order of the TPU tool; the core mode of each chain
VARIANTS = ("base", "pvrow", "rowmajor", "defer", "pipe", "dotonly", "none",
            "nomax", "sumdot", "xlaattn", "xlamlp", "mlp")
CORE_MODES = {"pvrow": "rowmajor", "rowmajor": "rowmajor", "defer": "defer",
              "pipe": "pipe", "dotonly": "dotonly", "none": "none",
              "nomax": "nomax", "sumdot": "sumdot"}
YARDSTICKS = ("xlaattn", "xlamlp")
MLP_VARIANTS = ("xlamlp", "mlp")


def attn_flops(n, c, heads):
    """Matrix-product FLOPs of one image's attention block."""
    return 2 * n * c * 3 * c + 4 * heads * n * n * (c // heads) + 2 * n * c * c


def mlp_flops(n, c, hidden):
    return 4 * n * c * hidden


def make_inputs(batch, seq, dim, heads, seed, device):
    """The TPU tool's inputs, drawn from ``seed``: x bf16 (B, N, C) std 1,
    the LayerNorm's ones and zeros (bf16), wqkv (C, 3C) and wp (C, C) std
    0.05 and their biases std 0.01 (fp32, cast per variant by
    :func:`variant_weights`), the MLP's w1 (C, 4C) and w2 (4C, C) bf16
    std 0.05 with zero fp32 biases."""
    g = torch.Generator(device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=g)

    c = dim
    return {
        "x": randn(batch, seq, c).to(bf),
        "ln_s": torch.ones(c, dtype=bf, device=device),
        "ln_b": torch.zeros(c, dtype=bf, device=device),
        "wqkv": randn(c, 3 * c) * 0.05, "bqkv": randn(3 * c) * 0.01,
        "wp": randn(c, c) * 0.05, "bp": randn(c) * 0.01,
        "w1": (randn(c, 4 * c) * 0.05).to(bf),
        "b1": torch.zeros(4 * c, device=device),
        "w2": (randn(4 * c, c) * 0.05).to(bf),
        "b2": torch.zeros(c, device=device),
    }


def variant_weights(wqkv, bqkv, wp, bp, heads):
    """{variant: (w, bq, wp, bp)} from the fp32 (C, 3C) QKV weight and
    the rest, with the casts each TPU variant applies: bf16 weights and
    an fp32 QKV bias throughout, ``bp`` fp32 for ``base`` and bf16 for
    the probe chains; ``pvrow``'s QKV weight head-major, w3 (3, H, C, D),
    and its bias bq3 (3, H, D) (``attn_microbench.py`` :325-350)."""
    bf = torch.bfloat16
    c = wqkv.shape[0]
    d = c // heads
    probe = (wqkv.to(bf), bqkv.float(), wp.to(bf), bp.to(bf))
    out = {name: probe for name in CORE_MODES}
    out["base"] = (wqkv.to(bf), bqkv.float(), wp.to(bf), bp.float())
    out["pvrow"] = (
        wqkv.reshape(c, 3, heads, d).permute(1, 2, 0, 3).contiguous().to(bf),
        bqkv.reshape(3, heads, d).float(), wp.to(bf), bp.to(bf))
    return out


def probe_block(kern, x, ln_s, ln_b, w, bq, wp, bp, heads, variant):
    """A probe variant's chain on ``kern`` (``K.CUDA`` or ``K.PLAIN``)."""
    b, n, c = x.shape
    x2 = x.contiguous().view(b * n, c)
    scale = (c // heads) ** -0.5
    if variant == "dotonly":
        qkv = kern.gemm_probe(x2, w, None, "store")
    else:
        xn = kern.layernorm_rows(x2, ln_s, ln_b)
        qkv = kern.gemm_probe(xn, w, bq.reshape(-1).contiguous(), "bias")
    ctx = kern.attention_core_probe(qkv.view(b, n, 3 * c), heads, scale,
                                    CORE_MODES[variant]).view(b * n, c)
    if variant == "dotonly":
        y = kern.gemm_probe(ctx, wp, None, "store")
    else:
        y = kern.gemm_probe(ctx, wp, bp.float().contiguous(),
                            "bias_residual", residual=x2)
    return y.view(b, n, c)


def eager_attention(x, ln_s, ln_b, wqkv, bqkv, wp, bp, heads):
    """The attention block in eager PyTorch: the yardstick ``xlaattn``."""
    b, n, c = x.shape
    dt = x.dtype
    xn = F.layer_norm(x.float(), (c,), ln_s.float(), ln_b.float(),
                      K.EPS).to(dt)
    qkv = torch.matmul(xn, wqkv.to(dt)) + bqkv.to(dt)
    q, k, v = qkv.view(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=(c // heads) ** -0.5)
    o = o.transpose(1, 2).reshape(b, n, c)
    return x + (torch.matmul(o, wp.to(dt)) + bp.to(dt))


def eager_mlp(x, ln_s, ln_b, w1, b1, w2, b2):
    """The MLP block in eager PyTorch: the yardstick ``xlamlp``."""
    c = x.shape[-1]
    dt = x.dtype
    xn = F.layer_norm(x.float(), (c,), ln_s.float(), ln_b.float(),
                      K.EPS).to(dt)
    g = F.gelu(torch.matmul(xn, w1) + b1.to(dt))
    return x + (torch.matmul(g, w2) + b2.to(dt))


def variants(inputs, heads, plain=False):
    """{variant: thunk} over ``inputs`` (:func:`make_inputs`); the kernel
    chains, or with ``plain`` their plain versions (the yardsticks are
    the same eager calls either way)."""
    kern = K.PLAIN if plain else K.for_device(inputs["x"])
    x, ln_s, ln_b = inputs["x"], inputs["ln_s"], inputs["ln_b"]
    weights = variant_weights(inputs["wqkv"], inputs["bqkv"], inputs["wp"],
                              inputs["bp"], heads)
    mlp_args = [inputs[k] for k in ("w1", "b1", "w2", "b2")]
    scale = (x.shape[-1] // heads) ** -0.5
    attn_op = fused_attention_block_plain if plain else fused_attention_block
    mlp_op = fused_mlp_block_plain if plain else fused_mlp_block
    out = {
        "base": lambda: attn_op(x, ln_s, ln_b, *weights["base"], heads,
                                scale),
        "xlaattn": lambda: eager_attention(x, ln_s, ln_b, inputs["wqkv"],
                                           inputs["bqkv"], inputs["wp"],
                                           inputs["bp"], heads),
        "xlamlp": lambda: eager_mlp(x, ln_s, ln_b, *mlp_args),
        "mlp": lambda: mlp_op(x, ln_s, ln_b, *mlp_args),
    }
    for name in CORE_MODES:
        out[name] = (lambda name=name: probe_block(
            kern, x, ln_s, ln_b, *weights[name], heads, name))
    return out


def variant_cost(name, inputs, heads):
    """The bound of one call of a variant (bytes: x in, the block out,
    the weights; operations: its matrix products at the bf16 peak) and
    its yardstick: the eager block (F.layer_norm, cuBLAS, SDPA, F.gelu)."""
    x = inputs["x"]
    b, n, c = x.shape
    if name in MLP_VARIANTS:
        w = [inputs[k] for k in ("w1", "b1", "w2", "b2")]
        return cost(2 * nbytes(x) + nbytes(*w), b * mlp_flops(n, c, 4 * c),
                    "bf16", lambda: eager_mlp(x, inputs["ln_s"],
                                              inputs["ln_b"], *w))
    moved = 2 * nbytes(x) + 2 * (3 * c * c + c * c) + 4 * 3 * c + 2 * c
    return cost(moved, b * attn_flops(n, c, heads), "bf16",
                lambda: eager_attention(x, inputs["ln_s"], inputs["ln_b"],
                                        inputs["wqkv"], inputs["bqkv"],
                                        inputs["wp"], inputs["bp"], heads))


def main(argv=None):
    from myrtle_vision_tpu_torch.classification.test import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--seq", type=int, default=197)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--heads", type=int, default=6)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    names = args.variants.split(",")
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise SystemExit(f"attn_microbench: unknown variants {unknown}")
    inputs = make_inputs(args.batch, args.seq, args.dim, args.heads,
                         args.seed, device)
    fns = variants(inputs, args.heads)
    b, n, c = inputs["x"].shape
    print(f"attn_microbench: B={b} N={n} C={c} H={args.heads} bf16 "
          f"[{where(device)}]")

    # numerics against the production chains
    refs = {"base": fns["base"](), "mlp": fns["mlp"]()}
    results = {}
    for name in names:
        ref = refs["mlp" if name in MLP_VARIANTS else "base"]
        err = (fns[name]().float() - ref.float()).abs().max().item()
        results[name] = {"max_diff": err}
        if name not in ("base", "mlp"):
            print(f"{name:10s} max|diff| vs "
                  f"{'mlp' if name in MLP_VARIANTS else 'base'} = {err:.4f}")
    del refs

    for name in names:
        ms = time_ms(fns[name], device, args.iters)
        c_ = variant_cost(name, inputs, args.heads)
        b_ms, by = bound(c_)
        results[name].update(ms=ms, bound_ms=b_ms, bound_by=by)
        print(f"{name:10s} {ms:8.3f} ms/iter   "
              + device_rates(device, c_["ops"], ms, b)
              + f"   bound {b_ms:.4f} ms ({by})")
    return results


if __name__ == "__main__":
    main()
