"""K14: the block backwards' transposed contractions, by operand layout.

The counterpart of the TPU probe tools/perf/layout_probe.py (``run_case``
:37 -> ``pallas_call`` :81, its ten bodies in ``main`` :136-224 via
``_dot`` :30).  The backward passes are full of products that contract a
transposed operand: over dim 0 of an activation (dv = e^T du, dk = ds^T
q, dW = xn^T dy) and over dim 1 of a weight (dxn = dy W^T).  Each case
times one such product per image (per head where the operands are
stacks of head slices, head h at columns h N of the (N, H N) score stack
and h D of the (N, C) stack, the heads' products concatenated), bf16 in,
fp32 out, in the batched kernel csrc/gemm_layout_probe.cu:

  implicit        the transposed operand read as it is stored, through
                  column-major WMMA fragments (as the WMMA backward
                  GEMMs read theirs before csrc/gemm_bf16_wgmma.cu, which
                  reads it through the wgmma transpose bits)
  explicit T      the same product with the operand transposed as it is
                  staged into shared memory, so the fragments load
                  row-major
  pre-transposed  the weight stored (3C, C), contracted the natural way
  REF             the forward's natural products, for scale

At B=512 each case is bound by its fp32 output bytes, not by the tensor
cores (dW writes 906 MB a call): the line gives the bound and which of
bytes and operations sets it.  The TPU tool's two-length scan slope
(a workaround for a client whose block_until_ready did not synchronize)
is gone: CUDA events time the card.

    python -m myrtle_vision_tpu_torch.perf.layout_probe [--device cuda|cpu]
        [--batch 512] [--seq 197] [--dim 384] [--heads 6] [--iters 20]
        [--seed 0]
"""
from __future__ import annotations

import argparse

import torch

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.perf._timing import (
    bound,
    cost,
    nbytes,
    time_ms,
    where,
)


def cases(seq, dim, heads):
    """The ten cases: (name, per-image operand shapes (shape, batched),
    contract, per head, explicit)."""
    n, c = seq, dim
    c3 = 3 * c
    estk = ((n, heads * n), True)  # per-head (N, N) stack
    dstk = ((n, c), True)          # per-head (N, D) stack
    proj = [((n, c), True), ((n, c3), True)]
    return [
        ("dv  e^T@du   implicit (0,0)", [estk, dstk], ((0,), (0,)), True,
         False),
        ("dv  (e.T)@du explicit T", [estk, dstk], ((0,), (0,)), True, True),
        ("dp  du@v^T   implicit (1,1)", [dstk, dstk], ((1,), (1,)), True,
         False),
        ("dp  du@(v.T) explicit T", [dstk, dstk], ((1,), (1,)), True, True),
        ("s   q@k^T    implicit (1,1) REF", [dstk, dstk], ((1,), (1,)),
         True, False),
        ("dw  xn^T@dqkv implicit (0,0)", proj, ((0,), (0,)), False, False),
        ("dw  (xn.T)@dqkv explicit T", proj, ((0,), (0,)), False, True),
        ("dxn dqkv@w^T implicit (1,1)", [((n, c3), True), ((c, c3), False)],
         ((1,), (1,)), False, False),
        ("dxn dqkv@wT  pre-transposed", [((n, c3), True), ((c3, c), False)],
         ((1,), (0,)), False, False),
        ("qkv xn@w     natural REF", [((n, c), True), ((c, c3), False)],
         ((1,), (0,)), False, False),
    ]


def make_operands(shapes, batch, seed, device):
    """bf16 operands std 0.1 from ``seed`` (as the TPU tool draws them),
    batched ones (B, ...), shared ones as they are."""
    g = torch.Generator(device).manual_seed(seed)
    return [(torch.randn(((batch,) if batched else ()) + shape,
                         device=device, generator=g) * 0.1).to(torch.bfloat16)
            for shape, batched in shapes]


def case_fn(kern, a, b, contract, heads, explicit):
    """The case's product on ``kern`` (``K.CUDA`` or ``K.PLAIN``)."""
    return lambda: kern.layout_dot(a, b, contract, heads, explicit)


def case_cost(a, b, contract, heads, out_shape):
    """The bound of one call (bytes: both operands read once, the fp32
    output written once; operations: the products at the bf16 peak) and
    its yardstick: one batched ``torch.matmul`` (bmm) of the same strided
    views, heads as a batch dimension, bf16 out."""
    (ca,), (cb,) = contract
    h = heads or 1
    wa, wb = a.shape[-1] // h, b.shape[-1] // h
    k = a.shape[1] if ca == 0 else wa
    ops = 2 * out_shape[0] * out_shape[1] * out_shape[2] * k
    va, vb = a, b
    if heads:
        va = a.view(*a.shape[:-1], h, wa).transpose(-3, -2)
        vb = b.view(*b.shape[:-1], h, wb).transpose(-3, -2)
    if ca == 0:
        va = va.transpose(-1, -2)
    if cb == 1:
        vb = vb.transpose(-1, -2)
    return cost(nbytes(a, b) + 4 * out_shape.numel(), ops, "bf16",
                lambda: torch.matmul(va, vb))


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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    h = args.heads
    print(f"layout_probe: B={args.batch} N={args.seq} C={args.dim} H={h} "
          f"D={args.dim // h} bf16 in, fp32 out [{where(device)}]")
    results = {}
    for i, (name, shapes, contract, per_head, explicit) in enumerate(
            cases(args.seq, args.dim, h)):
        a, b = make_operands(shapes, args.batch, args.seed + i, device)
        heads = h if per_head else None
        fn = case_fn(K.for_device(a), a, b, contract, heads, explicit)
        out = fn()
        ms = time_ms(fn, device, args.iters)
        b_ms, by = bound(case_cost(a, b, contract, heads, out.shape))
        results[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": by,
                         "out": tuple(out.shape)}
        print(f"{name:34s} {ms:8.3f} ms/iter   bound {b_ms:.4f} ms ({by}), "
              f"out {tuple(out.shape)} fp32", flush=True)
        del a, b, out
    return results


if __name__ == "__main__":
    main()
