"""3-pass bf16 fp32 products (port of myrtle_vision_tpu/ops/
high_precision.py, forward only).

The JAX package computes the fp32 products of its quantized formats as
three bf16 passes, because Mosaic has no HIGH precision: ``x = hi + lo``
with ``hi = bf16(x)`` and ``lo = bf16(x - hi)``, and
``a . b = (ah.bh + ah.bl) + al.bh``, dropping al.bl.  The port emulates
the same split, so that its quantized formats compute what the JAX ones
compute: each pass is an fp32 product of bf16-representable operands,
which is exact per term, so only the fp32 summation order differs.
These functions are the plain form, used outside any kernel (the
calibrating INT8 forward; the float formats' QDense sites around the
blocks, as XLA runs them in the JAX package) and by the plain versions
of the kernels that do the same split on the tensor cores
(csrc/gemm_f32x3_epilogue.cu, csrc/attention_core_f32.cu).  On the card
fp32 products run without TF32 (the package turns TF32 off at import,
and :func:`_fp32_products` pins it around these calls).  The backward
(the custom VJPs of the JAX module) comes with QAT (ROADMAP A5a).
"""
from __future__ import annotations

import contextlib

import torch


def split_bf16(x):
    """fp32 -> (hi, lo), both bf16 values held in fp32, hi + lo ~= x."""
    x = x.float()
    hi = x.to(torch.bfloat16).float()
    lo = (x - hi).to(torch.bfloat16).float()
    return hi, lo


@contextlib.contextmanager
def _fp32_products():
    """Full fp32 CUDA matrix products (no TF32) inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _high3(a, b, product):
    ah, al = split_bf16(a)
    bh, bl = split_bf16(b)
    with _fp32_products():
        return (product(ah, bh) + product(ah, bl)) + product(al, bh)


def matmul_high3(x, w):
    """(..., K) @ (K, N) at 3-pass precision, fp32 out."""
    return _high3(x, w, torch.matmul)


def bdot_qk_high3(q, k):
    """scores[b,h,n,m] = sum_d q[b,h,n,d] k[b,h,m,d] at 3-pass
    precision."""
    return _high3(q, k, lambda a, b: torch.matmul(a, b.transpose(-1, -2)))


def bdot_pv_high3(p, v):
    """out[b,h,n,d] = sum_m p[b,h,n,m] v[b,h,m,d] at 3-pass precision."""
    return _high3(p, v, torch.matmul)
