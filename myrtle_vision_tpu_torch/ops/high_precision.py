"""3-pass bf16 fp32 products (port of myrtle_vision_tpu/ops/
high_precision.py).

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
(csrc/gemm_f32x3_wgmma.cu, csrc/attention_core_f32_wgmma.cu,
csrc/attention_core_f32_bwd_wgmma.cu).  On the card fp32 products run without
TF32 (the package turns TF32 off at import, and :func:`_fp32_products`
pins it around these calls).

:func:`matmul_high3` is differentiable with the JAX custom VJP's
backward: dx = high3(do, w^T) and dw = high3(x^T, do), the incoming
gradient split hi / lo as well.  Autodiff through the split would drop
the gradient's low half (the ``lo`` branch's derivative is zero, since
d/dx [x - bf16(x)] = 0 almost everywhere).  The batched attention
products :func:`bdot_qk_high3` and :func:`bdot_pv_high3` carry the JAX
custom VJPs' 3-pass backwards (``_qk_bwd``, ``_pv_bwd``) the same way,
for the float formats' discrete attention core (ops/attention.py
``impl="xla"``); inside the fused op their backward is written out
(ops/fused_attention_block.py).
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


class _MatmulHigh3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _high3(x, w, torch.matmul)

    @staticmethod
    def backward(ctx, do):
        x, w = ctx.saved_tensors
        do = do.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _high3(do, w.transpose(-1, -2), torch.matmul).to(x.dtype)
        if ctx.needs_input_grad[1]:
            # contract every leading (batch, row) axis
            dw = _high3(x.reshape(-1, x.shape[-1]).t(),
                        do.reshape(-1, do.shape[-1]),
                        torch.matmul).to(w.dtype)
        return dx, dw


def matmul_high3(x, w):
    """(..., K) @ (K, N) at 3-pass precision, fp32 out; its backward runs
    the same 3-pass products on the incoming gradient (``_mm_bwd``)."""
    return _MatmulHigh3.apply(x, w)


def matmul_fp32(x, w):
    """(..., K) @ (K, N) in full fp32 on any device (TF32 off): the JAX
    package's ``precision=HIGHEST`` dot, which the PyTorchINT8
    simulation's eval forward runs outside any kernel."""
    with _fp32_products():
        return torch.matmul(x.float(), w.float())


def _qk(a, b):
    return torch.matmul(a, b.transpose(-1, -2))


def _tr(t):
    return t.transpose(-1, -2)


class _BdotQK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return _high3(q, k, _qk)

    @staticmethod
    def backward(ctx, ds):
        q, k = ctx.saved_tensors
        ds = ds.float()
        dq = dk = None
        if ctx.needs_input_grad[0]:
            dq = _high3(ds, k, torch.matmul).to(q.dtype)
        if ctx.needs_input_grad[1]:
            dk = _high3(_tr(ds), q, torch.matmul).to(k.dtype)
        return dq, dk


class _BdotPV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, v):
        ctx.save_for_backward(p, v)
        return _high3(p, v, torch.matmul)

    @staticmethod
    def backward(ctx, g):
        p, v = ctx.saved_tensors
        g = g.float()
        dp = dv = None
        if ctx.needs_input_grad[0]:
            dp = _high3(g, v, _qk).to(p.dtype)
        if ctx.needs_input_grad[1]:
            dv = _high3(_tr(p), g, torch.matmul).to(v.dtype)
        return dp, dv


def bdot_qk_high3(q, k):
    """scores[b,h,n,m] = sum_d q[b,h,n,d] k[b,h,m,d] at 3-pass precision;
    its backward (``_qk_bwd``): dq = high3(ds, k), dk = high3(ds^T, q)."""
    return _BdotQK.apply(q, k)


def bdot_pv_high3(p, v):
    """out[b,h,n,d] = sum_m p[b,h,n,m] v[b,h,m,d] at 3-pass precision; its
    backward (``_pv_bwd``): dp = high3(g, v^T), dv = high3(p^T, g)."""
    return _BdotPV.apply(p, v)
