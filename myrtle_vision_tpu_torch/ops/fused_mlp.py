"""Fused transformer MLP block: x + fc2(GELU(fc1(LN(x)))), forward and
backward.

Replaces the TPU kernels of myrtle_vision_tpu/ops/fused_mlp.py: in their
plain FP32 form the forward ``_fwd_kernel`` (launched by
``_mlp_forward``) and the backward ``_bwd_kernel`` / ``_bwd_one_image``
(launched by ``_bwd_rule``); with a stateless float format's ``qspec``
the forward, inference only.  GELU is the Abramowitz & Stegun erf
polynomial with an exact divide, as in the TPU kernel's interpret mode.

On the H100 the two weights (2 x 1.2 MB in bf16 at ViT-S) do not fit an
SM's shared memory, so each direction is a chain of CUDA kernels
(ops/_kernels.py):

    forward   LN (layernorm_rows) -> fc1 GEMM + bias + GELU
                  -> fc2 GEMM + bias + residual
    backward  LN -> fc1 GEMM + bias -> GELU and GELU' (the remat)
                  -> dW2 (GEMM, A transposed, split K)
                  -> dh = (do W2^T) * GELU' (GEMM) with the db1 sums
                  -> dW1 (GEMM, A transposed, split K)
                  -> dxn = dh W1^T (GEMM, fp32) -> layernorm_rows_bwd
              and db2 through colsum_rows.

The backward recomputes LN and fc1 as the TPU kernel does; on the TPU
saving the pre-GELU rows lost to the remat (myrtle_vision_tpu/ops/
fused_mlp.py module docstring), and on the H100 that choice is still
open (ROADMAP B2).  Each direction rounds where the TPU kernel rounds,
so the plain PyTorch chain (CPU tensors) and the kernel chain (CUDA
tensors) differ only in the order of fp32 sums.

With ``qspec = (exp_bits, man_bits, all_sites)`` (FP16_16, FP16_32,
TF32) the activations are fp32 and the chain snaps where the TPU kernel
does, every snap the code of K11 (csrc/fake_quant.cuh):

    layernorm_snap_rows (snap x; LN; snap_all, snap)
      -> gemm_f32x3_epilogue (3-pass bf16 fc1 + bias, snap_all; GELU;
         snap_all, snap)
      -> gemm_f32x3_epilogue (fc2 + bias, snap_all; + x, snap_all)

Its backward (float-format QAT) is not ported: a call that would record
for one raises (ROADMAP A5a).

Weights keep the JAX layout: w1 (C, H), w2 (H, C), i.e. (in, out);
gradients come back in each input's dtype and layout.
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    QAT_NOT_PORTED,
    records,
)


def _forward(kern, x, scale, bias, w1, b1, w2, b2):
    if kern is K.CUDA and x.dtype != torch.bfloat16:
        raise TypeError(
            f"fused_mlp_block on CUDA takes bf16 activations, got {x.dtype} "
            "(compute_dtype float32 has no kernel yet)"
        )
    dt = x.dtype
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    xn = kern.layernorm_rows(x2, scale.to(dt).contiguous(),
                             bias.to(dt).contiguous())
    g = kern.gemm(xn, w1.to(dt), b1.to(dt).float().contiguous(), "bias_gelu")
    out = kern.gemm(g, w2.to(dt), b2.to(dt).float().contiguous(),
                    "bias_residual", residual=x2)
    return out.view(x.shape)


def _forward_q(kern, x, scale, bias, w1, b1, w2, b2, qspec):
    """The float-format chain (``_fwd_kernel`` with ``qspec``): fp32
    activations, parameters and weights, the weights' snaps already
    applied by the caller."""
    if x.dtype != torch.float32:
        raise TypeError(f"fused_mlp_block with qspec takes fp32 activations, "
                        f"got {x.dtype}")
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    xn = kern.layernorm_snap_rows(x2, scale.float().contiguous(),
                                  bias.float().contiguous(), qspec)
    g = kern.gemm_f32x3(xn, w1.float(), b1.float().contiguous(),
                        "bias_snap_gelu_snap", qspec)
    out = kern.gemm_f32x3(g, w2.float(), b2.float().contiguous(),
                          "bias_snap_residual_snap", qspec, residual=x2)
    return out.view(x.shape)


def _backward(kern, do, x, scale, bias, w1, b1, w2):
    """``_bwd_one_image`` over the batch -> (dx, dscale, dbias, dw1, db1,
    dw2, db2), weight gradients in the (in, out) shape."""
    dt = x.dtype
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    do2 = do.to(dt).contiguous().view(-1, c)
    s_dt = scale.to(dt).contiguous()
    w1, w2 = w1.to(dt), w2.to(dt)
    xn = kern.layernorm_rows(x2, s_dt, bias.to(dt).contiguous())
    g, gp = kern.gemm(xn, w1, b1.to(dt).float().contiguous(),
                      "bias_gelu_grad")
    # weight gradients in the torch (out, in) layout, returned as views
    dw2 = kern.gemm(do2.t(), g, None, "f32").t()
    db2 = kern.colsum_rows(do2)
    dh, db1 = kern.gemm(do2, w2.t(), None, "mul_aux", aux=gp)
    dw1 = kern.gemm(dh.t(), xn, None, "f32").t()
    dxn = kern.gemm(dh, w1.t(), None, "f32")
    dx, dscale, dbias = kern.layernorm_rows_bwd(x2, s_dt, dxn, do2)
    return dx.view(x.shape), dscale, dbias, dw1, db1, dw2, db2


class _FusedMlpBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kern, x, scale, bias, w1, b1, w2, b2):
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2)
        ctx.kern = kern
        return _forward(kern, x, scale, bias, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, do):
        inputs = ctx.saved_tensors
        grads = _backward(ctx.kern, do, *inputs[:-1])
        if ctx.kern is K.CUDA:
            fused_mlp_block.bwd_launches += 1
        return (None, *(g.to(t.dtype) for g, t in zip(grads, inputs)))


def _apply(kern, tensors, qspec):
    if qspec is not None:
        if records(tensors):
            raise NotImplementedError(f"fused_mlp_block: {QAT_NOT_PORTED}")
        return _forward_q(kern, *tensors, qspec)
    if records(tensors):
        return _FusedMlpBlock.apply(kern, *tensors)
    return _forward(kern, *tensors)


def fused_mlp_block_plain(x, scale, bias, w1, b1, w2, b2, qspec=None):
    """The plain PyTorch chain on any device, forward and backward: LN
    scale/bias, weights and both biases rounded to x.dtype, as the TPU
    kernel's caller does; with ``qspec`` everything fp32, snapped where
    the kernels snap."""
    return _apply(K.PLAIN, (x, scale, bias, w1, b1, w2, b2), qspec)


def fused_mlp_block(x, scale, bias, w1, b1, w2, b2, qspec=None):
    """x + fc2(GELU(fc1(LN(x)))) over (..., C) with weights (C, H),
    (H, C), differentiable.  A CPU tensor takes the plain chain; a CUDA
    tensor the kernel chain, forward and backward, or an error; any
    other device an error.  ``qspec`` (exp_bits, man_bits, all_sites)
    selects a float format's forward; it takes fp32 activations, weights
    already fake-quantized, and raises where it would record for a
    backward."""
    kern = K.for_device(x)
    out = _apply(kern, (x, scale, bias, w1, b1, w2, b2), qspec)
    if kern is K.CUDA:
        fused_mlp_block.launches += 1
    return out


# kernel-chain launches since the last reset (CUDA tensors only), forward
# and backward
fused_mlp_block.launches = 0
fused_mlp_block.bwd_launches = 0
