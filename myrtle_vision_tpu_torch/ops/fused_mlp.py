"""Fused transformer MLP block: x * res_scale + fc2(GELU(fc1(LN(x)))),
forward and backward.

Replaces the TPU kernels of myrtle_vision_tpu/ops/fused_mlp.py: in their
plain FP32 form the forward ``_fwd_kernel`` (launched by
``_mlp_forward``) and the backward ``_bwd_kernel`` / ``_bwd_one_image``
(launched by ``_bwd_rule``); with a stateless float format's ``qspec``
the same forward and backward (QAT).  GELU is the Abramowitz & Stegun erf
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

Its backward keeps only the inputs, as the JAX ``_fwd_rule`` does, and
recomputes LN, fc1 and the GELU with their snaps; every site is
straight-through and every product 3-pass (``_bwd_one_image`` with
``qspec``):

    layernorm_snap_rows (xn) -> gemm_f32x3_epilogue, fc1 with
      bias_snap_gelu_snap_grad (g and GELU', one erf)
      -> dW2 (gemm_f32x3_epilogue, A transposed, split K)
      -> dh = (do W2^T) * GELU' (gemm_f32x3_epilogue, mul_aux) with the
         db1 sums -> dW1 (A transposed) -> dxn = dh W1^T (f32)
      -> layernorm_rows_bwd (its snap form)
    and db2 through colsum_rows.

PyTorchINT8's two-pass QAT (the JAX ``fused_mlp_block_i8``: the TPU
kernels with ``qspec="int8"``) runs the same chains with the frozen
observer sites in place of the float snaps, ``qspec`` the block half's
(5, 3) site table on the activation's device (ops/fused_attention_block.py
says how): the LayerNorm's output (row 0), fc1 after its bias (1), the
GELU's output (2; the backward's fc1 recompute snaps it again, and dW2
contracts against it), fc2 after its bias (3) and the residual sum (4).

On fp32 activations (``compute_dtype`` float32, ``qspec`` None) the card
runs the ``qspec`` chain with a site table that snaps nothing
(ops/fused_attention_block.py ``no_snap_sites``): 3-pass products against
the plain chain's true fp32 ones.

``res_scale`` (1 unless hidden-sharded tensor parallelism runs the op on
its local hidden columns: then 1/n_tp, with w1 (C, H/n_tp), b1 (H/n_tp,),
w2 (H/n_tp, C) and b2 pre-scaled by 1/n_tp, parallel/tp.py) scales the
residual in fc2's epilogue and the upstream gradient in the LayerNorm
backward, as in ops/fused_attention_block.py.

Weights keep the JAX layout: w1 (C, H), w2 (H, C), i.e. (in, out);
gradients come back in each input's dtype and layout.
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fake_quant import kernel_sites
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    _kernel_chain_f32,
    _site_table,
    no_snap_sites,
    records,
)


def _forward(kern, x, scale, bias, w1, b1, w2, b2, res_scale=1.0):
    if _kernel_chain_f32(kern, x):
        return _forward_q(kern, x, scale, bias, w1, b1, w2, b2,
                          no_snap_sites(x.device), res_scale)
    dt = x.dtype
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    xn = kern.layernorm_rows(x2, scale.to(dt).contiguous(),
                             bias.to(dt).contiguous())
    g = kern.gemm(xn, w1.to(dt), b1.to(dt).float().contiguous(), "bias_gelu")
    out = kern.gemm(g, w2.to(dt), b2.to(dt).float().contiguous(),
                    "bias_residual", residual=x2, res_scale=res_scale)
    return out.view(x.shape)


def _forward_q(kern, x, scale, bias, w1, b1, w2, b2, qspec, res_scale=1.0):
    """The float-format chain (``_fwd_kernel`` with ``qspec``), or INT8
    QAT's (``qspec`` the (5, 3) site table): fp32 activations, parameters
    and weights, the weights' snaps already applied by the caller."""
    if x.dtype != torch.float32:
        raise TypeError(f"fused_mlp_block with qspec takes fp32 activations, "
                        f"got {x.dtype}")
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    xn = kern.layernorm_snap_rows(x2, scale.float().contiguous(),
                                  bias.float().contiguous(),
                                  kernel_sites(qspec, 0))
    g = kern.gemm_f32x3(xn, w1.float(), b1.float().contiguous(),
                        "bias_snap_gelu_snap", kernel_sites(qspec, 1, 2))
    out = kern.gemm_f32x3(g, w2.float(), b2.float().contiguous(),
                          "bias_snap_residual_snap", kernel_sites(qspec, 3, 4),
                          residual=x2, res_scale=res_scale)
    return out.view(x.shape)


def _backward(kern, do, x, scale, bias, w1, b1, w2, res_scale=1.0):
    """``_bwd_one_image`` over the batch -> (dx, dscale, dbias, dw1, db1,
    dw2, db2), weight gradients in the (in, out) shape."""
    if _kernel_chain_f32(kern, x):
        return _backward_q(kern, do, x, scale, bias, w1, b1, w2,
                           no_snap_sites(x.device), res_scale)
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
    dx, dscale, dbias = kern.layernorm_rows_bwd(x2, s_dt, dxn, do2,
                                                res_scale=res_scale)
    return dx.view(x.shape), dscale, dbias, dw1, db1, dw2, db2


def _backward_q(kern, do, x, scale, bias, w1, b1, w2, qspec, res_scale=1.0):
    """``_bwd_one_image`` with ``qspec`` (a float format's, or INT8's
    site table) over the batch, fp32 -> (dx, dscale, dbias, dw1, db1, dw2,
    db2), weight gradients in the (in, out) shape."""
    c = x.shape[-1]
    x2 = x.contiguous().view(-1, c)
    do2 = do.float().contiguous().view(-1, c)
    s32 = scale.float().contiguous()
    w1, w2 = w1.float(), w2.float()
    xn = kern.layernorm_snap_rows(x2, s32, bias.float().contiguous(),
                                  kernel_sites(qspec, 0))
    g, gp = kern.gemm_f32x3(xn, w1, b1.float().contiguous(),
                            "bias_snap_gelu_snap_grad",
                            kernel_sites(qspec, 1, 2))
    qspec = kernel_sites(qspec)  # the products below snap nothing
    # weight gradients in the torch (out, in) layout, returned as views
    dw2 = kern.gemm_f32x3(do2.t(), g, None, "f32", qspec).t()
    db2 = kern.colsum_rows(do2)
    dh, db1 = kern.gemm_f32x3(do2, w2.t(), None, "mul_aux", qspec, aux=gp)
    dw1 = kern.gemm_f32x3(dh.t(), xn, None, "f32", qspec).t()
    dxn = kern.gemm_f32x3(dh, w1.t(), None, "f32", qspec)
    dx, dscale, dbias = kern.layernorm_rows_bwd(x2, s32, dxn, do2, qspec,
                                                res_scale=res_scale)
    return dx.view(x.shape), dscale, dbias, dw1, db1, dw2, db2


class _FusedMlpBlock(torch.autograd.Function):
    """The op, FP32, with a float format's ``qspec`` or with INT8's site
    table: the forward keeps its inputs, the backward recomputes (the JAX
    ``_fwd_rule`` / ``_bwd_rule`` pair, and their ``_i8`` forms)."""

    @staticmethod
    def forward(ctx, kern, x, scale, bias, w1, b1, w2, b2, qspec, res_scale):
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2)
        ctx.kern, ctx.qspec, ctx.res_scale = kern, qspec, res_scale
        if qspec is None:
            return _forward(kern, x, scale, bias, w1, b1, w2, b2, res_scale)
        return _forward_q(kern, x, scale, bias, w1, b1, w2, b2, qspec,
                          res_scale)

    @staticmethod
    def backward(ctx, do):
        inputs = ctx.saved_tensors
        if ctx.qspec is None:
            grads = _backward(ctx.kern, do, *inputs[:-1], ctx.res_scale)
        else:
            grads = _backward_q(ctx.kern, do, *inputs[:-1], ctx.qspec,
                                ctx.res_scale)
        if ctx.kern is K.CUDA:
            op = (fused_mlp_block_i8 if isinstance(ctx.qspec, torch.Tensor)
                  else fused_mlp_block)
            op.bwd_launches += 1
        return (None, *(g.to(t.dtype) for g, t in zip(grads, inputs)), None,
                None)


def _apply(kern, tensors, qspec, res_scale=1.0):
    res_scale = K.residual_scale(res_scale)
    if records(tensors):
        return _FusedMlpBlock.apply(kern, *tensors, qspec, res_scale)
    if qspec is not None:
        return _forward_q(kern, *tensors, qspec, res_scale)
    return _forward(kern, *tensors, res_scale)


def fused_mlp_block_plain(x, scale, bias, w1, b1, w2, b2, qspec=None,
                          res_scale=1.0):
    """The plain PyTorch chain on any device, forward and backward: LN
    scale/bias, weights and both biases rounded to x.dtype, as the TPU
    kernel's caller does; with ``qspec`` everything fp32, snapped where
    the kernels snap."""
    return _apply(K.PLAIN, (x, scale, bias, w1, b1, w2, b2), qspec, res_scale)


def fused_mlp_block(x, scale, bias, w1, b1, w2, b2, qspec=None,
                    res_scale=1.0):
    """x * res_scale + fc2(GELU(fc1(LN(x)))) over (..., C) with weights
    (C, H), (H, C), differentiable.  A CPU tensor takes the plain chain; a CUDA
    tensor the kernel chain, forward and backward, or an error; any
    other device an error.  ``qspec`` (exp_bits, man_bits, all_sites)
    selects a float format's chains, forward and backward; it takes fp32
    activations and weights already fake-quantized (the caller's
    straight-through estimator carries their gradient).  ``res_scale``
    (a finite real number; 1/n_tp with the local hidden columns under
    tensor parallelism) scales the residual."""
    kern = K.for_device(x)
    out = _apply(kern, (x, scale, bias, w1, b1, w2, b2), qspec, res_scale)
    if kern is K.CUDA:
        fused_mlp_block.launches += 1
    return out


def fused_mlp_block_i8_plain(x, scale, bias, w1, b1, w2, b2, qs):
    """The plain PyTorch chain of :func:`fused_mlp_block_i8` on any
    device, forward and backward."""
    return _apply(K.PLAIN, (x, scale, bias, w1, b1, w2, b2),
                  _site_table(qs, x))


def fused_mlp_block_i8(x, scale, bias, w1, b1, w2, b2, qs):
    """The JAX ``fused_mlp_block_i8`` (two-pass INT8 QAT): x +
    fc2(GELU(fc1(LN(x)))) over fp32 (..., C) with PyTorchINT8's affine
    uint8 snaps at the five observer sites of the discrete path, rows 0-4
    of ``qs`` (5, 3), frozen for the pass; straight-through sites, no
    gradient for ``qs``, weights already fake-quantized.  A CPU tensor
    takes the plain chain, a CUDA tensor the kernel chain or an error."""
    kern = K.for_device(x)
    out = _apply(kern, (x, scale, bias, w1, b1, w2, b2), _site_table(qs, x))
    if kern is K.CUDA:
        fused_mlp_block_i8.launches += 1
    return out


# kernel-chain launches since the last reset (CUDA tensors only), forward
# and backward
fused_mlp_block.launches = 0
fused_mlp_block.bwd_launches = 0
fused_mlp_block_i8.launches = 0
fused_mlp_block_i8.bwd_launches = 0
