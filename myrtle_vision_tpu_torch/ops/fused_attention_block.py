"""Fused transformer attention block: x + proj(MHA(qkv(LN(x)))), forward
and backward.

Replaces the TPU kernels of myrtle_vision_tpu/ops/fused_attention_block.py
in their plain FP32 form (no quantization snaps, ``res_scale`` 1): the
forward ``_fwd_kernel`` (launched by ``_attn_forward``) and the backward
``_bwd_kernel`` / ``_bwd_one_image`` (launched by ``_bwd_rule``).

The TPU kernel runs one image's whole block half per program with the
weights resident in VMEM; on the H100 the QKV weight alone (864 KiB in
bf16) is far larger than an SM's shared memory, so each direction is a
chain of CUDA kernels with intermediates in device memory
(ops/_kernels.py):

    forward   LN (layernorm_rows) -> QKV GEMM + bias -> attention_core
                  -> output GEMM + bias + residual
    backward  LN -> [QKV GEMM + bias, when the qkv rows were not saved]
                  -> d_o = do Wp^T (GEMM, fp32) -> attention_core_bwd
                  -> dWp, dWqkv (GEMM, A transposed, split K)
                  -> dxn = dqkv Wqkv^T (GEMM, fp32) -> layernorm_rows_bwd
              and the bias sums through colsum_rows.

Where the TPU kernel accumulates the weight gradients across its
sequential grid, each is here one product over the B*N rows.  When it
records for the backward, the forward also keeps the context, the
softmax rowmax and reciprocal rowsum and, when ``save_acts``
(ops/acts_policy.py, a copy of the JAX package's, so both packages
decide alike) affords it, the qkv rows; otherwise the backward
recomputes them.
Each direction rounds where the TPU kernel rounds, so the plain PyTorch
chain (CPU tensors) and the kernel chain (CUDA tensors) differ only in
the order of fp32 sums.

The chain takes any sequence length on the card, forward and backward:
up to 256 tokens the attention core and its backward hold one image's
keys in shared memory, above that they walk them in tiles
(csrc/attention_core.cu, csrc/attention_core_bwd.cu with
csrc/flash_bwd_tiles.cuh).  Which sequences take this op at all is the
JAX package's decision,
copied here as :func:`fuses_at`: the ViT Block fuses where the TPU kernel
fits its VMEM and otherwise runs the discrete composition, whose attention
is the flash kernel (ops/flash_attention.py).

Weights keep the JAX layout: wqkv (C, 3C) with feature order [3][h][d],
wp (C, C), i.e. (in, out).  A transposed view of a torch (out, in)
weight is read in place, and its gradient is returned as the same kind
of view.  Gradients come back in each input's dtype, as the JAX rule
casts them.
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.acts_policy import save_acts


def _per_image_stack_bytes(n: int, heads: int, d: int) -> int:
    """The JAX package's per-image VMEM stack estimate of the fused TPU
    kernel (myrtle_vision_tpu/ops/fused_attention_block.py): ~3 fp32
    copies of the (N, N) scores per head plus the fp32 qkv
    intermediates."""
    return 3 * heads * n * n * 4 + 2 * 3 * heads * d * n * 4


def fuses_at(n: int, heads: int, d: int) -> bool:
    """Whether the JAX Block fuses a sequence of ``n`` tokens (one image's
    attention working set under the TPU kernel's 40 MiB VMEM ceiling);
    the port's Block decides the same way, so that both packages run the
    same composition at every size."""
    return _per_image_stack_bytes(n, heads, d) <= 40 * 1024 * 1024


def _forward(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads, scale,
             record):
    """The chain; with ``record`` also (ctx, m, rs, qkv) for the
    backward."""
    if kern is K.CUDA and x.dtype != torch.bfloat16:
        raise TypeError(
            f"fused_attention_block on CUDA takes bf16 activations, got "
            f"{x.dtype} (compute_dtype float32 has no kernel yet)"
        )
    dt = x.dtype
    b, n, c = x.shape
    cl = wp.shape[0]
    x2 = x.contiguous().view(b * n, c)
    xn = kern.layernorm_rows(x2, scale_ln.to(dt).contiguous(),
                             bias_ln.to(dt).contiguous())
    qkv = kern.gemm(xn, wqkv.to(dt), bqkv.float().contiguous(), "bias")
    qkv3 = qkv.view(b, n, 3 * cl)
    if record:
        ctx, m, rs = kern.attention_core(qkv3, heads, scale, stats=True)
    else:
        ctx = kern.attention_core(qkv3, heads, scale)
    out = kern.gemm(ctx.view(b * n, cl), wp.to(dt),
                    bp.to(dt).float().contiguous(), "bias_residual",
                    residual=x2).view(b, n, c)
    if record:
        return out, (ctx, m, rs, qkv3)
    return out


def _backward(kern, do, x, scale_ln, bias_ln, wqkv, bqkv, wp, ctx, m, rs,
              qkv, heads, scale):
    """``_bwd_one_image`` over the batch -> (dx, dscale, dbias, dwqkv,
    dbqkv, dwp, dbp), weight gradients in the (in, out) shape."""
    dt = x.dtype
    b, n, c = x.shape
    cl = wp.shape[0]
    rows = b * n
    x2 = x.contiguous().view(rows, c)
    do2 = do.to(dt).contiguous().view(rows, c)
    s_dt = scale_ln.to(dt).contiguous()
    wqkv, wp = wqkv.to(dt), wp.to(dt)
    xn = kern.layernorm_rows(x2, s_dt, bias_ln.to(dt).contiguous())
    if qkv is None:
        qkv = kern.gemm(xn, wqkv, bqkv.float().contiguous(), "bias")
    d_o = kern.gemm(do2, wp.t(), None, "f32")
    dqkv, dbq_image = kern.attention_core_bwd(
        qkv.view(b, n, 3 * cl), d_o.view(b, n, cl), m, rs, heads, scale)
    dqkv = dqkv.view(rows, 3 * cl)
    dbq = kern.colsum_rows(dbq_image)
    # weight gradients in the torch (out, in) layout, returned as views
    dwp = kern.gemm(do2.t(), ctx.view(rows, cl), None, "f32").t()
    dbp = kern.colsum_rows(do2)
    dwqkv = kern.gemm(dqkv.t(), xn, None, "f32").t()
    dxn = kern.gemm(dqkv, wqkv.t(), None, "f32")
    dx, dscale, dbias = kern.layernorm_rows_bwd(x2, s_dt, dxn, do2)
    return dx.view(b, n, c), dscale, dbias, dwqkv, dbq, dwp, dbp


class _FusedAttentionBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                scale, depth):
        b, n, _ = x.shape
        cl = wp.shape[0]
        out, (attn, m, rs, qkv) = _forward(
            kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads, scale,
            record=True)
        if not save_acts(b * n * 3 * cl * x.element_size(), depth):
            qkv = None
        ctx.save_for_backward(x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, attn,
                              m, rs, qkv)
        ctx.kern, ctx.heads, ctx.scale = kern, heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, attn, m, rs, qkv = \
            ctx.saved_tensors
        grads = _backward(ctx.kern, do, x, scale_ln, bias_ln, wqkv, bqkv,
                          wp, attn, m, rs, qkv, ctx.heads, ctx.scale)
        if ctx.kern is K.CUDA:
            fused_attention_block.bwd_launches += 1
        inputs = (x, scale_ln, bias_ln, wqkv, bqkv, wp, bp)
        return (None, *(g.to(t.dtype) for g, t in zip(grads, inputs)),
                None, None, None)


def _apply(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads, scale,
           depth):
    tensors = (x, scale_ln, bias_ln, wqkv, bqkv, wp, bp)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedAttentionBlock.apply(kern, *tensors, heads, scale,
                                          depth)
    return _forward(kern, *tensors, heads, scale, record=False)


def fused_attention_block_plain(x, scale_ln, bias_ln, wqkv, bqkv, wp, bp,
                                heads, scale, depth=None):
    """The plain PyTorch chain on any device, forward and backward: the
    reference the kernels are held against.  It rounds where the kernels
    round: LN scale/bias, weights and bp in x.dtype, bqkv in fp32."""
    return _apply(K.PLAIN, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                  scale, depth)


def fused_attention_block(x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                          scale, depth=None):
    """x + proj(MHA(qkv(LN(x)))) over (B, N, C), the argument order of
    the JAX function, differentiable.  A CPU tensor takes the plain
    chain; a CUDA tensor the kernel chain, forward and backward, or an
    error; any other device an error.  ``depth``, the model's layer
    count, sizes the qkv-saving budget as in the JAX package."""
    kern = K.for_device(x)
    out = _apply(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                 scale, depth)
    if kern is K.CUDA:
        fused_attention_block.launches += 1
    return out


# kernel-chain launches since the last reset (CUDA tensors only), forward
# and backward
fused_attention_block.launches = 0
fused_attention_block.bwd_launches = 0
