"""Fused transformer attention block: x * res_scale + proj(MHA(qkv(LN(x)))),
forward and backward.

Replaces the TPU kernels of myrtle_vision_tpu/ops/fused_attention_block.py:
in the plain FP32 form (no quantization snaps) the
forward ``_fwd_kernel`` (launched by ``_attn_forward``) and the backward
``_bwd_kernel`` / ``_bwd_one_image`` (launched by ``_bwd_rule``); with a
stateless float format's ``qspec = (exp_bits, man_bits, all_sites)``
(FP16_16, FP16_32, TF32) the same forward and backward (QAT).

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

On fp32 activations (``compute_dtype`` float32, ``qspec`` None) the TPU
kernel takes ``_dot`` with true fp32 products (interpret mode on the
CPU, where the plain chain above reproduces it).  On the card that form
runs the ``qspec`` chain below with a site table whose rows have no
statistics (:func:`no_snap_sites`), so that no kernel snaps: its
LayerNorm, 3-pass GEMMs, fp32 attention core and their backwards.  The
3-pass bf16 split loses about 2^-16 of each product, where the plain
chain's fp32 products lose about 2^-24 (chip_smoke.py holds the two
against each other with a stated bar); the core puts the scale after the
scores' sum and divides by the rowsum, where the plain chain scales q
first and multiplies by the reciprocal, which differ by fp32 roundings.

The chain takes any sequence length on the card, forward and backward:
up to 256 tokens the attention core and its backward hold one image's
keys in shared memory, above that they walk them in tiles fed by TMA
(csrc/attention_core_long_wgmma.cu, csrc/attention_core_bwd_long_wgmma.cu).
Which sequences take this op at all is the JAX package's decision,
copied here as :func:`fuses_at`: the ViT Block fuses where the TPU kernel
fits its VMEM and otherwise runs the discrete composition, whose attention
is the flash kernel (ops/flash_attention.py).

With ``qspec`` the activations are fp32 and the chain snaps where the
TPU kernel does, every snap the code of K11 (csrc/fake_quant.cuh):

    layernorm_snap_rows (snap x; LN; snap_all, snap)
      -> gemm_f32x3_epilogue (3-pass bf16 QKV product + bias, snap_all)
      -> attention_core_f32, snap mode (3-pass scores times scale, an
         exact-divide softmax, 3-pass P V; snap)
      -> gemm_f32x3_epilogue (projection + bias, snap_all; + x, snap_all)

at any length up to the fused gate on the card: up to 256 tokens the
fp32 core and its backward hold one (image, head) in a CTA, above that
they walk 64-row tiles (csrc/attention_core_f32_long_wgmma.cu,
csrc/attention_core_f32_bwd_long_wgmma.cu), INT8 QAT's sites as well.
When it records, the core also writes its rowmax and
reciprocal rowsum, and the forward keeps what the JAX ``_fwd_rule``
keeps: x, the parameters, the snapped context (the projection's actual
input), m, rs and, when ``save_acts`` affords them at fp32 itemsize, the
qkv rows.  Every site is straight-through, so the backward is the FP32
backward with the snapped forward values recomputed at the same
positions and every product 3-pass (``_bwd_one_image`` with ``qspec``):

    layernorm_snap_rows (xn) -> [gemm_f32x3_epilogue, bias_snap (qkv),
      when not saved] -> gemm_f32x3_epilogue, f32 (d_o = do Wp^T)
      -> attention_core_f32_bwd (dqkv, per-image dbqkv)
      -> gemm_f32x3_epilogue, A transposed (dWp, dWqkv)
      -> gemm_f32x3_epilogue, f32 (dxn = dqkv Wqkv^T)
      -> layernorm_rows_bwd (its snap form)
    and the bias sums through colsum_rows.

PyTorchINT8's two-pass QAT (the JAX ``fused_attention_block_i8``: the
TPU kernels with ``qspec="int8"``) runs the same chains with the frozen
observer sites in place of the float snaps: ``qspec`` is then the block
half's (5, 3) site table (scale, zero point, has_stats per row, on the
activation's device), and each kernel takes the rows it snaps at
(ops/fake_quant.py ``Int8Sites``; ``snap`` and ``snap_all`` are
identities): the LayerNorm's output (row 0), the qkv rows after their
bias (1), the context (2, the quant_out stub, also the saved residual),
the projection after its bias (3) and the residual sum (4).  The table
is read on the device, so no step waits on the host.  Its gradient is
None, as the JAX rule gives it zeros.

``res_scale`` (1 unless head-sharded tensor parallelism runs the op on
its local heads: then 1/n_tp, with the local wqkv (C, 3 cl), bqkv (3 cl,)
and wp (cl, C), cl = C / n_tp, and bp pre-scaled by 1/n_tp, so that the
sum of the partial outputs over the model group is x + proj + bias,
parallel/tp.py) scales the residual in the output projection's epilogue,
``x * res_scale + y``, and the upstream gradient in the LayerNorm
backward's, ``dx = do * res_scale + dx_ln``, as the TPU kernels do; the
bf16 chain's ``gemm_bf16_epilogue`` and ``layernorm_rows_bwd``, the fp32
chain's ``gemm_f32x3_epilogue`` and the snap form of ``layernorm_rows_bwd``
take it.  The local width cl comes from wp, not from x.

Weights keep the JAX layout: wqkv (C, 3C) with feature order [3][h][d],
wp (C, C), i.e. (in, out).  A transposed view of a torch (out, in)
weight is read in place, and its gradient is returned as the same kind
of view.  Gradients come back in each input's dtype, as the JAX rule
casts them.
"""
from __future__ import annotations

import functools

import torch

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.acts_policy import save_acts
from myrtle_vision_tpu_torch.ops.fake_quant import kernel_sites


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


@functools.lru_cache(maxsize=None)
def no_snap_sites(device):
    """A (5, 3) site table on ``device`` whose rows have no statistics:
    under it every snap of the qspec / INT8 chains is the identity, so
    those chains compute the unquantized block half on fp32 activations
    (the module docstring)."""
    table = torch.zeros((5, 3), device=device)
    table[:, 0] = 1.0
    return table


def _kernel_chain_f32(kern, x):
    """Whether a call runs the fp32 kernel chain: fp32 activations on the
    card, where the bf16 chain's kernels do not apply; any dtype but bf16
    and fp32 raises there."""
    if kern is not K.CUDA or x.dtype == torch.bfloat16:
        return False
    if x.dtype != torch.float32:
        raise TypeError(f"the block-half chains on CUDA take bf16 or fp32 "
                        f"activations, got {x.dtype}")
    return True


def _forward(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads, scale,
             record, res_scale=1.0):
    """The chain; with ``record`` also (ctx, m, rs, qkv) for the
    backward."""
    if _kernel_chain_f32(kern, x):
        return _forward_q(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp,
                          heads, scale, no_snap_sites(x.device), record,
                          res_scale)
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
                    residual=x2, res_scale=res_scale).view(b, n, c)
    if record:
        return out, (ctx, m, rs, qkv3)
    return out


def _forward_q(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads, scale,
               qspec, record=False, res_scale=1.0):
    """The float-format chain (``_fwd_kernel`` with ``qspec``), or INT8
    QAT's (``qspec`` the (5, 3) site table): fp32 activations, parameters
    and weights, the weights' snaps already applied by the caller; with
    ``record`` also (ctx, m, rs, qkv) for the backward."""
    if x.dtype != torch.float32:
        raise TypeError(f"fused_attention_block with qspec takes fp32 "
                        f"activations, got {x.dtype}")
    b, n, c = x.shape
    cl = wp.shape[0]
    x2 = x.contiguous().view(b * n, c)
    xn = kern.layernorm_snap_rows(x2, scale_ln.float().contiguous(),
                                  bias_ln.float().contiguous(),
                                  kernel_sites(qspec, 0))
    qkv = kern.gemm_f32x3(xn, wqkv.float(), bqkv.float().contiguous(),
                          "bias_snap", kernel_sites(qspec, 1)
                          ).view(b, n, 3 * cl)
    q_ctx = kernel_sites(qspec, 2)
    if record:
        ctx, m, rs = kern.attention_core_snap(qkv, heads, scale, q_ctx,
                                              stats=True)
    else:
        ctx = kern.attention_core_snap(qkv, heads, scale, q_ctx)
    out = kern.gemm_f32x3(ctx.view(b * n, cl), wp.float(),
                          bp.float().contiguous(), "bias_snap_residual_snap",
                          kernel_sites(qspec, 3, 4), residual=x2,
                          res_scale=res_scale).view(b, n, c)
    if record:
        return out, (ctx, m, rs, qkv)
    return out


def _backward(kern, do, x, scale_ln, bias_ln, wqkv, bqkv, wp, ctx, m, rs,
              qkv, heads, scale, res_scale=1.0):
    """``_bwd_one_image`` over the batch -> (dx, dscale, dbias, dwqkv,
    dbqkv, dwp, dbp), weight gradients in the (in, out) shape."""
    if _kernel_chain_f32(kern, x):
        return _backward_q(kern, do, x, scale_ln, bias_ln, wqkv, bqkv, wp,
                           ctx, m, rs, qkv, heads, scale,
                           no_snap_sites(x.device), res_scale)
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
    dx, dscale, dbias = kern.layernorm_rows_bwd(x2, s_dt, dxn, do2,
                                                res_scale=res_scale)
    return dx.view(b, n, c), dscale, dbias, dwqkv, dbq, dwp, dbp


def _backward_q(kern, do, x, scale_ln, bias_ln, wqkv, bqkv, wp, ctx, m, rs,
                qkv, heads, scale, qspec, res_scale=1.0):
    """``_bwd_one_image`` with ``qspec`` (a float format's, or INT8's
    site table) over the batch, fp32 -> (dx, dscale, dbias, dwqkv, dbqkv,
    dwp, dbp), weight gradients in the (in, out) shape."""
    b, n, c = x.shape
    cl = wp.shape[0]
    rows = b * n
    x2 = x.contiguous().view(rows, c)
    do2 = do.float().contiguous().view(rows, c)
    s32 = scale_ln.float().contiguous()
    wqkv, wp = wqkv.float(), wp.float()
    xn = kern.layernorm_snap_rows(x2, s32, bias_ln.float().contiguous(),
                                  kernel_sites(qspec, 0))
    if qkv is None:
        qkv = kern.gemm_f32x3(xn, wqkv, bqkv.float().contiguous(),
                              "bias_snap", kernel_sites(qspec, 1))
    qspec = kernel_sites(qspec)  # the products below snap nothing
    d_o = kern.gemm_f32x3(do2, wp.t(), None, "f32", qspec)
    dqkv, dbq_image = kern.attention_core_f32_bwd(
        qkv.view(b, n, 3 * cl), d_o.view(b, n, cl), m, rs, heads, scale)
    dqkv = dqkv.view(rows, 3 * cl)
    dbq = kern.colsum_rows(dbq_image)
    # weight gradients in the torch (out, in) layout, returned as views
    dwp = kern.gemm_f32x3(do2.t(), ctx.view(rows, cl), None, "f32",
                          qspec).t()
    dbp = kern.colsum_rows(do2)
    dwqkv = kern.gemm_f32x3(dqkv.t(), xn, None, "f32", qspec).t()
    dxn = kern.gemm_f32x3(dqkv, wqkv.t(), None, "f32", qspec)
    dx, dscale, dbias = kern.layernorm_rows_bwd(x2, s32, dxn, do2, qspec,
                                                res_scale=res_scale)
    return dx.view(b, n, c), dscale, dbias, dwqkv, dbq, dwp, dbp


class _FusedAttentionBlock(torch.autograd.Function):
    """The op with the JAX ``_fwd_rule`` / ``_bwd_rule`` pair, FP32, with
    a float format's ``qspec``, or with INT8's site table (``_fwd_rule_i8``
    / ``_bwd_rule_i8``)."""

    @staticmethod
    def forward(ctx, kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                scale, depth, qspec, res_scale):
        b, n, _ = x.shape
        cl = wp.shape[0]
        inputs = (x, scale_ln, bias_ln, wqkv, bqkv, wp, bp)
        if qspec is None:
            out, (attn, m, rs, qkv) = _forward(kern, *inputs, heads, scale,
                                               True, res_scale)
        else:
            out, (attn, m, rs, qkv) = _forward_q(kern, *inputs, heads, scale,
                                                 qspec, True, res_scale)
        if not save_acts(b * n * 3 * cl * qkv.element_size(), depth):
            qkv = None
        ctx.save_for_backward(*inputs, attn, m, rs, qkv)
        ctx.kern, ctx.heads, ctx.scale, ctx.qspec = kern, heads, scale, qspec
        ctx.res_scale = res_scale
        return out

    @staticmethod
    def backward(ctx, do):
        x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, attn, m, rs, qkv = \
            ctx.saved_tensors
        args = (ctx.kern, do, x, scale_ln, bias_ln, wqkv, bqkv, wp, attn, m,
                rs, qkv, ctx.heads, ctx.scale)
        if ctx.qspec is None:
            grads = _backward(*args, ctx.res_scale)
        else:
            grads = _backward_q(*args, ctx.qspec, ctx.res_scale)
        if ctx.kern is K.CUDA:
            op = (fused_attention_block_i8
                  if isinstance(ctx.qspec, torch.Tensor)
                  else fused_attention_block)
            op.bwd_launches += 1
        inputs = (x, scale_ln, bias_ln, wqkv, bqkv, wp, bp)
        return (None, *(g.to(t.dtype) for g, t in zip(grads, inputs)),
                None, None, None, None, None)


def records(tensors) -> bool:
    """Whether a call on ``tensors`` would record for a backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _apply(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads, scale,
           depth, qspec, res_scale=1.0):
    res_scale = K.residual_scale(res_scale)
    tensors = (x, scale_ln, bias_ln, wqkv, bqkv, wp, bp)
    if records(tensors):
        return _FusedAttentionBlock.apply(kern, *tensors, heads, scale,
                                          depth, qspec, res_scale)
    if qspec is not None:
        return _forward_q(kern, *tensors, heads, scale, qspec, False,
                          res_scale)
    return _forward(kern, *tensors, heads, scale, False, res_scale)


def fused_attention_block_plain(x, scale_ln, bias_ln, wqkv, bqkv, wp, bp,
                                heads, scale, depth=None, qspec=None,
                                res_scale=1.0):
    """The plain PyTorch chain on any device, forward and backward: the
    reference the kernels are held against.  It rounds where the kernels
    round: LN scale/bias, weights and bp in x.dtype, bqkv in fp32; with
    ``qspec`` everything fp32, snapped where the kernels snap."""
    return _apply(K.PLAIN, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                  scale, depth, qspec, res_scale)


def fused_attention_block(x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                          scale, depth=None, qspec=None, res_scale=1.0):
    """x * res_scale + proj(MHA(qkv(LN(x)))) over (B, N, C), the argument
    order of the JAX function, differentiable.  A CPU tensor takes the plain
    chain; a CUDA tensor the kernel chain, forward and backward, or an
    error; any other device an error.  ``depth``, the model's layer
    count, sizes the qkv-saving budget as in the JAX package.  ``qspec``
    (exp_bits, man_bits, all_sites) selects a float format's chains,
    forward and backward; it takes fp32 activations and weights already
    fake-quantized (the caller's straight-through estimator carries
    their gradient).  ``res_scale`` (a finite real number; 1/n_tp with
    the local heads' weights under head-sharded tensor parallelism, see
    the module docstring) scales the residual."""
    kern = K.for_device(x)
    out = _apply(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                 scale, depth, qspec, res_scale)
    if kern is K.CUDA:
        fused_attention_block.launches += 1
    return out


def _site_table(qs, x):
    if tuple(qs.shape) != (5, 3) or qs.dtype != torch.float32 or \
            qs.device != x.device:
        raise ValueError(f"qs: expected a (5, 3) fp32 site table on "
                         f"{x.device}, got {tuple(qs.shape)} {qs.dtype} on "
                         f"{qs.device}")
    return qs.detach().contiguous()


def fused_attention_block_i8_plain(x, scale_ln, bias_ln, wqkv, bqkv, wp, bp,
                                   qs, heads, scale, depth=None):
    """The plain PyTorch chain of :func:`fused_attention_block_i8` on any
    device, forward and backward."""
    return _apply(K.PLAIN, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                  scale, depth, _site_table(qs, x))


def fused_attention_block_i8(x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, qs,
                             heads, scale, depth=None):
    """The JAX ``fused_attention_block_i8`` (two-pass INT8 QAT): x +
    proj(MHA(qkv(LN(x)))) over fp32 (B, N, C) with PyTorchINT8's affine
    uint8 snaps at the five observer sites of the discrete path, rows 0-4
    of ``qs`` (5, 3) = (scale, zero point, has_stats) per site, frozen for
    the pass.  Every site is straight-through and ``qs`` takes no
    gradient; the weights arrive already fake-quantized (the caller's
    straight-through estimator carries their gradient).  A CPU tensor
    takes the plain chain, a CUDA tensor the kernel chain or an error."""
    kern = K.for_device(x)
    out = _apply(kern, x, scale_ln, bias_ln, wqkv, bqkv, wp, bp, heads,
                 scale, depth, _site_table(qs, x))
    if kern is K.CUDA:
        fused_attention_block_i8.launches += 1
    return out


# kernel-chain launches since the last reset (CUDA tensors only), forward
# and backward
fused_attention_block.launches = 0
fused_attention_block.bwd_launches = 0
fused_attention_block_i8.launches = 0
fused_attention_block_i8.bwd_launches = 0
