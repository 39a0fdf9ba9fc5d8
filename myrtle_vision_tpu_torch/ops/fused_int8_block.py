"""Converted-INT8 transformer block halves, inference only.

Replaces the TPU kernels of myrtle_vision_tpu/ops/fused_int8_block.py:
``_attn_kernel`` (launched by ``int8_attention_block``, K9) and
``_mlp_kernel`` (launched by ``int8_mlp_block``, K10).  The converted
PyTorchINT8 model stores its Linear weights as int8 with a per-tensor
scale, and each projection runs as an int8 x int8 -> int32 product with
the shifted-zero-point identity of QDense._int8_forward:

    y = s_x s_w ((q - 128) @ w8 + (128 - zp) colsum) + bias.

On the H100 each half is a chain of CUDA kernels (ops/_kernels.py),
fp32 activations between them, int8 operands into the products:

    attention  layernorm_quant_rows (LN, site 0 grid)
               -> gemm_s8_epilogue (qkv, requant at site 1)
               -> attention_core_f32 (3-pass bf16 scores and P V, exact
                  softmax divide, the context on the site 2 grid)
               -> gemm_s8_epilogue (out, requant at site 3, + x, requant
                  at site 4)
    mlp        layernorm_quant_rows (site 0)
               -> gemm_s8_epilogue (fc1, requant at site 1, GELU with
                  the polynomial erf and an exact divide, site 2 grid)
               -> gemm_s8_epilogue (fc2, requant at site 3, + x,
                  requant at site 4)

Sites, as the JAX kernels order them: attention 0 = attn_norm.act_out,
1 = to_qkv.act_out, 2 = quant_out, 3 = to_out.act_out, 4 = attn_res;
mlp 0 = ffn_norm.act_out, 1 = fc1.act_out, 2 = gelu.act_out,
3 = fc2.act_out, 4 = ffn_res.  ``sites`` is a (5, 3) fp32 tensor of
(scale, zero point, has_stats) rows.  A site without statistics passes
its requant through, and an integer product whose input site has none
uses scale 1 and zero point 128, as in the JAX kernels.

The ops take any sequence the JAX model fuses (``fuses_at``, up to 701
tokens at 6 heads of 64): on the card up to 256 tokens the attention core
holds one (image, head) in a CTA, above that it walks 64-row tiles
(csrc/attention_core_f32_long_wgmma.cu, its int8 mode); the other kernels
are length-agnostic.  Past the gate the attention op raises: the JAX model
runs the discrete converted Block there, which is not ported yet.  The
MLP op takes any length (the gate is the Block's, which the ViT reads).

A CPU tensor takes the plain chain, a CUDA tensor the kernel chain or an
error; any other device an error.  Weights keep the JAX layout: (in,
out) int8, the transposed view of a torch (out, in) tensor read in
place.  ``colsums`` are the int8 weights' column sums as fp32, which the
model computes once when its state dict is loaded.
"""
from __future__ import annotations

import torch

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at


def weight_colsum(w8):
    """fp32 column sums of an (in, out) int8 weight (``_colsum``)."""
    return w8.sum(0, dtype=torch.int32).float()


def _attention(kern, x, ln_scale, ln_bias, wqkv, wqkv_scale, bqkv, wout,
               wout_scale, bout, sites, heads, scale, colsums):
    b, n, c = x.shape
    if not fuses_at(n, heads, c // heads):
        raise ValueError(f"int8_attention_block: sequence {n} is past the "
                         f"fused gate (fuses_at) at {heads} heads of "
                         f"{c // heads}; the JAX model runs the discrete "
                         "converted Block there, which waits (ROADMAP A5b)")
    cs_qkv, cs_out = colsums or (weight_colsum(wqkv), weight_colsum(wout))
    x2 = x.contiguous().view(b * n, c)
    q8 = kern.layernorm_quant_rows(x2, ln_scale, ln_bias, sites[0])
    qkv = kern.gemm_s8(q8, wqkv, cs_qkv, wqkv_scale, sites[0], bqkv,
                       "requant", sites[1])
    ctx8 = kern.attention_core_f32(qkv.view(b, n, 3 * c), heads, scale,
                                   sites[2])
    out = kern.gemm_s8(ctx8.view(b * n, c), wout, cs_out, wout_scale,
                       sites[2], bout, "requant_residual_requant", sites[3],
                       sites[4], residual=x2)
    return out.view(b, n, c)


def _mlp(kern, x, ln_scale, ln_bias, w1, w1_scale, b1, w2, w2_scale, b2,
         sites, colsums):
    c = x.shape[-1]
    cs1, cs2 = colsums or (weight_colsum(w1), weight_colsum(w2))
    x2 = x.contiguous().view(-1, c)
    q8 = kern.layernorm_quant_rows(x2, ln_scale, ln_bias, sites[0])
    g8 = kern.gemm_s8(q8, w1, cs1, w1_scale, sites[0], b1,
                      "requant_gelu_quant", sites[1], sites[2])
    out = kern.gemm_s8(g8, w2, cs2, w2_scale, sites[2], b2,
                       "requant_residual_requant", sites[3], sites[4],
                       residual=x2)
    return out.view(x.shape)


def int8_attention_block_plain(x, ln_scale, ln_bias, wqkv, wqkv_scale,
                               bqkv, wout, wout_scale, bout, sites, heads,
                               scale, colsums=None):
    """The plain PyTorch chain on any device: the reference the kernels
    are held against."""
    return _attention(K.PLAIN, x, ln_scale, ln_bias, wqkv, wqkv_scale,
                      bqkv, wout, wout_scale, bout, sites, heads, scale,
                      colsums)


def int8_attention_block(x, ln_scale, ln_bias, wqkv, wqkv_scale, bqkv,
                         wout, wout_scale, bout, sites, heads, scale,
                         colsums=None):
    """x + to_out(core(to_qkv(LN(x)))) with int8 projections, fp32 (B, N,
    C) in and out, the argument order of the JAX function (plus
    ``colsums``, (wqkv, wout) column sums, computed when None)."""
    kern = K.for_device(x)
    out = _attention(kern, x, ln_scale, ln_bias, wqkv, wqkv_scale, bqkv,
                     wout, wout_scale, bout, sites, heads, scale, colsums)
    if kern is K.CUDA:
        int8_attention_block.launches += 1
    return out


def int8_mlp_block_plain(x, ln_scale, ln_bias, w1, w1_scale, b1, w2,
                         w2_scale, b2, sites, colsums=None):
    """The plain PyTorch chain on any device."""
    return _mlp(K.PLAIN, x, ln_scale, ln_bias, w1, w1_scale, b1, w2,
                w2_scale, b2, sites, colsums)


def int8_mlp_block(x, ln_scale, ln_bias, w1, w1_scale, b1, w2, w2_scale,
                   b2, sites, colsums=None):
    """x + fc2(GELU(fc1(LN(x)))) with int8 projections (see
    :func:`int8_attention_block`)."""
    kern = K.for_device(x)
    out = _mlp(kern, x, ln_scale, ln_bias, w1, w1_scale, b1, w2, w2_scale,
               b2, sites, colsums)
    if kern is K.CUDA:
        int8_mlp_block.launches += 1
    return out


# kernel-chain launches since the last reset (CUDA tensors only)
int8_attention_block.launches = 0
int8_mlp_block.launches = 0
