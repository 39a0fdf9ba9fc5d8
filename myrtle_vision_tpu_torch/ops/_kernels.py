"""The CUDA kernels of the block halves, forward and backward, each beside
its plain PyTorch version.

``fused_attention_block`` is LN -> GEMM(+bias) -> attention core ->
GEMM(+bias+residual); ``fused_mlp_block`` is LN -> GEMM(+bias, GELU) ->
GEMM(+bias+residual).  Their backwards are chains of the same kinds of
kernel (ops/fused_attention_block.py, ops/fused_mlp.py).  The kernels
(``csrc/``):

- ``layernorm_rows``       csrc/layernorm_rows.cu
- ``gemm_bf16_epilogue``   csrc/gemm_bf16_wgmma.cu (wgmma, TMA)
- ``attention_core``       csrc/attention_core_wgmma.cu (wgmma, TMA); above
                           256 tokens csrc/attention_core_long_wgmma.cu
- ``attention_core_bwd``   csrc/attention_core_bwd_wgmma.cu (wgmma, TMA);
                           above 256 tokens
                           csrc/attention_core_bwd_long_wgmma.cu (both long
                           routes' shapes in csrc/core_long_wgmma.cuh)
- ``layernorm_rows_bwd``   csrc/layernorm_rows_bwd.cu
- ``colsum_rows``          csrc/layernorm_rows_bwd.cu

and those of the converted-INT8 block halves (ops/fused_int8_block.py),
fp32 activations, int8 operands:

- ``layernorm_quant_rows`` csrc/layernorm_quant_rows.cu
- ``gemm_s8_epilogue``     csrc/gemm_s8_wgmma.cu (int8 wgmma, TMA)
- ``attention_core_f32``   csrc/attention_core_f32_wgmma.cu (3-pass wgmma)

and the flash attention of the discrete attention path, forward and
backward (ops/flash_attention.py holds their plain versions):

- ``flash_attention_fwd``  csrc/flash_attention_fwd_wgmma.cu (wgmma, TMA)
- ``flash_attention_bwd``  csrc/flash_attention_bwd_wgmma.cu (wgmma, TMA;
                           what both share in csrc/flash_wgmma.cuh)

and their forms on fp32 operands (``compute_dtype`` float32), every
product 3xTF32 on the tensor cores:

- ``flash_attention_f32_fwd``  csrc/flash_attention_f32_fwd_wgmma.cu (a
                               split pass, then wgmma fed by TMA)
- ``flash_attention_f32_bwd``  csrc/flash_attention_f32_bwd_wgmma.cu (dsum,
                               the split pass, dk / dv, dq; what both
                               share in csrc/flash_tf32.cuh)

and those of the stateless float formats (FP16_16, FP16_32, TF32): the
qtorch fake-quant K11 and the block halves with ``qspec = (exp_bits,
man_bits, all_sites)``, forward and backward, fp32 activations, every
snap from csrc/fake_quant.cuh:

- ``fake_quant_rows``          csrc/fake_quant_rows.cu
- ``layernorm_snap_rows``      csrc/layernorm_snap_rows.cu
- ``gemm_f32x3_epilogue``      csrc/gemm_f32x3_wgmma.cu (wgmma, TMA)
- ``attention_core_f32``       csrc/attention_core_f32_wgmma.cu, its fp32
                               snap mode
- ``attention_core_f32_bwd``   csrc/attention_core_f32_bwd_wgmma.cu (3-pass
                               wgmma; the score chain of both in
                               csrc/attention_f32_tiles.cuh)
- ``attention_core_f32_long``  above 256 tokens, the fp32 core's snap
                               and int8 modes:
                               csrc/attention_core_f32_long_wgmma.cu (a
                               split pass, then a core kernel fed by TMA)
- ``attention_core_f32_bwd_long``  above 256 tokens, its backward:
                               csrc/attention_core_f32_bwd_long_wgmma.cu
                               (a split pass, dq, dk / dv, column sums;
                               both long routes' shapes in
                               csrc/f32_long_wgmma.cuh and
                               :func:`f32_long_plan`)
- ``layernorm_rows_bwd``       csrc/layernorm_rows_bwd.cu, its fp32 snap form
                               (counted as ``layernorm_snap_rows_bwd``)

and, with the same kernels, the PyTorchINT8 two-pass QAT block halves
(``fused_attention_block_i8``, ``fused_mlp_block_i8``): each float-format
function above takes, where it takes a ``qspec``, an
:class:`~myrtle_vision_tpu_torch.ops.fake_quant.Int8Sites` instead, the
frozen observer rows it snaps at, read on the device (the snap policy:
``snap`` and ``snap_all`` are identities under it, ``snap_int8`` applies
its rows).

and the probes of the port's kernels (myrtle_vision_tpu_torch/perf/, the
counterparts of the TPU probes K12-K14 in tools/perf/), each an
instantiation of a kernel above or a kernel of its own:

- ``attention_core_probe``  csrc/attention_core.cu in a probe mode (K12):
                            the WMMA design that attention_core replaced
- ``gemm_bf16_probe``       csrc/gemm_bf16_epilogue.cu, the WMMA design that
                            gemm_bf16_epilogue replaced: the GELU modes of
                            the fc1 epilogue (K13; counted as
                            ``gemm_bf16_gelu_probe``), a bf16 store without
                            bias, a head-major weight (K12)
- ``gemm_layout_probe``     csrc/gemm_layout_probe.cu, batched per-image
                            products with transposed operands read in
                            place or transposed as staged (K14)

A PyTorchINT8 observer site is a (3,) fp32 tensor (scale, zero point,
has_stats as 1 or 0), a row of the model's site table.

Each ``*_plain`` function rounds at the same points as its kernel and as
the TPU kernels it stands in for (operands in the activation dtype, fp32
accumulation and statistics, one rounding of each output), so the CPU
tests hold it against the JAX package and the card holds the kernel
against it.  The ``*_cuda`` launchers take CUDA tensors only, launch on
the current stream, raise on a refused launch and count their launches
in :data:`LAUNCHES`.  :data:`PLAIN` and :data:`CUDA` gather each set
under the same names, so that one chain of calls serves both.
"""
from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace

import torch

from myrtle_vision_tpu_torch.ops.fake_quant import (
    Int8Sites,
    fixed_point_quantize,
    float_quantize,
    snap,
    snap_all,
    snap_int8,
)
from myrtle_vision_tpu_torch.ops.high_precision import (
    bdot_pv_high3,
    bdot_qk_high3,
    matmul_high3,
)

EPS = 1e-5
_SQRT_2 = 1.4142135623730951
_INV_SQRT_2PI = 0.3989422804014327
EPILOGUES = {"bias": 0, "bias_gelu": 1, "bias_residual": 2, "f32": 3,
             "bias_gelu_grad": 4, "mul_aux": 5, "store": 6}
# the GELU of the fc1 epilogue in the K13 probe's modes
# (tools/perf/mlp_microbench.py ``_erf_variant``); production is "base"
GELU_MODES = {"base": 0, "nogelu": 1, "noexp": 2, "nodiv": 3}
# the attention core's K12 probe modes (csrc/attention_core.cu), and those
# that divide the P V product by the rowsum
PROBE_MODES = {"defer": 1, "rowmajor": 2, "none": 3, "nomax": 4,
               "sumdot": 5, "pipe": 6, "dotonly": 7}
DEFERRED_MODES = ("defer", "none", "nomax", "sumdot", "pipe")
# gemm_bf16_epilogue's output tile (rows, columns) and K step
# (csrc/gemm_bf16_wgmma.cu BM, BN, BK)
GEMM_TILE = (128, 128)
GEMM_BK = 64
# colsum_rows (csrc/layernorm_rows_bwd.cu): up to this many rows one
# kernel sums them, above it two passes; a first-pass block's columns
# (kPass1Cols there), its least chunk of rows, and the first-pass blocks
# an SM that the chunk aims at
COLSUM_ONE_PASS = 64
COLSUM_COLS = 128
COLSUM_MIN_CHUNK = 32
COLSUM_BLOCKS_PER_SM = 4
# layernorm_snap_rows (csrc/layernorm_snap_rows.cu): its widest row, the
# multiple of the width (a lane holds every 32nd column), a block's warps
# (one row each), and the most values a lane of a kernel built for eight
# blocks an SM holds (above it, four)
LN_SNAP_MAX_COLS = 768
LN_SNAP_COLS_STEP = 32
LN_SNAP_WARPS = 4
LN_SNAP_FEW_VALUES = 12

# launches of each kernel since the last reset_launches()
LAUNCHES = {"layernorm_rows": 0, "gemm_bf16_epilogue": 0,
            "attention_core": 0, "attention_core_bwd": 0,
            "layernorm_rows_bwd": 0, "colsum_rows": 0,
            "layernorm_quant_rows": 0, "gemm_s8_epilogue": 0,
            "attention_core_f32": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0, "fake_quant_rows": 0,
            "layernorm_snap_rows": 0, "gemm_f32x3_epilogue": 0,
            "attention_core_f32_bwd": 0, "layernorm_snap_rows_bwd": 0,
            "attention_core_f32_long": 0, "attention_core_f32_bwd_long": 0,
            "flash_attention_f32_fwd": 0, "flash_attention_f32_bwd": 0,
            "attention_core_probe": 0, "gemm_bf16_probe": 0,
            "gemm_bf16_gelu_probe": 0, "gemm_layout_probe": 0}
# of those, the launches with a residual scale other than 1 (head-sharded
# tensor parallelism, ``res_scale`` 1/n_tp; K1-K4's ``x * res_scale + y``
# and ``do * res_scale + dx_ln``)
RES_SCALE_LAUNCHES = {"gemm_bf16_epilogue": 0, "gemm_f32x3_epilogue": 0,
                      "layernorm_rows_bwd": 0, "layernorm_snap_rows_bwd": 0}
INT8_EPILOGUES = {"requant": 0, "requant_gelu_quant": 1,
                  "requant_residual_requant": 2}
FAKE_QUANT_MODES = {"float": 0, "fixed": 1}
F32X3_EPILOGUES = {"bias_snap": 0, "bias_snap_gelu_snap": 1,
                   "bias_snap_residual_snap": 2, "f32": 3,
                   "bias_snap_gelu_snap_grad": 4, "mul_aux": 5}
# gemm_f32x3_epilogue's output tile (rows, columns), that of its two GELU
# epilogues, and its fp32 K step (csrc/gemm_f32x3_wgmma.cu BM, bn_of, BK),
# the waves of its one persistent CTA an SM that a weight gradient's split
# K aims at, and a K chunk's least depth
F32X3_TILE = (128, 128)
F32X3_GELU_TILE = (192, 64)
F32X3_BK = 32
F32X3_WAVES = 4
F32X3_MIN_CHUNK = 256
# gemm_s8_epilogue's output tile and K step in int8 elements
# (csrc/gemm_s8_wgmma.cu)
S8_TILE = (128, 128)
S8_BK = 128
# attention_core_f32 and its backward (csrc/attention_core_f32_wgmma.cu,
# csrc/attention_core_f32_bwd_wgmma.cu, csrc/attention_f32_tiles.cuh): an
# SM's shared memory, what the card keeps of it for each CTA, the 1024
# bytes each kernel adds to align its swizzled tiles, and the longest
# sequence
SM_SHARED_BYTES = 233472
CTA_RESERVED_BYTES = 1024
TILE_ALIGN_BYTES = 1024
F32_CORE_MAX_N = 256
# the flash kernels (csrc/flash_wgmma.cuh): a CTA's own query or key rows
# and threads (two consumer warpgroups and a producer), the forward's KV
# tile and ring stages, the backward's walked tile and ring stages
FLASH_ROWS = 128
FLASH_THREADS = 384
FLASH_FWD_TILE = 128
FLASH_FWD_STAGES = 3
FLASH_BWD_TILE = 64
FLASH_BWD_STAGES = 4
# the fused core above 256 tokens (csrc/core_long_wgmma.cuh): a CTA's own
# query or key rows, the threads of the forward's CTA (one warpgroup) and
# of the backward's (a warpgroup and a producer warp), the CTAs an SM
# their launch bounds count on, the forward's KV tile and ring stages, the
# backward's walked tile and ring stages, and the backward's kernels a call
CORE_LONG_ROWS = 64
CORE_LONG_FWD_THREADS = 128
CORE_LONG_THREADS = 160
CORE_LONG_CTAS_PER_SM = 2
CORE_LONG_FWD_TILE = 128
CORE_LONG_FWD_STAGES = 3
CORE_LONG_BWD_TILE = 64
CORE_LONG_BWD_STAGES = 4
CORE_LONG_BWD_LAUNCHES = 4
# the fp32 core above F32_CORE_MAX_N (float formats, INT8 QAT, converted INT8)
# (csrc/attention_core_f32_long_wgmma.cu,
# csrc/attention_core_f32_bwd_long_wgmma.cu; kLongTile, kLongMaxN,
# kBlockMaxN in csrc/attention_f32_tiles.cuh, the rest in
# csrc/f32_long_wgmma.cuh): a CTA's own rows and the tile it walks, the
# longest sequence (the longest that the fused gate ``fuses_at`` lets
# through at a head width of 32 or 64: one head of 32), the longest that
# the forward's score-block design takes (above it the cluster design),
# the score-block design's threads (a warpgroup and a producer warp) and
# its ring's most stages, the cluster design's threads (eight warps), most
# CTAs a cluster and most key tiles a CTA, the SMs its cluster size is
# weighed for by default (an H100 SXM's), the backward's threads (a
# warpgroup) and CTAs an SM, the most dynamic shared memory a CTA may ask
# for, the kernels a forward and a backward call launch (the split pass
# included)
F32_LONG_TILE = 64
F32_LONG_MAX_N = 1837
F32_LONG_BLOCK_MAX_N = 768
F32_LONG_FWD_THREADS = 160
F32_LONG_FWD_MAX_STAGES = 4
F32_SWEEP_THREADS = 256
F32_SWEEP_MAX_CLUSTER = 8
F32_SWEEP_MAX_TILES = 8
F32_LONG_SMS = 132
F32_LONG_BWD_THREADS = 128
F32_LONG_BWD_CTAS_PER_SM = 2
F32_LONG_SMEM_OPTIN = 232448
F32_LONG_FWD_LAUNCHES = 2
F32_LONG_BWD_LAUNCHES = 4
# the fp32 flash kernels' launches a call (csrc/flash_attention_f32_{fwd,
# bwd}_wgmma.cu): the split pass and the core; the dsum pre-pass, the split
# pass, dk / dv and dq
F32_FLASH_FWD_LAUNCHES = 2
F32_FLASH_BWD_LAUNCHES = 4


def reset_launches() -> None:
    for counts in (LAUNCHES, RES_SCALE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def residual_scale(res_scale) -> float:
    """``res_scale`` as a float: a real number (not a bool) and finite,
    else ``TypeError`` / ``ValueError``; the kernels and their plain
    versions check it alike, so no wrong scale reaches either."""
    if isinstance(res_scale, bool) or not isinstance(res_scale,
                                                     (int, float)):
        raise TypeError(f"res_scale must be a real number, got "
                        f"{type(res_scale).__name__}")
    if not math.isfinite(res_scale):
        raise ValueError(f"res_scale must be finite, got {res_scale}")
    return float(res_scale)


# ------------------------------------------------------------------ plain

def layernorm_rows_plain(x, scale, bias):
    """fp32 LayerNorm over the last axis, eps 1e-5, rounded to x.dtype
    (``_ln_f32`` / ``_layernorm_f32`` of the JAX kernels)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    xhat = (xf - mu) * torch.rsqrt(var + EPS)
    return (xhat * scale.float() + bias.float()).to(x.dtype)


def erf_poly(x, mode="base"):
    """erf by Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7) with an
    exact divide (``_erf_f32`` of myrtle_vision_tpu/ops/fused_mlp.py).
    The K13 probe's modes (``_erf_variant`` of
    tools/perf/mlp_microbench.py): "noexp" drops the exp term (wrong on
    purpose, a diagnostic); "nodiv" takes t from an approximate
    reciprocal r of y = 1 + 0.3275911 |x| and one Newton step r (2 - y r).
    Here r is 1 / y: the card's ``rcp.approx`` is within 2^-23 of it, and
    the Newton step leaves both within 2^-24 of 1 / y."""
    ax = x.abs()
    if mode == "nodiv":
        y = 1.0 + 0.3275911 * ax
        r = 1.0 / y
        t = r * (2.0 - y * r)
    else:
        t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (
        0.254829592
        + t * (
            -0.284496736
            + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429))
        )
    )
    if mode == "noexp":
        return torch.sign(x) * (1.0 - poly * 0.1)
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_poly(h, mode="base"):
    """GELU with :func:`erf_poly`, in fp32; the K13 probe's mode "nogelu"
    passes h through."""
    if mode == "nogelu":
        return h
    return 0.5 * h * (1.0 + erf_poly(h / _SQRT_2, mode))


def gelu_and_grad_poly(h):
    """(GELU(h), GELU'(h)) sharing one :func:`erf_poly`, in fp32
    (``_gelu_and_grad_f32`` of myrtle_vision_tpu/ops/fused_mlp.py)."""
    cdf = 0.5 * (1.0 + erf_poly(h / _SQRT_2))
    pdf = torch.exp(-0.5 * h.square()) * _INV_SQRT_2PI
    return h * cdf, cdf + h * pdf


def gemm_bf16_epilogue_plain(a, b, bias, epilogue, residual=None, aux=None,
                             gelu="base", res_scale=1.0):
    """epilogue(a @ b + bias): a (..., K), b (K, N), products of the
    rounded operands summed in fp32; b may also be head-major (3, H, K,
    D), column (t, h, d) of the (K, 3HD) operand at [t, h, :, d] (the K12
    probe's ``pvrow`` weight).
    "bias", "bias_gelu", "bias_residual": rounded to a.dtype; "bias_gelu"
    with ``gelu`` one of :data:`GELU_MODES` (:func:`gelu_poly`);
    "bias_residual" adds ``residual * res_scale`` (fp32, rounded once).
    "store": a @ b rounded to a.dtype, no bias.
    "f32": fp32 a @ b, no bias.
    "bias_gelu_grad": (GELU rounded to a.dtype, fp32 GELU'), both of
    a @ b + bias.
    "mul_aux": (a @ b * aux rounded to a.dtype, fp32 column sums of
    a @ b * aux), no bias."""
    res_scale = residual_scale(res_scale)
    if b.dim() == 4:
        b = b.permute(2, 0, 1, 3).reshape(b.shape[2], -1)
    v = torch.matmul(a.float(), b.float())
    if epilogue == "f32":
        return v
    if epilogue == "store":
        return v.to(a.dtype)
    if epilogue == "mul_aux":
        v = v * aux
        return v.to(a.dtype), v.reshape(-1, v.shape[-1]).sum(0)
    v = v + bias.float()
    if epilogue == "bias_gelu":
        v = gelu_poly(v, gelu)
    elif epilogue == "bias_residual":
        v = residual.float() * res_scale + v
    elif epilogue == "bias_gelu_grad":
        g, gp = gelu_and_grad_poly(v)
        return g.to(a.dtype), gp
    elif epilogue != "bias":
        raise ValueError(f"unknown epilogue {epilogue!r}")
    return v.to(a.dtype)


def _heads(t, heads):
    """(B, N, 3C) -> q, k, v, each (B, H, N, D)."""
    b, n, c3 = t.shape
    c = c3 // 3
    t = t.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    return t[0], t[1], t[2]


def attention_core_plain(qkv, heads, scale, stats=False):
    """(B, N, 3C) qkv rows, feature order [3][h][d] -> (B, N, C) context
    (``_attn_heads_fwd`` of myrtle_vision_tpu/ops/fused_attention_block.py
    with the exact reciprocal of its interpret mode).  ``stats`` adds the
    rowmax and the reciprocal rowsum, (B, H, N) fp32 each."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = _heads(qkv, heads)
    qs = (q.float() * scale).to(qkv.dtype).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    u = torch.matmul(e.to(qkv.dtype).float(), v.float())
    rs = 1.0 / e.sum(-1, keepdim=True)
    o = (u * rs).to(qkv.dtype).permute(0, 2, 1, 3).reshape(b, n, c)
    if stats:
        return o, m[..., 0], rs[..., 0]
    return o


def attention_core_probe_plain(qkv, heads, scale, mode, parts=False):
    """The attention core in a K12 probe mode (:data:`PROBE_MODES`, the
    per-head bodies of tools/perf/attn_microbench.py): (B, N, 3C) qkv rows
    -> (B, N, C) context, rounded to qkv.dtype.
    "defer", "pipe": bf16(bf16(e) v / rowsum(e)), e = exp(s - rowmax),
        s = bf16(q scale) k^T (the production core with a true divide);
    "none": e = s 0.01; "nomax": e = exp(s); "sumdot": the rowsum over
        bf16(e); each then as "defer";
    "rowmajor": s = (q k^T) scale in fp32, bf16(bf16(e / rowsum) v);
    "dotonly": bf16(bf16(q k^T) v), no scale, no softmax.
    ``parts`` (a deferred-divide mode): (bf16(bf16(e) v) undivided, the
    rowmax (0 where the mode takes none), the rowsum), the last two (B,
    H, N) fp32."""
    b, n, c3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _heads(qkv, heads)
    kt, vf = k.float().transpose(-1, -2), v.float()
    if mode in ("rowmajor", "dotonly"):
        s = torch.matmul(q.float(), kt)
        if mode == "dotonly":
            o = torch.matmul(s.to(dt).float(), vf)
        else:
            s = s * scale
            e = torch.exp(s - s.amax(-1, keepdim=True))
            p = (e / e.sum(-1, keepdim=True)).to(dt)
            o = torch.matmul(p.float(), vf)
    elif mode in DEFERRED_MODES:
        s = torch.matmul((q.float() * scale).to(dt).float(), kt)
        m = torch.zeros_like(s[..., :1])
        if mode == "none":
            e = s * 0.01
        elif mode == "nomax":
            e = torch.exp(s)
        else:
            m = s.amax(-1, keepdim=True)
            e = torch.exp(s - m)
        eb = e.to(dt).float()
        ssum = (eb if mode == "sumdot" else e).sum(-1, keepdim=True)
        o = torch.matmul(eb, vf)
        if parts:
            u = o.to(dt).permute(0, 2, 1, 3).reshape(b, n, c3 // 3)
            return u, m[..., 0], ssum[..., 0]
        o = o / ssum
    else:
        raise ValueError(f"unknown probe mode {mode!r}")
    if parts:
        raise ValueError(f"probe mode {mode!r} has no parts")
    return o.to(dt).permute(0, 2, 1, 3).reshape(b, n, c3 // 3)


def _layout_heads(a, b, contract, heads):
    """(a's and b's contracted dimensions, the number of heads, a's and
    b's head widths) of :func:`batched_layout_dot_plain`: both operands
    split into ``heads`` equal column slices (one without heads)."""
    (ca,), (cb,) = contract
    h = heads or 1
    if a.shape[-1] % h or b.shape[-1] % h or ca not in (0, 1) or \
            cb not in (0, 1):
        raise ValueError(f"layout_dot: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, contract {contract}, heads "
                         f"{heads}")
    return ca, cb, h, a.shape[-1] // h, b.shape[-1] // h


def batched_layout_dot_plain(a, b, contract, heads=None, explicit=False):
    """The K14 probe's contraction (``_dot`` of tools/perf/layout_probe.py
    per image): a (B, r, c) batched, b (B, r', c') batched or (r', c')
    shared, ``contract`` ((i,), (j,)) the dimensions of a's and b's
    per-image matrices to sum over; with ``heads`` each operand is that
    many equal column slices and the heads' products are concatenated
    along the last axis.  fp32 products of the rounded operands, fp32
    out.  ``explicit`` transposes a transposed operand into a contiguous
    copy first (the same function)."""
    ca, cb, h, wa, wb = _layout_heads(a, b, contract, heads)
    outs = []
    for i in range(h):
        ah = a[..., i * wa:(i + 1) * wa].float()
        bh = b[..., i * wb:(i + 1) * wb].float()
        if ca == 0:
            ah = ah.transpose(-1, -2)
        if cb == 1:
            bh = bh.transpose(-1, -2)
        if explicit:
            ah, bh = ah.contiguous(), bh.contiguous()
        outs.append(torch.matmul(ah, bh))
    return torch.cat(outs, -1)


def attention_core_bwd_plain(qkv, d_o, m, rs, heads, scale):
    """The per-head backward of ``_bwd_one_image``: qkv (B, N, 3C),
    d_o = do @ Wp^T (B, N, C) fp32, the saved m and rs (B, H, N) ->
    (dqkv (B, N, 3C) rounded to qkv.dtype, its fp32 column sums per
    image (B, 3C))."""
    dt = qkv.dtype
    b, n, c3 = qkv.shape
    q, k, v = _heads(qkv, heads)
    qs = (q.float() * scale).to(dt).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    e = torch.exp(s - m[..., None])
    d_oh = d_o.reshape(b, n, heads, -1).permute(0, 2, 1, 3)
    du = (d_oh * rs[..., None]).to(dt).float()
    dv = torch.matmul(e.to(dt).float().transpose(-1, -2), du)
    dp = torch.matmul(du, v.float().transpose(-1, -2))
    r = (dp * e).sum(-1, keepdim=True)
    dsb = (e * (dp - r * rs[..., None])).to(dt).float()
    dq = torch.matmul(dsb, k.float()) * scale
    dk = torch.matmul(dsb.transpose(-1, -2), qs)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(b, n, c3)
    return dqkv.to(dt), dqkv.sum(1)


def layernorm_rows_bwd_plain(x, scale, dxn, do, qspec=None, res_scale=1.0):
    """LayerNorm backward with the residual gradient (``_bwd_one_image``):
    x, do (rows, C) in the activation dtype, scale (C,), dxn (rows, C)
    fp32 -> (dx rounded to x.dtype, dscale, dbias), the last two fp32
    column sums of dxn * xhat and dxn.  With a float format's ``qspec``
    (fp32 throughout) xhat is recomputed from snap(x), the norm's act_in
    site, whose gradient is straight-through; with :class:`Int8Sites`
    (fp32) from x.  dx = do * res_scale + the LayerNorm's part."""
    res_scale = residual_scale(res_scale)
    xf = snap(x, qspec).float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + EPS)
    xhat = (xf - mu) * rstd
    dxhat = dxn * scale.float()
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = do.float() * res_scale + rstd * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), (dxn * xhat).sum(0), dxn.sum(0)


def colsum_rows_plain(t):
    """fp32 column sums of a (rows, cols) matrix."""
    return t.float().sum(0)


def _guarded(site):
    """(scale, zero point) of a site, 1 and 128 without statistics (the
    integer products' guard, ``_quantize_i8``)."""
    has = site[2] > 0.5
    return (torch.where(has, site[0], torch.ones_like(site[0])),
            torch.where(has, site[1], torch.full_like(site[1], 128.0)))


def quantize_i8(x, site):
    """fp32 -> the site's uint8 grid q = clip(rint(x/s) + zp, 0, 255),
    returned as int8 q - 128, with the guard of :func:`_guarded`."""
    s, zp = _guarded(site)
    q = torch.clamp(torch.round(x / s) + zp, 0.0, 255.0)
    return (q - 128.0).to(torch.int8)


def requant(x, site):
    """The site's uint8 affine fake-quant; without statistics x as it is
    (``_requant`` of myrtle_vision_tpu/ops/fused_int8_block.py, the same
    snap as the QAT kernels' ``snap_int8``)."""
    return snap_int8(x, Int8Sites(site), 0)


def layernorm_quant_rows_plain(x, scale, bias, site):
    """fp32 (..., C) -> the int8 grid of ``site`` of LayerNorm(x) (eps
    1e-5, fp32 scale and bias): the prologue of both converted-INT8
    block kernels."""
    return quantize_i8(layernorm_rows_plain(x, scale, bias), site)


def gemm_s8_epilogue_plain(a, w, colsum, w_scale, a_site, bias, epilogue,
                           site, site2=None, residual=None):
    """The shifted-zero-point int8 product of ``_i8_dot`` and an
    epilogue: a int8 (M, K) = q - 128 on ``a_site``'s grid, w int8 (K,
    N), colsum fp32 (N,) = sum_k w[k, n], w_scale fp32 0-d ->
    v = (s_x s_w) (a @ w + (128 - zp_x) colsum) + bias, the integer
    product exact (float64, rounded once to fp32 as the int32 sum is),
    then
    "requant":                  requant(v, site), fp32;
    "requant_gelu_quant":       the int8 grid of ``site2`` of
                                GELU(requant(v, site)), int8;
    "requant_residual_requant": requant(requant(v, site) + residual,
                                site2), fp32."""
    acc = torch.matmul(a.double(), w.double()).float()
    s_x, zp = _guarded(a_site)
    v = (s_x * w_scale) * (acc + (128.0 - zp) * colsum) + bias
    v = requant(v, site)
    if epilogue == "requant":
        return v
    if epilogue == "requant_gelu_quant":
        return quantize_i8(gelu_poly(v), site2)
    if epilogue == "requant_residual_requant":
        return requant(v + residual, site2)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def attention_context_f32(qkv, heads, scale, stats=False):
    """fp32 (B, N, 3C) qkv rows, feature order [3][h][d] -> the fp32 (B,
    N, C) context: the 3-pass bf16 scores (ops/high_precision.py), x
    scale after the product, softmax with a true divide, the 3-pass P V
    (the core of ``_attn_kernel``).  ``stats`` adds the rowmax and the
    reciprocal rowsum (a true divide), (B, H, N) fp32 each, as
    ``_attn_heads_fwd`` with ``qspec`` returns them."""
    b, n, c3 = qkv.shape
    q, k, v = _heads(qkv, heads)
    s = bdot_qk_high3(q, k) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    ssum = e.sum(-1, keepdim=True)
    ctx = bdot_pv_high3(e / ssum, v).permute(0, 2, 1, 3).reshape(
        b, n, c3 // 3)
    if stats:
        return ctx, m[..., 0], (1.0 / ssum)[..., 0]
    return ctx


def attention_core_f32_plain(qkv, heads, scale, site):
    """The int8 grid of ``site`` of :func:`attention_context_f32`."""
    return quantize_i8(attention_context_f32(qkv, heads, scale), site)


def fake_quant_rows_plain(x, mode, a, b):
    """K11 (``_elementwise_pallas``): ``float_quantize(x, a, b)`` for mode
    "float" (a = exp_bits, b = man_bits), ``fixed_point_quantize(x, a, b)``
    for "fixed" (a = wl, b = fl); fp32 out, x's shape."""
    if mode == "float":
        return float_quantize(x, a, b)
    if mode == "fixed":
        return fixed_point_quantize(x, a, b)
    raise ValueError(f"unknown fake-quant mode {mode!r}")


def layernorm_snap_rows_plain(x, scale, bias, qspec):
    """The float-format and INT8 QAT LayerNorm prologue (``_qkv_rows`` /
    ``fc1`` with ``qspec``): fp32 (..., C) ->
    snap_int8(snap(snap_all(LN(snap(x)))), site 0)."""
    y = layernorm_rows_plain(snap(x, qspec), scale, bias)
    return snap_int8(snap(snap_all(y, qspec), qspec), qspec, 0)


def gemm_f32x3_epilogue_plain(a, w, bias, epilogue, qspec, residual=None,
                              aux=None, res_scale=1.0):
    """fp32 a (M, K) @ w (K, N) at 3-pass precision (``dot_high3``: both
    operands split, the incoming gradient too), then
    "f32":                      the product, no bias, no snap;
    "mul_aux":                  (product * aux, its fp32 column sums);
    and with the bias added, h = site0(snap_all(product + bias)) (site0,
    site1: ``snap_int8`` at the first and second INT8 site):
    "bias_snap":                h;
    "bias_snap_gelu_snap":      site1(snap(snap_all(GELU(h)))), the
                                polynomial erf with an exact divide;
    "bias_snap_gelu_snap_grad": (that, fp32 GELU'(h)) from one erf (the
                                backward's fc1 recompute);
    "bias_snap_residual_snap":  site1(snap_all(residual * res_scale + h))."""
    res_scale = residual_scale(res_scale)
    p = matmul_high3(a, w)
    if epilogue == "f32":
        return p
    if epilogue == "mul_aux":
        v = p * aux
        return v, v.sum(0)
    v = snap_int8(snap_all(p + bias, qspec), qspec, 0)
    if epilogue == "bias_snap":
        return v
    if epilogue == "bias_snap_gelu_snap":
        return snap_int8(snap(snap_all(gelu_poly(v), qspec), qspec), qspec, 1)
    if epilogue == "bias_snap_gelu_snap_grad":
        g, gp = gelu_and_grad_poly(v)
        return snap_int8(snap(snap_all(g, qspec), qspec), qspec, 1), gp
    if epilogue == "bias_snap_residual_snap":
        return snap_int8(snap_all(residual * res_scale + v, qspec), qspec, 1)
    raise ValueError(f"unknown epilogue {epilogue!r}")


def attention_core_snap_plain(qkv, heads, scale, qspec, stats=False):
    """:func:`attention_context_f32` through the projection's pre_linear
    ``snap`` (``_attn_heads_fwd`` with ``qspec``, then to_out.act_in), or
    INT8's quant_out site (``snap_int8`` at site 0); ``stats`` adds the
    rowmax and reciprocal rowsum."""
    if stats:
        ctx, m, rs = attention_context_f32(qkv, heads, scale, stats=True)
        return snap_int8(snap(ctx, qspec), qspec, 0), m, rs
    return snap_int8(snap(attention_context_f32(qkv, heads, scale), qspec),
                     qspec, 0)


def attention_core_f32_bwd_plain(qkv, d_o, m, rs, heads, scale):
    """The per-head backward of ``_bwd_one_image`` with ``qspec``, fp32
    throughout, every product 3-pass: qkv (B, N, 3C) (the forward's
    snapped rows), d_o = do @ Wp^T (B, N, C), the saved m and rs (B, H,
    N) -> (dqkv (B, N, 3C), its column sums per image (B, 3C))."""
    b, n, c3 = qkv.shape
    q, k, v = _heads(qkv, heads)
    e = torch.exp(bdot_qk_high3(q, k) * scale - m[..., None])
    du = d_o.reshape(b, n, heads, -1).permute(0, 2, 1, 3) * rs[..., None]
    dv = bdot_pv_high3(e.transpose(-1, -2), du)
    dp = bdot_qk_high3(du, v)
    r = (dp * e).sum(-1, keepdim=True)
    ds = e * (dp - r * rs[..., None])
    dq = bdot_pv_high3(ds, k) * scale
    dk = bdot_pv_high3(ds.transpose(-1, -2), q) * scale
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(b, n, c3)
    return dqkv, dqkv.sum(1)




PLAIN = SimpleNamespace(
    layernorm_rows=layernorm_rows_plain,
    gemm=gemm_bf16_epilogue_plain,
    attention_core=attention_core_plain,
    attention_core_bwd=attention_core_bwd_plain,
    layernorm_rows_bwd=layernorm_rows_bwd_plain,
    colsum_rows=colsum_rows_plain,
    layernorm_quant_rows=layernorm_quant_rows_plain,
    gemm_s8=gemm_s8_epilogue_plain,
    attention_core_f32=attention_core_f32_plain,
    fake_quant_rows=fake_quant_rows_plain,
    layernorm_snap_rows=layernorm_snap_rows_plain,
    gemm_f32x3=gemm_f32x3_epilogue_plain,
    attention_core_snap=attention_core_snap_plain,
    attention_core_f32_bwd=attention_core_f32_bwd_plain,
    attention_core_probe=attention_core_probe_plain,
    gemm_probe=gemm_bf16_epilogue_plain,
    layout_dot=batched_layout_dot_plain,
)


# ------------------------------------------------------------------- CUDA

def _require(t, name, dtype=torch.bfloat16):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


def _require_shape(t, name, shape, dtype=torch.float32):
    _require(t, name, dtype)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name, fn, t, *args, launched=None):
    """Run C entry point ``fn`` on ``t``'s device and stream, raise if it
    returned an error, count its kernel launches: one, or the value of
    the ``ctypes.c_int`` ``launched`` that ``fn`` writes through a
    pointer among ``args``."""
    from myrtle_vision_tpu_torch.ops import _build

    with torch.cuda.device(t.device):
        err = fn(*args, _stream(t))
    _build.check(err, name)
    LAUNCHES[name] += 1 if launched is None else launched.value


def _lib():
    from myrtle_vision_tpu_torch.ops import _build

    return _build.lib()


def layernorm_rows_cuda(x, scale, bias):
    """bf16 (..., C) -> bf16 LayerNorm; scale and bias bf16 (C,)."""
    cols = x.shape[-1]
    _require(x, "x")
    for t, name in ((scale, "scale"), (bias, "bias")):
        _require_shape(t, name, (cols,), torch.bfloat16)
    out = torch.empty_like(x)
    _launch("layernorm_rows", _lib().mvt_layernorm_rows, x,
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            x.numel() // cols, cols, EPS)
    return out


def _operand(t, name):
    """(tensor to pass, column-major flag): a row-major 2-D tensor as it
    is, the transpose of a row-major one in place; any other layout
    raises."""
    if t.dim() != 2:
        raise ValueError(f"gemm: {name} must be 2-D, got {tuple(t.shape)}")
    if t.is_contiguous():
        return t, 0
    if t.t().is_contiguous():
        return t.t(), 1
    raise ValueError(f"gemm: {name} must be row-major or the transpose of "
                     f"a row-major tensor, got strides {t.stride()}")


def _sms(t) -> int:
    """Streaming multiprocessors of ``t``'s device."""
    return _sm_count(t.device.index)


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    # one lookup a device: colsum_rows needs the count on every call, and
    # the properties call is host time a short kernel waits on
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm_plan(m, n, k, a_col_major, sms):
    """How gemm_bf16_epilogue covers an (M, N) output with K deep
    products: {"tile": (rows, cols), "k_split": K rows of a tile, "grid":
    (column tiles, row tiles, K chunks)}, the tiles that the persistent
    CTAs of csrc/gemm_bf16_wgmma.cu walk.  A transposed ``a`` (a weight
    gradient) splits K in multiples of :data:`GEMM_BK` into at most one
    wave of the kernel's two CTAs on each of ``sms`` SMs; any other
    product takes K whole."""
    bm, bn = GEMM_TILE
    k_split = k
    if a_col_major:
        # as many chunks as one wave of two CTAs an SM holds, each at
        # least 256 rows deep
        tiles = math.ceil(m / bm) * math.ceil(n / bn)
        splits = max(1, min(2 * sms // tiles, k // 256))
        k_split = math.ceil(math.ceil(k / splits) / GEMM_BK) * GEMM_BK
    return {"tile": GEMM_TILE, "k_split": k_split,
            "grid": (math.ceil(n / bn), math.ceil(m / bm),
                     math.ceil(k / k_split))}


def gemm_f32x3_plan(m, n, k, a_col_major, sms, epilogue="f32"):
    """How gemm_f32x3_epilogue covers an (M, N) output with K deep
    products: {"tile": (rows, cols), "k_split": K rows of a tile, "grid":
    (column tiles, row tiles, K chunks)}, the tiles that the one
    persistent CTA an SM of csrc/gemm_f32x3_wgmma.cu walks:
    :data:`F32X3_TILE`, or :data:`F32X3_GELU_TILE` for the two GELU
    epilogues (``epilogue``, a key of :data:`F32X3_EPILOGUES`).  A transposed
    ``a`` (a weight gradient) splits K in multiples of :data:`F32X3_BK`
    into about :data:`F32X3_WAVES` waves of tiles on ``sms`` SMs, each
    chunk at least :data:`F32X3_MIN_CHUNK` rows deep (8 steps); any other
    product takes K whole.  Row tile y of an epilogue-5 product writes
    row y of its column sums (``colpart``)."""
    tile = F32X3_GELU_TILE if "gelu" in epilogue else F32X3_TILE
    bm, bn = tile
    k_split = k
    if a_col_major:
        tiles = math.ceil(m / bm) * math.ceil(n / bn)
        splits = max(1, min(F32X3_WAVES * sms // tiles,
                            k // F32X3_MIN_CHUNK))
        k_split = math.ceil(math.ceil(k / splits) / F32X3_BK) * F32X3_BK
    return {"tile": tile, "k_split": k_split,
            "grid": (math.ceil(n / bn), math.ceil(m / bm),
                     math.ceil(k / k_split))}


def attention_core_f32_plan(n, d):
    """How ``attention_core_f32`` (every mode) and
    ``attention_core_f32_bwd`` cover one (image, head) of ``n`` tokens
    (1 to :data:`F32_CORE_MAX_N`) at head width ``d`` (32 or 64): {"n_pad":
    n rounded up to 16, "fwd": figures, "bwd": figures}, each with
    "warpgroups" of a CTA, "ka" (the keys of warpgroup 0 in the
    backward's query pass, a multiple of 16; warpgroup 1 takes the rest
    of n_pad; 0 in the forward), "launches" per call, "smem" (dynamic
    shared memory bytes a CTA) and "ctas_per_sm", the CTAs an SM that
    the kernel's launch bounds count on (a short sequence may fit more).
    One CTA per (image, head).  The forward holds the hi and lo halves of
    K and V (4 n_pad d bf16): one warpgroup a CTA where two CTAs fit an
    SM, else one CTA of two warpgroups.  The backward, two warpgroups,
    holds K and V or q and du in turn (4 n_pad d bf16), the query tile's
    or the key tiles' halves (8 x 64 d bf16), and m, rs, r rs of each
    query, the rowsum partials and the column sums in fp32."""
    if not 1 <= n <= F32_CORE_MAX_N or d not in (32, 64):
        raise ValueError(f"attention_core_f32_plan: n={n}, d={d}")
    n_pad = math.ceil(n / 16) * 16
    row = 2 * d  # bytes of a split bf16 row
    fwd_smem = TILE_ALIGN_BYTES + 4 * n_pad * row
    two = 2 * (fwd_smem + CTA_RESERVED_BYTES) <= SM_SHARED_BYTES
    stats = 3 * F32_CORE_MAX_N + 128 + 8 * 3 * d  # floats
    bwd_smem = TILE_ALIGN_BYTES + 4 * n_pad * row + 8 * 64 * row + 4 * stats
    return {
        "n_pad": n_pad,
        "fwd": {"warpgroups": 1 if two else 2, "ka": 0, "launches": 1,
                "smem": fwd_smem, "ctas_per_sm": 2 if two else 1},
        "bwd": {"warpgroups": 2, "ka": math.ceil(n_pad / 32) * 16,
                "launches": 1, "smem": bwd_smem, "ctas_per_sm": 1},
    }


def flash_plan(n, d):
    """How ``flash_attention_fwd`` and ``flash_attention_bwd`` cover one
    (image, head) of ``n`` tokens (n_valid = n) at head width ``d`` (32 or
    64): {"fwd": figures, "dkdv": figures, "dq": figures, "launches":
    {"fwd": 1, "bwd": 3}}.  Each kernel's figures: "grid" (its CTAs per
    (image, head): tiles of :data:`FLASH_ROWS` queries, or keys for dk /
    dv; the grid's second axis is the B H images and heads), "rows" (a
    CTA's own rows), "tile" (the rows of a tile it walks: keys, or
    queries for dk / dv), "walk" (the tiles it walks), "threads",
    "stages" (the ring's tiles), "smem" (dynamic shared memory bytes) and
    "ctas_per_sm" (their registers keep one CTA an SM).  The forward holds
    its Q tile and a ring of K and V tiles and the ring's barriers; dk /
    dv its K and V and a ring of q and do tiles with their LSE and dsum
    (each stage padded to 1024 bytes); dq its q and do and a ring of K and
    V tiles.  The backward's third launch, the dsum pre-pass, takes no
    shared memory."""
    if n < 1 or d not in (32, 64):
        raise ValueError(f"flash_plan: n={n}, d={d}")
    row = 2 * d  # bytes of a q, k, v or do row
    own = FLASH_ROWS * row
    tile = FLASH_BWD_TILE * row
    stages = FLASH_BWD_STAGES

    def kernel(walked, n_stages, smem):
        return {"grid": math.ceil(n / FLASH_ROWS), "rows": FLASH_ROWS,
                "tile": walked, "walk": math.ceil(n / walked),
                "threads": FLASH_THREADS, "stages": n_stages, "smem": smem,
                "ctas_per_sm": 1}

    return {
        "fwd": kernel(FLASH_FWD_TILE, FLASH_FWD_STAGES,
                      TILE_ALIGN_BYTES + own
                      + 2 * FLASH_FWD_STAGES * FLASH_FWD_TILE * row
                      + 8 * (1 + 4 * FLASH_FWD_STAGES)),
        "dkdv": kernel(FLASH_BWD_TILE, stages,
                       TILE_ALIGN_BYTES + 2 * own
                       + stages * (2 * tile + 1024) + 8 * (1 + 2 * stages)),
        "dq": kernel(FLASH_BWD_TILE, stages,
                     TILE_ALIGN_BYTES + 2 * own + stages * 2 * tile
                     + 8 * (1 + 2 * stages)),
        "launches": {"fwd": 1, "bwd": 3},
    }


def flash_launch(n, d):
    """The launch figures that the flash kernels report for ``n`` tokens
    at head width ``d``, in the form of :func:`flash_plan` without "walk"
    ("ctas_per_sm" the runtime's occupancy of the compiled kernel)."""
    from myrtle_vision_tpu_torch.ops import _build

    lib = _lib()
    keys = ("grid", "rows", "tile", "threads", "stages", "smem",
            "ctas_per_sm")
    f = (ctypes.c_int * 7)()
    _build.check(lib.mvt_flash_attention_fwd_plan(n, d, f),
                 "flash_launch[fwd]")
    figures = {"fwd": dict(zip(keys, f))}
    b = (ctypes.c_int * 15)()
    _build.check(lib.mvt_flash_attention_bwd_plan(n, d, b),
                 "flash_launch[bwd]")
    figures["dkdv"] = dict(zip(keys, b[:7]))
    figures["dq"] = dict(zip(keys, b[7:14]))
    figures["launches"] = {"fwd": 1, "bwd": b[14]}
    return figures


def core_long_plan(n, d, b=1, heads=1):
    """How the fused attention core's long route (``attention_core``
    above :func:`attention_core_max_n`, ``attention_core_bwd`` with
    ``tiled``) covers ``b`` images of ``heads`` heads of ``n`` tokens at
    head width ``d`` (32 or 64): {"fwd": figures, "dq": figures, "dkdv":
    figures, "launches": {"fwd": 1, "bwd": 4}, "n_pad": n rounded up to
    :data:`CORE_LONG_BWD_TILE`, "scratch": the backward's scratch
    shapes}.  Each kernel's figures: "grid" (its CTAs per (image, head):
    tiles of :data:`CORE_LONG_ROWS` queries, or keys for dk / dv; the
    grid's second axis is the b heads images and heads), "rows" (a CTA's
    own rows), "tile" (the rows of a tile it walks: keys, or queries for
    dk / dv), "walk" (the tiles of a pass), "passes" (the dq kernel walks
    the keys twice: r of every row, then ds and dQ), "threads", "stages"
    (the ring's tiles), "smem" (dynamic shared memory bytes) and
    "ctas_per_sm" (what the launch bounds count on).  The forward, one
    warpgroup whose thread 0 issues its loads, holds a ring of K and V
    tiles and their full barriers (its q rows live in registers); the
    backward's kernels add a producer warp; dq holds its qs and
    du rows and a ring of K and V tiles; dk / dv its K and V and a ring of
    qs and du tiles with their m log2(e) and r rs (each stage padded to
    1024 bytes); both backward kernels a column-sum buffer of 4 warps x 3
    sections x d fp32.  The backward's scratch: "qd" (qs, then du, each
    (b, n, heads d) bf16), "stats" (m log2(e), then r rs, in rows of
    n_pad per image and head) and "colpart" (each 64-row tile's column
    sums, (b, n_pad / 64, 3 heads d)); its other two launches, the prep
    pass and the column sums, take no shared memory.  64-row CTAs make
    the YOLOS-S train step's micro-batch (2 images of 6 heads, 677
    tokens) 132 CTAs, and two CTAs an SM fill the card at batch 8."""
    if n < 1 or d not in (32, 64) or b < 1 or heads < 1:
        raise ValueError(f"core_long_plan: n={n}, d={d}, b={b}, "
                         f"heads={heads}")
    row = 2 * d  # bytes of a qkv, qs or du row
    own = CORE_LONG_ROWS * row
    tile = CORE_LONG_BWD_TILE * row
    stages = CORE_LONG_BWD_STAGES
    n_pad = math.ceil(n / CORE_LONG_BWD_TILE) * CORE_LONG_BWD_TILE
    colbuf = 4 * (4 * 3 * d)  # bytes: 4 warps x 3 sections x d fp32

    def kernel(grid, walked, n_stages, smem, passes=1,
               threads=CORE_LONG_THREADS):
        return {"grid": grid, "rows": CORE_LONG_ROWS, "tile": walked,
                "walk": math.ceil(n / walked), "passes": passes,
                "threads": threads, "stages": n_stages, "smem": smem,
                "ctas_per_sm": CORE_LONG_CTAS_PER_SM}

    fwd_stages = CORE_LONG_FWD_STAGES
    bwd_grid = n_pad // CORE_LONG_ROWS
    return {
        "fwd": kernel(math.ceil(n / CORE_LONG_ROWS), CORE_LONG_FWD_TILE,
                      fwd_stages,
                      TILE_ALIGN_BYTES
                      + 2 * fwd_stages * CORE_LONG_FWD_TILE * row
                      + 8 * 2 * fwd_stages,
                      threads=CORE_LONG_FWD_THREADS),
        "dq": kernel(bwd_grid, CORE_LONG_BWD_TILE, stages,
                     TILE_ALIGN_BYTES + 2 * own + stages * 2 * tile
                     + 8 * (1 + 2 * stages) + colbuf, passes=2),
        "dkdv": kernel(bwd_grid, CORE_LONG_BWD_TILE, stages,
                       TILE_ALIGN_BYTES + 2 * own
                       + stages * (2 * tile + 1024) + 8 * (1 + 2 * stages)
                       + colbuf),
        "launches": {"fwd": 1, "bwd": CORE_LONG_BWD_LAUNCHES},
        "n_pad": n_pad,
        "scratch": {"qd": (2, b, n, heads * d),
                    "stats": (2, b * heads * n_pad),
                    "colpart": (b, bwd_grid, 3 * heads * d)},
    }


def core_long_launch(n, d):
    """The launch figures that the long route's kernels report for ``n``
    tokens at head width ``d``, in the form of :func:`core_long_plan`
    without "walk", "passes", "n_pad" and "scratch" ("ctas_per_sm" the
    runtime's occupancy of the compiled kernel)."""
    from myrtle_vision_tpu_torch.ops import _build

    keys = ("grid", "rows", "tile", "threads", "stages", "smem",
            "ctas_per_sm")
    f = (ctypes.c_int * 23)()
    _build.check(_lib().mvt_attention_core_long_plan(n, d, f),
                 "core_long_launch")
    figures = {key: dict(zip(keys, f[7 * i:7 * i + 7]))
               for i, key in enumerate(("fwd", "dq", "dkdv"))}
    figures["launches"] = {"fwd": f[22], "bwd": f[21]}
    return figures


def f32_sweep_smem(d, rank_tiles):
    """The cluster design's dynamic shared memory at head width ``d`` and
    ``rank_tiles`` key tiles a CTA (csrc/f32_long_wgmma.cuh
    ``sweep_smem``): the alignment slack, a ring stage a key tile (its K
    and then its V tile's bf16 hi and lo halves), q's and two landed K
    tiles' halves as fp32 rows, the 64 x (64 rank_tiles + 4) fp32 scores
    and the full barriers of :data:`F32_SWEEP_MAX_TILES` stages."""
    pair = 2 * F32_LONG_TILE * 2 * d
    return (TILE_ALIGN_BYTES + rank_tiles * pair + 2 * F32_LONG_TILE * d * 4
            + 4 * F32_LONG_TILE * d * 4
            + F32_LONG_TILE * (F32_LONG_TILE * rank_tiles + 4) * 4
            + 8 * F32_SWEEP_MAX_TILES)


def f32_sweep_max_tiles(d):
    """The most key tiles a cluster design CTA holds at head width ``d``
    (4 at 64, 7 at 32)."""
    t = 1
    while t < F32_SWEEP_MAX_TILES and \
            f32_sweep_smem(d, t + 1) <= F32_LONG_SMEM_OPTIN:
        t += 1
    return t


def f32_sweep_cluster(tiles, bh, sms, max_tiles):
    """The cluster design's CTAs a cluster for ``tiles`` 64-key tiles,
    ``bh`` (image, head) pairs and ``sms`` SMs (csrc/f32_long_wgmma.cuh
    ``sweep_cluster``): of the powers of two up to
    :data:`F32_SWEEP_MAX_CLUSTER` whose key tiles a CTA, ceil(tiles /
    cluster), fit ``max_tiles``, the one with the least estimated time,
    waves x (key tiles a CTA + 1), a wave as many CTAs as the SMs hold in
    whole clusters at one CTA an SM; the smaller on a tie."""
    best, best_cost, c = 0, 0, 1
    while c <= F32_SWEEP_MAX_CLUSTER:
        rank_tiles = -(-tiles // c)
        if rank_tiles <= max_tiles:
            slots = sms // c * c
            cost = -(-bh * tiles * c // slots) * (rank_tiles + 1)
            if best == 0 or cost < best_cost:
                best, best_cost = c, cost
        c *= 2
    return best


@functools.lru_cache(maxsize=256)
def f32_long_plan(n, d, b=1, heads=1, sweep=False, sms=F32_LONG_SMS):
    """How the fp32 core's long route (``attention_core_snap`` and
    ``attention_core_f32`` above :data:`F32_CORE_MAX_N` or with ``tiled``,
    ``attention_core_f32_bwd`` likewise) covers ``b`` images of ``heads``
    heads of ``n`` tokens (1 to :data:`F32_LONG_MAX_N`) at head width ``d``
    (32 or 64) on ``sms`` SMs: {"tiles": the 64-row tiles of a (image,
    head), "n_pad": n rounded up to :data:`F32_LONG_TILE`, "sweep": whether
    the forward takes the cluster design, "fwd", "dq", "dkdv": each
    kernel's figures, "launches": {"fwd": 2, "bwd": 4}, "scratch": {"fwd":
    ..., "bwd": ...} the shapes the wrappers allocate}.  A kernel's
    figures: "grid" (its CTAs per (image, head)), "rows" (a CTA's own
    rows), "tile" (the rows of a tile it walks), "threads", "stages" (its
    ring's tiles), "smem" (dynamic shared memory bytes), "ctas_per_sm" and,
    for the forward, "cluster" (its CTAs a cluster).  The forward is a
    split pass, then a core kernel, one CTA an SM.  Up to
    :data:`F32_LONG_BLOCK_MAX_N` tokens, unless ``sweep`` forces the other,
    the score-block design: a CTA a tile of 64 queries, a warpgroup and a
    producer warp, its 64 x n_pad fp32 score block and a ring of K or V
    tiles' bf16 hi and lo halves with what the score block leaves of
    :data:`F32_LONG_SMEM_OPTIN` (4 stages up to n_pad 640, 3 at 704, 2 at
    768), beside the full and empty barriers of
    :data:`F32_LONG_FWD_MAX_STAGES` stages.  Above it the cluster design:
    a cluster of :func:`f32_sweep_cluster` CTAs a tile of 64 queries, each
    CTA :data:`F32_SWEEP_THREADS` threads holding the scores of ceil(tiles
    / cluster) key tiles, a ring stage each (:func:`f32_sweep_smem`).  The
    backward is a split pass, a dq and a dk / dv kernel of one warpgroup,
    two CTAs an SM, each holding its own rows' two split operands, a ring
    of 2 (d 64) or 4 (d 32) stages of two more, the barriers and the
    stages' release counts and a column-sum buffer of 4 warps x 3 sections
    x d fp32, and the column sums.  Scratch: the forward's "split" (K's
    and V's hi and lo halves, (4, b, heads, n_pad, d) bf16); the
    backward's "split" (q's, k's, v's and du's, (8, b, heads, n_pad, d)
    bf16), "rt" (r rs of every row, (b, heads, n_pad) fp32) and "colpart"
    (each 64-row tile's column sums, (b, tiles, 3 heads d) fp32).  Cached:
    every long-route call reads it, and the returned dictionary is not to
    be changed."""
    if not 1 <= n <= F32_LONG_MAX_N or d not in (32, 64) or b < 1 or \
            heads < 1:
        raise ValueError(f"f32_long_plan: n={n}, d={d}, b={b}, "
                         f"heads={heads}")
    tiles = math.ceil(n / F32_LONG_TILE)
    n_pad = tiles * F32_LONG_TILE
    pair = 2 * F32_LONG_TILE * 2 * d  # bytes: a tile's hi and lo halves
    bars = 8 * 2 * F32_LONG_FWD_MAX_STAGES
    sweep = bool(sweep) or n > F32_LONG_BLOCK_MAX_N
    bwd_stages = 2 if d == 64 else 4
    bwd_smem = (TILE_ALIGN_BYTES + 2 * pair + bwd_stages * 2 * pair
                + 8 * (1 + 2 * bwd_stages) + 4 * 4 * 3 * d)

    def kernel(threads, stages, smem, ctas, grid=tiles):
        return {"grid": grid, "rows": F32_LONG_TILE, "tile": F32_LONG_TILE,
                "threads": threads, "stages": stages, "smem": smem,
                "ctas_per_sm": ctas}

    bwd = kernel(F32_LONG_BWD_THREADS, bwd_stages, bwd_smem,
                 F32_LONG_BWD_CTAS_PER_SM)
    if sweep:
        cluster = f32_sweep_cluster(tiles, b * heads, sms,
                                    f32_sweep_max_tiles(d))
        rank_tiles = -(-tiles // cluster)
        fwd = kernel(F32_SWEEP_THREADS, rank_tiles,
                     f32_sweep_smem(d, rank_tiles), 1, tiles * cluster)
    else:
        cluster, scores = 1, n_pad * F32_LONG_TILE * 4
        stages = min(F32_LONG_FWD_MAX_STAGES,
                     (F32_LONG_SMEM_OPTIN - TILE_ALIGN_BYTES - scores - bars)
                     // pair)
        fwd = kernel(F32_LONG_FWD_THREADS, stages,
                     TILE_ALIGN_BYTES + stages * pair + scores + bars, 1)
    return {
        "tiles": tiles, "n_pad": n_pad, "sweep": sweep,
        "fwd": dict(fwd, cluster=cluster),
        "dq": bwd, "dkdv": dict(bwd),
        "launches": {"fwd": F32_LONG_FWD_LAUNCHES,
                     "bwd": F32_LONG_BWD_LAUNCHES},
        "scratch": {
            "fwd": {"split": (4, b, heads, n_pad, d)},
            "bwd": {"split": (8, b, heads, n_pad, d),
                    "rt": (b, heads, n_pad),
                    "colpart": (b, tiles, 3 * heads * d)}},
    }


def f32_long_launch(n, d, sweep=False, bh=1):
    """The launch figures that the fp32 core's long route reports for ``n``
    tokens of ``bh`` (image, head) pairs at head width ``d`` (the
    forward's cluster design where ``sweep`` or above
    :data:`F32_LONG_BLOCK_MAX_N`), in the form of :func:`f32_long_plan`
    without "tiles", "n_pad", "sweep" and "scratch" ("ctas_per_sm" the
    runtime's occupancy of the compiled kernel, the forward's cluster size
    weighed for the device's SMs), and "clusters": the forward's clusters
    that the runtime fits on the device at once (0 for the score-block
    design)."""
    from myrtle_vision_tpu_torch.ops import _build

    keys = ("grid", "rows", "tile", "threads", "stages", "smem",
            "ctas_per_sm")
    f = (ctypes.c_int * 25)()
    _build.check(_lib().mvt_attention_core_f32_long_plan(n, d, int(sweep),
                                                         bh, f),
                 "f32_long_launch")
    figures = {key: dict(zip(keys, f[7 * i:7 * i + 7]))
               for i, key in enumerate(("fwd", "dq", "dkdv"))}
    figures["fwd"]["cluster"] = f[23]
    figures["launches"] = {"fwd": f[22], "bwd": f[21]}
    figures["clusters"] = f[24]
    return figures


def _f32_long_split(plan, kind, like):
    """The bf16 split scratch of one long-route call (:func:`f32_long_plan`
    ``kind`` "fwd" or "bwd") on ``like``'s device."""
    return torch.empty(plan["scratch"][kind]["split"], dtype=torch.bfloat16,
                       device=like.device)


def gemm_s8_plan(m, n, k):
    """How gemm_s8_epilogue covers an (M, N) output: {"tile": (rows,
    cols), "k_split": K (never split), "steps": K steps of
    :data:`S8_BK` (the last zero-filled past K), "grid": (column tiles,
    row tiles, 1)}, the tiles that the two persistent CTAs an SM of
    csrc/gemm_s8_wgmma.cu walk."""
    bm, bn = S8_TILE
    return {"tile": S8_TILE, "k_split": k, "steps": math.ceil(k / S8_BK),
            "grid": (math.ceil(n / bn), math.ceil(m / bm), 1)}


def colsum_plan(rows, cols, sms):
    """How colsum_rows sums a (rows, cols) matrix on ``sms`` SMs:
    {"chunk": rows a first-pass block sums, "chunks": the partial rows
    it writes (1: the sums themselves, one kernel)}.  Up to
    :data:`COLSUM_ONE_PASS` rows take one chunk; above it the chunk, a
    multiple of 8 and at least :data:`COLSUM_MIN_CHUNK` rows, gives about
    :data:`COLSUM_BLOCKS_PER_SM` first-pass blocks an SM (of
    :data:`COLSUM_COLS` columns each), so the grid fills the card and the
    second pass adds at most that many partials a column (and never fewer
    than two chunks)."""
    if rows <= COLSUM_ONE_PASS:
        chunk = rows
    else:
        col_blocks = math.ceil(cols / COLSUM_COLS)
        want = max(2, math.ceil(COLSUM_BLOCKS_PER_SM * sms / col_blocks))
        chunk = max(COLSUM_MIN_CHUNK, math.ceil(rows / want / 8) * 8)
    return {"chunk": chunk, "chunks": math.ceil(rows / chunk)}


def layernorm_snap_plan(rows, cols):
    """How layernorm_snap_rows covers a (rows, cols) fp32 matrix: {"values":
    the columns a lane holds (lane l: l, l + 32, ...), "warps": a block's
    warps, "blocks": the grid, one row a warp, "blocks_per_sm": the blocks
    an SM the kernel is built for (its registers a thread, 65,536 /
    (blocks_per_sm * 32 * warps), hold a row's values, scale and bias)}.
    Raises ``ValueError`` for a width the kernel does not take: none, past
    :data:`LN_SNAP_MAX_COLS` or not a multiple of
    :data:`LN_SNAP_COLS_STEP`."""
    if cols <= 0 or cols > LN_SNAP_MAX_COLS or cols % LN_SNAP_COLS_STEP:
        raise ValueError(
            f"layernorm_snap_rows: width {cols} is not a multiple of "
            f"{LN_SNAP_COLS_STEP} up to the kernel's maximum "
            f"{LN_SNAP_MAX_COLS}")
    values = cols // LN_SNAP_COLS_STEP
    return {"values": values, "warps": LN_SNAP_WARPS,
            "blocks": math.ceil(rows / LN_SNAP_WARPS),
            "blocks_per_sm": 8 if values <= LN_SNAP_FEW_VALUES else 4}


def layernorm_snap_launch(rows, cols):
    """The launch that layernorm_snap_rows reports for a (rows, cols) call,
    in the form of :func:`layernorm_snap_plan`, and "occupancy": the
    runtime's blocks an SM of its float-format and INT8 kernels."""
    from myrtle_vision_tpu_torch.ops import _build

    f = (ctypes.c_int * 6)()
    _build.check(_lib().mvt_layernorm_snap_rows_plan(rows, cols, f),
                 "layernorm_snap_launch")
    keys = ("values", "warps", "blocks", "blocks_per_sm")
    return dict(zip(keys, f[:4]), occupancy={"float": f[4], "int8": f[5]})


def tma_operand(t, name):
    """Raise ``ValueError`` unless the row-major 2-D tensor ``t`` (bf16,
    fp32 or int8) can be a TMA tensor map's base: a 16-byte aligned
    address and rows a multiple of 16 bytes apart (the tensor-map
    encoding's rules)."""
    if t.dim() != 2 or t.stride(1) != 1:
        raise ValueError(f"gemm: {name} must be a row-major 2-D tensor for "
                         f"TMA, got shape {tuple(t.shape)} strides "
                         f"{t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"gemm: {name} starts at an address that is not "
                         "16-byte aligned, which TMA cannot load")
    if (t.stride(0) * t.element_size()) % 16:
        raise ValueError(f"gemm: {name}'s rows are {t.stride(0)} elements "
                         "apart, not a multiple of 16 bytes, which TMA "
                         "cannot load")


def gemm_bf16_epilogue_cuda(a, b, bias, epilogue, residual=None, aux=None,
                            res_scale=1.0):
    """The CUDA version of :func:`gemm_bf16_epilogue_plain` for a bf16
    (M, K) and b bf16 (K, N), each read in place by TMA when it is
    row-major or the transpose of a row-major tensor, with 16-byte
    aligned bases and rows (:func:`tma_operand`; anything else raises
    ``ValueError``).  A transposed ``a`` takes the weight-gradient form:
    fp32 out ("f32" only), any K, K split across CTAs (:func:`gemm_plan`)
    and the partial products summed in order by ``colsum_rows``."""
    res_scale = residual_scale(res_scale)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    a, a_col_major = _operand(a, "a")
    b, b_col_major = _operand(b, "b")
    _require(a, "a")
    _require(b, "b")
    if a_col_major:
        if epilogue != "f32" or b_col_major:
            raise ValueError("gemm: a transposed `a` takes a row-major `b` "
                             "and the f32 epilogue")
        if m % 8 or n % 8:
            raise ValueError(f"gemm: M={m} and N={n} must be multiples of 8")
    elif k % 8 or n % 8:
        raise ValueError(f"gemm: K={k} and N={n} must be multiples of 8")
    tma_operand(a, "a")
    tma_operand(b, "b")
    lib = _lib()
    if a_col_major:
        plan = gemm_plan(m, n, k, True, _sms(a))
        splits = plan["grid"][2]
        part = torch.empty((splits, m, n), dtype=torch.float32,
                           device=a.device)
        _launch("gemm_bf16_epilogue", lib.mvt_gemm_bf16_at, a,
                a.data_ptr(), b.data_ptr(), part.data_ptr(), m, n, k,
                plan["k_split"])
        if splits == 1:
            return part[0]
        return colsum_rows_cuda(part.view(splits, m * n)).view(m, n)
    code = EPILOGUES[epilogue]
    if epilogue not in ("f32", "mul_aux"):
        _require_shape(bias, "bias", (n,))
    res_ptr = aux_ptr = col_ptr = None
    if epilogue == "bias_residual":
        _require_shape(residual, "residual", (m, n), torch.bfloat16)
        res_ptr = residual.data_ptr()
    if epilogue in ("bias_gelu_grad", "mul_aux"):
        if epilogue == "bias_gelu_grad":
            aux = torch.empty((m, n), dtype=torch.float32, device=a.device)
        _require_shape(aux, "aux", (m, n))
        aux_ptr = aux.data_ptr()
    colpart = None
    if epilogue == "mul_aux":
        colpart = torch.empty((math.ceil(m / GEMM_TILE[0]), n),
                              dtype=torch.float32, device=a.device)
        col_ptr = colpart.data_ptr()
    out = torch.empty((m, n), device=a.device,
                      dtype=torch.float32 if epilogue == "f32" else a.dtype)
    _launch("gemm_bf16_epilogue", lib.mvt_gemm_bf16, a,
            a.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(), res_ptr,
            out.data_ptr(), aux_ptr, col_ptr, m, n, k, b_col_major, code,
            res_scale)
    if epilogue == "bias_residual" and res_scale != 1.0:
        RES_SCALE_LAUNCHES["gemm_bf16_epilogue"] += 1
    if epilogue == "bias_gelu_grad":
        return out, aux
    if epilogue == "mul_aux":
        return out, colsum_rows_cuda(colpart)
    return out


def attention_core_max_n() -> int:
    return _lib().mvt_attention_core_max_n()


def _head_width(c3, heads, name):
    c = c3 // 3
    d = c // heads
    if c3 != 3 * c or c != heads * d or d not in (32, 64):
        raise ValueError(
            f"{name}: width {c3} with {heads} heads; the kernel takes head "
            "widths 32 and 64"
        )
    return c, d


def attention_core_cuda(qkv, heads, scale, stats=False, tiled=False):
    """bf16 (B, N, 3C) qkv rows -> bf16 (B, N, C) context, and with
    ``stats`` the rowmax and reciprocal rowsum (B, H, N) fp32; D = C/heads
    must be 32 or 64.  N above :func:`attention_core_max_n` takes the long
    route (csrc/attention_core_long_wgmma.cu, :func:`core_long_plan`), any
    N; ``tiled`` takes it at any N (for timing the two against each
    other)."""
    _require(qkv, "qkv")
    b, n, c3 = qkv.shape
    c, d = _head_width(c3, heads, "attention_core")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    m = rs = None
    if stats:
        m = torch.empty((b, heads, n), dtype=torch.float32,
                        device=qkv.device)
        rs = torch.empty_like(m)
    lib = _lib()
    _launch("attention_core",
            lib.mvt_attention_core_long if tiled else lib.mvt_attention_core,
            qkv, qkv.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if rs is None else rs.data_ptr(), b, n, heads, d,
            float(scale))
    return (out, m, rs) if stats else out


def attention_core_bwd_cuda(qkv, d_o, m, rs, heads, scale, tiled=False):
    """The CUDA version of :func:`attention_core_bwd_plain`, any N: up to
    :func:`attention_core_max_n` one wgmma CTA per (image, head)
    (csrc/attention_core_bwd_wgmma.cu), above it the long route
    (csrc/attention_core_bwd_long_wgmma.cu: four launches, the scratch of
    :func:`core_long_plan`).  ``tiled`` takes the long route at any N
    (for timing the two against each other)."""
    _require(qkv, "qkv")
    b, n, c3 = qkv.shape
    c, d = _head_width(c3, heads, "attention_core_bwd")
    _require_shape(d_o, "d_o", (b, n, c))
    _require_shape(m, "m", (b, heads, n))
    _require_shape(rs, "rs", (b, heads, n))
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((b, c3), dtype=torch.float32, device=qkv.device)
    scratch = (None, None, None)
    tiled = tiled or n > attention_core_max_n()
    if tiled:
        shapes = core_long_plan(n, d, b, heads)["scratch"]
        scratch = (torch.empty(shapes["qd"], dtype=qkv.dtype,
                               device=qkv.device),
                   torch.empty(shapes["stats"], dtype=torch.float32,
                               device=qkv.device),
                   torch.empty(shapes["colpart"], dtype=torch.float32,
                               device=qkv.device))
    lib = _lib()
    launched = ctypes.c_int(0)
    _launch("attention_core_bwd",
            lib.mvt_attention_core_bwd_tiled if tiled
            else lib.mvt_attention_core_bwd, qkv,
            qkv.data_ptr(), d_o.data_ptr(), m.data_ptr(), rs.data_ptr(),
            dqkv.data_ptr(), dbias.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch),
            b, n, heads, d, float(scale), ctypes.addressof(launched),
            launched=launched)
    return dqkv, dbias


def layernorm_rows_bwd_cuda(x, scale, dxn, do, qspec=None, res_scale=1.0):
    """The CUDA version of :func:`layernorm_rows_bwd_plain`: x, do bf16
    (rows, C), C a multiple of 4 up to 768, scale bf16 (C,), dxn fp32
    (rows, C); with ``qspec`` (a float format's, or :class:`Int8Sites`)
    x, do and scale fp32, its snap form (``layernorm_snap_rows_bwd``)."""
    res_scale = residual_scale(res_scale)
    dt = torch.bfloat16 if qspec is None else torch.float32
    _require(x, "x", dt)
    rows, cols = x.shape
    lib = _lib()
    if cols > lib.mvt_layernorm_rows_bwd_max_cols() or cols % 4:
        raise ValueError(f"layernorm_rows_bwd: width {cols} exceeds the "
                         "kernel's maximum or is not a multiple of 4")
    _require_shape(scale, "scale", (cols,), dt)
    _require_shape(dxn, "dxn", (rows, cols))
    _require_shape(do, "do", (rows, cols), dt)
    blocks = min(math.ceil(rows / 8), 4 * _sms(x))
    dx = torch.empty_like(x)
    part = torch.empty((blocks, 2 * cols), dtype=torch.float32,
                       device=x.device)
    args = (x.data_ptr(), scale.data_ptr(), dxn.data_ptr(), do.data_ptr(),
            dx.data_ptr(), part.data_ptr(), rows, cols, blocks, EPS)
    if qspec is None:
        name = "layernorm_rows_bwd"
        _launch(name, lib.mvt_layernorm_rows_bwd, x, *args, res_scale)
    else:
        name = "layernorm_snap_rows_bwd"
        int8 = isinstance(qspec, Int8Sites)
        _launch(name, lib.mvt_layernorm_snap_rows_bwd,
                x, *args, *(_NO_SNAP if int8 else _qspec_args(qspec)),
                int(int8), res_scale)
    if res_scale != 1.0:
        RES_SCALE_LAUNCHES[name] += 1
    sums = colsum_rows_cuda(part)
    return dx, sums[:cols], sums[cols:]


def colsum_rows_cuda(t):
    """fp32 column sums of a bf16 or fp32 (rows, cols) matrix, in the
    chunks of :func:`colsum_plan`: one kernel, or two above one chunk."""
    _require(t, "t", t.dtype)
    if t.dtype not in (torch.bfloat16, torch.float32) or t.dim() != 2:
        raise TypeError("colsum_rows: expected a 2-D bf16 or fp32 tensor")
    rows, cols = t.shape
    plan = colsum_plan(rows, cols, _sms(t))
    scratch = None
    if plan["chunks"] > 1:
        scratch = torch.empty((plan["chunks"], cols), dtype=torch.float32,
                              device=t.device)
    out = torch.empty(cols, dtype=torch.float32, device=t.device)
    launched = ctypes.c_int(0)  # one kernel, or two above a chunk of rows
    _launch("colsum_rows", _lib().mvt_colsum_rows, t,
            t.data_ptr(), int(t.dtype == torch.bfloat16),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            rows, cols, plan["chunk"], ctypes.addressof(launched),
            launched=launched)
    return out


def _require_site(site, name):
    """A site row: fp32 (3,) on the card, contiguous (4-byte aligned, as
    a row of the site table is)."""
    if site.device.type != "cuda" or site.dtype != torch.float32:
        raise TypeError(f"{name}: expected a CUDA fp32 site, got "
                        f"{site.dtype} on {site.device}")
    if tuple(site.shape) != (3,) or not site.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (3,) site, got "
                         f"{tuple(site.shape)}")


def layernorm_quant_rows_cuda(x, scale, bias, site):
    """The CUDA version of :func:`layernorm_quant_rows_plain`: x fp32
    (..., C), scale and bias fp32 (C,) -> int8 (..., C)."""
    cols = x.shape[-1]
    _require(x, "x", torch.float32)
    for t, name in ((scale, "scale"), (bias, "bias")):
        _require_shape(t, name, (cols,))
    _require_site(site, "site")
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    _launch("layernorm_quant_rows", _lib().mvt_layernorm_quant_rows, x,
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), site.data_ptr(),
            out.data_ptr(), x.numel() // cols, cols, EPS)
    return out


def gemm_s8_epilogue_cuda(a, w, colsum, w_scale, a_site, bias, epilogue,
                          site, site2=None, residual=None):
    """The CUDA version of :func:`gemm_s8_epilogue_plain`: a int8 (M, K)
    row-major, w int8 (K, N) read in place as the transpose of a
    row-major (N, K) tensor (the (in, out) view of a torch (out, in)
    weight), both by TMA (:func:`tma_operand`: 16-byte aligned bases;
    anything else raises ``ValueError``); K a multiple of 16, M and N
    any (:func:`gemm_s8_plan`)."""
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_s8: shapes {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[1]
    wt, col_major = _operand(w, "w")
    if not col_major:
        raise ValueError("gemm_s8: w must be the transpose of a row-major "
                         "(N, K) tensor, as a torch weight's (in, out) view")
    _require(a, "a", torch.int8)
    _require(wt, "w", torch.int8)
    if k % 16:
        raise ValueError(f"gemm_s8: K={k} must be a multiple of 16")
    tma_operand(a, "a")
    tma_operand(wt, "w")
    code = INT8_EPILOGUES[epilogue]
    _require_shape(colsum, "colsum", (n,))
    _require_shape(bias, "bias", (n,))
    if w_scale.numel() != 1 or w_scale.dtype != torch.float32 or \
            w_scale.device != a.device:
        raise TypeError("gemm_s8: w_scale must be one fp32 value on the card")
    _require_site(a_site, "a_site")
    _require_site(site, "site")
    res_ptr = site2_ptr = None
    if code:
        _require_site(site2, "site2")
        site2_ptr = site2.data_ptr()
    if epilogue == "requant_residual_requant":
        _require_shape(residual, "residual", (m, n))
        res_ptr = residual.data_ptr()
    out = torch.empty((m, n), device=a.device,
                      dtype=torch.int8 if code == 1 else torch.float32)
    _launch("gemm_s8_epilogue", _lib().mvt_gemm_s8, a,
            a.data_ptr(), wt.data_ptr(), colsum.data_ptr(),
            w_scale.data_ptr(), a_site.data_ptr(), bias.data_ptr(),
            site.data_ptr(), site2_ptr, res_ptr, out.data_ptr(), m, n, k,
            code)
    return out


def attention_core_f32_max_n() -> int:
    return _lib().mvt_attention_core_f32_max_n()


def attention_core_f32_cuda(qkv, heads, scale, site, tiled=False,
                            sweep=False):
    """The CUDA version of :func:`attention_core_f32_plain`: fp32 (B, N,
    3C) -> int8 (B, N, C); D = C/heads must be 32 or 64.  Up to
    :func:`attention_core_f32_max_n` one CTA per (image, head)
    (csrc/attention_core_f32_wgmma.cu); above it the long route to
    :data:`F32_LONG_MAX_N` (csrc/attention_core_f32_long_wgmma.cu, its
    int8 mode; the cluster design above
    :data:`F32_LONG_BLOCK_MAX_N`), counted as ``attention_core_f32_long``;
    ``tiled`` takes the long route at any N, ``sweep`` its cluster
    design at any N (for holding each against the other)."""
    _require(qkv, "qkv", torch.float32)
    b, n, c3 = qkv.shape
    c, d = _head_width(c3, heads, "attention_core_f32")
    tiled = tiled or sweep or n > attention_core_f32_max_n()
    if tiled:
        _long_route(n, "attention_core_f32")
    _require_site(site, "site")
    out = torch.empty((b, n, c), dtype=torch.int8, device=qkv.device)
    args = (qkv.data_ptr(), site.data_ptr(), out.data_ptr(), b, n, heads, d,
            float(scale))
    if tiled:
        split = _f32_long_split(f32_long_plan(n, d, b, heads), "fwd", qkv)
        launched = ctypes.c_int(0)
        _launch("attention_core_f32_long",
                _lib().mvt_attention_core_f32_long_i8, qkv, *args[:3],
                split.data_ptr(), *args[3:], int(sweep),
                ctypes.addressof(launched), launched=launched)
    else:
        _launch("attention_core_f32", _lib().mvt_attention_core_f32, qkv,
                *args)
    return out


def _qspec_args(qspec):
    exp_bits, man_bits, all_sites = qspec
    return int(exp_bits), int(man_bits), int(bool(all_sites))


_NO_SNAP = (8, 10, 0)  # the qspec arguments of a call that snaps nothing


def _policy_args(qspec, sites, slots=1):
    """The C arguments of a snap policy: (exp_bits, man_bits, all_sites)
    and ``slots`` site pointers, the device rows of the ``sites`` INT8
    sites the kernel snaps at (null for a float format, and past
    ``sites``)."""
    if not isinstance(qspec, Int8Sites):
        return (*_qspec_args(qspec), *([None] * slots))
    rows = (qspec.first, qspec.second)[:sites]
    for k, row in enumerate(rows):
        if row is None:
            raise ValueError(f"Int8Sites: the kernel snaps at {sites} "
                             f"sites, site {k} is missing")
        _require_site(row, f"site {k}")
    return (*_NO_SNAP, *(row.data_ptr() for row in rows),
            *([None] * (slots - sites)))


def fake_quant_rows_cuda(x, mode, a, b):
    """The CUDA version of :func:`fake_quant_rows_plain`: fp32, any shape
    and length, contiguous (16-byte vectors where aligned)."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError(f"fake_quant_rows: expected a CUDA fp32 tensor, got "
                        f"{x.dtype} on {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _launch("fake_quant_rows", _lib().mvt_fake_quant_rows, x,
                x.data_ptr(), out.data_ptr(), x.numel(),
                FAKE_QUANT_MODES[mode], int(a), int(b))
    return out


def layernorm_snap_rows_cuda(x, scale, bias, qspec):
    """The CUDA version of :func:`layernorm_snap_rows_plain`: x fp32
    (..., C), C a multiple of 32 up to 768 (:func:`layernorm_snap_plan`
    raises ``ValueError`` before any launch otherwise), scale and bias fp32
    (C,); ``qspec`` a float format's or :class:`Int8Sites` (one site)."""
    cols = x.shape[-1]
    rows = x.numel() // max(cols, 1)
    layernorm_snap_plan(rows, cols)
    _require(x, "x", torch.float32)
    for t, name in ((scale, "scale"), (bias, "bias")):
        _require_shape(t, name, (cols,))
    out = torch.empty_like(x)
    _launch("layernorm_snap_rows", _lib().mvt_layernorm_snap_rows, x,
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, cols, EPS, *_policy_args(qspec, 1))
    return out


def gemm_f32x3_epilogue_cuda(a, w, bias, epilogue, qspec, residual=None,
                             aux=None, res_scale=1.0):
    """The CUDA version of :func:`gemm_f32x3_epilogue_plain`, each operand
    read in place by TMA (16-byte aligned bases, :func:`tma_operand`;
    anything else raises ``ValueError``).  The forward epilogues take a
    fp32 (M, K) row-major and w (K, N) as the transpose of a row-major
    (N, K) tensor (the (in, out) view of a torch (out, in) weight); "f32"
    and "mul_aux" a row-major w (a torch weight as it is stored, for dX =
    dY W^T); K a multiple of 4.  A transposed ``a`` (the (K, M)
    activation as it is stored) takes the weight-gradient form: a
    row-major w, fp32 out ("f32" only), any K, K split across CTAs
    (:func:`gemm_f32x3_plan`) and the partial products summed in order
    by ``colsum_rows``; M and N multiples of 4.  ``qspec``: a float format's,
    or :class:`Int8Sites` (one site for "bias_snap", two for the other
    snapping epilogues); "f32" and "mul_aux" read none.  ``res_scale``
    scales the residual of "bias_snap_residual_snap"."""
    res_scale = residual_scale(res_scale)
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_f32x3: shapes {tuple(a.shape)} @ "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[1]
    a, a_col_major = _operand(a, "a")
    w, w_col_major = _operand(w, "w")
    _require(a, "a", torch.float32)
    _require(w, "w", torch.float32)
    lib = _lib()
    if a_col_major:
        if epilogue != "f32" or w_col_major:
            raise ValueError("gemm_f32x3: a transposed `a` takes a row-major "
                             "`w` and the f32 epilogue")
        if m % 4 or n % 4:
            raise ValueError(f"gemm_f32x3: M={m} and N={n} must be multiples "
                             "of 4")
        tma_operand(a, "a")
        tma_operand(w, "w")
        plan = gemm_f32x3_plan(m, n, k, True, _sms(a))
        splits = plan["grid"][2]
        part = torch.empty((splits, m, n), dtype=torch.float32,
                           device=a.device)
        _launch("gemm_f32x3_epilogue", lib.mvt_gemm_f32x3_at, a,
                a.data_ptr(), w.data_ptr(), part.data_ptr(), m, n, k,
                plan["k_split"])
        if splits == 1:
            return part[0]
        return colsum_rows_cuda(part.view(splits, m * n)).view(m, n)
    row_b = epilogue in ("f32", "mul_aux")
    if row_b and w_col_major:
        raise ValueError(f"gemm_f32x3: epilogue {epilogue} takes a row-major "
                         "w, as a torch weight is stored")
    if not row_b and not w_col_major:
        raise ValueError("gemm_f32x3: w must be the transpose of a row-major "
                         "(N, K) tensor, as a torch weight's (in, out) view")
    if k % 4 or (row_b and n % 4):
        raise ValueError(f"gemm_f32x3: K={k} (and N={n} for a row-major w) "
                         "must be a multiple of 4")
    tma_operand(a, "a")
    tma_operand(w, "w")
    code = F32X3_EPILOGUES[epilogue]
    if not row_b:
        _require_shape(bias, "bias", (n,))
    res_ptr = aux_ptr = col_ptr = colpart = None
    if epilogue == "bias_snap_residual_snap":
        _require_shape(residual, "residual", (m, n))
        res_ptr = residual.data_ptr()
    if epilogue == "bias_snap_gelu_snap_grad":
        aux = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if epilogue in ("bias_snap_gelu_snap_grad", "mul_aux"):
        _require_shape(aux, "aux", (m, n))
        aux_ptr = aux.data_ptr()
    if epilogue == "mul_aux":
        colpart = torch.empty(
            (gemm_f32x3_plan(m, n, k, False, 1, epilogue)["grid"][1], n),
            dtype=torch.float32, device=a.device)
        col_ptr = colpart.data_ptr()
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _launch("gemm_f32x3_epilogue", lib.mvt_gemm_f32x3, a,
            a.data_ptr(), w.data_ptr(), None if row_b else bias.data_ptr(),
            res_ptr, out.data_ptr(), aux_ptr, col_ptr, m, n, k, int(row_b),
            code, *((*_NO_SNAP, None, None) if row_b else _policy_args(
                qspec, 1 if epilogue == "bias_snap" else 2, slots=2)),
            res_scale)
    if epilogue == "bias_snap_residual_snap" and res_scale != 1.0:
        RES_SCALE_LAUNCHES["gemm_f32x3_epilogue"] += 1
    if epilogue == "bias_snap_gelu_snap_grad":
        return out, aux
    if epilogue == "mul_aux":
        return out, colsum_rows_cuda(colpart)
    return out


def _long_route(n, name):
    """Raise where the fp32 core's long route does not take a call: more
    than :data:`F32_LONG_MAX_N` tokens, which the fused gate never sends
    to it."""
    if n > F32_LONG_MAX_N:
        raise NotImplementedError(
            f"{name}: sequence {n} exceeds {F32_LONG_MAX_N}, the longest "
            "that the fused gate (fuses_at) lets through at a head width of "
            "32 or 64; the Block takes its discrete path there")


def attention_core_snap_cuda(qkv, heads, scale, qspec, stats=False,
                             tiled=False, sweep=False):
    """The CUDA version of :func:`attention_core_snap_plain`, the fp32 snap
    mode of ``attention_core_f32``: fp32 (B, N, 3C) -> fp32 (B, N, C), and
    with ``stats`` the rowmax and reciprocal rowsum (B, H, N) fp32; D =
    C/heads must be 32 or 64; ``qspec`` a float format's or
    :class:`Int8Sites` (one site).  Up to :func:`attention_core_f32_max_n`
    one CTA per (image, head) (csrc/attention_core_f32_wgmma.cu); above it
    the long route to :data:`F32_LONG_MAX_N`
    (csrc/attention_core_f32_long_wgmma.cu, :func:`f32_long_plan`; the
    cluster design above :data:`F32_LONG_BLOCK_MAX_N`), counted as
    ``attention_core_f32_long``; ``tiled`` takes the long route at any N,
    ``sweep`` its cluster design at any N (for holding each against
    the other)."""
    _require(qkv, "qkv", torch.float32)
    b, n, c3 = qkv.shape
    c, d = _head_width(c3, heads, "attention_core_f32")
    tiled = tiled or sweep or n > attention_core_f32_max_n()
    if tiled:
        _long_route(n, "attention_core_f32")
    exp_bits, man_bits, _, site = _policy_args(qspec, 1)
    out = torch.empty((b, n, c), dtype=torch.float32, device=qkv.device)
    m = rs = None
    if stats:
        m = torch.empty((b, heads, n), dtype=torch.float32,
                        device=qkv.device)
        rs = torch.empty_like(m)
    stat_ptrs = (None if m is None else m.data_ptr(),
                 None if rs is None else rs.data_ptr())
    if tiled:
        split = _f32_long_split(f32_long_plan(n, d, b, heads), "fwd", qkv)
        launched = ctypes.c_int(0)
        _launch("attention_core_f32_long", _lib().mvt_attention_core_f32_long,
                qkv, qkv.data_ptr(), out.data_ptr(), *stat_ptrs,
                split.data_ptr(), b, n, heads, d, float(scale), exp_bits,
                man_bits, site, int(sweep), ctypes.addressof(launched),
                launched=launched)
    else:
        _launch("attention_core_f32", _lib().mvt_attention_core_f32_snap, qkv,
                qkv.data_ptr(), out.data_ptr(), *stat_ptrs, b, n, heads, d,
                float(scale), exp_bits, man_bits, site)
    return (out, m, rs) if stats else out


def attention_core_f32_recip_probe_cuda(qkv, heads, scale, qspec):
    """:func:`attention_core_snap_cuda` with ``stats`` under a float
    format, but p = e * (1 / rowsum) in place of the true divide: a timing
    variant that prices the divide (chip_smoke.py), which no path calls;
    head width 64 and N 193-208 only.  Counts as ``attention_core_f32``."""
    _require(qkv, "qkv", torch.float32)
    b, n, c3 = qkv.shape
    c, d = _head_width(c3, heads, "attention_core_f32")
    out = torch.empty((b, n, c), dtype=torch.float32, device=qkv.device)
    m = torch.empty((b, heads, n), dtype=torch.float32, device=qkv.device)
    rs = torch.empty_like(m)
    exp_bits, man_bits, _ = _qspec_args(qspec)
    _launch("attention_core_f32", _lib().mvt_attention_core_f32_snap_recip,
            qkv, qkv.data_ptr(), out.data_ptr(), m.data_ptr(), rs.data_ptr(),
            b, n, heads, d, float(scale), exp_bits, man_bits)
    return out, m, rs


def attention_core_f32_launch(n, d):
    """The launch figures that the fp32 core's kernels report for ``n``
    tokens at head width ``d``, in the form of
    :func:`attention_core_f32_plan` ("ctas_per_sm" the runtime's
    occupancy of the compiled kernel)."""
    from myrtle_vision_tpu_torch.ops import _build

    lib = _lib()
    figures = {}
    for key, fn in (("fwd", lib.mvt_attention_core_f32_launch),
                    ("bwd", lib.mvt_attention_core_f32_bwd_launch)):
        f = (ctypes.c_int * 5)()
        _build.check(fn(n, d, f), f"attention_core_f32_launch[{key}]")
        figures[key] = dict(zip(("warpgroups", "ka", "launches", "smem",
                                 "ctas_per_sm"), f))
    return figures


def attention_core_f32_bwd_cuda(qkv, d_o, m, rs, heads, scale,
                                tiled=False):
    """The CUDA version of :func:`attention_core_f32_bwd_plain`: fp32 qkv
    (B, N, 3C), d_o (B, N, C), m and rs (B, H, N); D = C/heads must be 32
    or 64.  Up to :func:`attention_core_f32_max_n` one CTA of two
    warpgroups per (image, head) (csrc/attention_core_f32_bwd_wgmma.cu);
    above it the long route to :data:`F32_LONG_MAX_N`
    (csrc/attention_core_f32_bwd_long_wgmma.cu: four launches, the
    scratch of :func:`f32_long_plan`), counted as
    ``attention_core_f32_bwd_long``; ``tiled`` takes it at any N."""
    _require(qkv, "qkv", torch.float32)
    b, n, c3 = qkv.shape
    c, d = _head_width(c3, heads, "attention_core_f32_bwd")
    lib = _lib()
    tiled = tiled or n > lib.mvt_attention_core_f32_bwd_max_n()
    if tiled:
        _long_route(n, "attention_core_f32_bwd")
    _require_shape(d_o, "d_o", (b, n, c))
    _require_shape(m, "m", (b, heads, n))
    _require_shape(rs, "rs", (b, heads, n))
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((b, c3), dtype=torch.float32, device=qkv.device)
    args = (qkv.data_ptr(), d_o.data_ptr(), m.data_ptr(), rs.data_ptr(),
            dqkv.data_ptr(), dbias.data_ptr())
    if tiled:
        plan = f32_long_plan(n, d, b, heads)
        split = _f32_long_split(plan, "bwd", qkv)
        rt, colpart = (torch.empty(plan["scratch"]["bwd"][k],
                                   dtype=torch.float32, device=qkv.device)
                       for k in ("rt", "colpart"))
        launched = ctypes.c_int(0)
        _launch("attention_core_f32_bwd_long",
                lib.mvt_attention_core_f32_bwd_long, qkv, *args,
                split.data_ptr(), rt.data_ptr(), colpart.data_ptr(), b, n,
                heads, d, float(scale), ctypes.addressof(launched),
                launched=launched)
    else:
        _launch("attention_core_f32_bwd", lib.mvt_attention_core_f32_bwd,
                qkv, *args, b, n, heads, d, float(scale))
    return dqkv, dbias


def _require_rows(t, name, dtype=torch.bfloat16):
    """A CUDA tensor of ``dtype`` (bf16 or fp32) whose last dimension is
    contiguous and whose other strides keep every row 16-byte aligned."""
    if t.device.type != "cuda" or t.dtype != dtype:
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        raise TypeError(f"{name}: expected a {kind} CUDA tensor, got "
                        f"{t.dtype} on {t.device}")
    per_16 = 16 // t.element_size()
    if t.stride(-1) != 1 or any(s % per_16 for s in t.stride()[:-1]) or \
            t.data_ptr() % 16:
        raise ValueError(f"{name}: expected rows contiguous and 16-byte "
                         f"aligned, got strides {t.stride()}")


def _flash_args(name, dtype, q, k, v, n_valid, more=()):
    """The checks of the flash wrappers -> (B, H, N, D, n_valid): q, k, v
    (and ``more``, (tensor, name) pairs of the same shape) (B, H, N, D)
    CUDA views of ``dtype`` with rows contiguous and 16-byte aligned, q,
    k and v sharing strides, D 32 or 64, 1 <= n_valid <= N."""
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, v, *(
            t for t, _ in more))):
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for t, label in ((q, "q"), (k, "k"), (v, "v"), *more):
        _require_rows(t, label, dtype)
    if not q.stride() == k.stride() == v.stride():
        raise ValueError(f"{name}: q, k and v must share strides")
    b, h, n, d = q.shape
    if d not in (32, 64):
        raise ValueError(f"{name}: head width {d}; the kernel takes 32 and "
                         "64")
    n_valid = n if n_valid is None else int(n_valid)
    if not 1 <= n_valid <= n:
        raise ValueError(f"{name}: n_valid {n_valid} of {n}")
    return b, h, n, d, n_valid


def flash_attention_fwd_cuda(q, k, v, scale, n_valid=None, lse=False):
    """Softmax attention of bf16 (B, H, N, D) q, k, v, keys at or past
    ``n_valid`` masked -> bf16 (B, H, N, D), a view of (B, N, H, D)
    storage (so the heads' concatenation is a view too), and with ``lse``
    the fp32 (B, H, N) log-sum-exp.  q, k and v share one set of strides
    with the last dimension contiguous, e.g. the (B, H, N, D) views of
    the fused (B, N, 3C) qkv rows, read in place by TMA; D must be 32 or
    64 (csrc/flash_attention_fwd_wgmma.cu, :func:`flash_plan`)."""
    b, h, n, d, n_valid = _flash_args("flash_attention", torch.bfloat16, q,
                                      k, v, n_valid)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
             if lse else None)
    sb, sh, sn, _ = q.stride()
    _launch("flash_attention_fwd", _lib().mvt_flash_attention_fwd, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse_t is None else lse_t.data_ptr(), sb, sh, sn,
            n * h * d, d, h * d, b, h, n, d, n_valid, float(scale))
    out = out.permute(0, 2, 1, 3)
    return (out, lse_t) if lse else out


def flash_attention_bwd_cuda(q, k, v, o, do, lse, scale, n_valid=None):
    """The backward of :func:`flash_attention_fwd_cuda`
    (csrc/flash_attention_bwd_wgmma.cu, three launches: the dsum pre-pass,
    dk / dv, dq; :func:`flash_plan`): bf16 (B, H, N, D) q, k,
    v with the forward's strides, its output o, the output gradient do
    (each with rows contiguous and 16-byte aligned, strides of their own)
    and its fp32 (B, H, N) LSE -> bf16 (dq, dk, dv), (B, H, N, D) views of
    (B, N, H, D) storage."""
    b, h, n, d, n_valid = _flash_args(
        "flash_attention_bwd", torch.bfloat16, q, k, v, n_valid,
        more=((o, "o"), (do, "do")))
    _require_shape(lse, "lse", (b, h, n))
    # the pre-pass's rows: LSE log2(e) and dsum, n padded to the tile
    n_pad = math.ceil(n / FLASH_BWD_TILE) * FLASH_BWD_TILE
    stats = torch.empty(2 * b * h * n_pad, dtype=torch.float32,
                        device=q.device)
    grads = [torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
             for _ in range(3)]
    launched = ctypes.c_int(0)
    _launch("flash_attention_bwd", _lib().mvt_flash_attention_bwd, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), stats.data_ptr(),
            *(g.data_ptr() for g in grads), *q.stride()[:3],
            *o.stride()[:3], *do.stride()[:3], n * h * d, d, h * d, b, h, n,
            d, n_valid, float(scale), ctypes.addressof(launched),
            launched=launched)
    return tuple(g.permute(0, 2, 1, 3) for g in grads)


def _flash_f32_scratch(b, h, n, d, arrays, device):
    """The split pass's scratch of the fp32 flash kernels: ``arrays``
    operand layouts (the forward 2, the backward 7), each a hi and a lo
    half of (B H, n_split(N), D) fp32 values (csrc/flash_tf32.cuh): the
    forward's K as it lies, then V transposed; the backward's K, V, q and
    do as they lie, then K, q and do transposed (the layouts of
    ``ops.flash_attention.flash_f32_split_plain``)."""
    ns = -(-n // 8) * 8
    return torch.empty(2 * arrays * b * h * ns * d, dtype=torch.float32,
                       device=device)


def flash_attention_f32_fwd_cuda(q, k, v, scale, n_valid=None, lse=False):
    """:func:`flash_attention_fwd_cuda` on fp32 operands
    (csrc/flash_attention_f32_fwd_wgmma.cu, K5 and K6 on fp32: every
    product 3xTF32 on wgmma; two launches, the split pass and the core):
    fp32 (B, H, N, D) q, k, v sharing strides, rows contiguous and 16-byte
    aligned, D 32 or 64 -> fp32 (B, H, N, D), a view of (B, N, H, D)
    storage, and with ``lse`` the fp32 (B, H, N) log-sum-exp."""
    b, h, n, d, n_valid = _flash_args("flash_attention_f32", torch.float32,
                                      q, k, v, n_valid)
    out = torch.empty((b, n, h, d), dtype=torch.float32, device=q.device)
    lse_t = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
             if lse else None)
    scratch = _flash_f32_scratch(b, h, n, d, 2, q.device)
    launched = ctypes.c_int(0)
    _launch("flash_attention_f32_fwd", _lib().mvt_flash_attention_f32_fwd, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse_t is None else lse_t.data_ptr(), scratch.data_ptr(),
            *q.stride()[:3], b, h, n, d, n_valid, float(scale),
            ctypes.addressof(launched), launched=launched)
    out = out.permute(0, 2, 1, 3)
    return (out, lse_t) if lse else out


def flash_attention_f32_bwd_cuda(q, k, v, o, do, lse, scale, n_valid=None):
    """The backward of :func:`flash_attention_f32_fwd_cuda`
    (csrc/flash_attention_f32_bwd_wgmma.cu, K7 and K8 on fp32; four
    launches: the dsum pre-pass, the split pass, dk / dv, dq): fp32 (B, H,
    N, D) q, k, v with the forward's strides, its output o, the output
    gradient do (rows contiguous and 16-byte aligned, strides of their own)
    and its fp32 (B, H, N) LSE -> fp32 (dq, dk, dv), (B, H, N, D) views of
    (B, N, H, D) storage."""
    b, h, n, d, n_valid = _flash_args(
        "flash_attention_f32_bwd", torch.float32, q, k, v, n_valid,
        more=((o, "o"), (do, "do")))
    _require_shape(lse, "lse", (b, h, n))
    dsum = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    scratch = _flash_f32_scratch(b, h, n, d, 7, q.device)
    grads = [torch.empty((b, n, h, d), dtype=torch.float32, device=q.device)
             for _ in range(3)]
    launched = ctypes.c_int(0)
    _launch("flash_attention_f32_bwd", _lib().mvt_flash_attention_f32_bwd, q,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            scratch.data_ptr(), *(g.data_ptr() for g in grads),
            *q.stride()[:3], *o.stride()[:3], *do.stride()[:3], b, h, n, d,
            n_valid, float(scale), ctypes.addressof(launched),
            launched=launched)
    return tuple(g.permute(0, 2, 1, 3) for g in grads)


def attention_core_probe_cuda(qkv, heads, scale, mode, parts=False):
    """The CUDA version of :func:`attention_core_probe_plain`
    (csrc/attention_core.cu in a probe mode): bf16 (B, N, 3C) qkv rows, D
    = C/heads 64, N at most :func:`attention_core_max_n`."""
    _require(qkv, "qkv")
    b, n, c3 = qkv.shape
    c, d = _head_width(c3, heads, "attention_core_probe")
    if d != 64:
        raise ValueError(f"attention_core_probe: head width {d}; the probe "
                         "modes take 64")
    if n > attention_core_max_n():
        raise ValueError(f"attention_core_probe: sequence {n} exceeds the "
                         f"kernel's maximum {attention_core_max_n()}")
    if mode not in PROBE_MODES or (parts and mode not in DEFERRED_MODES):
        raise ValueError(f"attention_core_probe: mode {mode!r}"
                         + (" has no parts" if parts else ""))
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    m = rs = None
    if parts:
        m = torch.empty((b, heads, n), dtype=torch.float32,
                        device=qkv.device)
        rs = torch.empty_like(m)
    _launch("attention_core_probe", _lib().mvt_attention_core_probe, qkv,
            qkv.data_ptr(), out.data_ptr(),
            None if m is None else m.data_ptr(),
            None if rs is None else rs.data_ptr(), b, n, heads, d,
            float(scale), PROBE_MODES[mode])
    return (out, m, rs) if parts else out


def gemm_bf16_probe_cuda(a, b, bias, epilogue, residual=None, gelu="base"):
    """The probes' GEMMs (csrc/gemm_bf16_epilogue.cu, its probe
    instantiations): :func:`gemm_bf16_epilogue_plain` for a row-major bf16
    a (M, K) and the epilogues "bias", "bias_gelu" (in GELU mode
    ``gelu``), "bias_residual" and "store"; b bf16 (K, N) row-major, or
    for "bias" head-major (3, H, K, 64), read in place."""
    if b.dim() == 4:
        _require(b, "b")
        three, h, k, d = b.shape
        n, layout = three * h * d, d
        if d != 64 or epilogue != "bias":
            raise ValueError(f"gemm_probe: a head-major b takes width 64 and "
                             f"the bias epilogue, got {d} and {epilogue!r}")
    else:
        k, n = b.shape
        _require(b, "b")
        layout = 0
    if a.dim() != 2 or a.shape[1] != k:
        raise ValueError(f"gemm_probe: shapes {tuple(a.shape)} @ "
                         f"({k}, {n})")
    _require(a, "a")
    m = a.shape[0]
    if k % 8 or n % 8:
        raise ValueError(f"gemm_probe: K={k} and N={n} must be multiples "
                         "of 8")
    if epilogue not in ("bias", "bias_gelu", "bias_residual", "store") or \
            gelu not in GELU_MODES or (gelu != "base" and
                                       epilogue != "bias_gelu"):
        raise ValueError(f"gemm_probe: epilogue {epilogue!r}, GELU mode "
                         f"{gelu!r}")
    if epilogue != "store":
        _require_shape(bias, "bias", (n,))
    res_ptr = None
    if epilogue == "bias_residual":
        _require_shape(residual, "residual", (m, n), torch.bfloat16)
        res_ptr = residual.data_ptr()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _launch("gemm_bf16_gelu_probe" if epilogue == "bias_gelu"
            else "gemm_bf16_probe", _lib().mvt_gemm_bf16_probe, a,
            a.data_ptr(), b.data_ptr(),
            None if epilogue == "store" else bias.data_ptr(), res_ptr,
            out.data_ptr(), m, n, k, layout, EPILOGUES[epilogue],
            GELU_MODES[gelu])
    return out


def batched_layout_dot_cuda(a, b, contract, heads=None, explicit=False):
    """The CUDA version of :func:`batched_layout_dot_plain`
    (csrc/gemm_layout_probe.cu): a bf16 (B, r, c) and b bf16 (B, r', c')
    or (r', c'), contiguous, read in place; a transposed operand read by
    column-major fragments, or with ``explicit`` transposed as it is
    staged into shared memory."""
    ca, cb, h, wa, wb = _layout_heads(a, b, contract, heads)
    _require(a, "a")
    _require(b, "b")
    if a.dim() != 3 or b.dim() not in (2, 3) or \
            (b.dim() == 3 and b.shape[0] != a.shape[0]):
        raise ValueError(f"layout_dot: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    bsz, ra, cols_a = a.shape
    rb, cols_b = b.shape[-2:]
    m, k = (ra, wa) if ca == 1 else (wa, ra)
    kb, n = (rb, wb) if cb == 0 else (wb, rb)
    if k != kb:
        raise ValueError(f"layout_dot: contracted lengths {k} and {kb}")
    out = torch.empty((bsz, m, h * n), dtype=torch.float32, device=a.device)
    _launch("gemm_layout_probe", _lib().mvt_gemm_layout_probe, a,
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bsz, h,
            ra * cols_a, wa, cols_a, 0 if b.dim() == 2 else rb * cols_b, wb,
            cols_b, m * h * n, n, h * n, int(ca == 0), int(cb == 1),
            int(explicit))
    return out


CUDA = SimpleNamespace(
    layernorm_rows=layernorm_rows_cuda,
    gemm=gemm_bf16_epilogue_cuda,
    attention_core=attention_core_cuda,
    attention_core_bwd=attention_core_bwd_cuda,
    layernorm_rows_bwd=layernorm_rows_bwd_cuda,
    colsum_rows=colsum_rows_cuda,
    layernorm_quant_rows=layernorm_quant_rows_cuda,
    gemm_s8=gemm_s8_epilogue_cuda,
    attention_core_f32=attention_core_f32_cuda,
    fake_quant_rows=fake_quant_rows_cuda,
    layernorm_snap_rows=layernorm_snap_rows_cuda,
    gemm_f32x3=gemm_f32x3_epilogue_cuda,
    attention_core_snap=attention_core_snap_cuda,
    attention_core_f32_bwd=attention_core_f32_bwd_cuda,
    attention_core_probe=attention_core_probe_cuda,
    gemm_probe=gemm_bf16_probe_cuda,
    layout_dot=batched_layout_dot_cuda,
)


def for_device(t):
    """:data:`PLAIN` for a CPU tensor, :data:`CUDA` for a CUDA tensor; any
    other device raises."""
    if t.device.type == "cpu":
        return PLAIN
    if t.device.type == "cuda":
        return CUDA
    raise ValueError(f"no kernel for {t.device}")
